"""Simulated communication-complexity sweep (paper Sec. III-B at scale).

Port of ``benchmarks/sim_sweep.py`` over the port's simulator; host
only, every time is the model's simulated clock.

Sweeps P, d, buckets and method through ``repro_torch.sim`` — the
discrete-event replay of the real schedules — and validates the paper's
headline claim on *measured simulated traffic* rather than closed-form
algebra:

    gs-SGD   per-worker bytes·rounds grow O(log d · log P)
    dense    per-worker bytes grow O(d), flat in P
    sketched-sgd rounds grow O(P) (the PS inbox hotspot)

The sweep uses ``rows='log'`` so the sketch depth carries the O(log d)
union-bound term the claim is about (the fixed-width payload is the
O(1/eps^2) factor). Writes ``BENCH_sim.json`` under
``experiments/bench_torch/`` (or ``--out``).

    python -m repro_torch.bench.sim_sweep [--fast] [--p 4 16 64]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

from repro_torch.bench.cnn_dist import OUT
from repro_torch.sim import ComputeModel, SimConfig, simulate

METHODS = ("gs-sgd", "gtopk", "sketched-sgd", "dense")


K, WIDTH = 15_000, 2 ** 17  # fixed across d (comm_complexity geometry):
# the d-dependence of the sketch payload is the O(log d) rows term alone


def run_cell(method: str, p: int, d: int, buckets: int = 1,
             steps: int = 3, bwd_chunks: int = 1,
             topology: str = "flat") -> dict:
    cfg = SimConfig(p=p, d=d, method=method, buckets=buckets, steps=steps,
                    k=K, rows="log", width=WIDTH, topology=topology,
                    bwd_chunks=bwd_chunks,
                    compute=ComputeModel(mean=0.05, jitter=0.0),
                    drop_stragglers=False)
    res = simulate(cfg)
    tot = res.totals()
    n = max(1, len(res.records))
    return {"method": method, "p": p, "d": d, "buckets": buckets,
            "bwd_chunks": bwd_chunks, "topology": topology,
            "bytes_per_step": tot["bytes_critical"] / n,
            "fabric_bytes_per_step": tot["bytes_wire"] / n,
            "rounds_per_step": tot["rounds"] / n,
            "comm_s_per_step": tot["comm"] / n,
            "encode_s_per_step": tot["encode"] / n,
            "step_s": tot["makespan"] / n}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, nargs="+",
                    default=[4, 16, 64, 256, 1024])
    ap.add_argument("--d", type=int, nargs="+",
                    default=[1_000_000, 15_000_000, 60_000_000])
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--fast", action="store_true",
                    help="small sweep (P<=64, one d)")
    ap.add_argument("--out", default=OUT, help="directory of BENCH_sim.json")
    args = ap.parse_args(argv)
    ps = [p for p in args.p if p <= 64] or [4, 16, 64] if args.fast else args.p
    ds = args.d[:1] if args.fast else args.d
    # the claim checks compare every bucketed cell against monolithic
    bks = sorted(set(args.buckets) | {1})

    t0 = time.time()
    cells = []
    for method in METHODS:
        for p in ps:
            for d in ds:
                for b in (bks if method == "gs-sgd" else [1]):
                    cells.append(run_cell(method, p, d, b))
    print(f"{len(cells)} cells in {time.time() - t0:.1f}s")

    by = {(c["method"], c["p"], c["d"], c["buckets"]): c for c in cells}
    p_lo, p_hi = min(ps), max(ps)
    d_lo, d_hi = min(ds), max(ds)

    def cell(m, p, d, b=1):
        return by[(m, p, d, b)]

    print(f"\n{'method':>14s} {'P':>6s} {'d':>12s} {'MiB/step':>10s} "
          f"{'rounds':>8s} {'comm s':>8s}")
    for c in cells:
        print(f"{c['method']:>14s} {c['p']:6d} {c['d']:12d} "
              f"{c['bytes_per_step'] / 2**20:10.2f} "
              f"{c['rounds_per_step']:8.0f} {c['comm_s_per_step']:8.3f}")

    # -- claim checks on measured simulated traffic -----------------------
    checks = {}
    gs_p = (cell("gs-sgd", p_hi, d_lo)["bytes_per_step"]
            / cell("gs-sgd", p_lo, d_lo)["bytes_per_step"])
    log_p = math.log2(p_hi) / math.log2(p_lo)
    dn_p = (cell("dense", p_hi, d_lo)["bytes_per_step"]
            / cell("dense", p_lo, d_lo)["bytes_per_step"])
    ring_ratio = (2 * (p_hi - 1) / p_hi) / (2 * (p_lo - 1) / p_lo)
    checks["gs_bytes_growth_P"] = gs_p
    checks["log_P_ratio"] = log_p
    checks["dense_bytes_growth_P"] = dn_p
    assert gs_p <= 1.5 * log_p, (gs_p, log_p)      # O(log P), not O(P)
    assert dn_p <= ring_ratio * 1.02               # ring: 2(P-1)/P, saturates
    if len(ds) > 1:
        gs_d = (cell("gs-sgd", p_lo, d_hi)["bytes_per_step"]
                / cell("gs-sgd", p_lo, d_lo)["bytes_per_step"])
        dn_d = (cell("dense", p_lo, d_hi)["bytes_per_step"]
                / cell("dense", p_lo, d_lo)["bytes_per_step"])
        lin_d = d_hi / d_lo
        checks["gs_bytes_growth_d"] = gs_d
        checks["dense_bytes_growth_d"] = dn_d
        assert gs_d <= 0.25 * lin_d, (gs_d, lin_d)  # O(log d), not O(d)
        assert dn_d >= 0.9 * lin_d
        print(f"\nbytes growth d={d_lo:.0e}->{d_hi:.0e} (x{lin_d:.0f} "
              f"linear): gs-sgd x{gs_d:.2f} (log), dense x{dn_d:.2f}")
    ps_r = (cell("sketched-sgd", p_hi, d_lo)["rounds_per_step"]
            / cell("sketched-sgd", p_lo, d_lo)["rounds_per_step"])
    checks["ps_rounds_growth_P"] = ps_r
    assert ps_r >= 0.5 * (p_hi / p_lo)             # O(P) inbox rounds
    print(f"bytes growth P={p_lo}->{p_hi}: gs-sgd x{gs_p:.2f} "
          f"(log ratio {log_p:.2f}), dense x{dn_p:.2f}, "
          f"sketched-sgd rounds x{ps_r:.1f} (linear {p_hi / p_lo:.0f})")

    # bucketize preserves the aggregate sketch geometry: same payload to
    # within scaling slack, rounds multiplied by the bucket count (the
    # alpha cost the encode-overlap pays for; see DESIGN.md §5-6)
    for p in ps:
        for b in bks[1:]:
            c1 = cell("gs-sgd", p, ds[0], 1)
            cb = cell("gs-sgd", p, ds[0], b)
            assert 0.7 <= cb["bytes_per_step"] / c1["bytes_per_step"] <= 1.6
            assert cb["rounds_per_step"] >= c1["rounds_per_step"]

    # -- backward-interleaved readiness: exposed comm shrinks with chunks --
    # The readiness scheduler starts a bucket's all-reduce as soon as the
    # backward scan emits it; on the hierarchical topology (slow inter-group
    # links = comm-bound regime) the exposed comm must STRICTLY decrease as
    # bwd_chunks grows — the executable form of the paper's overlap claim.
    p_b = max(ps)
    bwd_sweep = [run_cell("gs-sgd", p_b, ds[0], buckets=8, bwd_chunks=kc,
                          topology="hier") for kc in (1, 2, 4, 8)]
    cells.extend(bwd_sweep)
    exposed = [c["comm_s_per_step"] for c in bwd_sweep]
    checks["bwd_chunks_exposed_comm"] = {
        str(c["bwd_chunks"]): e for c, e in zip(bwd_sweep, exposed)}
    for a, b in zip(exposed, exposed[1:]):
        assert b < a, ("exposed comm must strictly decrease with "
                       "bwd_chunks", exposed)
    print(f"\nexposed exchange s/step @P={p_b} hier, 8 buckets: " + "  ".join(
        f"K={c['bwd_chunks']}:{e:.4f}" for c, e in zip(bwd_sweep, exposed)))

    from repro_torch.obs import provenance
    out = {"cells": cells, "checks": checks,
           "sweep": {"p": ps, "d": ds, "buckets": bks,
                     "bwd_chunks": [1, 2, 4, 8]},
           "provenance": provenance()}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "BENCH_sim.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
