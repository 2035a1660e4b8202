"""Simulator scale benchmark: the batched engine vs the seed loop path.

Port of ``benchmarks/sim_scale.py`` over the port's simulator; host
only. Wall seconds are this host's clock; every simulated time is the
model's.

Two questions, answered on measured wall-clock:

1. **Speedup** — at P=1024 on one churned 50-step config, how much faster
   is the batched engine (vectorized memberships, ``beat_many``, batched
   samplers, array collective pricing) than the seed engine? The baseline
   re-creates the seed's cost profile: ``engine='loop'`` + the
   ``perworker`` compute sampler (one Generator per (seed, step, worker))
   + a network wrapper that prices every pair through the scalar
   ``link()`` python fallback. Asserts the ≥10x floor.

2. **Scale** — does the batched engine hold P ∈ {1k, 10k, 100k}, with and
   without heavy churn (fail/rejoin/straggle every other step), inside a
   wall-clock ceiling? The P=100k churned cell is the web-scale deliverable
   and the cell ``--fast --ceiling`` runs.

Writes ``BENCH_simscale.json`` under ``experiments/bench_torch/`` (or
``--out``): per-cell wall seconds, engine events/s, worker-steps/s,
replans.

    python -m repro_torch.bench.sim_scale            # full matrix
    python -m repro_torch.bench.sim_scale --fast --ceiling 120
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.bench.cnn_dist import OUT
from repro_torch.sim import ComputeModel, SimConfig, network as netm, \
    simulate, synthetic

CHURN = dict(fail_rate=0.5, rejoin_after=5,
             straggle_rate=0.5, straggle_factor=8.0)


class SeedFidelityNet(netm.NetworkModel):
    """Price pairs through the scalar ``link()`` fallback — the seed
    engine's per-pair python walk — while keeping the wrapped model's own
    ``worst_link`` (the seed already had per-model O(1)/O(n) overrides
    there, so the generic O(n^2) base fallback would overstate the
    baseline's cost)."""

    def __init__(self, inner: netm.NetworkModel):
        self.inner = inner

    def link(self, src: int, dst: int) -> netm.LinkSpec:
        return self.inner.link(src, dst)

    def worst_link(self, ids, nbytes: float = 0.0) -> netm.LinkSpec:
        return self.inner.worst_link(ids, nbytes)


def _cfg(p: int, *, sampler: str = "batched") -> SimConfig:
    return SimConfig(p=p, d=1_000_000, method="gs-sgd", buckets=4, steps=50,
                     compute=ComputeModel(mean=0.05, jitter=0.05,
                                          sampler=sampler),
                     heartbeat_timeout=0.4)


def run_cell(p: int, *, churn: bool, engine: str = "batched",
             sampler: str = "batched", seed_net: bool = False) -> dict:
    cfg = _cfg(p, sampler=sampler)
    trace = (synthetic(p, cfg.steps, **CHURN) if churn else None)
    net = SeedFidelityNet(netm.make_network(cfg.topology, link=cfg.link)) \
        if seed_net else None
    t0 = time.time()
    res = simulate(cfg, trace, net=net, engine=engine)
    wall = time.time() - t0
    steps = len(res.records)
    return {"p": p, "churn": churn, "engine": engine, "sampler": sampler,
            "seed_net": seed_net, "steps": steps, "wall_s": wall,
            "events": res.events_run,
            "events_per_s": res.events_run / wall if wall > 0 else 0.0,
            "worker_steps_per_s": p * steps / wall if wall > 0 else 0.0,
            "replans": len(res.replans),
            "makespan": res.makespan}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, nargs="+",
                    default=[1_000, 10_000, 100_000])
    ap.add_argument("--speedup-p", type=int, default=1024,
                    help="P of the loop-vs-batched speedup cell")
    ap.add_argument("--speedup-floor", type=float, default=10.0,
                    help="required wall-clock speedup over the seed path "
                         "(0 disables the assert)")
    ap.add_argument("--ceiling", type=float, default=None, metavar="SEC",
                    help="assert the churned max-P cell finishes under "
                         "SEC wall seconds")
    ap.add_argument("--fast", action="store_true",
                    help="quick profile: speedup cell at P=256 "
                         "(informational) + the churned max-P scale cell "
                         "only")
    ap.add_argument("--out", default=OUT,
                    help="directory of BENCH_simscale.json")
    args = ap.parse_args(argv)

    sp = 256 if args.fast else args.speedup_p
    base = run_cell(sp, churn=True, engine="loop", sampler="perworker",
                    seed_net=True)
    new = run_cell(sp, churn=True)
    speedup = base["wall_s"] / new["wall_s"] if new["wall_s"] > 0 \
        else float("inf")
    print(f"speedup @P={sp} churned, 50 steps: seed path "
          f"{base['wall_s']:.2f}s -> batched {new['wall_s']:.2f}s "
          f"= x{speedup:.1f}")
    if not args.fast and args.speedup_floor:
        assert speedup >= args.speedup_floor, (
            f"batched engine speedup x{speedup:.1f} below the "
            f"x{args.speedup_floor:.0f} floor")

    scale_ps = [max(args.p)] if args.fast else sorted(args.p)
    churns = [True] if args.fast else [False, True]
    cells = []
    print(f"\n{'P':>8s} {'churn':>6s} {'wall s':>8s} {'ev/s':>10s} "
          f"{'wsteps/s':>12s} {'replans':>8s}")
    for p in scale_ps:
        for churn in churns:
            c = run_cell(p, churn=churn)
            cells.append(c)
            print(f"{p:8d} {str(churn):>6s} {c['wall_s']:8.2f} "
                  f"{c['events_per_s']:10.1f} "
                  f"{c['worker_steps_per_s']:12.0f} {c['replans']:8d}")

    hot = max((c for c in cells if c["churn"]), key=lambda c: c["p"])
    if args.ceiling is not None:
        assert hot["wall_s"] <= args.ceiling, (
            f"P={hot['p']} churned cell took {hot['wall_s']:.1f}s "
            f"(> {args.ceiling:.0f}s ceiling)")
        print(f"\nP={hot['p']} churned: {hot['wall_s']:.2f}s "
              f"<= {args.ceiling:.0f}s ceiling")

    from repro_torch.obs import provenance
    out = {"speedup": {"p": sp, "baseline": base, "batched": new,
                       "wall_speedup": speedup,
                       "floor": args.speedup_floor if not args.fast else None},
           "cells": cells, "provenance": provenance()}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "BENCH_simscale.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
