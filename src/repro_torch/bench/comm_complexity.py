"""Paper Eq. 1 / Sec. III-B: communication complexity against worker count.

Port of ``benchmarks/comm_complexity.py``:

    gs-SGD:        O(log d * log P)   (tree all-reduce of sketches)
    Sketched-SGD:  O(log d * P)       (parameter-server inbox)
    gTop-k:        O(k * log P)       (tree of 2k (value, index) payloads)

from the compressors' static CommStats at VGG-16's scale (k = 15,000,
~0.1% of d = 15M; none of the three depends on d itself) over P = 2..64:
bytes, rounds and Eq. 1's time at 1 GbE. A model: it runs no
step and touches no device (the reference runs one step per point to read
the same CommStats). It checks the claim the reference asserts: gs-SGD's
bytes grow under 2.5x from P = 8 to 64, Sketched-SGD's over it.

    python -m repro_torch.bench.comm_complexity [--out DIR]

writes ``comm_complexity.json`` under ``experiments/bench_torch/``.
"""

from __future__ import annotations

import math

from repro_torch.bench import cnn_dist
from repro_torch.core import compression as comp
from repro_torch.sim.network import LINK_1GBE

ALPHA, BETA = LINK_1GBE.alpha, LINK_1GBE.beta
K, ROWS, WIDTH = 15_000, 5, 2 ** 17  # ~0.1% of d, paper-scale sketch
METHODS = ("gs-sgd", "sketched-sgd", "gtopk")


def stats_for(method: str, p: int, *, k: int = K, rows: int = ROWS,
              width: int = WIDTH, d: int | None = None) -> comp.CommStats:
    """The CommStats of one step of ``method`` at worker count p."""
    kw: dict = dict(k=k)
    if method in ("gs-sgd", "sketched-sgd"):
        kw.update(rows=rows, width=width)
    if method == "gs-sgd":
        kw.update(allreduce_mode="tree")
    return comp.make(method, **kw).comm_stats(d or width, p)


def analytic_curves(ps, methods=METHODS, *, k: int = K, rows: int = ROWS,
                    width: int = WIDTH, d: int | None = None) -> list[dict]:
    """Flat rows: one dict per (method, p) with bytes/rounds/Eq. 1 time."""
    rows_out = []
    for p in ps:
        for m in methods:
            s = stats_for(m, p, k=k, rows=rows, width=width, d=d)
            rows_out.append({"method": m, "p": p, "bytes": s.bytes_out,
                             "rounds": s.rounds,
                             "time_1gbe": s.time(ALPHA, BETA)})
    return rows_out


def main(out: str | None = None) -> dict:
    ps = [2, 4, 8, 16, 32, 64]
    curves = analytic_curves(ps)
    by = {(c["method"], c["p"]): c for c in curves}
    print(f"{'P':>4s}  " + "".join(f"{m:>22s}" for m in METHODS))
    for p in ps:
        print(f"{p:4d}  " + "".join(
            f"{by[m, p]['bytes'] / 2**20:9.1f}MiB/{by[m, p]['rounds']:3d}r   "
            for m in METHODS))

    def growth(m):
        return by[m, 64]["bytes"] / by[m, 8]["bytes"]

    g_gs, g_ps = growth("gs-sgd"), growth("sketched-sgd")
    print(f"bytes growth P=8->64: gs-sgd {g_gs:.2f}x (log: "
          f"{math.log2(64) / math.log2(8):.2f}x), "
          f"sketched-sgd {g_ps:.2f}x (linear: {64 / 8:.1f}x)")
    if not g_gs < 2.5 < g_ps:
        raise RuntimeError(f"communication growth P=8->64: gs-sgd {g_gs}, "
                           f"sketched-sgd {g_ps}; the claim is gs < 2.5 < "
                           "sketched")
    results = {
        "model": {"alpha": ALPHA, "beta": BETA, "k": K, "rows": ROWS,
                  "width": WIDTH, "link": "1gbe"},
        "methods": list(METHODS),
        "ps": ps,
        "curves": curves,
        "checks": {"gs_bytes_growth_8_64": g_gs,
                   "sketched_bytes_growth_8_64": g_ps},
    }
    cnn_dist.write_json(results, "comm_complexity.json", out)
    return results


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="directory of the JSON")
    main(**vars(ap.parse_args()))
