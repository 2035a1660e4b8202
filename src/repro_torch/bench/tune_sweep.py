"""Tuned-vs-default sweep: does the auto-tuner ever lose to the defaults?

Port of ``benchmarks/tune_sweep.py`` over the port's tuner; host only,
every time is the cost model's.

For every (P, topology) grid point, run ``repro_torch.tune.search`` over a
small exchange-config space that CONTAINS the all-defaults candidate
(buckets=1, bwd_chunks=1, rows=5, default geometry — exactly the CLI
defaults) and compare the winner's predicted step time against that
default's. Because the default is in the space and both are priced by the
same real-replay cost model, tuned <= default must hold on EVERY grid
point — asserted, so a cost-model or search regression that mis-ranks the
space fails.

Writes ``BENCH_tune.json`` under ``experiments/bench_torch/`` (or
``--out``): grid rows with the tuned choice, both predictions, and the
saving.

    python -m repro_torch.bench.tune_sweep [--fast] [--p 8 64 256]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.bench.cnn_dist import OUT
from repro_torch.tune import Candidate, CostModel, Env, SearchSpace, search

SPACE = SearchSpace(methods=("gs-sgd",), buckets=(1, 4, 8),
                    bwd_chunks=(1, 2, 4), rows=(5,), widths=(None,),
                    k_fracs=(None,), shapes=(None,))
DEFAULT = Candidate()  # the CLI defaults — must be a member of SPACE


def run_cell(p: int, topology: str, d: int, *, t_compute: float,
             seed: int = 0) -> dict:
    env = Env(p=p, d=d, topology=topology, t_compute=t_compute)
    cm = CostModel(env, error_probe=False)   # rank on time; fidelity is a
    # CLI-only refinement (the probe would only shrink the search further)
    default = cm.evaluate(DEFAULT)
    plan = search(SPACE, env, top=3, seed=seed, error_probe=False,
                  cost_model=cm)
    tuned = plan.predicted["step_time"]
    assert tuned <= default.step_time + 1e-12, (
        "tuned must never lose to the default it searched over",
        p, topology, tuned, default.step_time)
    return {"p": p, "topology": topology, "d": d,
            "default": default.to_json(),
            "tuned": {"candidate": plan.choice.to_json(),
                      "geometry": dict(plan.geometry),
                      "cost": dict(plan.predicted),
                      # the winner as a ready-to-run RunSpec (repro_torch.api):
                      # apply with train --spec / simulate --spec
                      "spec": plan.spec.to_json()},
            "saving_s": default.step_time - tuned,
            "saving_frac": 1.0 - tuned / default.step_time}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, nargs="+", default=[8, 64, 256])
    ap.add_argument("--d", type=int, default=15_000_000)
    ap.add_argument("--compute-mean", type=float, default=0.05)
    ap.add_argument("--fast", action="store_true",
                    help="small grid (P<=64, d=1e6)")
    ap.add_argument("--out", default=OUT, help="directory of BENCH_tune.json")
    args = ap.parse_args(argv)
    ps = ([p for p in args.p if p <= 64] or [8, 64]) if args.fast else args.p
    d = 1_000_000 if args.fast else args.d

    t0 = time.time()
    grid = [run_cell(p, topo, d, t_compute=args.compute_mean)
            for p in ps for topo in ("flat", "hier")]
    wall = time.time() - t0
    print(f"{len(grid)} grid points x {SPACE.size} candidates in "
          f"{wall:.1f}s\n")
    print(f"{'P':>5s} {'topology':>9s} {'default ms':>11s} "
          f"{'tuned ms':>9s} {'saving':>7s}  tuned candidate")
    for c in grid:
        cand = Candidate(**c["tuned"]["candidate"])
        print(f"{c['p']:5d} {c['topology']:>9s} "
              f"{c['default']['step_time'] * 1e3:11.2f} "
              f"{c['tuned']['cost']['step_time'] * 1e3:9.2f} "
              f"{c['saving_frac'] * 100:6.1f}%  {cand.label()}")

    # the hierarchical (slow inter-group) regime is comm-bound: the tuner
    # must find a STRICT improvement there at scale, not just tie
    hier_big = [c for c in grid
                if c["topology"] == "hier" and c["p"] == max(ps)]
    checks = {"grid_points": len(grid),
              "max_saving_frac": max(c["saving_frac"] for c in grid),
              "hier_maxp_saving_frac": (hier_big[0]["saving_frac"]
                                        if hier_big else None)}
    if hier_big:
        assert hier_big[0]["saving_frac"] > 0.0, (
            "no tuning win in the comm-bound hier regime", hier_big[0])

    out = {"space": SPACE.to_json(), "default": DEFAULT.to_json(),
           "sweep": {"p": ps, "d": d, "topologies": ["flat", "hier"],
                     "compute_mean": args.compute_mean},
           "grid": grid, "checks": checks}
    from repro_torch.obs import provenance
    out["provenance"] = provenance()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "BENCH_tune.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
