"""Auto-tuner driver — spec-first (``repro_torch.api.RunSpec``).

Port of ``repro/launch/tune.py``, with the same flags. Searches (buckets,
bwd_chunks, rows, width, top-k fraction, collective) by replaying every
candidate through the simulator's pricing (``repro_torch.sim.replay``) on
the target environment, optionally anchored to hardware with
``--calibrate`` (measured step-time traces from ``train --json``). The
recovery-error probe encodes and recovers on the card (the hand-written
kernels) unless ``--device cpu`` is given; ``--no-error-probe`` skips it.

The environment half (arch/d, workers, topology, links, compute) is a
``RunSpec`` built from the same generated flags the train driver uses
(``--spec`` loads one as the base); the searched half stays the explicit
grid axes below. The winning plan serializes the tuned ``RunSpec`` and the
train driver applies it directly:

    repro_torch.launch.train --auto-tune PLAN.json

Examples:
  PYTHONPATH=src python -m repro_torch.launch.tune --p 64 --d 15000000 \
      --topology hier --buckets 1 4 8 --bwd-chunks 1 2 4 --out plan.json
  PYTHONPATH=src python -m repro_torch.launch.tune \
      --spec examples/specs/qwen3_smoke.json --calibrate a.json b.json c.json \
      --out plan.json --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch import api, obs
from repro_torch.api import RunSpec
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.tune import (SearchSpace, TunePlan, fit, load_trace,
                              search)


def _arch_d(arch: str, smoke: bool, p: int) -> int:
    """Flat gradient dimension of an arch exactly as train would see it."""
    return RunSpec(arch=arch, smoke=smoke,
                   cluster=api.ClusterSpec(p=p)).resolve_d()


def _rows(vals) -> tuple:
    return tuple(v if v == "log" else int(v) for v in vals)


def _opt_int(vals) -> tuple:
    return tuple(None if v in ("none", "None") else int(v) for v in vals)


def _opt_float(vals) -> tuple:
    return tuple(None if v in ("none", "None") else float(v) for v in vals)


def _opt_str(vals) -> tuple:
    return tuple(None if v in ("none", "None") else v for v in vals)


def main(argv=None) -> TunePlan:
    ap = argparse.ArgumentParser(
        description="sim-driven auto-tuner for the gs-SGD exchange pipeline")
    # environment: generated from the spec fields (shared with train/sim)
    api.add_spec_args(ap, "tune")
    ap.add_argument("--spec", default=None, metavar="SPEC.json",
                    help="load a RunSpec as the base environment "
                         "(explicit flags still override)")
    ap.add_argument("--dump-spec", default=None, metavar="PATH",
                    help="write the resolved base RunSpec JSON and continue")
    # search space
    ap.add_argument("--methods", nargs="+", default=["gs-sgd"])
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--bwd-chunks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--rows", nargs="+", default=["5"],
                    help="sketch depths: ints and/or 'log'")
    ap.add_argument("--widths", nargs="+", default=["none"],
                    help="sketch widths: ints and/or 'none' (default "
                         "geometry)")
    ap.add_argument("--k-fracs", nargs="+", default=["none"],
                    help="top-k fractions of d and/or 'none' (0.4%% "
                         "default)")
    ap.add_argument("--shapes", nargs="+", default=["none"],
                    help="collective shapes: tree/ring/hier/ps and/or "
                         "'none' (per-method default)")
    # search controls
    ap.add_argument("--top", type=int, default=5,
                    help="alternatives kept in the plan")
    ap.add_argument("--budget", type=int, default=None,
                    help="max candidates to evaluate (seeded subsample)")
    ap.add_argument("--no-error-probe", action="store_true",
                    help="skip the count-sketch fidelity probe (rank on "
                         "time only)")
    ap.add_argument("--max-error", type=float, default=None,
                    help="drop candidates whose error proxy exceeds this")
    ap.add_argument("--probe-d", type=int, default=1 << 14)
    # calibration + output
    ap.add_argument("--calibrate", default=None, nargs="+",
                    metavar="TRACE.json",
                    help="fit alpha/beta/compute from measured trace(s) "
                         "(train --json / simulate --json) before tuning; "
                         "pass several runs captured at different "
                         "buckets/widths to make alpha/beta identifiable")
    ap.add_argument("--out", default=None, metavar="PLAN.json")
    ap.add_argument("--device", default=None,
                    help="torch device of the error probe (default: the "
                         "CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    device = None if args.no_error_probe else resolve_device(args.device)

    base = RunSpec.load(args.spec) if args.spec else RunSpec()
    spec = api.apply_args(base, args, "tune")
    spec.validate()
    if spec.d is None:
        spec = dataclasses.replace(spec, d=spec.resolve_d())
        print(f"arch {spec.arch}{' (smoke)' if spec.smoke else ''}: "
              f"d = {spec.d}")
    if args.calibrate:
        cal = fit([load_trace(p) for p in args.calibrate])
        spec = dataclasses.replace(
            spec, cluster=dataclasses.replace(
                spec.cluster, compute_mean=cal.t_compute,
                link_alpha=cal.alpha, link_beta=cal.beta))
        print(f"calibrated from {', '.join(args.calibrate)}: "
              f"alpha={cal.alpha:.3e}s "
              f"beta={cal.beta:.3e}s/B t_compute={cal.t_compute:.4f}s "
              f"(rms residual {cal.residual:.2e}s over {cal.n_records} "
              f"records)")
    if args.dump_spec:
        spec.save(args.dump_spec)
        print(f"wrote resolved spec to {args.dump_spec}")
    env = spec.env()

    space = SearchSpace(methods=tuple(args.methods),
                        buckets=tuple(args.buckets),
                        bwd_chunks=tuple(args.bwd_chunks),
                        rows=_rows(args.rows), widths=_opt_int(args.widths),
                        k_fracs=_opt_float(args.k_fracs),
                        shapes=_opt_str(args.shapes))
    t0 = time.time()
    plan = search(space, env, top=args.top, budget=args.budget,
                  seed=spec.seed, error_probe=not args.no_error_probe,
                  probe_d=args.probe_d, max_error=args.max_error,
                  spec=spec, device=device)
    wall = time.time() - t0
    # stamp the host identity (torch/backend/hostname/git rev/spec hash)
    # so a saved plan records where its calibration numbers came from
    plan = dataclasses.replace(
        plan, provenance={**plan.provenance,
                          "host": obs.provenance(spec, device)})

    pv = plan.provenance
    print(f"searched {pv['n_evaluated']}/{pv['space_size']} candidates "
          f"({len(plan.skipped)} skipped) in {wall:.1f}s for P={env.p} "
          f"d={env.d:.2e} {env.topology}/{env.link}\n")
    print(f"{'rank':>4s}  {'candidate':<28s} {'step ms':>9s} "
          f"{'exposed ms':>10s} {'err':>6s} {'compress':>8s}")
    rows = [(plan.choice, plan.predicted)] + [
        (type(plan.choice)(**a["candidate"]), a["cost"])
        for a in plan.alternatives]
    for i, (cand, cc) in enumerate(rows):
        print(f"{i:4d}  {cand.label():<28s} {cc['step_time'] * 1e3:9.2f} "
              f"{cc['exposed_comm'] * 1e3:10.2f} {cc['error_proxy']:6.3f} "
              f"x{cc['compression']:7.0f}")
    if plan.skipped:
        reasons = {}
        for s in plan.skipped:
            key = s["reason"].split(";")[0][:60]
            reasons[key] = reasons.get(key, 0) + 1
        print("\nskipped:")
        for r, n in sorted(reasons.items()):
            print(f"  {n:3d} x {r}")
    print(f"\nplan: {plan.summary()}")
    try:
        print("train flags: " + " ".join(plan.train_argv()))
    except ValueError as e:  # sim-only plan (tuned collective shape)
        print(f"train flags: n/a — {e}")
    if args.out:
        plan.save(args.out)
        print(f"wrote {args.out}")
    return plan


if __name__ == "__main__":
    main()
