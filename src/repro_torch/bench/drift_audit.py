"""Drift-watchdog audit: detection latency, false positives, makespan.

Port of ``benchmarks/drift_audit.py`` over the port's simulator
(``sim.simulate``, ``tune.watch.SimWatcher``); host only, every time is
the model's simulated clock.

Runs the cluster sim four ways on one spec (gs-sgd defaults, flat/1gbe,
zero compute jitter so every phase is deterministic):

  1. clean, no watchdog          — the baseline timeline
  2. clean, --watch              — must be a bit-exact no-op: zero
                                   detections AND per-step records
                                   identical to run 1 (the jitter-free
                                   zero-false-positive guarantee)
  3. congested, no watchdog      — cluster-wide comm x FACTOR injected
                                   mid-run; the makespan the watchdog
                                   has to beat
  4. congested, --watch          — the watchdog must detect within the
                                   documented bound (`obs.detection_bound`
                                   drifted samples), re-plan, and land a
                                   makespan strictly below run 3

and writes ``BENCH_drift.json`` (schema ``repro.obs/bench_drift@1``,
stamped with ``obs.provenance``): detection latency in drifted steps vs
the analytic bound, clean-run false-positive count (must be 0), and the
four makespans with the watch-vs-no-watch improvement. Exits 1 if any
check fails.

Usage:
  python -m repro_torch.bench.drift_audit [--fast] \
      [--out experiments/bench_torch/BENCH_drift.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch import obs
from repro_torch.api import RunSpec
from repro_torch.sim import FaultTrace, TraceEvent, simulate
from repro_torch.tune.watch import SimWatcher

SCHEMA = "repro.obs/bench_drift@1"


def _run(spec: RunSpec, trace: FaultTrace, *, watch: bool, engine: str):
    cfg = spec.sim_config()
    watcher = SimWatcher(spec) if watch else None
    res = simulate(cfg, trace, net=spec.cluster.network(), engine=engine,
                   watcher=watcher)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="fewer steps (the quick profile)")
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--d", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=None,
                    help="override step count (default 30, 24 with --fast)")
    ap.add_argument("--congest-step", type=int, default=10)
    ap.add_argument("--congest-factor", type=float, default=6.0)
    ap.add_argument("--engine", default="batched",
                    choices=("batched", "loop"))
    ap.add_argument("--out",
                    default="experiments/bench_torch/BENCH_drift.json")
    args = ap.parse_args(argv)
    steps = args.steps or (24 if args.fast else 30)
    if args.congest_step >= steps - 2:
        ap.error(f"--congest-step {args.congest_step} leaves no room to "
                 f"detect + re-plan in {steps} steps")

    base = RunSpec()
    spec = dataclasses.replace(
        base, d=args.d, steps=steps,
        cluster=dataclasses.replace(base.cluster, p=args.p,
                                    compute_jitter=0.0),
        watch=dataclasses.replace(base.watch, enabled=True))
    spec.validate()
    w = spec.watch
    # comm scales xFACTOR, so the relative residual is FACTOR-1 (>= the
    # winsorize clip for any factor >= 2) — the analytic worst case
    bound = obs.detection_bound(args.congest_factor - 1.0,
                                delta=w.delta, threshold=w.threshold)

    clean = FaultTrace()
    congested = FaultTrace((
        TraceEvent(args.congest_step, "congest",
                   factor=args.congest_factor,
                   duration=steps - args.congest_step),))

    print(f"drift audit: P={args.p} d={args.d:.0e} "
          f"{spec.exchange.compressor} {steps} steps, congest "
          f"x{args.congest_factor} @ step {args.congest_step}, "
          f"detection bound {bound} drifted step(s)")

    runs = {
        "clean": _run(spec, clean, watch=False, engine=args.engine),
        "clean_watch": _run(spec, clean, watch=True, engine=args.engine),
        "congested": _run(spec, congested, watch=False,
                          engine=args.engine),
        "congested_watch": _run(spec, congested, watch=True,
                                engine=args.engine),
    }
    mk = {k: r.totals()["makespan"] for k, r in runs.items()}
    for k, v in mk.items():
        print(f"  makespan {k:16s} {v:8.3f}s")

    checks: dict[str, bool] = {}

    # --- false positives: jitter-free clean run must never alarm, and
    # an armed-but-silent watchdog must not perturb the timeline
    fp = [e for e in runs["clean_watch"].watch
          if e["kind"] == "drift.detected"]
    checks["zero_false_positives"] = not fp
    same = ([dataclasses.asdict(r) for r in runs["clean"].records]
            == [dataclasses.asdict(r) for r in runs["clean_watch"].records])
    checks["clean_watch_bit_identical"] = same

    # --- detection latency vs the analytic bound
    dets = [e for e in runs["congested_watch"].watch
            if e["kind"] == "drift.detected"]
    replans = [e for e in runs["congested_watch"].watch
               if e["kind"] == "watch.replan"]
    det = dets[0] if dets else None
    # congestion applies from congest_step inclusive, so the number of
    # drifted records consumed through detection is det_step - onset
    latency = (det["step"] - args.congest_step + 1) if det else None
    checks["congestion_detected"] = det is not None
    checks["latency_within_bound"] = (latency is not None
                                      and latency <= bound)
    if det:
        print(f"  detected: step {det['step']} ({det['phase']} "
              f"{det['direction']}, rel {det['rel']:+.2f}) — "
              f"{latency} drifted step(s), bound {bound}")

    # --- the whole point: re-planning must beat riding out congestion
    checks["replanned"] = bool(replans)
    checks["makespan_improved"] = mk["congested_watch"] < mk["congested"]
    if replans:
        rp = replans[0]
        print(f"  re-plan: step {rp['step']} -> {rp['choice']} "
              f"(gain {rp['gain']:.1%}); makespan "
              f"{mk['congested_watch']:.3f}s vs no-watch "
              f"{mk['congested']:.3f}s")

    ok = all(checks.values())
    doc = {
        "schema": SCHEMA,
        "provenance": obs.provenance(spec),
        "scenario": {"p": args.p, "d": args.d,
                     "method": spec.exchange.compressor, "steps": steps,
                     "engine": args.engine,
                     "congest_step": args.congest_step,
                     "congest_factor": args.congest_factor,
                     "watch": w.to_json()},
        "detection": {"bound_steps": bound,
                      "detected_step": det["step"] if det else None,
                      "onset": det["onset"] if det else None,
                      "phase": det["phase"] if det else None,
                      "latency_steps": latency,
                      "clean_detections": len(fp)},
        "replan": replans[0] if replans else None,
        "makespan": {**mk,
                     "improvement": 1.0 - mk["congested_watch"]
                     / mk["congested"]},
        "checks": checks,
        "ok": ok,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}")
    if not ok:
        failed = [k for k, v in checks.items() if not v]
        print(f"DRIFT AUDIT FAILED: {failed}")
        return 1
    print("drift audit ok: zero clean false positives, detection within "
          f"{bound} step(s), re-plan improved makespan "
          f"{doc['makespan']['improvement']:.1%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
