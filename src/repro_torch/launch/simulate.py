"""Cluster-simulation driver — spec-first (``repro_torch.api.RunSpec``).

Port of ``repro/launch/simulate.py``, with the same flags and output
files. Runs ``repro_torch.sim`` — the discrete-event simulator that
replays the port's ``reduce_schedule`` / bucketed-overlap pipeline on a
modeled network — so elastic/straggler policies and the paper's
communication claims can be evaluated at P=1024+ on a host in seconds.
It runs nothing on a device (no ``--device`` flag): every step time it
prints or writes is the model's simulated clock, and the one wall time it
prints is the simulator's own run on the host.

Config flags are GENERATED from the ``repro_torch.api`` spec fields (the same
declarations train and tune use, so defaults cannot drift); ``--spec``
loads a full ``RunSpec`` as the base, ``--plan`` uses a tune plan's spec
(tuned exchange + env topology/link + calibrated alpha/beta + compute
mean), and explicitly-passed flags override either. The flat gradient
dimension defaults to the spec arch's (``--d`` overrides it).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.simulate --p 1024 --method gs-sgd \
      --buckets 8 --fault-trace examples/traces/fail_rejoin.json
  PYTHONPATH=src python -m repro_torch.launch.simulate --p 256 --topology hier \
      --group-size 32 --method gtopk --steps 50
  PYTHONPATH=src python -m repro_torch.launch.simulate --p 512 --synthetic-faults \
      "fail_rate=0.05,rejoin_after=20" --out experiments/sim_512.json
  PYTHONPATH=src python -m repro_torch.launch.simulate --p 64 \
      --slow-workers 3:10,7:2.5 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.simulate --p 100000 --steps 50 \
      --participation 0.01 --synthetic-faults \
      "fail_rate=0.5,straggle_rate=0.5,rejoin_after=5"
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch import api
from repro_torch.api import RunSpec
from repro_torch.sim import FaultTrace, TraceEvent, simulate, synthetic


def _parse_kv(spec: str) -> dict:
    out: dict = {}
    for part in filter(None, spec.split(",")):
        k, v = part.split("=")
        out[k.strip()] = float(v) if "." in v or "e" in v.lower() else int(v)
    return out


def _timeline(res, around: int = 2) -> None:
    """Per-phase table: aggregate + every step near a replan/drop event."""
    hot = set()
    for rp in res.replans:
        hot.update(range(rp["step"] - 1, rp["step"] + around))
    hot.update(r.step for r in res.records if r.dropped)
    print(f"{'step':>5s} {'P':>5s} {'gen':>3s} "
          f"{'compute':>9s} {'stall':>9s} {'encode':>9s} {'comm':>9s} "
          f"{'recover':>9s} {'total':>9s}  events")
    shown_gap = False
    for r in res.records:
        interesting = (r.step in hot or r.step < 2
                       or r.step == len(res.records) - 1)
        if not interesting:
            if not shown_gap:
                print("  ...")
                shown_gap = True
            continue
        shown_gap = False
        evs = []
        for rp in res.replans:
            if rp["step"] == r.step:
                what = (f"fail{rp['failed']}" if rp["failed"]
                        else f"join{rp['joined']}")
                evs.append(f"replan gen{rp['generation']} -> P={rp['p']} "
                           f"({what}, lr x{rp['lr_scale']:.3f})")
        if r.dropped:
            evs.append(f"dropped stragglers {list(r.dropped)}")
        print(f"{r.step:5d} {r.p:5d} {r.generation:3d} "
              f"{r.compute:9.4f} {r.stall:9.4f} {r.encode:9.4f} "
              f"{r.comm:9.4f} {r.recover:9.4f} {r.total:9.4f}  "
              + "; ".join(evs))


def curves_json(res) -> dict:
    """Machine-readable sim timeline, shaped like ``comm_complexity.json``
    (``bench/comm_complexity.py``).

    Top-level ``model`` (geometry/provenance) / ``curves`` (flat rows, one
    per simulated step, with bytes/rounds/Eq.1-style time) / ``checks`` —
    so sim timelines diff with the analytic curves in CI tooling.
    """
    cfg = res.config
    model = {"p": cfg.p, "d": cfg.d, "method": cfg.method,
             "buckets": cfg.buckets, "bwd_chunks": cfg.bwd_chunks,
             "bwd_frac": cfg.bwd_frac, "topology": cfg.topology,
             "link": cfg.link, "shape": cfg.shape,
             "group_size": cfg.group_size, "overlap": cfg.overlap,
             "k": cfg.k, "rows": cfg.rows, "width": cfg.width,
             "wire_dtype_bytes": cfg.wire_dtype_bytes,
             "participation": cfg.participation,
             "seed": cfg.seed}
    curves = [{"method": cfg.method, "step": r.step, "p": r.p,
               "generation": r.generation, "bytes": r.bytes_critical,
               "bytes_wire": r.bytes_wire, "rounds": r.rounds,
               "compute": r.compute, "stall": r.stall, "encode": r.encode,
               "comm": r.comm, "recover": r.recover, "time_sim": r.total,
               "sampled": r.sampled,
               "dropped": list(r.dropped)} for r in res.records]
    return {"model": model, "methods": [cfg.method], "curves": curves,
            "totals": res.totals(), "replans": res.replans,
            "watch": list(res.watch), "checks": {}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="discrete-event gs-SGD cluster simulator")
    api.add_spec_args(ap, "sim")  # every config flag: repro_torch.api.spec
    ap.add_argument("--spec", default=None, metavar="SPEC.json",
                    help="load a RunSpec as the base config "
                         "(explicit flags still override)")
    ap.add_argument("--dump-spec", default=None, metavar="PATH",
                    help="write the fully-resolved RunSpec JSON and "
                         "continue")
    ap.add_argument("--plan", default=None, metavar="PLAN.json",
                    help="use a launch.tune plan's spec as the base: "
                         "tuned exchange config plus the plan env's "
                         "topology/link regime and calibrated alpha/beta; "
                         "the remaining CLI flags (steps, faults, compute "
                         "jitter, ...) still apply")
    ap.add_argument("--fault-trace", default=None,
                    help="path to a JSON fault trace (see sim/traces.py)")
    ap.add_argument("--synthetic-faults", default=None, metavar="KV",
                    help="generate a seeded trace, e.g. "
                         "'fail_rate=0.05,straggle_rate=0.1,rejoin_after=20'")
    ap.add_argument("--congest", default=None, metavar="STEP:FACTOR[:DUR]",
                    help="inject cluster-wide link congestion: comm times "
                         "x FACTOR from STEP for DUR steps (default: the "
                         "rest of the run) — the drift-watchdog scenario")
    ap.add_argument("--engine", default="batched",
                    choices=("batched", "loop"),
                    help="sim engine: 'batched' (vectorized, the P=100k "
                         "path) or 'loop' (per-worker compat reference); "
                         "pinned identical in tests")
    ap.add_argument("--out", default=None, help="write full JSON result here")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write machine-readable curves JSON (same shape "
                         "as bench/comm_complexity.py: model/curves/"
                         "checks) for CI diffing")
    args = ap.parse_args(argv)
    if args.spec and args.plan:
        ap.error("--spec and --plan both name a base spec; pass one")

    plan = None
    if args.plan:
        from repro_torch.tune import TunePlan
        plan = TunePlan.load(args.plan)
        base = plan.spec
    elif args.spec:
        base = RunSpec.load(args.spec)
    else:
        base = RunSpec()
    spec = api.apply_args(base, args, "sim")
    spec.validate()
    if spec.d is None:
        # make the arch-derived flat dimension visible (e.g. the full,
        # non-smoke default arch is ~4e9 coordinates)
        spec = dataclasses.replace(spec, d=spec.resolve_d())
        print(f"arch {spec.arch}{' (smoke)' if spec.smoke else ''}: "
              f"d = {spec.d}")
    if args.dump_spec:
        spec.save(args.dump_spec)
        print(f"wrote resolved spec to {args.dump_spec}")

    if plan is not None:
        cl = spec.cluster
        cal = (f" [calibrated a={cl.link_spec().alpha:.2e} "
               f"b={cl.link_spec().beta:.2e}]"
               if cl.link_alpha is not None or cl.link_beta is not None
               else "")
        print(f"plan {args.plan}: {plan.choice.label()} on "
              f"{cl.topology}/{cl.link}{cal} (predicted step "
              f"{plan.predicted['step_time'] * 1e3:.2f}ms)")

    cfg = spec.sim_config()
    p = cfg.p

    trace = FaultTrace()
    if args.fault_trace:
        trace = FaultTrace.load(args.fault_trace)
    elif args.synthetic_faults is not None:
        kv = _parse_kv(args.synthetic_faults)
        rejoin = kv.pop("rejoin_after", None)
        trace = synthetic(p, spec.steps, seed=spec.seed,
                          rejoin_after=int(rejoin) if rejoin else None,
                          **{k: float(v) for k, v in kv.items()})
    if args.congest:
        parts = args.congest.split(":")
        if len(parts) not in (2, 3):
            ap.error(f"--congest wants STEP:FACTOR[:DUR], got {args.congest!r}")
        c_step, c_factor = int(parts[0]), float(parts[1])
        c_dur = int(parts[2]) if len(parts) == 3 \
            else max(1, spec.steps - c_step)
        ev = TraceEvent(c_step, "congest", factor=c_factor, duration=c_dur)
        trace = FaultTrace(tuple(sorted(trace.events + (ev,),
                                        key=lambda e: e.step)))

    watcher = None
    if spec.watch.enabled:
        from repro_torch.tune.watch import SimWatcher
        watcher = SimWatcher(spec)
        w = spec.watch
        print(f"watchdog armed: warmup={w.warmup} delta={w.delta} "
              f"threshold={w.threshold} window={w.window} "
              f"budget={w.replan_budget}")

    # the spec's network carries calibrated alpha/beta AND slow workers —
    # SimConfig's preset name alone would silently lose the calibration
    net = spec.cluster.network()

    t0 = time.time()
    res = simulate(cfg, trace, net=net, engine=args.engine, watcher=watcher)
    wall = time.time() - t0
    tot = res.totals()
    print(f"simulated P={p} d={cfg.d:.2e} {cfg.method} "
          f"buckets={cfg.buckets} for {tot['steps']} steps "
          f"({res.events_run} events) in {wall:.2f}s host wall, "
          f"{tot['makespan']:.1f}s simulated\n")
    _timeline(res)
    print(f"\nphase totals (s): " + "  ".join(
        f"{k}={tot[k]:.2f}" for k in
        ("compute", "stall", "encode", "comm", "recover")))
    print(f"bytes/worker (critical path): {tot['bytes_critical']:.3e}  "
          f"fabric bytes: {tot['bytes_wire']:.3e}  rounds: {tot['rounds']}")
    print(f"throughput: {tot['steps_per_s']:.2f} steps/s simulated; "
          f"{len(res.replans)} elastic replan(s)")
    for w in res.watch:
        if w["kind"] == "drift.detected":
            print(f"watchdog: drift detected at step {w['step']} "
                  f"({w['phase']} {w['direction']}, rel {w['rel']:+.2f}, "
                  f"onset step {w['onset']})")
        elif w["kind"] == "watch.replan":
            print(f"watchdog: re-planned at step {w['step']} -> "
                  f"{w['choice']} (predicted step "
                  f"{w['predicted'] * 1e3:.2f}ms vs current "
                  f"{w['current'] * 1e3:.2f}ms, gain {w['gain']:.1%})")
        elif w["kind"] == "watch.keep":
            print(f"watchdog: kept the current plan at step {w['step']} "
                  f"(best candidate gain {w['gain']:.1%} < 1%)")
    if args.out:
        res.dump(args.out)
        print(f"wrote {args.out}")
    if spec.trace:
        from repro_torch import obs
        # the simulator runs on the host: its provenance names the CPU
        doc = res.to_tracer().save(spec.trace, spec=spec,
                                   provenance=obs.provenance(spec, "cpu"),
                                   source="sim")
        print(f"wrote {spec.trace} ({len(doc['traceEvents'])} events)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(curves_json(res), f, indent=1)
        print(f"wrote {args.json}")
    return tot


if __name__ == "__main__":
    main()
