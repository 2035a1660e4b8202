"""Sim-vs-measured overlap audit over trace@1 files.

Port of ``benchmarks/overlap_audit.py``, over the port's ``obs.trace``,
``api.RunSpec`` and ``sim.replay.predict_step``: it reads the trace@1
files that ``python -m repro_torch.launch.train --trace`` and
``python -m repro_torch.launch.simulate --trace`` write.

Loads one or more ``repro.obs/trace@1`` documents (``train --trace`` or
``simulate --trace`` — the file embeds the resolved RunSpec, so the trace
alone is enough to re-price its schedule), prices the SAME spec through
``sim.replay.predict_step`` (the jitter-free single-step oracle the tuner
ranks with), and reports per phase (backward / encode / comm / recover):

  * measured seconds per step-unit vs the sim-priced prediction (delta +
    relative delta),
  * the overlap-realization ratio
        (serial_step - measured_step) / (serial_step - scheduled_step)
    — 1.0 means the run realized exactly the overlap the schedule
    promised; the serial baseline re-prices the spec with overlap off,
  * for traces that carry per-bucket stage spans (a train probe), the
    3-stage readiness recurrence re-run on the MEASURED stage times —
    the overlap saving the real pipeline could have achieved given its
    own encode/comm durations (model-free realization).

A sim trace audits against its own pricing model, so with zero compute
jitter every delta is ~0 and the ratio is ~1 (``predict_step`` is pinned
== one jitter-free simulated step) — that self-check is what
``--tolerance`` gates. Train traces measure a real run (on the card, or
the plain path on the CPU), which the cluster cost model does not price;
they are always report-only.

Usage:
  python -m repro_torch.bench.overlap_audit TRACE.json [...] \
      [--tolerance 0.5] [--out experiments/bench_torch/BENCH_obs.json]
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch import obs
from repro_torch.api import RunSpec
from repro_torch.core import compression as comp
from repro_torch.obs import trace as obtrace
from repro_torch.sim import replay

SCHEMA = "repro.obs/bench@1"
_TINY = 1e-12

AUDIT_PHASES = ("backward", "encode", "comm", "recover")


def _measured(doc: dict) -> dict:
    """Per-step-unit phase seconds + step stats from a chrome trace doc.

    Train traces attribute phases under the eager probe step(s); sim
    traces have per-step phase children — either way the unit count is
    the number of span groups the phase totals are spread over.
    """
    probes = obtrace.spans(doc, cat="probe")
    steps = obtrace.spans(doc, cat="step")
    n_units = len(probes) if probes else max(1, len(steps))
    totals = obtrace.phase_totals(doc)
    phases = {ph: totals.get(ph, 0.0) / n_units for ph in AUDIT_PHASES}
    phases["forward"] = totals.get("forward", 0.0) / n_units
    hot = [s["dur"] for s in steps if not (s.get("args") or {}).get("warmup")]
    durs = hot or [s["dur"] for s in steps]
    return {"n_units": n_units, "n_steps": len(steps),
            "step_time": sum(durs) / len(durs) if durs else None,
            "phases": phases}


def _measured_schedule(doc: dict, spec: RunSpec) -> dict | None:
    """Re-run the readiness recurrence on the trace's own per-bucket
    stage spans — the overlap the real pipeline could realize given its
    measured encode/comm durations. None when the trace has no
    per-bucket spans (sim exports aggregate phases only)."""
    probes = obtrace.spans(doc, cat="probe")
    n = len(probes) if probes else 1
    t_enc = [t / n for t in obtrace.bucket_durations(doc, "encode",
                                                     "encode/b")]
    t_comm = [t / n for t in obtrace.bucket_durations(doc, "comm",
                                                      "allreduce/b")]
    if not t_enc or len(t_enc) != len(t_comm):
        return None
    totals = obtrace.phase_totals(doc)
    t_bwd = totals.get("backward", 0.0) / n
    cfg = spec.sim_config()
    if cfg.bwd_chunks > 1 and cfg.overlap:
        rep = replay.ExchangeReplay(
            cfg.method, cfg.d, buckets=cfg.buckets, k=cfg.k, rows=cfg.rows,
            width=cfg.width, shape=cfg.shape, group_size=cfg.group_size,
            wire_dtype_bytes=cfg.wire_dtype_bytes)
        sp = rep.bc.spec
        if sp.n != len(t_enc):
            return None
        ev_t = replay.event_times(t_bwd, cfg.bwd_chunks)
        ready_ev = replay.bucket_readiness(sp.offsets, sp.sizes, sp.total,
                                           cfg.bwd_chunks)
        ready = [ev_t[e] for e in ready_ev]
        serial, pipelined, exposed, _ = comp.interleaved_schedule_time(
            t_enc, t_comm, ready, t_backward=t_bwd)
    else:
        serial, pipelined = comp.overlap_schedule_time(t_enc, t_comm)
        serial += t_bwd
        pipelined += t_bwd
        exposed = pipelined - t_bwd
    saving = serial - pipelined
    return {"t_backward": t_bwd, "t_encode": t_enc, "t_comm": t_comm,
            "serial": serial, "pipelined": pipelined, "exposed": exposed,
            "saving": saving,
            "saving_frac": saving / serial if serial > _TINY else None}


def _predicted(spec: RunSpec, *, overlap: bool) -> dict:
    cfg = spec.sim_config()
    r = replay.predict_step(
        cfg.method, cfg.d, cfg.p, buckets=cfg.buckets,
        bwd_chunks=cfg.bwd_chunks, k=cfg.k, rows=cfg.rows, width=cfg.width,
        shape=cfg.shape, topology=cfg.topology, link=cfg.link,
        intra_link=cfg.intra_link, group_size=cfg.group_size,
        overlap=overlap, fuse_encode=cfg.fuse_encode,
        t_compute=cfg.compute.mean, bwd_frac=cfg.bwd_frac,
        wire_dtype_bytes=cfg.wire_dtype_bytes,
        net=spec.cluster.network())
    r["backward"] = cfg.compute.mean * cfg.bwd_frac
    r["forward"] = cfg.compute.mean * (1.0 - cfg.bwd_frac)
    return r


def audit_trace(path: str) -> dict:
    doc = obtrace.load(path)
    obtrace.validate(doc)
    if not doc.get("spec"):
        raise ValueError(f"{path}: trace carries no RunSpec — re-export "
                         "with train/simulate --trace")
    spec = RunSpec.from_json(doc["spec"])
    if spec.d is None:
        import dataclasses
        spec = dataclasses.replace(spec, d=spec.resolve_d())
    meas = _measured(doc)
    pred = _predicted(spec, overlap=True)
    serial = _predicted(spec, overlap=False)
    serial_step = serial["step_time"]
    scheduled_step = pred["step_time"]

    deltas = {}
    for ph in AUDIT_PHASES:
        m, p = meas["phases"][ph], pred[ph]
        deltas[ph] = {"measured": m, "predicted": p, "delta": m - p,
                      "rel": (m - p) / p if abs(p) > _TINY else None}

    ratio = None
    if (meas["step_time"] is not None
            and serial_step - scheduled_step > _TINY):
        ratio = ((serial_step - meas["step_time"])
                 / (serial_step - scheduled_step))
    return {"trace": path, "source": doc.get("source"),
            "provenance": doc.get("provenance"),
            "measured": meas, "predicted": pred,
            "serial_step": serial_step, "scheduled_step": scheduled_step,
            "phase_deltas": deltas, "realization_ratio": ratio,
            "measured_schedule": _measured_schedule(doc, spec)}


def check(audit: dict, tolerance: float) -> list[str]:
    """Tolerance gate — sim-source traces only (a sim trace must
    reproduce its own pricing oracle; measured CPU traces are
    report-only)."""
    if audit["source"] != "sim":
        return []
    fails = []
    for ph in ("encode", "comm", "recover"):
        rel = audit["phase_deltas"][ph]["rel"]
        if rel is not None and abs(rel) > tolerance:
            fails.append(f"{audit['trace']}: phase {ph} rel delta "
                         f"{rel:+.3f} exceeds {tolerance}")
    st = audit["measured"]["step_time"]
    pt = audit["scheduled_step"]
    if st is not None and pt > _TINY and abs(st - pt) / pt > tolerance:
        fails.append(f"{audit['trace']}: step time {st:.4f}s vs scheduled "
                     f"{pt:.4f}s exceeds {tolerance}")
    r = audit["realization_ratio"]
    # the ratio divides by the promised saving — only gate it when that
    # saving is a meaningful share of the step, else jitter dominates
    saving = audit["serial_step"] - audit["scheduled_step"]
    if (r is not None and saving > 0.05 * audit["scheduled_step"]
            and abs(r - 1.0) > tolerance):
        fails.append(f"{audit['trace']}: realization ratio {r:.3f} "
                     f"exceeds 1 +/- {tolerance}")
    return fails


def _report(a: dict) -> None:
    print(f"\n== {a['trace']}  (source={a['source']}, "
          f"{a['measured']['n_steps']} steps, "
          f"{a['measured']['n_units']} phase unit(s))")
    print(f"{'phase':>9s} {'measured':>12s} {'predicted':>12s} "
          f"{'delta':>12s} {'rel':>8s}")
    for ph in AUDIT_PHASES:
        d = a["phase_deltas"][ph]
        rel = f"{d['rel']:+8.2f}" if d["rel"] is not None else "     n/a"
        print(f"{ph:>9s} {d['measured']:12.6f} {d['predicted']:12.6f} "
              f"{d['delta']:+12.6f} {rel}")
    st = a["measured"]["step_time"]
    print(f"step: measured {st:.4f}s" if st is not None else
          "step: no step spans", end="")
    print(f"  scheduled {a['scheduled_step']:.4f}s  "
          f"serial {a['serial_step']:.4f}s")
    r = a["realization_ratio"]
    print("overlap realization: "
          + (f"{r:.3f} (1.0 = exactly the promised overlap)"
             if r is not None else "n/a (schedule promises no saving)"))
    ms = a["measured_schedule"]
    if ms:
        sf = ms["saving_frac"]
        print(f"measured-stage schedule: serial {ms['serial']:.4f}s -> "
              f"pipelined {ms['pipelined']:.4f}s "
              f"(saving {ms['saving']:.4f}s"
              + (f", {sf:.1%})" if sf is not None else ")"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="align measured repro.obs traces with the sim-priced "
                    "schedule")
    ap.add_argument("traces", nargs="+", metavar="TRACE.json",
                    help="repro.obs/trace@1 file(s) from train/simulate "
                         "--trace")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="fail (exit 1) when a SIM trace deviates from "
                         "its own pricing oracle by more than this "
                         "relative amount; measured traces are always "
                         "report-only")
    ap.add_argument("--out",
                    default="experiments/bench_torch/BENCH_obs.json")
    args = ap.parse_args(argv)

    audits = [audit_trace(p) for p in args.traces]
    for a in audits:
        _report(a)

    fails: list[str] = []
    if args.tolerance is not None:
        for a in audits:
            fails.extend(check(a, args.tolerance))

    out = {"schema": SCHEMA, "tolerance": args.tolerance,
           "failures": fails, "audits": audits,
           "provenance": obs.provenance()}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {args.out} ({len(audits)} audit(s))")
    if fails:
        for msg in fails:
            print(f"FAIL: {msg}")
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
