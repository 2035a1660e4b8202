"""The drift watchdog: detect -> refit -> re-plan at a step boundary.

Port of ``repro/tune/watch.py``: ``Watchdog``, ``SimWatcher`` and
``predict_phases``.

Closes the truth loop (DESIGN.md §12): per-step records stream through
``obs.drift.DriftDetector``; on a sustained-drift alarm the watchdog

1. refits a ``CalibrationProfile`` on the trailing post-onset window of
   measured records against the CURRENT spec's identity-profile
   prediction (``calibrate.fit_profile``),
2. re-runs a budgeted tuner ``search`` with a profile-corrected
   ``CostModel`` (the search space keeps the run's own compressor —
   the watchdog retunes the schedule, never the algorithm), and
3. applies the winning plan's spec at the NEXT step boundary — but only
   if the profile-corrected model predicts at least ``_MIN_GAIN``
   relative step-time improvement over re-pricing the current spec
   under the SAME profile (otherwise it logs ``watch.keep`` and leaves
   the run alone — persistent-but-already-optimal congestion must not
   churn re-plans).

After either outcome the detector is reset: it re-learns the post-event
regime from a fresh warmup (the implicit cooldown), so constant
congestion alarms once, not every step.

Both launchers drive one watchdog: ``launch/train.py --watch`` feeds
measured ``t_step`` records and rebuilds the train step from the new
spec; ``launch/simulate.py --watch`` wraps it in ``SimWatcher`` so the
event-loop engines replay the same loop on modeled time.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs.drift import DriftDetector
from repro_torch.sim import replay
from repro_torch.tune.calibrate import fit_profile
from repro_torch.tune.cost import CalibrationProfile, CostModel
from repro_torch.tune.search import search
from repro_torch.tune.space import SearchSpace

#: Minimum predicted relative step-time gain before a re-plan is applied.
_MIN_GAIN = 0.01


def predict_phases(spec, *, profile: CalibrationProfile | None = None,
                   p: int | None = None) -> dict:
    """``sim.replay.predict_step`` for a full ``RunSpec`` — the spec's
    exchange geometry priced on the spec's cluster network (calibrated
    alpha/beta included), optionally profile-corrected and at a live
    worker count ``p`` (None = the spec's)."""
    cfg = spec.sim_config()
    return replay.predict_step(
        cfg.method, cfg.d, cfg.p if p is None else int(p),
        buckets=cfg.buckets, bwd_chunks=cfg.bwd_chunks, k=cfg.k,
        rows=cfg.rows, width=cfg.width, shape=cfg.shape,
        group_size=cfg.group_size, overlap=cfg.overlap,
        fuse_encode=cfg.fuse_encode, t_compute=cfg.compute.mean,
        bwd_frac=cfg.bwd_frac, wire_dtype_bytes=cfg.wire_dtype_bytes,
        participation=cfg.participation, net=spec.cluster.network(),
        profile=profile)


class Watchdog:
    """Stream records in, get a re-planned ``RunSpec`` out (rarely).

    ``on_step(record, now=...)`` returns the new spec when a re-plan was
    applied at this boundary, else ``None``. ``log`` accumulates every
    decision (``drift.detected`` / ``watch.replan`` / ``watch.keep``) as
    JSON-ready dicts; ``spec`` always holds the currently-applied spec.
    """

    def __init__(self, spec, *, space: SearchSpace | None = None):
        spec.validate()
        # fail fast: a compressor the simulator cannot replay (topk, ...)
        # cannot be re-planned either — raise at startup, not mid-run
        cfg = spec.sim_config()
        self.spec = spec
        w = spec.watch
        self.detector = DriftDetector(delta=w.delta, threshold=w.threshold,
                                      warmup=w.warmup)
        self.window = w.window
        self.budget = w.replan_budget
        self.space = space if space is not None else SearchSpace(
            methods=(cfg.method,))
        self.profile: CalibrationProfile | None = None
        self.log: list[dict] = []
        self.replans = 0
        self._records: list[dict] = []
        self._p: int | None = None

    def on_step(self, record: dict, *, now: float = 0.0):
        if record.get("p") is not None:
            self._p = int(record["p"])
        self._records.append(dict(record))
        events = self.detector.observe(record, ts=now)
        if not events:
            return None
        ev = events[0]  # attribute to the first phase whose test fired
        self.log.append({"kind": "drift.detected", "time": now,
                         "step": ev.step, "phase": ev.phase,
                         "direction": ev.direction, "rel": ev.rel,
                         "baseline": ev.baseline, "value": ev.value,
                         "onset": ev.onset})
        try:
            return self._replan(ev, now)
        finally:
            # re-arm with a fresh baseline either way: the detector must
            # learn the post-decision regime, not re-alarm on it
            self.detector.reset()

    # -- the feedback half --------------------------------------------------

    def _replan(self, ev, now: float):
        baseline = predict_phases(self.spec, p=self._p)
        post = [r for r in self._records
                if not r.get("warmup") and r.get("step", 0) > ev.onset]
        if not post:
            post = self._records[-1:]
        self.profile = fit_profile(post, baseline, window=self.window)
        env = self.spec.env()
        if self._p is not None:
            env = dataclasses.replace(env, p=self._p)
        plan = search(self.space, env, budget=self.budget,
                      error_probe=False,
                      cost_model=CostModel(env, error_probe=False,
                                           profile=self.profile),
                      spec=self.spec)
        current = predict_phases(self.spec, profile=self.profile, p=self._p)
        gain = ((current["step_time"] - plan.predicted["step_time"])
                / current["step_time"]) if current["step_time"] > 0 else 0.0
        entry = {"time": now, "step": ev.step, "phase": ev.phase,
                 "choice": plan.choice.label(),
                 "predicted": plan.predicted["step_time"],
                 "current": current["step_time"], "gain": gain,
                 "profile": self.profile.to_json()}
        if gain < _MIN_GAIN:
            self.log.append({"kind": "watch.keep", **entry})
            return None
        # the plan's spec carries the tuned exchange; everything else
        # (steps, arch, cluster, watch thresholds) stays this run's own
        self.spec = dataclasses.replace(plan.spec, steps=self.spec.steps)
        self.replans += 1
        self.log.append({"kind": "watch.replan", **entry})
        return self.spec


class SimWatcher(Watchdog):
    """Adapter for the event-loop engines: consumes ``sim.cluster``
    ``StepRecord``s and returns the new ``SimConfig`` on re-plan."""

    def on_record(self, r, *, now: float):
        new = self.on_step(
            {"step": r.step, "p": r.p, "t_step": r.total,
             "compute": r.compute, "stall": r.stall, "encode": r.encode,
             "comm": r.comm, "recover": r.recover},
            now=now)
        return None if new is None else new.sim_config()
