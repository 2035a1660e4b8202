"""Port parity for ``repro_torch.obs.drift``, the calibration profile and
the watch spec: the reference's detector cases, each fed the same seeded
record stream through ``repro.obs.drift`` and ``repro_torch.obs.drift``,
give the same events (and the same ``drift.detected`` instants)."""

import argparse
import dataclasses
import json

import numpy as np
import pytest

from repro import api as japi
from repro import obs as jobs
from repro.obs import drift as jdrift
from repro.tune import calibrate as jcal
from repro.tune.cost import CalibrationProfile as JProfile
from repro_torch import api as tapi
from repro_torch import obs as tobs
from repro_torch.obs import drift as tdrift
from repro_torch.tune import calibrate as tcal
from repro_torch.tune.cost import CalibrationProfile as TProfile

BASE = {"compute": 0.10, "encode": 0.02, "comm": 0.05, "recover": 0.01}


def _rec(step, *, comm=0.05, warmup=False, **kw):
    r = {"step": step, "t_step": BASE["compute"] + BASE["encode"]
         + comm + BASE["recover"], **BASE, "comm": comm}
    if warmup:
        r["warmup"] = True
    r.update(kw)
    return r


def _stream(case: str, seed: int = 0) -> list[dict]:
    """The reference tests' record streams, plus seeded jitter."""
    rng = np.random.default_rng(seed)
    jit = lambda: float(1.0 + 0.01 * rng.standard_normal())  # noqa: E731
    if case == "jitter_free":
        return [_rec(s) for s in range(200)]
    if case == "drift_up":
        return [_rec(s, comm=(0.3 if s >= 20 else 0.05) * jit())
                for s in range(40)]
    if case == "spike":
        return [_rec(s, comm=5.0 if s == 20 else 0.05 * jit())
                for s in range(60)]
    if case == "drift_down":
        return [_rec(s, comm=(0.01 if s >= 10 else 0.05) * jit())
                for s in range(30)]
    if case == "warmup_tagged":
        return ([_rec(s, comm=9.9, warmup=True) for s in range(3)]
                + [_rec(s, comm=0.05 * jit()) for s in range(3, 20)])
    if case == "stall":
        return [_rec(s, stall=float(s % 7)) for s in range(20)]
    if case == "random_walk":
        level, out = 0.05, []
        for s in range(120):
            level *= float(np.exp(0.05 * rng.standard_normal()))
            out.append(_rec(s, comm=level, compute=0.1 * jit()))
        return out
    raise ValueError(case)


CASES = [("jitter_free", {}), ("drift_up", {"warmup": 5}),
         ("spike", {"warmup": 5}), ("drift_down", {"warmup": 5}),
         ("warmup_tagged", {"warmup": 3}),
         ("stall", {"warmup": 2, "threshold": 0.5}),
         ("random_walk", {"warmup": 4, "delta": 0.02, "threshold": 0.3})]


@pytest.mark.parametrize("case,kw", CASES, ids=[c for c, _ in CASES])
def test_detector_events_equal_the_reference(case, kw):
    out = []
    for obs_pkg, drift in ((jobs, jdrift), (tobs, tdrift)):
        tr = obs_pkg.Tracer(clock=lambda: 0.0, epoch=0.0)
        det = drift.DriftDetector(**kw)
        fired = []
        with tr.activate():
            for i, r in enumerate(_stream(case)):
                fired.append([e.to_json() for e in
                              det.observe(r, ts=0.5 * i)])
        base = {ph: det.baseline(ph) for ph in drift.DEFAULT_PHASES}
        out.append((fired, [e.to_json() for e in det.events], base,
                    tr.to_chrome()["traceEvents"]))
    assert out[0] == out[1]
    if case in ("jitter_free", "spike", "stall"):
        assert not out[1][1]
    if case in ("drift_up", "drift_down"):
        assert out[1][1]


def test_detection_bound_and_defaults_equal_the_reference():
    assert tdrift.DEFAULT_PHASES == jdrift.DEFAULT_PHASES
    for rel in (0.05, 0.5, 2.0, 5.0, -3.0):
        for delta, thr in ((0.1, 1.5), (0.1, 1.2), (0.0, 0.3)):
            assert tdrift.detection_bound(rel, delta=delta, threshold=thr) \
                == jdrift.detection_bound(rel, delta=delta, threshold=thr)
    for bad in ({"warmup": 0}, {"threshold": -1.0}, {"clip": 0.0}):
        for drift in (jdrift, tdrift):
            with pytest.raises(ValueError):
                drift.DriftDetector(**bad)


def test_reset_relearns_like_the_reference():
    stream = [_rec(s, comm=(0.3 if s >= 12 else 0.05)) for s in range(25)]
    runs = []
    for drift in (jdrift, tdrift):
        det = drift.DriftDetector(warmup=5)
        for _ in range(2):
            det.reset()
            det.events.clear()
            for r in stream:
                det.observe(r)
        runs.append([dataclasses.asdict(e) for e in det.events])
    assert runs[0] == runs[1]
    assert sorted(e["phase"] for e in runs[1]) == ["comm", "t_step"]


def test_calibration_profile_and_fit_profile_match():
    pred = {"compute": 0.1, "encode": 0.02, "comm": 0.05,
            "recover": 0.01, "step_time": 0.18}
    rng = np.random.default_rng(3)
    recs = [{"step": s, "compute": 0.12 * (1 + 0.01 * rng.random()),
             "encode": 0.016, "comm": 0.3 + 0.01 * rng.random(),
             "recover": 0.01, "t_step": 0.45, "warmup": s == 0}
            for s in range(10)]
    for window in (None, 4):
        t = tcal.fit_profile(recs, pred, window=window)
        j = jcal.fit_profile(recs, pred, window=window)
        assert t.to_json() == j.to_json()
    t_only = [{"step": s, "t_step": 0.18 + 0.05 * s} for s in range(5)]
    assert tcal.fit_profile(t_only, pred).to_json() == \
        jcal.fit_profile(t_only, pred).to_json()
    p = TProfile(comm=6.0, compute=0.5)
    assert TProfile.from_json(p.to_json()) == p
    assert p.to_json() == JProfile(comm=6.0, compute=0.5).to_json()
    audit = {"phase_deltas": {"comm": {"predicted": 0.05, "measured": 0.2}},
             "measured": {"phases": {"forward": 0.03, "backward": 0.09}},
             "predicted": {"forward": 0.02, "backward": 0.08}}
    assert TProfile.from_audit(audit).to_json() == \
        JProfile.from_audit(audit).to_json()
    for bad in ({"comm": 0.0}, {"encode": float("nan")}):
        with pytest.raises(ValueError):
            TProfile(**bad)


def test_watch_spec_json_and_flags_match_the_reference():
    spec = dataclasses.replace(
        tapi.RunSpec(), watch=tapi.WatchSpec(enabled=True, warmup=3,
                                             threshold=2.0))
    back = tapi.RunSpec.from_json(json.loads(json.dumps(spec.to_json())))
    assert back.watch == spec.watch
    j = japi.RunSpec.from_json(spec.to_json())
    assert j.watch.to_json() == spec.watch.to_json()
    d = tapi.RunSpec().to_json()
    d.pop("watch")
    assert tapi.RunSpec.from_json(d).watch == tapi.WatchSpec()
    argv = ["--watch", "--drift-warmup", "2", "--drift-delta", "-1",
            "--drift-threshold", "0.5", "--drift-window", "3",
            "--replan-budget", "4"]
    got = []
    for api in (japi, tapi):
        ap = argparse.ArgumentParser()
        api.add_spec_args(ap, "train")
        got.append(api.apply_args(api.RunSpec(), ap.parse_args(argv),
                                  "train").watch.to_json())
    assert got[0] == got[1]
    assert got[1]["enabled"] and got[1]["replan_budget"] == 4
    for bad in ({"warmup": 0}, {"threshold": -1.0}, {"window": 0},
                {"replan_budget": 0}):
        with pytest.raises(ValueError):
            tapi.WatchSpec(**bad).validate()
