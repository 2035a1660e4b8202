"""Port parity: the cluster simulator's event-loop engines
(``sim/engine.py``, ``sim/traces.py``, ``sim/cluster.py``), the
``SimWatcher`` and ``obs.trace.from_sim`` against the JAX package's.

Both simulators are NumPy over the same seeds, so the port must replay
the reference's timeline EXACTLY: ``SimResult.to_json()`` equal (every
float by ==) for the same config and trace, on both engines, across
topologies (flat, hier, slow workers), fault traces (none, the repo's
``examples/traces/*.json``, seeded synthetic churn), partial
participation, the interleaved pipeline with the fused encode, and a
watched run under congestion. Every draw goes through
``ComputeModel.durations``, held draw for draw for both samplers.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from repro import api as japi
from repro.obs import trace as jtrace
from repro.runtime import HeartbeatMonitor as JMonitor
from repro.sim import cluster as jcl
from repro.sim import engine as jeng
from repro.sim import traces as jtr
from repro.sim.workers import ComputeModel as JCompute
from repro.tune.watch import SimWatcher as JWatcher
from repro_torch import api as tapi
from repro_torch import sim as tsim
from repro_torch.obs import trace as ttrace
from repro_torch.runtime import HeartbeatMonitor as TMonitor
from repro_torch.sim import cluster as tcl
from repro_torch.sim import engine as teng
from repro_torch.sim import traces as ttr
from repro_torch.sim.workers import ComputeModel as TCompute
from repro_torch.tune.watch import SimWatcher as TWatcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repo's fault traces (step_times_1gbe.json beside them is a
# calibration capture, repro.tune/trace@1, not a fault trace)
TRACE_FILES = [p for p in sorted(glob.glob(os.path.join(
    ROOT, "examples", "traces", "*.json"))) if "step_times" not in p]


def _loop_order(mod, batched):
    """The firing order of a fixed schedule: equal times fire in insertion
    order, ``at_array`` coalesces equal deadlines into one event."""
    lp = mod.BatchedEventLoop() if batched else mod.EventLoop()
    fired = []
    lp.at(2.0, lambda l: fired.append(("a", l.now)))
    lp.at(1.0, lambda l: fired.append(("b", l.now)))
    lp.at(2.0, lambda l: fired.append(("c", l.now)))
    lp.after(0.5, lambda l: l.after(1.5, lambda m: fired.append(("d",
                                                                 m.now))))
    if batched:
        lp.at_array([3.0, 1.5, 3.0, 0.25, 1.5],
                    lambda l, idx: fired.append(("arr", l.now,
                                                 tuple(idx.tolist()))))
    end = lp.run(until=2.5)
    lp.at(4.0, lambda l: fired.append(("e", l.now)))
    end2 = lp.run()
    return fired, end, end2, lp.events_run


@pytest.mark.parametrize("batched", [False, True])
def test_event_loops_fire_in_the_reference_order(batched):
    got = _loop_order(teng, batched)
    assert got == _loop_order(jeng, batched)
    names = [f[0] for f in got[0]]
    assert names.index("a") < names.index("c")   # insertion-order tie
    for mod in (teng, jeng):
        lp = mod.EventLoop()
        lp.at(1.0, lambda l: None)
        lp.run()
        with pytest.raises(ValueError):
            lp.at(0.5, lambda l: None)
        with pytest.raises(ValueError):
            lp.after(-1.0, lambda l: None)


@pytest.mark.parametrize("path", TRACE_FILES,
                         ids=[os.path.basename(p) for p in TRACE_FILES])
def test_fault_trace_files_load_like_the_reference(path):
    t, j = ttr.FaultTrace.load(path), jtr.FaultTrace.load(path)
    assert t.to_json() == j.to_json()
    back = ttr.FaultTrace.from_json(t.to_json())
    assert back == t
    for s in range(max((e.step for e in t.events), default=0) + 2):
        assert ([dataclasses.asdict(e) for e in t.at(s)]
                == [dataclasses.asdict(e) for e in j.at(s)])
    with pytest.raises(ValueError):
        ttr.TraceEvent(0, "explode")


@pytest.mark.parametrize("kw", [
    dict(p=8, steps=40, seed=0, fail_rate=0.2),
    dict(p=64, steps=60, seed=3, fail_rate=0.3, straggle_rate=0.5,
         straggle_factor=8.0, rejoin_after=5),
    dict(p=3, steps=30, seed=11, fail_rate=0.9, rejoin_after=2),
], ids=["fail", "churn", "exhaust"])
def test_synthetic_trace_equals_the_reference(kw):
    p, steps = kw.pop("p"), kw.pop("steps")
    t = ttr.synthetic(p, steps, **kw)
    j = jtr.synthetic(p, steps, **kw)
    assert t.events and t.to_json() == j.to_json()


@pytest.mark.parametrize("sampler", ["batched", "perworker"])
def test_compute_durations_draw_for_draw(sampler):
    kw = dict(mean=0.05, jitter=0.2, seed=7, speed={3: 2.0, 9: 0.5},
              sampler=sampler)
    t, j = TCompute(**kw), JCompute(**kw)
    ids = np.array([0, 3, 5, 9, 12, 40], dtype=np.int64)
    for step in range(5):
        sf = np.linspace(1.0, 4.0, ids.size) if step % 2 else None
        a = t.durations(step, ids, sf)
        b = j.durations(step, ids, sf)
        assert a.tolist() == b.tolist()
    # a dict of straggle factors by worker id (the loop engine's form)
    assert (t.durations(9, [1, 2, 3], {2: 5.0}).tolist()
            == j.durations(9, [1, 2, 3], {2: 5.0}).tolist())


def test_sample_cohort_and_aged_sweep_equal_the_reference():
    members = np.array([9, 2, 7, 4, 11, 0, 5, 3], dtype=np.int64)
    for step in range(6):
        for f in (0.1, 0.4, 1.0):
            a = tcl.sample_cohort(5, step, members, f)
            assert a.tolist() == jcl.sample_cohort(5, step, members,
                                                   f).tolist()
            pos = [members.tolist().index(w) for w in a.tolist()]
            assert pos == sorted(pos)       # survivor order is kept
    clock = [0.0]
    hbs = [TMonitor(range(6), clock=lambda: clock[0]),
           JMonitor(range(6), clock=lambda: clock[0])]
    for hb in hbs:
        hb.beat_many(np.arange(6))
    clock[0] = 2.0
    for hb in hbs:
        hb.beat_many(np.array([0, 1, 3]))
    silenced = {2, 3, 4}
    assert (tcl._aged_silenced(hbs[0], silenced, 2.5, 1.0)
            == jcl._aged_silenced(hbs[1], silenced, 2.5, 1.0) == {2, 4})


_TOPOLOGY = {
    "flat": {},
    "hier": dict(topology="hier", group_size=4),
    "slow": dict(slow_workers={3: 10.0, 7: 2.5}, drop_stragglers=False),
}


def _cfg(mod, **kw):
    p = kw.pop("p", 16)
    compute = kw.pop("compute", dict(mean=0.05, jitter=0.05))
    cm = (tcl if mod == "t" else jcl)
    comp_cls = TCompute if mod == "t" else JCompute
    base = dict(p=p, d=50_000, steps=12, buckets=2, k=256, rows=3,
                width=1024, heartbeat_timeout=0.4)
    base.update(kw)
    return cm.SimConfig(compute=comp_cls(**compute), **base)


def _traces(kind, p):
    if kind == "none":
        return ttr.FaultTrace(), jtr.FaultTrace()
    if kind.endswith(".json"):
        path = os.path.join(ROOT, "examples", "traces", kind)
        return ttr.FaultTrace.load(path), jtr.FaultTrace.load(path)
    kw = dict(fail_rate=0.25, straggle_rate=0.5, straggle_factor=8,
              rejoin_after=4, seed=p + 1)
    return ttr.synthetic(p, 12, **kw), jtr.synthetic(p, 12, **kw)


def _both(tcfg, jcfg, ttrace_, jtrace_, engine, **kw):
    t = tcl.simulate(tcfg, ttrace_, engine=engine, **kw.get("t", {}))
    j = jcl.simulate(jcfg, jtrace_, engine=engine, **kw.get("j", {}))
    assert t.to_json() == j.to_json()
    assert t.events_run == j.events_run
    return t, j


@pytest.mark.parametrize("engine", ["batched", "loop"])
@pytest.mark.parametrize("topology", sorted(_TOPOLOGY))
@pytest.mark.parametrize("kind", ["none", "fail_rejoin.json", "churn"])
def test_simulate_to_json_equals_the_reference(engine, topology, kind):
    p = 16
    tt, jt = _traces(kind, p)
    assert tt.to_json() == jt.to_json()
    # the file's events run to step 80
    kw = dict(_TOPOLOGY[topology], p=p, steps=90 if kind.endswith(".json")
              else 12)
    t, _ = _both(_cfg("t", **kw), _cfg("j", **kw), tt, jt, engine)
    if kind != "none":
        assert t.replans or any(r.dropped for r in t.records)


@pytest.mark.parametrize("engine", ["batched", "loop"])
@pytest.mark.parametrize("case", ["participation", "interleave_fused"])
def test_simulate_pipeline_and_cohorts_equal_the_reference(engine, case):
    if case == "participation":
        kw = dict(p=40, participation=0.1)
    else:
        kw = dict(p=8, buckets=4, bwd_chunks=2, fuse_encode=True)
    tt, jt = _traces("churn", kw["p"])
    t, _ = _both(_cfg("t", **kw), _cfg("j", **kw), tt, jt, engine)
    if case == "participation":
        assert all(r.sampled == max(1, round(0.1 * r.p)) for r in t.records)


@pytest.mark.parametrize("engine", ["batched", "loop"])
def test_engines_identical_and_events_contract(engine):
    """The port's two engines give the same timeline (as the reference's
    test_sim_equivalence pins its own); a whole-cluster failure ends the
    run without an error, and a join and a fail of the same worker in one
    step are both applied."""
    tt, _ = _traces("churn", 16)
    a = tcl.simulate(_cfg("t"), tt, engine="loop")
    b = tcl.simulate(_cfg("t"), tt, engine="batched")
    assert a.to_json()["steps"] == b.to_json()["steps"]
    assert a.replans == b.replans and a.makespan == b.makespan
    dead = ttr.FaultTrace(tuple(ttr.TraceEvent(2, "fail", w)
                                for w in range(4)))
    jdead = jtr.FaultTrace(tuple(jtr.TraceEvent(2, "fail", w)
                                 for w in range(4)))
    t, _ = _both(_cfg("t", p=4), _cfg("j", p=4), dead, jdead, engine)
    assert t.replans[-1].get("cluster_failed") and len(t.records) == 2
    tt = ttr.FaultTrace((ttr.TraceEvent(1, "fail", 2),
                         ttr.TraceEvent(4, "join", 2),
                         ttr.TraceEvent(4, "fail", 2)))
    jt = jtr.FaultTrace((jtr.TraceEvent(1, "fail", 2),
                         jtr.TraceEvent(4, "join", 2),
                         jtr.TraceEvent(4, "fail", 2)))
    t, _ = _both(_cfg("t", p=4), _cfg("j", p=4), tt, jt, engine)
    gens = [(rp["joined"], rp["failed"]) for rp in t.replans]
    assert gens == [([], [2]), ([2], []), ([], [2])]
    # a silenced worker blocks the barrier until last_beat + timeout
    assert any(r.stall >= 0.4 for r in t.records)


STEPS, CONGEST_AT, FACTOR = 20, 8, 6.0


def _watch_spec(api):
    base = api.RunSpec()
    return dataclasses.replace(
        base, d=1_000_000, steps=STEPS,
        cluster=dataclasses.replace(base.cluster, p=8, compute_jitter=0.0),
        watch=dataclasses.replace(base.watch, enabled=True))


@pytest.fixture(scope="module")
def watched():
    """A SimWatcher run under 6x congestion from step 8, in both
    packages (batched and loop engines)."""
    out = {}
    for engine in ("batched", "loop"):
        res = []
        for api, cl, tr, watcher in ((tapi, tcl, ttr, TWatcher),
                                     (japi, jcl, jtr, JWatcher)):
            spec = _watch_spec(api)
            trace = tr.FaultTrace((tr.TraceEvent(
                CONGEST_AT, "congest", factor=FACTOR,
                duration=STEPS - CONGEST_AT),))
            res.append(cl.simulate(spec.sim_config(), trace,
                                   net=spec.cluster.network(), engine=engine,
                                   watcher=watcher(spec)))
        out[engine] = res
    return out


@pytest.mark.parametrize("engine", ["batched", "loop"])
def test_watched_congested_run_equals_the_reference(watched, engine):
    t, j = watched[engine]
    assert t.to_json() == j.to_json()
    kinds = [w["kind"] for w in t.watch]
    assert "drift.detected" in kinds and "watch.replan" in kinds


def _events(tracer):
    return [(e["ph"], e["name"], e["cat"], e["track"], e["ts"],
             e.get("dur"), e.get("args")) for e in tracer.events]


@pytest.mark.parametrize("case", ["churn", "watched"])
def test_from_sim_equals_the_reference_event_for_event(watched, case):
    if case == "watched":
        t, j = watched["batched"]
    else:
        tt, jt = _traces("churn", 16)
        t = tcl.simulate(_cfg("t"), tt)
        j = jcl.simulate(_cfg("j"), jt)
    tr, jr = ttrace.from_sim(t), jtrace.from_sim(j)
    assert _events(tr) == _events(jr)
    assert _events(t.to_tracer()) == _events(tr)
    doc = tr.to_chrome(source="sim")
    assert doc["traceEvents"] == jr.to_chrome(source="sim")["traceEvents"]
    ttrace.validate(doc)
    drops = [e for e in tr.events if e["name"] == "straggler.drop"]
    assert all(e["cat"] == "runtime" for e in drops)
    if case == "churn":
        assert drops


def test_sim_package_exports_the_reference_names():
    import repro.sim as jsim
    assert set(jsim.__all__) <= set(tsim.__all__)
    for name in ("SimResult", "StepRecord", "simulate", "sample_cohort",
                 "EventLoop", "BatchedEventLoop", "FaultTrace",
                 "TraceEvent", "synthetic"):
        assert getattr(tsim, name).__module__.startswith("repro_torch.")
