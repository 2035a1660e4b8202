"""Port parity: elastic re-planning and heartbeat failure detection
(``runtime/elastic.py``, ``runtime/heartbeat.py``) on tests/test_runtime.py's
cases, each run in both packages with the same answers; the port's
``heartbeat.dead`` and ``elastic.replan`` instants through its tracer.
"""

import numpy as np
import pytest

from repro.core import allreduce as jar
from repro.runtime import ElasticPlan as JPlan
from repro.runtime import HeartbeatMonitor as JMonitor
from repro.runtime import initial_plan as j_initial_plan
from repro.runtime import replan as j_replan
from repro_torch import obs
from repro_torch.core import allreduce as ar
from repro_torch.runtime import (ElasticPlan, HeartbeatMonitor,
                                 initial_plan, replan)

BOTH = [(initial_plan, replan), (j_initial_plan, j_replan)]


def _fields(p):
    return (p.n_workers, p.survivor_ids, p.generation, p.lr_scale)


def test_replan_drops_and_reranks():
    out = []
    for init, rep in BOTH:
        p1 = rep(init(8), failed={2, 5})
        assert p1.n_workers == 6
        assert p1.survivor_ids == (0, 1, 3, 4, 6, 7)
        assert p1.rank_of(3) == 2 and p1.rank_of(5) is None
        assert p1.generation == 1
        assert p1.lr_scale == pytest.approx(6 / 8)
        out.append(_fields(p1))
    assert out[0] == out[1]


def test_replan_join_and_all_fail():
    for init, rep in BOTH:
        p = rep(init(4), failed={0, 1, 2}, joined=(9,))
        assert p.survivor_ids == (3, 9)
        with pytest.raises(RuntimeError):
            rep(p, failed={3, 9})


def test_replan_pure_join_reranks_and_rescales_lr_up():
    p1 = replan(initial_plan(4), failed=set(), joined=(7, 9))
    j1 = j_replan(j_initial_plan(4), failed=set(), joined=(7, 9))
    assert _fields(p1) == _fields(j1)
    assert p1.survivor_ids == (0, 1, 2, 3, 7, 9)
    assert [p1.rank_of(w) for w in (0, 3, 7, 9)] == [0, 3, 4, 5]
    assert p1.lr_scale == pytest.approx(6 / 4)
    assert p1.schedule == j1.schedule
    flat = [r for pairs in p1.schedule for pair in pairs for r in pair]
    assert flat and all(0 <= r < 6 for r in flat)
    assert ar.tree_allreduce_rounds(6) == jar.tree_allreduce_rounds(6) == 6


@pytest.mark.parametrize("failed,joined,rescale", [
    (set(), (5,), False), ({1}, (8,), True), ({0, 3}, (), True)])
def test_replan_cases_match(failed, joined, rescale):
    p = replan(initial_plan(4), failed=failed, joined=joined,
               rescale_lr=rescale)
    j = j_replan(j_initial_plan(4), failed=failed, joined=joined,
                 rescale_lr=rescale)
    assert _fields(p) == _fields(j)


@pytest.mark.parametrize("p", [1, 2, 3, 5, 6, 7, 9])
def test_plan_schedule_valid_any_p(p):
    plan = ElasticPlan(p, tuple(range(p)), 0)
    assert plan.schedule == ar.reduce_schedule(p) == \
        JPlan(p, tuple(range(p)), 0).schedule


@pytest.mark.parametrize("Mon", [HeartbeatMonitor, JMonitor])
def test_heartbeat(Mon):
    t = [0.0]
    hb = Mon([0, 1, 2], clock=lambda: t[0])
    t[0] = 5.0
    hb.beat(0)
    hb.beat(1)
    t[0] = 9.0
    assert hb.dead(timeout=5.0) == {2}
    hb.remove(2)
    assert hb.dead(timeout=5.0) == set()


def test_heartbeat_vectorized_paths_match():
    """beat_many / last_of / add / remove (swap-with-last) and string ids
    (the dict fallback) give the same answers in both packages."""
    for ids in (list(range(12)), [f"w{i}" for i in range(12)]):
        t = [0.0]
        mons = [M(ids, clock=lambda: t[0])
                for M in (HeartbeatMonitor, JMonitor)]
        script = [("beat_many", ids[::2], 1.0), ("remove", ids[3], 2.0),
                  ("add", ids[3], 3.0), ("beat", ids[5], 4.0),
                  ("add", "new" if ids[0] == "w0" else 40, 5.0),
                  ("beat_many", ids[:4], 6.0)]
        for op, arg, now in script:
            t[0] = now
            for m in mons:
                getattr(m, op)(arg)
        t[0] = 9.5
        assert mons[0].dead(5.0) == mons[1].dead(5.0)
        np.testing.assert_array_equal(mons[0].last_of(ids[:6]),
                                      mons[1].last_of(ids[:6]))
        with pytest.raises(KeyError):
            mons[0].beat_many([ids[0], "missing" if ids[0] == "w0" else 99])


def test_runtime_instants_through_the_tracer():
    t = [0.0]
    tr = obs.Tracer(clock=lambda: t[0])
    with tr.activate():
        hb = HeartbeatMonitor([0, 1], clock=lambda: t[0])
        t[0] = 3.0
        hb.beat(0)
        assert hb.dead(timeout=2.0) == {1}
        assert hb.dead(timeout=2.0) == {1}     # reported once
        replan(initial_plan(2), failed={1})
    names = [e["name"] for e in tr.to_chrome()["traceEvents"]
             if e.get("ph") == "i"]
    assert names == ["heartbeat.dead", "elastic.replan"]
