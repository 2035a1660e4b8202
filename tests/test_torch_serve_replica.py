"""Port parity: replica failover (``serve/replica.py``) and the seeded load
test (``serve/loadtest.py``) against the reference's, on the same weights.

The weights are seeded numpy segments of qwen3-4b's smoke config
(``tests/test_torch_serve_model.np_segs``), carried into the port by
``params_from_numpy``. Failover: the port's replica set
gives the reference's completions (tokens, finish, replays, virtual
times) when one replica is killed mid-run, and an uninterrupted run's
tokens. Load test: the report equals the reference's with the wall-clock
fields and the provenance stripped (the virtual clock is a pure function
of the spec and the seed).
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.serve import ReplicaSet as JReplicaSet
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve.loadtest import make_trace as j_make_trace
from repro.serve.loadtest import run_load_test as j_run_load_test
from repro_torch.serve import ReplicaSet, Request, ServeEngine
from repro_torch.serve.loadtest import make_trace, run_load_test
from tests.test_torch_serve_engine import (as_dicts, built, one_thread,
                                           requests, specs)

_ = one_thread   # the module-wide single-thread fixture


def replica_sets(n, spec_kw, timeout=2.0):
    b = built("qwen3-4b")
    jspec, tspec = specs(**spec_kw)
    cfg, ctx, fs, segs, jfns = b["j"]
    tcfg, tfs, tsegs, fns = b["t"]
    return (JReplicaSet([JEngine(cfg, ctx, fs, segs, jspec, fns=jfns)
                         for _ in range(n)], heartbeat_timeout=timeout),
            ReplicaSet([ServeEngine(tcfg, tfs, tsegs, tspec, fns=fns)
                        for _ in range(n)], heartbeat_timeout=timeout))


def submit(rsets, reqs, req_kw=None):
    req_kw = req_kw or {}
    jr, tr = rsets
    for rid, prompt, max_new in reqs:
        jr.submit(JRequest(rid=rid, prompt=prompt, max_new=max_new,
                           **req_kw.get(rid, {})))
        tr.submit(Request(rid=rid, prompt=prompt, max_new=max_new,
                          **req_kw.get(rid, {})))


def test_replica_failover_replays_identically():
    """Kill replica 1 after three rounds: the heartbeat detects it, the
    elastic re-plan re-routes, and every request's tokens equal an
    uninterrupted single replica's."""
    kw = dict(batch=2, block_size=4, max_len=24, prompt_len=8, gen=8)
    reqs = requests(256, 6, seed=11, prompt_hi=7, max_new=6)
    _, ref = replica_sets(1, kw)
    for rid, prompt, max_new in reqs:
        ref.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    want = {c.rid: c.tokens for c in ref.run()}

    rsets = replica_sets(2, kw, timeout=1.5)
    submit(rsets, reqs)
    for rs in rsets:
        for _ in range(3):
            rs.step_round()
        rs.kill(1)
    jgot, got = (rs.run() for rs in rsets)
    assert as_dicts(got) == as_dicts(jgot)
    assert {c.rid: c.tokens for c in got} == want
    tr = rsets[1]
    assert tr.plan.generation == 1 and 1 not in tr.live()
    assert any(c.replays > 0 for c in got)


def test_replica_failover_deadline_drop():
    rsets = replica_sets(2, dict(batch=1, block_size=4, max_len=24,
                                 prompt_len=8, gen=8), timeout=1.5)
    submit(rsets, [(0, (1, 2, 3), 6), (1, (4, 5, 6), 6)],
           {1: {"deadline": 1e-9}})
    for rs in rsets:
        rs.step_round()
        rs.kill(1)
    jgot, got = (rs.run() for rs in rsets)
    assert as_dicts(got) == as_dicts(jgot)
    done = {c.rid: c for c in got}
    assert done[1].finish == "dropped" and done[1].reason == "deadline"
    assert done[0].finish == "length"


def _strip_wall(report):
    d = json.loads(json.dumps(report))
    d.pop("wall")
    d.pop("provenance")
    for pol in ("continuous", "static"):
        d[pol].pop("wall_s")
        d[pol].pop("per_token_wall")
    return d


def test_load_test_report_equals_reference():
    b = built("qwen3-4b")
    kw = dict(batch=3, block_size=4, max_len=16, prompt_len=8, gen=6,
              rate=300.0, n_requests=10)
    jspec, tspec = specs(**kw)
    cfg, ctx, fs, segs, _ = b["j"]
    tcfg, tfs, tsegs, _ = b["t"]
    want = j_run_load_test(cfg, ctx, fs, segs, jspec)
    got = run_load_test(tcfg, tfs, tsegs, tspec)
    assert _strip_wall(got) == _strip_wall(want)
    assert got["speedup_vs_static"] > 1.0
    assert got["continuous"]["dropped"] == 0 and got["tokens_match_static"]
    h = got["continuous"]["ttft"]
    assert h["count"] == 10 and h["p50"] <= h["p95"] <= h["p99"]
    assert got["provenance"]["backend"] == "cpu"
    assert set(got["wall"]) == set(want["wall"])


@pytest.mark.parametrize("deadline", [None, 1.0])
def test_trace_equals_reference(deadline):
    jspec, tspec = specs(batch=2, block_size=4, max_len=16, prompt_len=8,
                         gen=6, n_requests=20, rate=50.0, deadline=deadline)
    got = make_trace(tspec.serve, 256, seed=4)
    want = j_make_trace(jspec.serve, 256, seed=4)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    for r in got:
        assert len(r.prompt) - 1 + r.max_new <= \
            tspec.serve.resolved_max_len()
    assert np.all(np.diff([r.arrival for r in got]) > 0)
