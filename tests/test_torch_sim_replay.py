"""Port parity for the simulator's pricing oracle: ``repro_torch.sim``'s
network model, ``replay.predict_step`` (and ``tune.watch.predict_phases``)
and the three schedule pricers of ``core/compression.py``, held against
``repro.sim`` / ``repro.core.compression`` on the same inputs at rel 1e-12
(they agree exactly: the same float operations in the same order)."""

import dataclasses
import math

import numpy as np
import pytest

from repro.api import RunSpec as JSpec
from repro.core import compression as jcomp
from repro.sim import network as jnet
from repro.sim import replay as jrep
from repro.tune.cost import CalibrationProfile as JProfile
from repro.tune.watch import predict_phases as j_predict_phases
from repro_torch.api import RunSpec as TSpec
from repro_torch.core import compression as tcomp
from repro_torch.sim import network as tnet
from repro_torch.sim import replay as trep
from repro_torch.tune.cost import CalibrationProfile as TProfile
from repro_torch.tune.watch import predict_phases as t_predict_phases

REL = 1e-12


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float):
        assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0), (a, b)
    else:
        assert a == b


NETS = [("flat", "1gbe", None), ("flat", "10gbe", None),
        ("hier", "1gbe", None), ("flat", "1gbe", {3: 4.0, 5: 1.5})]


@pytest.mark.parametrize("method", ["gs-sgd", "gtopk", "sketched-sgd",
                                    "dense"])
@pytest.mark.parametrize("topology,link,slow", NETS,
                         ids=["flat-1gbe", "flat-10gbe", "hier", "slow"])
def test_predict_step_grid_matches(method, topology, link, slow):
    shapes = {"gs-sgd": (None, "ring", "hier", "ps"), "gtopk": (None,),
              "sketched-sgd": (None,), "dense": (None, "tree")}[method]
    fuses = (False, True) if method == "gs-sgd" else (False,)
    for p, d in ((8, 1_000_000), (11, 91_648)):
        nets = [pkg.make_network(topology, link=link, group_size=4,
                                 slow_workers=slow)
                for pkg in (tnet, jnet)]
        for buckets in (1, 3):
            for chunks in (1, 2, 4):
                for fuse in fuses:
                    for shape in shapes:
                        kw = dict(buckets=buckets, bwd_chunks=chunks,
                                  shape=shape, group_size=4,
                                  fuse_encode=fuse, t_compute=0.07,
                                  topology=topology, link=link)
                        t = trep.predict_step(method, d, p, net=nets[0], **kw)
                        j = jrep.predict_step(method, d, p, net=nets[1], **kw)
                        _close(t, j)


def test_predict_step_options_match():
    for kw in ({"overlap": False, "buckets": 4},
               {"participation": 0.5, "buckets": 2},
               {"rows": "log", "width": None, "k": 5000},
               {"wire_dtype_bytes": 2, "bwd_chunks": 3, "buckets": 5},
               {"bwd_frac": 0.5, "bwd_chunks": 2, "buckets": 2}):
        _close(trep.predict_step("gs-sgd", 2_000_000, 16, **kw),
               jrep.predict_step("gs-sgd", 2_000_000, 16, **kw))
    for prof in ({"comm": 6.0}, {"compute": 0.5, "encode": 2.0,
                                 "recover": 3.0}, {}):
        kw = dict(buckets=4, bwd_chunks=2, t_compute=0.1)
        _close(trep.predict_step("gs-sgd", 1 << 20, 8, **kw,
                                 profile=TProfile(**prof)),
               jrep.predict_step("gs-sgd", 1 << 20, 8, **kw,
                                 profile=JProfile(**prof)))
    for bad in ({"method": "gtopk", "shape": "ring"},
                {"method": "sketched-sgd", "shape": "tree"},
                {"method": "nope"}):
        for rep in (trep, jrep):
            with pytest.raises((ValueError, KeyError)):
                rep.ExchangeReplay(d=1000, **bad)


@pytest.mark.parametrize("spec_kw", [
    {},
    {"exchange": {"buckets": 4, "bwd_chunks": 2, "fuse_encode": True}},
    {"exchange": {"compressor": "gtopk", "buckets": 2}},
    {"exchange": {"compressor": "none"}, "cluster": {"p": 6,
                                                      "topology": "hier"}},
    {"cluster": {"link_alpha": 1e-4, "link_beta": 3e-9,
                 "slow_workers": {1: 3.0}, "participation": 0.5}},
], ids=["default", "fused", "gtopk", "dense-hier", "calibrated"])
def test_predict_phases_and_sim_config_match(spec_kw):
    doc = JSpec(d=1_000_000).to_json()
    for blk, kv in spec_kw.items():
        doc[blk] = {**doc[blk], **kv}
    t, j = TSpec.from_json(doc), JSpec.from_json(doc)
    for p in (None, 3):
        _close(t_predict_phases(t, p=p), j_predict_phases(j, p=p))
    _close(t_predict_phases(t, profile=TProfile(comm=2.0)),
           j_predict_phases(j, profile=JProfile(comm=2.0)))
    tc, jc = t.sim_config(), j.sim_config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.astuple(t.cluster.link_spec()) == \
        dataclasses.astuple(j.cluster.link_spec())
    assert t.env().to_json() == j.env().to_json()


def test_sim_config_refuses_what_the_simulator_cannot_replay():
    for pkg in (TSpec, JSpec):
        spec = pkg.from_json({**JSpec(d=1000).to_json(),
                              "exchange": {"compressor": "topk"}})
        with pytest.raises(ValueError, match="not replayable"):
            spec.sim_config()


@pytest.mark.parametrize("p", [1, 2, 5, 8, 13])
def test_network_collective_costs_match(p):
    ids = list(range(p))
    models = [(pkg.Homogeneous(pkg.LINK_10GBE),
               pkg.Hierarchical(group_size=4),
               pkg.Heterogeneous(pkg.Hierarchical(group_size=3),
                                 {1: 2.0, 4: 7.5}))
              for pkg in (tnet, jnet)]
    for tm, jm in zip(*models):
        for shape in ("tree", "ring", "hier", "ps"):
            t = tnet.allreduce_cost(tm, ids, 12_345.0, shape=shape,
                                    group_size=4)
            j = jnet.allreduce_cost(jm, ids, 12_345.0, shape=shape,
                                    group_size=4)
            _close([dataclasses.astuple(r) for r in t],
                   [dataclasses.astuple(r) for r in j])
        pairs = [[(0, p - 1)], [(i, (i + 1) % p) for i in range(p)]]
        _close([dataclasses.astuple(r) for r in
                tnet.pairwise_rounds(tm, ids, pairs, 99.0)],
               [dataclasses.astuple(r) for r in
                jnet.pairwise_rounds(jm, ids, pairs, 99.0)])
        assert dataclasses.astuple(tm.worst_link(ids, 10.0)) == \
            dataclasses.astuple(jm.worst_link(ids, 10.0))
        src, dst = np.arange(p), np.arange(p)[::-1].copy()
        _close(list(tm.pair_times(src, dst, 77.0)),
               list(jm.pair_times(src, dst, 77.0)))


def test_schedule_pricers_match():
    rng = np.random.default_rng(7)
    for n in (1, 2, 5, 9):
        tc = rng.random(n).tolist()
        tm = rng.random(n).tolist()
        ready = sorted(rng.random(n).tolist())
        shuffled = rng.permutation(ready).tolist()
        for rd in (None, ready):
            _close(tcomp.overlap_schedule_time(tc, tm, rd),
                   jcomp.overlap_schedule_time(tc, tm, rd))
        for tb in (None, 1.5):
            _close(tcomp.interleaved_schedule_time(tc, tm, shuffled,
                                                   t_backward=tb),
                   jcomp.interleaved_schedule_time(tc, tm, shuffled,
                                                   t_backward=tb))
            pb = [int(b) for b in rng.integers(0, n, size=2 * n)]
            pc = rng.random(2 * n).tolist()
            pr = rng.random(2 * n).tolist()
            _close(tcomp.fused_interleaved_schedule_time(pb, pc, pr, tm,
                                                         t_backward=tb),
                   jcomp.fused_interleaved_schedule_time(pb, pc, pr, tm,
                                                         t_backward=tb))
    # one fragment a bucket reduces to the unfused recurrence
    t = tcomp.fused_interleaved_schedule_time([0, 1], [0.2, 0.3], [0.1, 0.4],
                                              [0.5, 0.5])
    assert t == tcomp.interleaved_schedule_time([0.2, 0.3], [0.5, 0.5],
                                                [0.1, 0.4])
