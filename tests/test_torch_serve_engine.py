"""Port parity: the continuous-batching engine (``serve/scheduler.py``,
``serve/kvcache.py``, ``serve/streaming.py``) against the reference's on
the same weights and requests, and the engine's own invariants.

Both engines serve the same seeded numpy segments of the smoke config
(``tests/test_torch_serve_model.np_segs``, carried into the port by
``params_from_numpy``); the reference's prefill and
decode are jitted once per arch at module scope and shared by all its
engines. The completions are held EQUAL: tokens, finish reasons, replay
counts and the virtual-clock timestamps (``t_first``, ``t_done``: the
same float ops on the same ClusterSpec). Within the port, the paged
cache is held bit-equal to the contiguous one on every valid position,
and continuous batching equal to one request at a time.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import SMOKES as J_SMOKES
from repro.models.common import ShardCtx
from repro.models.flatten import make_flat_spec as j_fs
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.serve import stream_tokens as j_stream_tokens
from repro.serve.scheduler import predict_admission as j_predict
from repro.serve.scheduler import serve_fns as j_serve_fns
from repro_torch import api as tapi
from repro_torch.configs import SMOKES as T_SMOKES
from repro_torch.models import model as M
from repro_torch.models.common import tree_leaves
from repro_torch.models.flatten import make_flat_spec, params_from_numpy
from repro_torch.serve import (ContiguousKVCache, OutOfBlocks, PagedKVCache,
                               Request, ServeEngine, stream_tokens)
from repro_torch.serve.scheduler import predict_admission, serve_fns
from tests.test_torch_serve_model import np_segs

CTX = ShardCtx(dtype=jnp.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BUILT: dict = {}


def built(arch):
    """{"j": (cfg, ctx, fs, segs, fns), "t": (cfg, fs, segs, fns)}."""
    if arch not in _BUILT:
        cfg = J_SMOKES[arch]
        fs = j_fs(cfg, 1)
        seg_np = np_segs(fs)
        segs = {k: jnp.asarray(v) for k, v in seg_np.items()}
        tcfg = T_SMOKES[arch]
        tfs = make_flat_spec(tcfg, 1)
        tsegs = params_from_numpy(seg_np, tfs, "cpu")
        _BUILT[arch] = {"j": (cfg, CTX, fs, segs, j_serve_fns(cfg, CTX, fs)),
                        "t": (tcfg, tfs, tsegs, serve_fns(tcfg, tfs))}
    return _BUILT[arch]


def specs(**kw):
    """The same ServeSpec overrides on each package's smoke RunSpec."""
    out = []
    for api in (japi, tapi):
        base = api.RunSpec(smoke=True)
        spec = dataclasses.replace(
            base, serve=dataclasses.replace(base.serve, **kw))
        spec.validate()
        out.append(spec)
    return out


def requests(vocab, n, *, seed=0, prompt_hi=8, max_new=4):
    rng = np.random.default_rng(seed)
    return [(i, tuple(int(x) for x in rng.integers(
        1, vocab, int(rng.integers(1, prompt_hi)))), max_new)
        for i in range(n)]


def engines(arch, spec_kw, reqs, req_kw=None):
    """(reference engine, port engine), both with ``reqs`` submitted
    (``req_kw``: extra Request fields by rid)."""
    req_kw = req_kw or {}
    b = built(arch)
    jspec, tspec = specs(**spec_kw)
    cfg, ctx, fs, segs, fns = b["j"]
    je = JEngine(cfg, ctx, fs, segs, jspec, fns=fns)
    tcfg, tfs, tsegs, tfns = b["t"]
    te = ServeEngine(tcfg, tfs, tsegs, tspec, fns=tfns)
    for rid, prompt, max_new in reqs:
        je.submit(JRequest(rid=rid, prompt=prompt, max_new=max_new,
                           **req_kw.get(rid, {})))
        te.submit(Request(rid=rid, prompt=prompt, max_new=max_new,
                          **req_kw.get(rid, {})))
    return je, te


def as_dicts(comps):
    return [dataclasses.asdict(c) for c in comps]


SMALL = dict(batch=3, block_size=4, max_len=16, prompt_len=8, gen=4)


# attn (qwen3), mamba + shared_attn hybrid (zamba2), pure rwkv (no KV kinds)
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b", "rwkv6-7b"])
def test_engine_completions_equal_reference(arch, paged):
    reqs = requests(J_SMOKES[arch].vocab_size, 6, seed=1)
    je, te = engines(arch, dict(SMALL, paged=paged), reqs)
    want, got = je.run(), te.run()
    assert as_dicts(got) == as_dicts(want)
    assert te.n_steps == je.n_steps and te.now == je.now
    assert [(r, t, v) for r, t, v, _ in te.emissions] == \
        [(r, t, v) for r, t, v, _ in je.emissions]


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b", "rwkv6-7b"])
def test_paged_bitexact_vs_contiguous(arch):
    """Lockstep the port's two backends: every step's emissions match and
    the paged gather equals the contiguous cache BITWISE on every valid
    position of every active slot (recurrent state on every slot)."""
    tcfg, tfs, tsegs, fns = built(arch)["t"]
    _, spec = specs(**SMALL)
    reqs = requests(tcfg.vocab_size, 6, seed=1)

    def engine(paged):
        sp = dataclasses.replace(
            spec, serve=dataclasses.replace(spec.serve, paged=paged))
        eng = ServeEngine(tcfg, tfs, tsegs, sp, fns=fns)
        for rid, prompt, max_new in reqs:
            eng.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        return eng

    ep, ec = engine(True), engine(False)
    assert isinstance(ep.cache, PagedKVCache)
    assert isinstance(ec.cache, ContiguousKVCache)
    steps = 0
    while ep.pending() or ec.pending():
        assert ep.step() == ec.step()
        steps += 1
        assert steps < 1000
        kvp, stp = M.split_cache(ep.cache.gather())
        kvc, stc = M.split_cache(ec.cache.gather())
        for i, s in enumerate(ep.slots):
            if s is None:
                continue
            for (_, a), (_, b) in zip(tree_leaves(kvp), tree_leaves(kvc)):
                assert torch.equal(a[:, :, i, :s.pos], b[:, :, i, :s.pos])
        for (_, a), (_, b) in zip(tree_leaves(stp), tree_leaves(stc)):
            assert torch.equal(a, b)
    a = {c.rid: c.tokens for c in ep.run()}
    b = {c.rid: c.tokens for c in ec.run()}
    assert a == b and len(a) == len(reqs)


def test_continuous_matches_sequential():
    tcfg, tfs, tsegs, fns = built("qwen3-4b")["t"]
    _, spec = specs(**SMALL)
    reqs = requests(tcfg.vocab_size, 5, seed=3)
    eng = ServeEngine(tcfg, tfs, tsegs, spec, fns=fns)
    for rid, prompt, max_new in reqs:
        eng.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    batched = {c.rid: c.tokens for c in eng.run()}
    for rid, prompt, max_new in reqs:
        solo = ServeEngine(tcfg, tfs, tsegs, spec, fns=fns)
        solo.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        [c] = solo.run()
        assert batched[rid] == c.tokens


def test_block_accounting_no_leaks():
    tcfg, tfs, tsegs, fns = built("qwen3-4b")["t"]
    _, spec = specs(batch=2, block_size=4, max_len=16, prompt_len=8, gen=4)
    eng = ServeEngine(tcfg, tfs, tsegs, spec, fns=fns)
    cache = eng.cache
    total = cache.num_blocks - 1            # block 0 reserved
    for rid, prompt, max_new in requests(tcfg.vocab_size, 5, seed=5):
        eng.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    steps = 0
    while eng.pending():
        eng.step()
        steps += 1
        assert steps < 1000
        used = sum(cache.used_blocks(i) for i in range(cache.slots))
        assert used + cache.free_blocks == total
        for i, s in enumerate(eng.slots):
            if s is None:
                assert cache.used_blocks(i) == 0
            else:
                assert cache.used_blocks(i) >= cache.blocks_for(s.pos)
    assert cache.free_blocks == total
    assert not cache.pool["attn"]["k"][:, :, 0].any()   # block 0 stays 0


def test_preemption_matches_reference():
    """A pool of 7 usable blocks for 3 slots forces eviction; the evicted
    requests replay from prompt + emitted. Completions (replays and
    virtual times included) equal the reference's, and tokens equal an
    unconstrained run's."""
    rng = np.random.default_rng(7)
    reqs = [(i, tuple(int(x) for x in rng.integers(1, 256, 7)), 8)
            for i in range(3)]
    kw = dict(batch=3, block_size=4, max_len=16, prompt_len=8, gen=8)
    je, te = engines("qwen3-4b", dict(kw, kv_blocks=8), reqs)
    want, got = je.run(), te.run()
    assert as_dicts(got) == as_dicts(want)
    assert any(c.replays > 0 for c in got)
    assert te.cache.free_blocks == te.cache.num_blocks - 1
    _, free = engines("qwen3-4b", kw, reqs)
    assert {c.rid: c.tokens for c in free.run()} == \
        {c.rid: c.tokens for c in got}


def test_oversized_request_drops_loudly(capsys):
    tcfg, tfs, tsegs, fns = built("qwen3-4b")["t"]
    _, spec = specs(batch=2, block_size=4, max_len=8, prompt_len=4, gen=4)
    eng = ServeEngine(tcfg, tfs, tsegs, spec, fns=fns)
    eng.submit(Request(rid=0, prompt=(1,) * 20, max_new=4))
    [c] = eng.run()
    assert c.finish == "dropped" and c.reason == "too_long"
    assert "DROP" in capsys.readouterr().err


def test_deadline_drop_matches_reference():
    jspec, tspec = specs(batch=2, block_size=4, max_len=16, prompt_len=8,
                         gen=4)
    est = predict_admission(tspec, 7, 4)
    assert est == j_predict(jspec, 7, 4)
    reqs = [(0, (1,) * 8, 4), (1, (1,) * 8, 4)]
    je, te = engines("qwen3-4b", dict(batch=2, block_size=4, max_len=16,
                                      prompt_len=8, gen=4), reqs,
                     {0: {"deadline": est["t_total"] / 2},
                      1: {"deadline": est["t_total"] * 50}})
    want, got = je.run(), te.run()
    assert as_dicts(got) == as_dicts(want)
    assert got[0].finish == "dropped" and got[0].reason == "deadline"
    assert got[1].finish == "length"


def test_static_policy_matches_reference():
    """The static baseline never refills a freed slot mid-batch; its
    completions and virtual times equal the reference's."""
    reqs = [(0, (3, 4, 5), 2), (1, (6, 7, 8), 6), (2, (9, 10, 11), 2)]
    je, te = engines("qwen3-4b", dict(batch=2, block_size=4, max_len=16,
                                      prompt_len=8, gen=6, policy="static"),
                     reqs)
    saw_idle_slot_with_queue = False
    steps = 0
    while te.pending():
        te.step()
        steps += 1
        assert steps < 1000
        if te.queue and 0 < te.active() < len(te.slots):
            saw_idle_slot_with_queue = True
    assert saw_idle_slot_with_queue
    assert as_dicts(te.run()) == as_dicts(je.run())


def test_stream_tokens_and_stop_token_match_reference():
    b = built("qwen3-4b")
    jspec, tspec = specs(batch=2, block_size=4, max_len=16, prompt_len=8,
                         gen=8)
    cfg, ctx, fs, segs, jfns = b["j"]
    tcfg, tfs, tsegs, fns = b["t"]
    eng = ServeEngine(tcfg, tfs, tsegs, tspec, fns=fns)
    got = list(stream_tokens(eng, Request(rid=0, prompt=(5, 6, 7, 8),
                                          max_new=8)))
    want = list(j_stream_tokens(JEngine(cfg, ctx, fs, segs, jspec,
                                        fns=jfns),
                                JRequest(rid=0, prompt=(5, 6, 7, 8),
                                         max_new=8)))
    comp = eng.completion(0)
    assert got == want == comp.tokens and comp.finish == "length"
    eng2 = ServeEngine(tcfg, tfs, tsegs, tspec, fns=fns)
    eng2.submit(Request(rid=1, prompt=(5, 6, 7, 8), max_new=8,
                        stop_token=got[0]))
    [c] = eng2.run()
    assert c.finish == "stop" and c.tokens == [got[0]]


def test_paged_pool_sized_from_cluster_memory():
    tcfg = T_SMOKES["qwen3-4b"]
    jspec, tspec = specs(batch=2, block_size=4, max_len=16, prompt_len=8,
                         gen=8)
    per = PagedKVCache.block_bytes(tcfg, 4, torch.float32)
    from repro.serve import PagedKVCache as JPaged
    assert per == JPaged.block_bytes(J_SMOKES["qwen3-4b"], CTX, 4,
                                     jnp.float32) > 0
    for mem in (per * 10 / 0.5 / 1024 ** 3, 0.001, 16.0):
        cl = dataclasses.replace(tspec.cluster, mem_gb=mem)
        jcl = dataclasses.replace(jspec.cluster, mem_gb=mem)
        cache = PagedKVCache.from_cluster(tcfg, cl, tspec.serve,
                                          torch.float32)
        assert cache.num_blocks == JPaged.from_cluster(
            J_SMOKES["qwen3-4b"], CTX, jcl, jspec.serve,
            jnp.float32).num_blocks
    sv2 = dataclasses.replace(tspec.serve, kv_blocks=5)
    assert PagedKVCache.from_cluster(tcfg, tspec.cluster, sv2,
                                     torch.float32).num_blocks == 5


def test_contiguous_rejects_overflow():
    cache = ContiguousKVCache(T_SMOKES["qwen3-4b"], slots=2, block_size=4,
                              max_len=8, dtype=torch.float32)
    with pytest.raises(OutOfBlocks):
        cache.ensure(0, 9)


def test_vlm_engine_not_supported():
    _, spec = specs(**SMALL)
    tcfg = T_SMOKES["llama-3.2-vision-11b"]
    with pytest.raises(NotImplementedError):
        ServeEngine(tcfg, make_flat_spec(tcfg, 1),
                    {"top_s": torch.zeros(1)}, spec)
