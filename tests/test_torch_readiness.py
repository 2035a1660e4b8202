"""Port parity for the backward-interleaved exchange: the bucket plan
(``flatten.chunk_plan``, ``packed_offsets``, ``bucket_plan``), the chunked
backward (``model.chunked_loss_vjp``) and the readiness scheduler
(``gs_sgd.exchange_interleaved``, reached by ``make_train_step(...,
bwd_chunks=K)``), against the JAX package and against the port itself.

Tolerances: the plan is integer arithmetic, so it must be equal. The
chunked backward runs the monolithic backward's ops in the same order
(the graph is cut, not changed), so its gradients are bit-equal to
``loss.backward()``, and the step at ``bwd_chunks=1`` bit-equal to the
bucketed step. Against the JAX package, as ``tests/test_torch_gs_sgd.py``:
losses at rtol 1e-4, the selected coordinates (the EF zero pattern) equal
every step, EF and final params at rtol 1e-4 / atol 1e-6.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.api import RunSpec as JSpec
from repro.launch.train import build as j_build
from repro.models import flatten as jfl
from repro_torch.api import RunSpec as TSpec
from repro_torch.configs.qwen3_4b import CONFIG as QWEN3_4B
from repro_torch.core.gs_sgd import (MeshAxes, local_seg_shapes, make_state,
                                     make_train_step)
from repro_torch.data import LMStream
from repro_torch.launch import train as ttrain
from repro_torch.models import flatten as tfl
from repro_torch.models import model as tmdl
from repro_torch.models.flatten import SEG_NAMES, init_flat_params
from tests.test_torch_gs_sgd import SPEC, _run


def _shapes(top_s=53760, top_r=512, n_cyc=6, cyc_s=9216, cyc_r=512):
    return {"top_s": (top_s,), "top_r": (top_r,),
            "cycles_s": (n_cyc, cyc_s), "cycles_r": (n_cyc, cyc_r)}


def _cell_shapes():
    """qwen3-4b at its published widths, 2 layers, tp = 1 (shapes only)."""
    cfg = dataclasses.replace(QWEN3_4B, n_layers=2)
    return local_seg_shapes(tfl.make_flat_spec(cfg, 1),
                            MeshAxes(tp=1, data=2, tp_axis=None), "dp")


# ---------------------------------------------------------------------------
# The plan: equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(6, 2), (5, 3), (2, 8), (7, 1), (2, 2),
                                 (36, 5), (1, 1)])
def test_chunk_plan_matches_reference(n, k):
    assert tfl.chunk_plan(n, k) == jfl.chunk_plan(n, k)


@pytest.mark.parametrize("shapes", ["reference_test", "smoke", "cell"])
@pytest.mark.parametrize("n_buckets,n_chunks", [(1, 1), (2, 2), (4, 1),
                                                (4, 2), (8, 3), (6, 6),
                                                (2, 4)])
def test_bucket_plan_matches_reference(shapes, n_buckets, n_chunks):
    if shapes == "reference_test":
        sh = _shapes()
    elif shapes == "smoke":
        sh = local_seg_shapes(
            tfl.make_flat_spec(TSpec.load(SPEC).arch_config(), 1),
            MeshAxes(tp=1, data=2, tp_axis=None), "dp")
    else:
        sh = _cell_shapes()
    assert tfl.packed_offsets(sh) == jfl.packed_offsets(sh)
    got, want = (tfl.bucket_plan(sh, n_buckets, n_chunks),
                 jfl.bucket_plan(sh, n_buckets, n_chunks))
    assert (got.sizes, got.readiness, got.n_events, got.chunks, got.order) \
        == (want.sizes, want.readiness, want.n_events, want.chunks,
            want.order)
    assert got.sizes == tfl.bucket_sizes(sh, n_buckets)


@pytest.mark.parametrize("shapes", ["reference_test", "cell"])
@pytest.mark.parametrize("n_buckets,n_chunks", [(1, 1), (4, 2), (8, 3)])
def test_plan_emits_tile_the_packed_vector(shapes, n_buckets, n_chunks):
    """The emitted slices cover the packed vector once, chunk K-1's rows
    first and the top last; each bucket's fragments cover the bucket once,
    and a bucket's readiness is its last fragment's event."""
    sh = _shapes() if shapes == "reference_test" else _cell_shapes()
    plan = tfl.bucket_plan(sh, n_buckets, n_chunks)
    K = len(plan.chunks)
    assert [e for _, _, e in plan.emits] == sorted(
        [K - 1 - c for c in range(K)] * 2 + [K, K])
    off = 0
    for lo, n, _ in sorted(plan.emits):
        assert lo == off
        off += n
    assert off == sum(plan.sizes) == sum(math.prod(s) for s in sh.values())
    start = 0
    for i, (size, frags) in enumerate(zip(plan.sizes, plan.fragments())):
        o = 0
        for lo, n in sorted(frags):
            assert lo == o and n > 0
            o += n
        assert o == size
        last = max(e for lo, n, e in plan.emits
                   if lo < start + size and start < lo + n)
        assert plan.readiness[i] == last
        start += size


def test_cell_plan_interleaves():
    """The full-width cell (qwen3-4b, 2 layers): at buckets = 2 both
    buckets wait for the whole backward; at buckets = 4 three events
    each complete a bucket."""
    sh = _cell_shapes()
    assert sum(math.prod(s) for s in sh.values()) == 590_820_864
    two = tfl.bucket_plan(sh, 2, 2)
    assert two.sizes == (388_956_160, 201_864_704)
    assert two.readiness == (2, 2)
    four = tfl.bucket_plan(sh, 4, 2)
    assert four.sizes == (259_304_107, 230_580_053, 100_931_072, 5_632)
    assert four.readiness == (2, 2, 1, 0)
    assert four.order == (3, 2, 0, 1)


# ---------------------------------------------------------------------------
# The chunked backward: bit-equal to the monolithic one
# ---------------------------------------------------------------------------


def _smoke_params_and_batch():
    spec = TSpec.load(SPEC)
    cfg = spec.arch_config()
    fs = tfl.make_flat_spec(cfg, 1)
    segs = init_flat_params(cfg, torch.Generator().manual_seed(0), 1, fs)
    t = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, spec.seq)))
    return cfg, fs, segs, {"tokens": t, "labels": t}


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_chunked_vjp_matches_monolithic_backward(chunks):
    cfg, fs, segs, batch = _smoke_params_and_batch()
    leaves = {k: v.clone().requires_grad_() for k, v in segs.items()}
    loss_m = tmdl.loss_fn(cfg, fs, leaves, batch)
    loss_m.backward()
    loss_c, steps, top = tmdl.chunked_loss_vjp(cfg, fs, segs, batch,
                                               chunks=chunks)
    assert float(loss_c) == float(loss_m.detach())
    assert len(steps) == min(chunks, fs.n_cycles)
    d_cs = torch.zeros_like(segs["cycles_s"])
    d_cr = torch.zeros_like(segs["cycles_r"])
    spans = []
    for s in steps:
        (a, b), g_cs, g_cr = s()
        spans.append((a, b))
        d_cs[a:b], d_cr[a:b] = g_cs, g_cr
    d_ts, d_tr = top()
    # emission is reverse-chunk order and the spans tile [0, n_cycles)
    assert spans == sorted(spans, reverse=True)
    assert spans[-1][0] == 0 and spans[0][1] == fs.n_cycles
    got = {"top_s": d_ts, "top_r": d_tr, "cycles_s": d_cs, "cycles_r": d_cr}
    for k in SEG_NAMES:
        assert torch.equal(got[k], leaves[k].grad), k


def test_chunked_vjp_makes_no_top_zeros_for_dense_chunks():
    """Dense chunks read no top parameter: their backward gives no top
    gradient, so only the epilogue and prologue add to top_s / top_r."""
    cfg, fs, segs, batch = _smoke_params_and_batch()
    _, steps, _ = tmdl.chunked_loss_vjp(cfg, fs, segs, batch, chunks=2)
    seen = []
    real = torch.autograd.grad

    def spy(outputs, inputs, **kw):
        out = real(outputs, inputs, **kw)
        seen.append([g is None for g in out])
        return out

    torch.autograd.grad = spy
    try:
        for s in steps:
            s()
    finally:
        torch.autograd.grad = real
    # epilogue (carry, ts, tr), chunk 1, chunk 0 (carry, cs, cr, ts, tr),
    # prologue (ts, tr): the chunks' ts / tr are None, tr unused by the
    # prologue
    assert seen == [[False, False, False],
                    [False, False, False, True, True],
                    [False, False, False, True, True],
                    [False, True]]


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _port_run(buckets, bwd_chunks=None, fuse_encode=False, steps=3, **ex):
    spec = TSpec.load(SPEC)
    spec = dataclasses.replace(spec, exchange=dataclasses.replace(
        spec.exchange, buckets=buckets, bwd_chunks=bwd_chunks,
        fuse_encode=fuse_encode, **ex))
    cfg, opt, _, ts = ttrain.build(spec, "cpu")
    params = init_flat_params(cfg, torch.Generator().manual_seed(0), 1, ts.fs)
    st = make_state(params, opt, ts.compressor, ts.d_local, ts.nworkers)
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                      global_batch=spec.batch, seed=spec.seed)
    losses = []
    for s in range(steps):
        st, m = ts.fn(st, ttrain.shard_batch(stream.global_batch_at(s, "cpu"),
                                             ts.nworkers))
        losses.append(float(m["loss"]))
    return st, losses, ts


@pytest.mark.parametrize("buckets", [1, 4])
def test_chunks1_bitexact_vs_bucketed(buckets):
    """bwd_chunks=1 runs the chunked backward and the readiness scheduler,
    and reproduces the bucketed step bit-exactly (as
    tests/test_readiness.py holds the reference)."""
    legacy, l_loss, ts_l = _port_run(buckets)
    ready, r_loss, ts_r = _port_run(buckets, bwd_chunks=1)
    assert ts_l.bwd_chunks == 0 and ts_r.bwd_chunks == 1
    assert ts_r.plan is not None and ts_r.plan.n_events == 2
    assert r_loss == l_loss
    for k in SEG_NAMES:
        assert torch.equal(ready["params"][k], legacy["params"][k]), k
    for a, b in zip(ready["ef"], legacy["ef"]):
        assert torch.equal(a, b)


def test_chunks2_bitexact_vs_bucketed():
    """K = 2 cuts the same graph, and the schedule reorders disjoint bucket
    chains: on the CPU the step is still bit-exact."""
    legacy, l_loss, _ = _port_run(4)
    inter, i_loss, ts = _port_run(4, bwd_chunks=2)
    assert ts.plan.n_events == 3 and ts.plan.readiness == (2, 1, 1, 0)
    assert i_loss == l_loss
    for k in SEG_NAMES:
        assert torch.equal(inter["params"][k], legacy["params"][k]), k


@pytest.mark.parametrize("ex", [dict(buckets=None),
                                dict(buckets=4, overlap=False),
                                dict(buckets=4, compressor="topk")])
def test_chunked_backward_without_interleave(ex):
    """Where the exchange cannot interleave (no buckets, overlap off, a
    compressor without stages), a chunked backward runs to its end and the
    gradient is reassembled in pack_segs order (``flat_of_chunks``): the
    step is the unchunked one's, bit for bit."""
    legacy, l_loss, _ = _port_run(steps=2, **ex)
    chunked, c_loss, ts = _port_run(bwd_chunks=2, steps=2, **ex)
    assert ts.bwd_chunks == 2 and c_loss == l_loss
    for k in SEG_NAMES:
        assert torch.equal(chunked["params"][k], legacy["params"][k]), k


def _span_order(ts, state, batch):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ts.fn(state, batch)
    names = ("forward", "backward", "encode", "allreduce", "recover",
             "optimizer")
    evs = [e for e in prof.events() if e.name.split("/")[0] in names]
    return [e.name for e in sorted(evs, key=lambda e: e.time_range.start)]


def _reference_order(plan, fused_frags):
    """The reference's program order, from the plan alone: chunk j's
    backward at event j, the top with the last chunk, then each bucket
    ready at that event encoded and reduced, recovery one bucket behind.
    ``fused_frags[ev]``: (the buckets fused partial encodes touch after
    that event's chunk emits, the same after the top emits)."""
    out, launched = ["forward"], []
    k = plan.n_events - 1
    for ev in range(plan.n_events):
        after_chunk, after_top = fused_frags.get(ev, ([], []))
        if ev < k:
            out.append(f"backward/chunk{ev}")
            out += [f"encode/b{i}" for i in after_chunk]
        if ev == k - 1:
            out.append("backward/top")
            out += [f"encode/b{i}" for i in after_top]
        for i in plan.order:
            if plan.readiness[i] != ev:
                continue
            out += [f"encode/b{i}", f"allreduce/b{i}"]
            launched.append(i)
            while len(launched) > 1:
                out.append(f"recover/b{launched.pop(0)}")
    out += [f"recover/b{i}" for i in launched] + ["optimizer"]
    return out


@pytest.mark.parametrize("fuse", [False, True])
def test_interleave_runs_in_the_reference_order(fuse):
    """Spans of one step (torch.profiler on the CPU), in start order: the
    reference's schedule at buckets 4, K 2 (readiness (2, 1, 1, 0))."""
    spec = TSpec.load(SPEC)
    spec = dataclasses.replace(spec, exchange=dataclasses.replace(
        spec.exchange, buckets=4, bwd_chunks=2, fuse_encode=fuse))
    cfg, opt, _, ts = ttrain.build(spec, "cpu")
    st = ts.init_state(opt, torch.Generator().manual_seed(0))
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                      global_batch=spec.batch, seed=spec.seed)
    batch = ttrain.shard_batch(stream.global_batch_at(0, "cpu"), ts.nworkers)
    # smoke buckets (35328, 36864, 18944, 512): chunk 1 emits cycles_s row
    # 1 (buckets 1, 2) then cycles_r row 1 (bucket 3); chunk 0 emits
    # cycles_s row 0 (buckets 0, 1) and cycles_r row 0 (bucket 2); the top
    # emits top_s and top_r (bucket 0 both)
    frags = ({0: ([1, 2, 3], []), 1: ([0, 1, 2], [0, 0])} if fuse else {})
    got = _span_order(ts, st, batch)
    assert got == _reference_order(ts.plan, frags)


def test_interleave_matches_reference():
    """Two steps at buckets 4, K 2 (unfused) against the JAX package's
    interleaved step, from the reference's params and batches."""
    jspec, tspec = JSpec.load(SPEC), TSpec.load(SPEC)
    ex = dict(buckets=4, bwd_chunks=2)
    jspec = dataclasses.replace(jspec, exchange=dataclasses.replace(
        jspec.exchange, **ex))
    tspec = dataclasses.replace(tspec, exchange=dataclasses.replace(
        tspec.exchange, **ex))
    _, opt, _, jts = j_build(jspec)
    _, topt, _, tts = ttrain.build(tspec, "cpu")
    assert jts.bwd_chunks == tts.bwd_chunks == 2
    assert jts.plan == tts.plan or (
        jts.plan.sizes, jts.plan.readiness) == (tts.plan.sizes,
                                                tts.plan.readiness)
    out = _run(jspec, jts, opt, tts, topt)
    np.testing.assert_allclose(out["t_loss"], out["j_loss"], rtol=1e-4)
    for step, (jefs, tefs) in enumerate(zip(out["j_ef"], out["t_ef"])):
        for b, (je, te) in enumerate(zip(jefs, tefs)):
            np.testing.assert_array_equal(te == 0, je == 0,
                                          err_msg=f"step {step} bucket {b}")
            np.testing.assert_allclose(te, je, rtol=1e-4, atol=1e-6)
    for k, v in out["t_params"].items():
        np.testing.assert_allclose(v, out["j_params"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_bwd_chunks_with_microbatch_raises_like_reference():
    from repro.core import gs_sgd as jgs
    from repro.optim import make as j_make_opt
    from repro_torch.optim import make as t_make_opt
    msgs = []
    for make, opt, ma, kw in (
            (jgs.make_train_step, j_make_opt("adamw", lr=1e-3),
             jgs.MeshAxes(tp=1, data=2, tp_axis=None), {}),
            (make_train_step, t_make_opt("adamw", lr=1e-3),
             MeshAxes(tp=1, data=2, tp_axis=None), {"device": "cpu"})):
        cfg = (JSpec if make is jgs.make_train_step
               else TSpec).load(SPEC).arch_config()
        with pytest.raises(ValueError, match="microbatch") as e:
            make(cfg, ma, opt, microbatch=1, bwd_chunks=2, buckets=2, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
