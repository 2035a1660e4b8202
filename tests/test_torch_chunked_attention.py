"""Port parity: the chunked ``blockwise_attention`` and the chunked
``lm_loss`` (``repro_torch.models.layers``) against the reference's
(``repro.models.layers``), and against the port's one-pass functions they
replace.

Past one chunk (a small ``chunk`` so the shapes stay small: T and S not
multiples of it, so the tail is padded; causal and not; GQA 4/2, MHA and
4/1) values and gradients (torch autograd against ``jax.grad`` of the
same cotangent-weighted sum) in f32 within the bounds below, stated
before the first reading: the two packages run the same online softmax
and the same chunk sums in f32, so they differ by summation order only.
At T, S <= chunk the functions are bit-equal to the one-pass versions
(copied below as they were before the chunks): one chunk runs, with no
combine step. The tp = 2 loss (rank-stacked hidden and head, vocab
-sharded) is held to the one-pass tp = 2 loss the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlay
from repro.models.common import ShardCtx as JCtx
from repro_torch.configs import SMOKES
from repro_torch.models import layers as tlay
from repro_torch.models.common import ShardCtx

ATTN_ATOL = 5e-6          # values, O(1) inputs
ATTN_GRAD_ATOL = 5e-5     # gradients
LOSS_RTOL = 2e-6
LOSS_GRAD_ATOL = 2e-6


def one_pass_attention(q, k, v, *, causal, q_pos, kv_pos):
    """The port's blockwise_attention before the KV chunks."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = hd ** -0.5
    qt = q.permute(0, 2, 1, 3).reshape(B, Hkv, rep, S, hd)
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qt, kt).to(torch.float32) * scale
    valid = (kv_pos >= 0)[:, None, None, None, :]
    if causal:
        ok = q_pos[:, None, None, :, None] >= kv_pos[:, None, None, None, :]
        valid = valid & ok
    s = s + torch.where(valid, 0.0, tlay._NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(q.dtype), vt)
    out = o / torch.clamp(l, min=1e-20)[..., None].to(q.dtype)
    return out.reshape(B, Hq, S, hd).permute(0, 2, 1, 3)


def one_pass_loss(hidden, head_w, labels, cfg, ctx=None):
    """The port's lm_loss before the sequence chunks."""
    v_loc = head_w.shape[-1]
    start, col_valid = tlay._vocab_cols(cfg, v_loc, hidden.ndim,
                                        hidden.device, ctx)
    logits = tlay.lin(hidden, head_w.to(hidden.dtype)).to(torch.float32)
    logits = torch.where(col_valid, logits, tlay._NEG_INF)
    m = torch.amax(logits, dim=-1).detach()
    psum = ctx.psum_tp if ctx is not None else (lambda t: t)
    if ctx is not None:
        m = ctx.pmax_tp(m)
    z = psum(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    loc = labels - start
    ok = (loc >= 0) & (loc < v_loc)
    picked = torch.gather(logits, -1,
                          torch.clamp(loc, 0, v_loc - 1)[..., None])[..., 0]
    label_logit = psum(torch.where(ok, picked, 0.0))
    nll = torch.log(z) + m - label_logit
    w = (labels >= 0).to(torch.float32)
    tot = (torch.sum(nll * w, dim=(-2, -1)) if hidden.ndim == 4
           else torch.sum(nll * w))
    return tot / torch.clamp(torch.sum(w), min=1.0)


def _inputs(seed, B, S, T, hq, hkv, hd):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, hq, hd).astype(np.float32)
    k = rs.randn(B, T, hkv, hd).astype(np.float32)
    v = rs.randn(B, T, hkv, hd).astype(np.float32)
    cot = rs.randn(B, S, hq, hd).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(T - S, T), (B, S)).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32).copy()
    kv_pos[0, -3:] = -1            # a row with invalid keys
    return q, k, v, cot, q_pos, kv_pos


def _torch_attn(fn, q, k, v, cot, q_pos, kv_pos, causal, **kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(qt, kt, vt, causal=causal, q_pos=torch.from_numpy(q_pos),
             kv_pos=torch.from_numpy(kv_pos), **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (4, 1)])
def test_chunked_attention_matches_reference(hq, hkv, causal):
    B, S, T, hd, chunk = 2, 13, 21, 8, 8        # 3 chunks, the last padded
    q, k, v, cot, q_pos, kv_pos = _inputs(hq * 7 + hkv, B, S, T, hq, hkv, hd)

    def jfn(q, k, v):
        out = jlay.blockwise_attention(q, k, v, causal=causal,
                                       q_pos=jnp.asarray(q_pos),
                                       kv_pos=jnp.asarray(kv_pos),
                                       chunk=chunk)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got, tgrads = _torch_attn(tlay.blockwise_attention, q, k, v, cot, q_pos,
                              kv_pos, causal, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_ATOL)
    for name, g, w in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATTN_GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("T,chunk", [(16, 16), (16, 1024), (9, 16)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_one_chunk_attention_bit_equal_one_pass(T, chunk, causal):
    B, S, hq, hkv, hd = 2, min(T, 12), 4, 2, 8
    q, k, v, cot, q_pos, kv_pos = _inputs(T + chunk, B, S, T, hq, hkv, hd)
    got, g_got = _torch_attn(tlay.blockwise_attention, q, k, v, cot, q_pos,
                             kv_pos, causal, chunk=chunk)
    want, g_want = _torch_attn(one_pass_attention, q, k, v, cot, q_pos,
                               kv_pos, causal)
    assert torch.equal(got, want)
    for g, w in zip(g_got, g_want):
        assert torch.equal(g, w)


def _loss_inputs(seed, B, S, d, V):
    rs = np.random.RandomState(seed)
    hid = rs.randn(B, S, d).astype(np.float32)
    head = (0.3 * rs.randn(d, V)).astype(np.float32)
    labels = rs.randint(0, V, (B, S)).astype(np.int64)
    labels[0, :3] = -1
    labels[1, -2:] = V + 5            # beyond the head: no label logit
    return hid, head, labels


def _torch_loss(fn, hid, head, labels, cfg, **kw):
    h, w = (torch.from_numpy(a).requires_grad_() for a in (hid, head))
    loss = fn(h, w, torch.from_numpy(labels), cfg, **kw)
    loss.sum().backward()
    return loss.detach(), (h.grad, w.grad)


@pytest.mark.parametrize("S,chunk", [(23, 8), (24, 8), (40, 16)])
def test_chunked_loss_matches_reference(S, chunk):
    cfg = SMOKES["qwen3-4b"]
    V = cfg.vocab_size + 16             # padding columns, masked
    hid, head, labels = _loss_inputs(S, 3, S, 16, V)

    def jfn(h, w):
        return jlay.lm_loss(h, w, jnp.asarray(labels), cfg,
                            JCtx(dtype=jnp.float32), chunk=chunk)

    want, jgrads = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(hid), jnp.asarray(head))
    got, tgrads = _torch_loss(tlay.lm_loss, hid, head, labels, cfg,
                              chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOSS_RTOL)
    for name, g, w in zip(("hidden", "head"), tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=LOSS_GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("S,chunk", [(16, 16), (9, 1024)])
def test_one_chunk_loss_bit_equal_one_pass(S, chunk):
    cfg = SMOKES["qwen3-4b"]
    hid, head, labels = _loss_inputs(S, 3, S, 16, cfg.vocab_size + 16)
    got, g_got = _torch_loss(tlay.lm_loss, hid, head, labels, cfg,
                             chunk=chunk)
    want, g_want = _torch_loss(one_pass_loss, hid, head, labels, cfg)
    assert torch.equal(got, want)
    for g, w in zip(g_got, g_want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("S,chunk", [(12, 1024), (21, 8)])
def test_tp2_loss_chunks(S, chunk):
    """Rank-stacked (tp = 2) hidden and vocab-sharded head: bit-equal to
    the one-pass tp = 2 loss in one chunk, within LOSS_RTOL past it."""
    cfg = SMOKES["qwen3-4b"]
    tp, d, v_loc = 2, 16, (cfg.vocab_size + 16) // 2
    rs = np.random.RandomState(S)
    h = rs.randn(3, S, d).astype(np.float32)
    hid = np.broadcast_to(h, (tp, 3, S, d)).copy()
    head = (0.3 * rs.randn(tp, d, v_loc)).astype(np.float32)
    labels = rs.randint(0, cfg.vocab_size, (3, S)).astype(np.int64)
    labels[2, :2] = -1
    ctx = ShardCtx(tp=2, dtype=torch.float32)
    got, g_got = _torch_loss(tlay.lm_loss, hid, head, labels, cfg, ctx=ctx,
                             chunk=chunk)
    want, g_want = _torch_loss(one_pass_loss, hid, head, labels, cfg,
                               ctx=ctx)
    assert got.shape == (tp,) and torch.equal(got[0], got[1])
    if S <= chunk:
        assert torch.equal(got, want)
        for g, w in zip(g_got, g_want):
            assert torch.equal(g, w)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=LOSS_RTOL)
        for g, w in zip(g_got, g_want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=LOSS_GRAD_ATOL)


def test_serve_forward_runs_the_chunks_without_checkpoint():
    """Under no_grad (the serve path) the chunks run plainly and give
    what the recorded forward gives."""
    q, k, v, _, q_pos, kv_pos = _inputs(5, 1, 10, 30, 4, 2, 8)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    kw = dict(causal=True, q_pos=torch.from_numpy(q_pos),
              kv_pos=torch.from_numpy(kv_pos), chunk=8)
    with torch.no_grad():
        plain = tlay.blockwise_attention(*args, **kw)
    rec = tlay.blockwise_attention(*(a.requires_grad_() for a in args), **kw)
    assert torch.equal(plain, rec.detach())
