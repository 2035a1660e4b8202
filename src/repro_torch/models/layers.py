"""Block library: norms, RoPE, GQA self- and cross-attention, the
PaLM-style parallel attention+MLP block, SwiGLU MLP, embedding, LM loss,
and the serving pieces: one-token decode attention against a KV cache,
the cache append, full logits and the greedy argmax.

Port of ``repro/models/layers.py``. The reference's flash-style blockwise
attention is plain jnp, not a Pallas kernel, and so is the port's: KV
chunks of ``chunk`` = 1024 positions (the tail padded with ``kv_pos`` =
-1) under a running (m, l, o) online softmax, m and l in f32 and o in
the compute dtype, each chunk's scores computed as a recomputed region
(``models.remat.remat_call``) so the backward recomputes them and the
(S, T) matrix never exists. ``lm_loss`` runs the sequence in checkpointed
chunks of 1024 positions, summing (nll * w, w) chunk by chunk, so the
(B, S, V) logits never exist either. At T (S) <= chunk one chunk runs
with no combine step, so the result is bit for bit the one-pass
function's (the reference's combine from m = -1e30 reduces to it
exactly). The checkpoints apply only when autograd records; a serve
forward runs the same chunks plainly.

Tensor parallelism (``ctx``, a ``common.ShardCtx``; None is tp = 1): at
tp > 1 activations and the model-sharded weights are rank-stacked (a
leading dimension of size tp) and the blocks emit the reference's
collectives over it: column-parallel projections need none (``lin``
multiplies each rank's rows by its own shard), row-parallel ones psum
(``linear_row``), the vocab-sharded embedding and cross-entropy use the
masked local lookup with psum / pmax at each rank's vocab offset, and
``sharded_argmax`` picks the global winner. Replicated KV storage (kv <
tp) is sliced at each rank's KV head. Attention, like the reference's,
is independent per head, so the ranks' local heads run as one call with
the rank folded into the head axis (``ShardCtx.fold_heads``): the KV
cache holds the heads in that global order.

The attention blocks take the reference's ``mode``: ``"train"`` (the
default) returns the block's output alone, as before; ``"prefill"`` and
``"decode"`` return ``(output, cache)``. The KV cache a block is given
(``{"k": (B, T, Hkv, hd), "v": ...}``, a view into the model's stacked
cache) is written IN PLACE: prefill writes the prompt's K/V at [0, S)
and zeros after it, decode writes the new token's K/V at ``kv_len``.
The returned cache is that same dict.

``decode_attention`` is written with explicit ops, as the reference's:
scores, the mask to the finite ``_NEG_INF``, an f32 softmax, the cast,
then the product with V. Positions at or past ``kv_len`` get softmax
weight exactly 0, so finite garbage there (stale rows, reused paged
blocks) cannot change a bit of the output; a fused attention kernel
would sum in another order and break the paged/contiguous identity.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, ShardCtx, head_geometry
from repro_torch.models.remat import remat_call

_NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, delta: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with gain stored as a delta around 1 (zero-init friendly)."""
    xf = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((1.0 + delta.to(torch.float32)) * xf * rms).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """theta ** (-j / half) for j < half, f32, on ``device``. Made once per
    (theta, half, device): building the base tensor is a host-to-device
    copy, which syncs the card, and a layer calls rope twice a step."""
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd), pos: (B, S) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _rope_freqs(theta, half, x.device)
    ang = pos[..., None].to(torch.float32) * freqs          # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def lin(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``. A rank-stacked ``w`` (tp, k, n) multiplies each rank's
    rows of the rank-stacked ``x`` (tp, ..., k) by its own shard."""
    if w.ndim == 2:
        return x @ w
    return torch.matmul(x.reshape(w.shape[0], -1, x.shape[-1]), w).reshape(
        x.shape[:-1] + (w.shape[-1],))


def linear_row(x: torch.Tensor, w: torch.Tensor,
               ctx: ShardCtx | None = None) -> torch.Tensor:
    """Row-parallel matmul: local contraction + psum over the model axis."""
    y = lin(x, w.to(x.dtype))
    return y if ctx is None else ctx.psum_tp(y)


def ranked_vec(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A rank-stacked vector leaf (tp, n) shaped to broadcast against the
    rank-stacked ``x`` (tp, ..., n); an unranked leaf as it is."""
    if v.ndim == 1:
        return v
    return v.reshape(v.shape[:1] + (1,) * (x.ndim - v.ndim) + v.shape[1:])


def _kv_slice(w: torch.Tensor, hd: int, cfg: ArchConfig,
              ctx: ShardCtx | None) -> torch.Tensor:
    """Each rank's KV-head columns of replicated KV storage (kv < tp): rank
    r reads KV head floor(r * kv / tp), as the reference's dynamic slice
    at ``tp_rank()``; the result is rank-stacked (tp, d, hd)."""
    if ctx is None or not ctx.ranked:
        return w
    g = head_geometry(cfg, ctx.tp)
    if not g.kv_replicated:
        return w
    heads = [r * g.nkv // ctx.tp for r in ctx.ranks()]
    return torch.stack([w[:, h * hd:(h + 1) * hd] for h in heads])


def _attn_chunk(qt: torch.Tensor, k_c: torch.Tensor, v_c: torch.Tensor,
                bias: torch.Tensor, scale: float):
    """One online-softmax step over a KV chunk (grouped GQA heads):
    qt (B,G,R,S,hd), k_c / v_c (B,G,Ck,hd), bias (B,1,1,S,Ck) additive
    -> (m (B,G,R,S) f32, l (B,G,R,S) f32, o (B,G,R,S,hd) compute dtype)."""
    s = torch.einsum("bgrqd,bgkd->bgrqk", qt, k_c).to(torch.float32) * scale
    s = s + bias
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(qt.dtype), v_c)
    return m[..., 0], l, o


def _bias(q_pos: torch.Tensor, kv_pos: torch.Tensor,
          causal: bool) -> torch.Tensor:
    """The additive mask (B,1,1,S,Ck): 0 where a key is valid (kv_pos >=
    0, and at or before the query when causal), -1e30 elsewhere."""
    valid = (kv_pos >= 0)[:, None, None, None, :]
    if causal:
        valid = valid & (q_pos[:, None, None, :, None]
                         >= kv_pos[:, None, None, None, :])
    return torch.where(valid, 0.0, _NEG_INF)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_pos: torch.Tensor,
                        kv_pos: torch.Tensor,
                        chunk: int = 1024) -> torch.Tensor:
    """Flash-style GQA attention. q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd) ->
    (B,S,Hq,hd).

    Computed in grouped form (KV heads never repeated in memory), with the
    reference's additive -1e30 mask and its max(l, 1e-20) guard, over KV
    chunks of ``chunk`` positions (module docstring): live memory O(S *
    chunk), each chunk's scores recomputed in the backward.
    """
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    rep = Hq // Hkv
    scale = hd ** -0.5
    qt = q.permute(0, 2, 1, 3).reshape(B, Hkv, rep, S, hd)
    kt = k.permute(0, 2, 1, 3)                              # (B,Hkv,T,hd)
    vt = v.permute(0, 2, 1, 3)
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:
        kt = F.pad(kt, (0, 0, 0, pad))
        vt = F.pad(vt, (0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    n_chunks = (T + pad) // chunk
    if n_chunks == 1:
        _, l, o = remat_call(_attn_chunk, qt, kt, vt,
                             _bias(q_pos, kv_pos, causal), scale)
    else:
        m = torch.full((B, Hkv, rep, S), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, rep, S), dtype=torch.float32,
                        device=q.device)
        o = torch.zeros((B, Hkv, rep, S, hd), dtype=q.dtype, device=q.device)
        for c in range(n_chunks):
            cols = slice(c * chunk, (c + 1) * chunk)
            m_c, l_c, o_c = remat_call(
                _attn_chunk, qt, kt[:, :, cols], vt[:, :, cols],
                _bias(q_pos, kv_pos[:, cols], causal), scale)
            m_new = torch.maximum(m, m_c)
            a = torch.exp(m - m_new)
            b = torch.exp(m_c - m_new)
            l = a * l + b * l_c
            o = (o * a[..., None].to(q.dtype)
                 + o_c * b[..., None].to(q.dtype))
            m = m_new
    out = o / torch.clamp(l, min=1e-20)[..., None].to(q.dtype)
    return out.reshape(B, Hq, S, hd).permute(0, 2, 1, 3)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len) -> torch.Tensor:
    """One-token attention against a cache. q: (B,1,Hq,hd); caches:
    (B,T,Hkv,hd); kv_len: an int or 0-dim tensor, or a (B,) tensor of
    per-row valid lengths (continuous batching), counting the new token.
    Positions >= kv_len are masked to the finite -1e30, whose softmax
    weight underflows to exactly 0."""
    B, S, Hq, hd = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = Hq // Hkv
    # grouped: the rep q heads of a KV head and the S queries are rows of
    # one product (matmul, not einsum: the latter parses its equation on
    # every call, and decode is host bound)
    qg = q.permute(0, 2, 1, 3).reshape(B, Hkv, rep * S, hd)
    kt = k_cache.permute(0, 2, 3, 1)                        # (B,Hkv,hd,T)
    vg = v_cache.permute(0, 2, 1, 3)                        # (B,Hkv,T,hd)
    s = torch.matmul(qg, kt).to(torch.float32) * hd ** -0.5
    lens = torch.as_tensor(kv_len, device=q.device)
    if lens.ndim:                                           # per-row lengths
        lens = lens.reshape(B, 1, 1, 1)
    mask = torch.arange(T, device=q.device)[None, None, None, :] < lens
    s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.matmul(p, vg)                                 # (B,Hkv,rep*S,hd)
    return o.reshape(B, Hq, S, hd).permute(0, 2, 1, 3)


def _cache_append(cache: dict, k: torch.Tensor, v: torch.Tensor,
                  kv_len) -> tuple[torch.Tensor, torch.Tensor]:
    """Write this step's K/V (B, S, Hkv, hd) at ``kv_len`` into the cache
    time axis, in place. Scalar ``kv_len``: every row at the same
    position; a (B,) tensor: each row at its own (continuous batching).
    Positions are written by index, so a tensor ``kv_len`` needs no host
    read; the caller keeps ``kv_len + S <= T``."""
    kc, vc = cache["k"], cache["v"]
    B, S = k.shape[:2]
    lens = torch.as_tensor(kv_len, device=kc.device)
    t = torch.arange(S, device=kc.device)
    if lens.ndim:
        rows = torch.arange(B, device=kc.device)[:, None]
        idx = (rows, lens.reshape(B, 1) + t)
    else:
        idx = (slice(None), lens + t)
    kc[idx] = k.to(kc.dtype)
    vc[idx] = v.to(vc.dtype)
    return kc, vc


def _prefill_write(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """The prompt's K/V at [0, S) of the cache, zeros after (the
    reference's padded write), in place."""
    S = k.shape[1]
    for name, new in (("k", k), ("v", v)):
        cache[name][:, :S] = new.to(cache[name].dtype)
        cache[name][:, S:] = 0
    return cache


def _self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos: torch.Tensor, mode: str, cache: dict | None,
                    kv_len, dtype: torch.dtype):
    """Causal self-attention of one block in ``mode``: (o, new cache)."""
    if mode == "decode":
        k_cache, v_cache = _cache_append(cache, k, v, kv_len)
        o = decode_attention(q, k_cache.to(dtype), v_cache.to(dtype),
                             torch.as_tensor(kv_len, device=q.device)
                             + q.shape[1])
        return o, cache
    o = blockwise_attention(q, k, v, causal=True, q_pos=pos, kv_pos=pos)
    if mode == "prefill":
        return o, _prefill_write(cache, k, v)
    return o, None


def attention_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                    pos: torch.Tensor,
                    cross_kv: torch.Tensor | None = None, *,
                    mode: str = "train", cache: dict | None = None,
                    kv_len=None, ctx: ShardCtx | None = None):
    """Pre-norm attention block. x: (B,S,d).

    With ``cross_kv`` (the vlm's (B, n_cross, d) precomputed patch
    embeddings) the keys and values come from ``rmsnorm(cross_kv,
    kv_norm)``, without RoPE, and every query sees every patch
    (non-causal over kv_pos = 0; in decode, ``decode_attention`` over all
    n_cross keys). Cross K/V is static and never cached. Without it the
    block is causal self-attention with RoPE, as the reference runs a
    ``cross`` layer whose batch carries no ``cross_kv`` (``kv_norm`` then
    gets a zero gradient).

    mode "train" returns the output; "prefill" (the prompt from position
    0, its K/V written into ``cache``) and "decode" (S == 1 token appended
    at ``kv_len``, the valid length before it) return ``(output, cache)``.
    At tp > 1 (``ctx``) ``x`` is rank-stacked (tp, B, S, d) and the cache
    holds the ranks' KV heads folded into its head axis.
    """
    hd = cfg.hd
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    B, S = h.shape[-3:-1]
    q = lin(h, p["wq"].to(h.dtype)).reshape(h.shape[:-1] + (-1, hd))
    kv_src = h
    if cross_kv is not None:
        kv_src = rmsnorm(cross_kv.to(h.dtype), p["kv_norm"], cfg.norm_eps)
        if ctx is not None and ctx.ranked:
            kv_src = kv_src.expand((ctx.lead,) + kv_src.shape)
    T = kv_src.shape[-2]
    wk = _kv_slice(p["wk"], hd, cfg, ctx).to(h.dtype)
    wv = _kv_slice(p["wv"], hd, cfg, ctx).to(h.dtype)
    k = lin(kv_src, wk).reshape(kv_src.shape[:-1] + (-1, hd))
    v = lin(kv_src, wv).reshape(kv_src.shape[:-1] + (-1, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    new_cache = None
    fold = ctx.fold_heads if ctx is not None else (lambda t: t)
    if cross_kv is None:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        o, new_cache = _self_attention(fold(q), fold(k), fold(v), pos, mode,
                                       cache, kv_len, h.dtype)
    elif mode == "decode":
        o = decode_attention(fold(q), fold(k).to(h.dtype),
                             fold(v).to(h.dtype), T)
        new_cache = cache
    else:
        kv_pos = torch.zeros((B, T), dtype=pos.dtype, device=pos.device)
        o = blockwise_attention(fold(q), fold(k), fold(v), causal=False,
                                q_pos=pos, kv_pos=kv_pos)
        new_cache = cache
    if ctx is not None:
        o = ctx.unfold_heads(o)
    y = linear_row(o.reshape(h.shape[:-1] + (-1,)), p["wo"], ctx)
    out = x + y.to(x.dtype)
    return out if mode == "train" else (out, new_cache)


def parallel_attn_mlp_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                            pos: torch.Tensor, *, mode: str = "train",
                            cache: dict | None = None, kv_len=None,
                            ctx: ShardCtx | None = None):
    """PaLM-style parallel block: attention and MLP branch from one norm
    each and their outputs are summed before the residual add, in the
    reference's one row-parallel psum. ``mode`` and ``ctx`` as
    ``attention_block``'s."""
    hd = cfg.hd
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    lead = h.shape[:-1]
    q = lin(h, p["wq"].to(h.dtype)).reshape(lead + (-1, hd))
    k = lin(h, _kv_slice(p["wk"], hd, cfg, ctx).to(h.dtype)).reshape(
        lead + (-1, hd))
    v = lin(h, _kv_slice(p["wv"], hd, cfg, ctx).to(h.dtype)).reshape(
        lead + (-1, hd))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    fold = ctx.fold_heads if ctx is not None else (lambda t: t)
    o, new_cache = _self_attention(fold(q), fold(k), fold(v), pos, mode,
                                   cache, kv_len, h.dtype)
    if ctx is not None:
        o = ctx.unfold_heads(o)
    mp = p["mlp"]
    hm = rmsnorm(x, mp["norm"], cfg.norm_eps)
    act = (F.silu(lin(hm, mp["wg"].to(h.dtype)))
           * lin(hm, mp["wu"].to(h.dtype)))
    y = (lin(o.reshape(lead + (-1,)), p["wo"].to(h.dtype))
         + lin(act, mp["wo"].to(h.dtype)))
    if ctx is not None:
        y = ctx.psum_tp(y)                   # the ONE collective
    out = x + y.to(x.dtype)
    return out if mode == "train" else (out, new_cache)


def mlp_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
              ctx: ShardCtx | None = None) -> torch.Tensor:
    """Pre-norm SwiGLU MLP, column- then row-parallel."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    gate = lin(h, p["wg"].to(h.dtype))
    up = lin(h, p["wu"].to(h.dtype))
    y = linear_row(F.silu(gate) * up, p["wo"].to(h.dtype), ctx)
    return x + y.to(x.dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 dtype: torch.dtype,
                 ctx: ShardCtx | None = None) -> torch.Tensor:
    """Embedding lookup (ids outside the table read zeros, as the
    reference's masked take). At tp > 1 the table is vocab-sharded
    (tp, V_loc, d): each rank looks up the ids in its own vocab range,
    masked, and the psum assembles the rows."""
    if ctx is None or not ctx.ranked:
        v = table.shape[0]
        ok = (ids >= 0) & (ids < v)
        emb = table[torch.clamp(ids, 0, v - 1)]
        return torch.where(ok[..., None], emb, 0.0).to(dtype)
    v_loc = table.shape[1]
    local = ids - ctx.rank_offsets(v_loc, ids.ndim + 1, ids.device)
    ok = (local >= 0) & (local < v_loc)
    ranks = torch.arange(ctx.lead, device=ids.device).reshape(
        (ctx.lead,) + (1,) * ids.ndim)
    emb = table[ranks, torch.clamp(local, 0, v_loc - 1)]
    emb = torch.where(ok[..., None], emb, 0.0)
    return ctx.psum_tp(emb).to(dtype)


def _vocab_cols(cfg: ArchConfig, v_loc: int, ndim: int, device,
                ctx: ShardCtx | None):
    """(start, col_valid): each rank's first global vocab id and which of
    its V_loc columns are real ids (< vocab_size), shaped to broadcast
    against logits of ``ndim`` dims."""
    start = (0 if ctx is None
             else ctx.rank_offsets(v_loc, ndim - 1, device))
    cols = torch.arange(v_loc, device=device)
    if isinstance(start, torch.Tensor):
        cols = cols + start[..., None]
    return start, cols < cfg.vocab_size


def _loss_sums(hidden: torch.Tensor, head_w: torch.Tensor,
               labels: torch.Tensor, cfg: ArchConfig,
               ctx: ShardCtx | None):
    """One sequence chunk's (sum of nll * w, sum of w): its logits, the
    label's, the partition sum (module docstring of ``lm_loss``)."""
    v_loc = head_w.shape[-1]
    start, col_valid = _vocab_cols(cfg, v_loc, hidden.ndim, hidden.device,
                                   ctx)
    logits = lin(hidden, head_w.to(hidden.dtype)).to(torch.float32)
    logits = torch.where(col_valid, logits, _NEG_INF)
    m = torch.amax(logits, dim=-1).detach()   # stability only
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
    return tot, torch.sum(w)


def lm_loss(hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
            cfg: ArchConfig, ctx: ShardCtx | None = None, *,
            chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy over the padded vocab.

    hidden: (B,S,d); head_w: (d, V_pad); labels: (B,S) with -1 = ignore.
    Padding columns (ids >= vocab_size) are masked to -1e30. The sequence
    runs in checkpointed chunks of ``chunk`` positions (the tail padded
    with zero rows labelled -1), their (nll * w, w) sums added chunk by
    chunk, so (B, S, V) logits never exist at once. At tp > 1
    (rank-stacked hidden and head, (tp, d, V_loc)) the logits stay
    vocab-sharded: the max is pmax'd (stability only, no gradient), the
    partition sum and the label's logit psum'd; every rank gets the same
    loss, a (tp,) tensor.
    """
    S = hidden.shape[-2]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = cnt = None
    for c in range(0, S + pad, chunk):
        s_c, w_c = remat_call(
            lambda h, lab: _loss_sums(h, head_w, lab, cfg, ctx),
            hidden[..., c:c + chunk, :], labels[..., c:c + chunk])
        tot = s_c if tot is None else tot + s_c
        cnt = w_c if cnt is None else cnt + w_c
    return tot / torch.clamp(cnt, min=1.0)


def lm_logits(hidden: torch.Tensor, head_w: torch.Tensor,
              cfg: ArchConfig, ctx: ShardCtx | None = None) -> torch.Tensor:
    """Full f32 logits for decode: (B,S,d) -> (B,S,V_pad), the padding
    columns (ids >= vocab_size) masked to -1e30; vocab-sharded (tp, B, S,
    V_loc) at tp > 1."""
    logits = lin(hidden, head_w.to(hidden.dtype)).to(torch.float32)
    _, col_valid = _vocab_cols(cfg, head_w.shape[-1], hidden.ndim,
                               hidden.device, ctx)
    return torch.where(col_valid, logits, _NEG_INF)


def sharded_argmax(logits: torch.Tensor,
                   ctx: ShardCtx | None = None) -> torch.Tensor:
    """Greedy token (..., V) -> (...) int32, ties to the lowest index
    (``torch.argmax`` returns the first maximal value). At tp > 1 over
    vocab-sharded (tp, ..., V_loc) logits: each rank's local argmax at
    its vocab offset, the pmax of the maxima picks the winners and the
    lowest global id among them wins (the reference's pmin); every rank
    gets the same (tp, ...) ids."""
    if ctx is None or not ctx.ranked:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    v_loc = logits.shape[-1]
    loc_max = torch.amax(logits, dim=-1)
    loc_idx = (torch.argmax(logits, dim=-1)
               + ctx.rank_offsets(v_loc, loc_max.ndim, logits.device)
               ).to(torch.int32)
    gmax = ctx.pmax_tp(loc_max)
    cand = torch.where(loc_max >= gmax, loc_idx,
                       torch.full_like(loc_idx, 2 ** 30))
    return -ctx.pmax_tp(-cand)
