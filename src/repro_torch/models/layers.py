"""Block library at tp=1: norms, RoPE, GQA self- and cross-attention, the
PaLM-style parallel attention+MLP block, SwiGLU MLP, embedding, LM loss,
and the serving pieces: one-token decode attention against a KV cache,
the cache append, full logits and the greedy argmax.

Port of ``repro/models/layers.py`` (single device). The reference's
flash-style blockwise attention is plain jnp, not a Pallas kernel; here
it is written as plain f32 softmax attention, which is the same function
(the reference's online softmax over one KV chunk reduces to it exactly).

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

from repro_torch.models.common import ArchConfig

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


def linear_row(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Row-parallel matmul; at tp=1 the reference's psum is the identity."""
    return x @ w.to(x.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_pos: torch.Tensor,
                        kv_pos: torch.Tensor) -> torch.Tensor:
    """GQA attention. q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd) -> (B,S,Hq,hd).

    Computed in grouped form (KV heads never repeated in memory), with the
    reference's additive -1e30 mask and its max(l, 1e-20) guard.
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
    s = torch.einsum("bgrqd,bgkd->bgrqk", qt, kt).to(torch.float32) * scale
    valid = (kv_pos >= 0)[:, None, None, None, :]
    if causal:
        ok = q_pos[:, None, None, :, None] >= kv_pos[:, None, None, None, :]
        valid = valid & ok
    s = s + torch.where(valid, 0.0, _NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p.to(q.dtype), vt)
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
                    kv_len=None):
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
    """
    hd = cfg.hd
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    B, S, _ = h.shape
    q = (h @ p["wq"].to(h.dtype)).reshape(B, S, -1, hd)
    kv_src = h
    if cross_kv is not None:
        kv_src = rmsnorm(cross_kv.to(h.dtype), p["kv_norm"], cfg.norm_eps)
    T = kv_src.shape[1]
    k = (kv_src @ p["wk"].to(h.dtype)).reshape(B, T, -1, hd)
    v = (kv_src @ p["wv"].to(h.dtype)).reshape(B, T, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    new_cache = None
    if cross_kv is None:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
        o, new_cache = _self_attention(q, k, v, pos, mode, cache, kv_len,
                                       h.dtype)
    elif mode == "decode":
        o = decode_attention(q, k.to(h.dtype), v.to(h.dtype), T)
        new_cache = cache
    else:
        kv_pos = torch.zeros((B, T), dtype=pos.dtype, device=pos.device)
        o = blockwise_attention(q, k, v, causal=False, q_pos=pos,
                                kv_pos=kv_pos)
        new_cache = cache
    y = linear_row(o.reshape(B, S, -1), p["wo"])
    out = x + y.to(x.dtype)
    return out if mode == "train" else (out, new_cache)


def parallel_attn_mlp_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                            pos: torch.Tensor, *, mode: str = "train",
                            cache: dict | None = None, kv_len=None):
    """PaLM-style parallel block: attention and MLP branch from one norm
    each and their outputs are summed before the residual add (the
    reference's one row-parallel psum). ``mode`` as ``attention_block``'s."""
    hd = cfg.hd
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    B, S, _ = h.shape
    q = (h @ p["wq"].to(h.dtype)).reshape(B, S, -1, hd)
    k = (h @ p["wk"].to(h.dtype)).reshape(B, S, -1, hd)
    v = (h @ p["wv"].to(h.dtype)).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o, new_cache = _self_attention(q, k, v, pos, mode, cache, kv_len,
                                   h.dtype)
    mp = p["mlp"]
    hm = rmsnorm(x, mp["norm"], cfg.norm_eps)
    act = F.silu(hm @ mp["wg"].to(h.dtype)) * (hm @ mp["wu"].to(h.dtype))
    y = (o.reshape(B, S, -1) @ p["wo"].to(h.dtype)
         + act @ mp["wo"].to(h.dtype))
    out = x + y.to(x.dtype)
    return out if mode == "train" else (out, new_cache)


def mlp_block(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm SwiGLU MLP."""
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    gate = h @ p["wg"].to(h.dtype)
    up = h @ p["wu"].to(h.dtype)
    y = (F.silu(gate) * up) @ p["wo"].to(h.dtype)
    return x + y.to(x.dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup (ids outside the table read zeros, as the
    reference's masked take)."""
    v = table.shape[0]
    ok = (ids >= 0) & (ids < v)
    emb = table[torch.clamp(ids, 0, v - 1)]
    return torch.where(ok[..., None], emb, 0.0).to(dtype)


def lm_loss(hidden: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token cross-entropy over the padded vocab.

    hidden: (B,S,d); head_w: (d, V_pad); labels: (B,S) with -1 = ignore.
    Padding columns (ids >= vocab_size) are masked to -1e30.
    """
    v_pad = head_w.shape[1]
    col_valid = torch.arange(v_pad, device=hidden.device) < cfg.vocab_size
    logits = (hidden @ head_w.to(hidden.dtype)).to(torch.float32)
    logits = torch.where(col_valid, logits, _NEG_INF)
    m = torch.amax(logits, dim=-1).detach()   # stability only
    z = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    ok = (labels >= 0) & (labels < v_pad)
    picked = torch.gather(logits, -1,
                          torch.clamp(labels, 0, v_pad - 1)[..., None])[..., 0]
    label_logit = torch.where(ok, picked, 0.0)
    nll = torch.log(z) + m - label_logit
    w = (labels >= 0).to(torch.float32)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def lm_logits(hidden: torch.Tensor, head_w: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    """Full f32 logits for decode: (B,S,d) -> (B,S,V_pad), the padding
    columns (ids >= vocab_size) masked to -1e30."""
    logits = (hidden @ head_w.to(hidden.dtype)).to(torch.float32)
    col_valid = torch.arange(head_w.shape[1],
                             device=hidden.device) < cfg.vocab_size
    return torch.where(col_valid, logits, _NEG_INF)


def sharded_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token (..., V) -> (...) int32. At tp = 1 the reference's
    cross-shard pmax is the identity; ties go to the lowest index, as
    ``torch.argmax`` returns the first maximal value."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
