"""Block library for the dense family at tp=1: norms, RoPE, GQA attention,
SwiGLU MLP, embedding, LM loss.

Port of ``repro/models/layers.py`` (``mode="train"``, single device). The
reference's flash-style blockwise attention is plain jnp, not a Pallas
kernel; here it is written as plain f32 softmax attention, which is the
same function (the reference's online softmax over one KV chunk reduces
to it exactly).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig

_NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, delta: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with gain stored as a delta around 1 (zero-init friendly)."""
    xf = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((1.0 + delta.to(torch.float32)) * xf * rms).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd), pos: (B, S) int."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = pos[..., None].to(torch.float32) * freqs          # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


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


def attention_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Pre-norm causal self-attention block (train mode). x: (B,S,d)."""
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
    o = blockwise_attention(q, k, v, causal=True, q_pos=pos, kv_pos=pos)
    y = o.reshape(B, S, -1) @ p["wo"].to(h.dtype)
    return x + y.to(x.dtype)


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
