"""RWKV6 ("Finch") block (tp=1), train path: time-mix with data-dependent
decay, then the relu^2 channel-mix.

Port of ``repro/models/rwkv.py`` (``state=None``: training and prefill
from scratch). The recurrence per head

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

runs in the reference's chunked form (``wkv_chunked``): a chunk of L steps
is one (L, L) masked product plus a state passthrough, with the
cumulative log-decay clamped at -30 where a factor ``e^{-cum}`` stands
alone. All chunk math is f32.

Clips: ``jnp.clip`` and ``jnp.maximum`` split the gradient in half at an
exact tie with the bound; ``torch.clamp`` passes all of it. The port
writes both as ``torch.maximum``/``torch.minimum``, whose backward splits
at ties as the reference's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, pad_to
from repro_torch.models.layers import linear_row, rmsnorm

_CLAMP = 30.0  # |log-decay| cap inside a chunk (e^-30 ~ 1e-13)


def rwkv_geometry(cfg: ArchConfig, tp: int = 1) -> tuple[int, int]:
    """(n_heads padded to tp, head_dim) of the time-mix inner width."""
    return pad_to(cfg.d_model // cfg.ssm_head_dim, tp), cfg.ssm_head_dim


def _max(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``: the gradient splits in half at a tie."""
    return torch.maximum(x, torch.tensor(lo, dtype=x.dtype, device=x.device))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` = minimum(maximum(x, lo), hi)."""
    return torch.minimum(_max(x, lo),
                         torch.tensor(hi, dtype=x.dtype, device=x.device))


def _token_shift(h: torch.Tensor) -> torch.Tensor:
    """x_{t-1} per position; position 0 sees zeros."""
    if h.shape[1] == 1:
        return torch.zeros_like(h)
    return F.pad(h, (0, 0, 1, 0))[:, :-1, :]


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV. r/k/v/logw: (B,S,H,hd) f32; u: (H,hd); s0: (B,H,hd,hd).

    Returns (y (B,S,H,hd), s_final). logw <= 0. S not a multiple of the
    chunk is zero-padded (log w = 0 on the pad: the state is untouched).
    """
    B, S, H, hd = r.shape
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    n = (S + pad) // L
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    eye = torch.eye(L, dtype=r.dtype, device=r.device)
    s, ys = s0, []
    for c in range(n):
        sl = slice(c * L, (c + 1) * L)
        rc, kc, vc, wc = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        cum = torch.cumsum(wc, dim=1)             # inclusive log-decay
        cum_in = _max(cum, -_CLAMP)
        cum_prev = _max(cum - wc, -_CLAMP)
        rp = rc * torch.exp(cum_prev)             # r_t * A_{t-1}
        kp = kc * torch.exp(-cum_in)              # k_s / A_s
        att = torch.einsum("blhc,bmhc->bhlm", rp, kp)
        att = torch.where(mask, att, 0.0)
        bonus = torch.einsum("hc,blhc,blhc->bhl", u, rc, kc)
        att = att + eye * bonus[..., None]
        y = torch.einsum("bhlm,bmhd->blhd", att, vc)
        y = y + torch.einsum("blhc,bhcd->blhd", rp, s)
        a_l = cum[:, -1]                          # (B, H, hd) total decay
        kw = kc * torch.exp(_max(a_l[:, None] - cum_in, -_CLAMP))
        s = (torch.exp(_max(a_l, -_CLAMP))[..., None] * s
             + torch.einsum("blhc,blhd->bhcd", kw, vc))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], s


def rwkv_block(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Full RWKV6 block = time-mix + channel-mix (train). x: (B, S, d)."""
    B, S, d = x.shape
    nh, hd = rwkv_geometry(cfg)

    # ---- time mix -------------------------------------------------------
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    hs = _token_shift(h)
    mu = p["mu"].to(h.dtype)                         # (4, d)
    xr, xk, xv, xg = (h + mu[i] * (hs - h) for i in range(4))

    r = (xr @ p["wr"].to(h.dtype)).reshape(B, S, nh, hd)
    kk = (xk @ p["wk"].to(h.dtype)).reshape(B, S, nh, hd)
    vv = (xv @ p["wv"].to(h.dtype)).reshape(B, S, nh, hd)
    g = F.silu(xg @ p["wg"].to(h.dtype))             # (B, S, dh)

    # data-dependent decay: w = exp(-exp(.)) -> log w = -exp(.) in [-inf, 0)
    wx = ((xk @ p["ww"].to(h.dtype)).to(torch.float32)
          + p["w_bias"].to(torch.float32))
    logw = -torch.exp(_clip(wx, -12.0, 3.0)).reshape(B, S, nh, hd)
    u = p["bonus"].to(torch.float32).reshape(nh, hd)

    s0 = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=x.device)
    rf, kf, vf = (t.to(torch.float32) for t in (r, kk, vv))
    if S == 1:   # the reference's single-token recurrence
        kv = kf[:, 0, ..., :, None] * vf[:, 0, ..., None, :]
        y = torch.einsum("bhc,bhcd->bhd", rf[:, 0],
                         s0 + u[..., None] * kv)[:, None]
    else:
        y, _ = wkv_chunked(rf, kf, vf, logw, u, s0)
    y = y.reshape(B, S, nh * hd).to(h.dtype) * g
    x = x + linear_row(y, p["wo"]).to(x.dtype)

    # ---- channel mix ----------------------------------------------------
    h2 = rmsnorm(x, p["cnorm"], cfg.norm_eps)
    hs2 = _token_shift(h2)
    xin = h2 + p["cmu"].to(h2.dtype)[0] * (hs2 - h2)
    kx = torch.square(torch.relu(xin @ p["ck"].to(h2.dtype)))
    return x + linear_row(kx, p["cv"]).to(x.dtype)
