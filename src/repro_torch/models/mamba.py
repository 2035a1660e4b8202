"""Mamba2 (SSD) block (tp=1), train path — the state-space mixer of the
zamba2 hybrid.

Port of ``repro/models/mamba.py`` (``state=None``). Per head, with a
scalar decay per step:

    dt_t = softplus(x W_dt + dt_bias),  a_t = exp(-exp(A_log) dt_t)
    h_t  = a_t h_{t-1} + dt_t B_t x_t^T,  y_t = C_t^T h_t + D x_t

``ssd_chunked`` evaluates it a chunk of L steps at a time with the (L, L)
relative-decay matrix ``e^{cum_t - cum_s}``. As in the reference, the
exponential is taken over the whole (L, L) and the upper triangle masked
afterwards; there ``cum_t - cum_s >= 0``, so a large decay could overflow
it, and the backward would then give ``0 * inf = NaN`` in both packages.
All chunk math is f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, pad_to
from repro_torch.models.layers import linear_row, rmsnorm

_CONV_W = 4  # depthwise conv width (3 past tokens + current)


def mamba_geometry(cfg: ArchConfig, tp: int = 1) -> tuple[int, int, int]:
    """(n_heads padded to tp, head_dim, state_dim)."""
    nh = pad_to(max(1, cfg.d_model // cfg.ssm_head_dim), tp)
    return nh, cfg.ssm_head_dim, cfg.ssm_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv from zeros. x: (B,S,C); w: (W,C)."""
    xp = F.pad(x, (0, 0, _CONV_W - 1, 0))
    S = x.shape[1]
    return sum(xp[:, i:i + S, :] * w[i].to(x.dtype) for i in range(_CONV_W))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0) (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                dt: torch.Tensor, a_neg: torch.Tensor, h0: torch.Tensor, *,
                chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (B,S,H,hd), b/c: (B,S,H,ns), dt: (B,S,H) f32, a_neg: (H,)
    (= -exp(A_log)), h0: (B,H,ns,hd) f32. Returns (y (B,S,H,hd) f32,
    h_final). S not a multiple of the chunk is zero-padded (dt = 0: an
    identity step).
    """
    B, S, H, hd = xh.shape
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        xh, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, b, c))
        dt = F.pad(dt, (0, 0, 0, pad))
    n = (S + pad) // L
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    h, ys = h0, []
    for i in range(n):
        sl = slice(i * L, (i + 1) * L)
        xc, bc, cc, dtc = xh[:, sl], b[:, sl], c[:, sl], dt[:, sl]
        l = dtc * a_neg                            # (B,L,H) log-decay <= 0
        cum = torch.cumsum(l, dim=1)               # inclusive
        rel = cum[:, :, None, :] - cum[:, None, :, :]   # (B,L,L,H), t,s
        dec = torch.where(mask, torch.exp(rel), 0.0)
        att = (torch.einsum("blhn,bmhn->blmh", cc, bc) * dec
               * dtc[:, None])
        y = torch.einsum("blmh,bmhd->blhd", att, xc)
        y = y + torch.einsum("blhn,bhnd->blhd",
                             cc * torch.exp(cum)[..., None], h)
        a_l = cum[:, -1]                           # (B,H)
        bw = bc * (torch.exp(a_l[:, None] - cum) * dtc)[..., None]
        h = (torch.exp(a_l)[..., None, None] * h
             + torch.einsum("blhn,blhd->bhnd", bw, xc))
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def mamba_block(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm Mamba2 block (train). x: (B,S,d)."""
    B, S, d = x.shape
    nh, hd, ns = mamba_geometry(cfg)

    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    xz = h @ p["wx"].to(h.dtype)                     # (B,S,dh)
    z = h @ p["wz"].to(h.dtype)
    xc = F.silu(_causal_conv(xz, p["conv"]))

    b = (h @ p["wB"].to(h.dtype)).reshape(B, S, nh, ns)
    c = (h @ p["wC"].to(h.dtype)).reshape(B, S, nh, ns)
    dt = _softplus((h @ p["wdt"].to(h.dtype)).to(torch.float32)
                   + p["dt_bias"].to(torch.float32))   # (B,S,H)
    a_neg = -torch.exp(p["A_log"].to(torch.float32))   # (H,)

    xh = xc.reshape(B, S, nh, hd).to(torch.float32)
    bf, cf = b.to(torch.float32), c.to(torch.float32)
    h0 = torch.zeros((B, nh, ns, hd), dtype=torch.float32, device=x.device)
    if S == 1:   # the reference's one-token step
        dt0 = dt[:, 0]
        h1 = (torch.exp(dt0 * a_neg)[..., None, None] * h0
              + (dt0[..., None] * bf[:, 0])[..., :, None]
              * xh[:, 0, ..., None, :])
        y = torch.einsum("bhn,bhnd->bhd", cf[:, 0], h1)[:, None]
    else:
        y, _ = ssd_chunked(xh, bf, cf, dt, a_neg, h0)
    y = y + p["D"].to(torch.float32)[:, None] * xh    # skip term
    y = y.reshape(B, S, nh * hd).to(h.dtype)

    # gated RMSNorm over the channels, then the output projection
    y = rmsnorm(y * F.silu(z), p["gnorm"], cfg.norm_eps)
    return x + linear_row(y, p["wo"]).to(x.dtype)
