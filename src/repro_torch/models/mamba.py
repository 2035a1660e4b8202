"""Mamba2 (SSD) block — the state-space mixer of the zamba2 hybrid.

Port of ``repro/models/mamba.py``: the train path (``state=None``) and
the serving path (``state=`` the block's recurrent state, ``{"h": (B, H,
ns, hd) f32, "conv": (B, W-1, dh)}``; the block then also returns the
new state: the SSM state after the last token and the depthwise conv's
input tail). Per head, with a scalar decay per step:

    dt_t = softplus(x W_dt + dt_bias),  a_t = exp(-exp(A_log) dt_t)
    h_t  = a_t h_{t-1} + dt_t B_t x_t^T,  y_t = C_t^T h_t + D x_t

``ssd_chunked`` evaluates it a chunk of L steps at a time with the (L, L)
relative-decay matrix ``e^{cum_t - cum_s}``. As in the reference, the
exponential is taken over the whole (L, L) and the upper triangle masked
afterwards; there ``cum_t - cum_s >= 0``, so a large decay could overflow
it, and the backward would then give ``0 * inf = NaN`` in both packages.
All chunk math is f32.

TP (``ctx``, tp > 1): the x/z/B/C/dt projections, the depthwise conv and
the per-head parameters are sharded by head, the output projection is
row-parallel (psum), and the gated RMSNorm normalizes each rank's local
channels (the reference's grouped-norm treatment). The ranks' heads run
the SSD as one call, folded into the head axis (global order), so a
cache holds the global ``(B, H, ns, hd)`` state and ``(B, W-1, dh)`` conv
tail.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, ShardCtx, pad_to
from repro_torch.models.layers import lin, linear_row, ranked_vec, rmsnorm

_CONV_W = 4  # depthwise conv width (3 past tokens + current)


def mamba_geometry(cfg: ArchConfig, tp: int = 1) -> tuple[int, int, int]:
    """(n_heads padded to tp, head_dim, state_dim)."""
    nh = pad_to(max(1, cfg.d_model // cfg.ssm_head_dim), tp)
    return nh, cfg.ssm_head_dim, cfg.ssm_state


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 prev: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C); w: (W,C); prev: the (B,W-1,C)
    input tail of the tokens before, or None for zeros. Rank-stacked: x
    (tp,B,S,C), w (tp,W,C), prev (tp,B,W-1,C)."""
    if prev is None:
        xp = F.pad(x, (0, 0, _CONV_W - 1, 0))
    else:
        xp = torch.cat([prev.to(x.dtype), x], dim=-2)
    S = x.shape[-2]
    taps = w if w.ndim == 2 else w[:, :, None, None, :].movedim(1, 0)
    return sum(xp[..., i:i + S, :] * taps[i].to(x.dtype)
               for i in range(_CONV_W))


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


def ssd_step(xh: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             dt: torch.Tensor, a_neg: torch.Tensor, h0: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD. xh: (B,H,hd), b/c: (B,H,ns), dt: (B,H); h0:
    (B,H,ns,hd) f32. Returns (y (B,H,hd), h1)."""
    decay = torch.exp(dt * a_neg)                          # (B,H)
    h1 = (decay[..., None, None] * h0
          + (dt[..., None] * b)[..., :, None] * xh[..., None, :])
    y = torch.einsum("bhn,bhnd->bhd", c, h1)
    return y, h1


def mamba_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
                state: dict | None = None, ctx: ShardCtx | None = None):
    """Pre-norm Mamba2 block. x: (B,S,d), at tp > 1 rank-stacked (tp, B,
    S, d). Returns the output; with ``state`` (serving), ``(output, new
    state)``."""
    B, S, d = x.shape[-3:]
    tp = ctx.tp if ctx is not None else 1
    nr = ctx.lead if ctx is not None else 1   # ranks held (rank dimension)
    nh, hd, ns = mamba_geometry(cfg, tp)
    nh = ctx.held(nh) if ctx is not None else nh   # the held ranks' heads
    lead = x.shape[:-1]
    fold = ctx.fold_heads if ctx is not None else (lambda t: t)

    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    xz = lin(h, p["wx"].to(h.dtype))                 # (.., B,S,dh)
    z = lin(h, p["wz"].to(h.dtype))
    prev_conv = state["conv"] if state is not None else None
    if prev_conv is not None and tp > 1:   # held channels -> each rank's
        prev_conv = prev_conv.reshape(B, _CONV_W - 1, nr, -1).movedim(2, 0)
    xc = F.silu(_causal_conv(xz, p["conv"], prev_conv))

    b = lin(h, p["wB"].to(h.dtype)).reshape(lead + (-1, ns))
    c = lin(h, p["wC"].to(h.dtype)).reshape(lead + (-1, ns))
    dt = _softplus(lin(h, p["wdt"].to(h.dtype)).to(torch.float32)
                   + ranked_vec(p["dt_bias"], h).to(torch.float32))
    a_neg = -torch.exp(p["A_log"].to(torch.float32)).reshape(nh)   # (H,)

    xh = fold(xc.reshape(lead + (-1, hd)).to(torch.float32))
    bf, cf = fold(b.to(torch.float32)), fold(c.to(torch.float32))
    dt = fold(dt[..., None])[..., 0]                   # (B,S,H)
    h0 = (state["h"] if state is not None else
          torch.zeros((B, nh, ns, hd), dtype=torch.float32, device=x.device))
    if S == 1:   # the reference's one-token step
        y1, h1 = ssd_step(xh[:, 0], bf[:, 0], cf[:, 0], dt[:, 0], a_neg, h0)
        y = y1[:, None]
    else:
        y, h1 = ssd_chunked(xh, bf, cf, dt, a_neg, h0)
    y = y + p["D"].to(torch.float32).reshape(nh)[:, None] * xh   # skip term
    if ctx is not None:
        y = ctx.unfold_heads(y)
    y = y.reshape(lead + (-1,)).to(h.dtype)

    # gated RMSNorm over each rank's channels, then the output projection
    y = rmsnorm(y * F.silu(z), ranked_vec(p["gnorm"], y), cfg.norm_eps)
    x = x + linear_row(y, p["wo"], ctx).to(x.dtype)
    if state is None:
        return x
    conv_tail = torch.cat([prev_conv.to(xz.dtype), xz], dim=-2)
    conv_tail = conv_tail[..., -(_CONV_W - 1):, :]
    if tp > 1:
        conv_tail = conv_tail.movedim(0, 2).reshape(B, _CONV_W - 1, -1)
    return x, {"h": h1, "conv": conv_tail}


def init_mamba_state(cfg: ArchConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cpu", tp: int = 1,
                     ranks: int | None = None) -> dict:
    """Zeroed recurrent state of one Mamba2 block for ``batch`` rows (every
    rank's heads and channels, in global order, at ``tp``; with ``ranks``
    those of that many ranks, as a process of a mesh holds one)."""
    nh, hd, ns = mamba_geometry(cfg, tp)
    nh = nh * (ranks or tp) // tp
    return {"h": torch.zeros((batch, nh, ns, hd), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, nh * hd), dtype=dtype,
                                device=device)}
