"""RWKV6 ("Finch") block: time-mix with data-dependent decay, then the
relu^2 channel-mix.

Port of ``repro/models/rwkv.py``: the train path (``state=None``) and
the serving path (``state=`` ``{"s": (B, H, hd, hd) f32, "tm_prev": (B,
d) f32, "cm_prev": (B, d) f32}``: the WKV state and the last token's
normed inputs of the two token shifts; the block then also returns the
new state). The recurrence per head

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

runs in the reference's chunked form (``wkv_chunked``): a chunk of L steps
is one (L, L) masked product plus a state passthrough, with the
cumulative log-decay clamped at -30 where a factor ``e^{-cum}`` stands
alone. All chunk math is f32.

TP (``ctx``, tp > 1): the r/k/v/g/decay projections are column-parallel
by head and the output projections row-parallel (psum), the token-shift
mixes and norms replicated. The ranks' local heads run the WKV as one
call, folded into the head axis (global head order), so the state a
cache holds is the global ``(B, H, hd, hd)`` and the token-shift carries
are the (identical) rows of rank 0.

Clips: ``jnp.clip`` and ``jnp.maximum`` split the gradient in half at an
exact tie with the bound; ``torch.clamp`` passes all of it. The port
writes both as ``torch.maximum``/``torch.minimum``, whose backward splits
at ties as the reference's does.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, ShardCtx, pad_to
from repro_torch.models.layers import lin, linear_row, ranked_vec, rmsnorm

_CLAMP = 30.0  # |log-decay| cap inside a chunk (e^-30 ~ 1e-13)


def rwkv_geometry(cfg: ArchConfig, tp: int = 1) -> tuple[int, int]:
    """(n_heads padded to tp, head_dim) of the time-mix inner width."""
    return pad_to(cfg.d_model // cfg.ssm_head_dim, tp), cfg.ssm_head_dim


@functools.lru_cache(maxsize=None)
def _const(v: float, dtype: torch.dtype, device: torch.device
           ) -> torch.Tensor:
    """A 0-dim constant, made once per (value, dtype, device): building it
    is a host-to-device copy, which syncs the card."""
    return torch.tensor(v, dtype=dtype, device=device)


def _max(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``: the gradient splits in half at a tie."""
    return torch.maximum(x, _const(lo, x.dtype, x.device))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` = minimum(maximum(x, lo), hi)."""
    return torch.minimum(_max(x, lo), _const(hi, x.dtype, x.device))


def _token_shift(h: torch.Tensor,
                 prev: torch.Tensor | None = None) -> torch.Tensor:
    """x_{t-1} per position; position 0 sees ``prev`` (B, d) or zeros."""
    if h.shape[-2] == 1:   # decode fast path
        return (torch.zeros_like(h) if prev is None
                else prev[:, None, :].to(h.dtype).expand_as(h))
    shifted = F.pad(h, (0, 0, 1, 0))[..., :-1, :]
    if prev is not None:
        shifted[..., 0, :] = prev.to(h.dtype)
    return shifted


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


def wkv_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. r/k/v/logw: (B,H,hd); s0: (B,H,hd,hd).
    Returns (y (B,H,hd), s1)."""
    kv = k[..., :, None] * v[..., None, :]           # (B,H,hd_k,hd_v)
    y = torch.einsum("bhc,bhcd->bhd", r, s0 + u[..., None] * kv)
    s1 = torch.exp(logw)[..., None] * s0 + kv
    return y, s1


def rwkv_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
               state: dict | None = None, ctx: ShardCtx | None = None):
    """Full RWKV6 block = time-mix + channel-mix. x: (B, S, d), at tp > 1
    rank-stacked (tp, B, S, d). Returns the output; with ``state``
    (serving), ``(output, new state)``."""
    B, S, d = x.shape[-3:]
    tp = ctx.tp if ctx is not None else 1
    nh, hd = rwkv_geometry(cfg, tp)
    nh = ctx.held(nh) if ctx is not None else nh   # the held ranks' heads
    lead = x.shape[:-1]
    fold = ctx.fold_heads if ctx is not None else (lambda t: t)

    # ---- time mix -------------------------------------------------------
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    hs = _token_shift(h, state["tm_prev"] if state is not None else None)
    mu = p["mu"].to(h.dtype)                         # (4, d)
    xr, xk, xv, xg = (h + mu[i] * (hs - h) for i in range(4))

    r = lin(xr, p["wr"].to(h.dtype)).reshape(lead + (-1, hd))
    kk = lin(xk, p["wk"].to(h.dtype)).reshape(lead + (-1, hd))
    vv = lin(xv, p["wv"].to(h.dtype)).reshape(lead + (-1, hd))
    g = F.silu(lin(xg, p["wg"].to(h.dtype)))         # (.., B, S, dh)

    # data-dependent decay: w = exp(-exp(.)) -> log w = -exp(.) in [-inf, 0)
    wx = (lin(xk, p["ww"].to(h.dtype)).to(torch.float32)
          + ranked_vec(p["w_bias"], xk).to(torch.float32))
    logw = -torch.exp(_clip(wx, -12.0, 3.0)).reshape(lead + (-1, hd))
    u = p["bonus"].to(torch.float32).reshape(nh, hd)

    s0 = (state["s"] if state is not None else
          torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=x.device))
    rf, kf, vf, lw = (fold(t.to(torch.float32)) for t in (r, kk, vv, logw))
    if S == 1:   # the reference's single-token recurrence
        y1, s1 = wkv_step(rf[:, 0], kf[:, 0], vf[:, 0], lw[:, 0], u, s0)
        y = y1[:, None]
    else:
        y, s1 = wkv_chunked(rf, kf, vf, lw, u, s0)
    if ctx is not None:
        y = ctx.unfold_heads(y)
    y = y.reshape(lead + (-1,)).to(h.dtype) * g
    x = x + linear_row(y, p["wo"], ctx).to(x.dtype)

    # ---- channel mix ----------------------------------------------------
    h2 = rmsnorm(x, p["cnorm"], cfg.norm_eps)
    hs2 = _token_shift(h2, state["cm_prev"] if state is not None else None)
    xin = h2 + p["cmu"].to(h2.dtype)[0] * (hs2 - h2)
    kx = torch.square(torch.relu(lin(xin, p["ck"].to(h2.dtype))))
    x = x + linear_row(kx, p["cv"], ctx).to(x.dtype)
    if state is None:
        return x
    if x.ndim == 4:   # the ranks' token-shift rows are equal: rank 0's
        h, h2 = h[0], h2[0]
    return x, {"s": s1, "tm_prev": h[:, -1, :].to(torch.float32),
               "cm_prev": h2[:, -1, :].to(torch.float32)}


def init_rwkv_state(cfg: ArchConfig, batch: int,
                    device: str | torch.device = "cpu", tp: int = 1,
                    ranks: int | None = None) -> dict:
    """Zeroed recurrent state of one RWKV6 block for ``batch`` rows (every
    rank's heads, in global order, at ``tp``; with ``ranks`` those of
    that many ranks, as a process of a mesh holds one)."""
    nh, hd = rwkv_geometry(cfg, tp)
    nh = nh * (ranks or tp) // tp
    f32 = torch.float32
    return {"s": torch.zeros((batch, nh, hd, hd), dtype=f32, device=device),
            "tm_prev": torch.zeros((batch, cfg.d_model), dtype=f32,
                                   device=device),
            "cm_prev": torch.zeros((batch, cfg.d_model), dtype=f32,
                                   device=device)}
