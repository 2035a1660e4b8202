"""Mixture-of-Experts block (tp=1), train path.

Port of ``repro/models/moe.py``: a replicated router, top-k routing with
the reference's tie order, capacity-factor dispatch with a running
per-expert counter (choice-major: every token's first choice is placed
before any token's second), an overflow row for the dropped tokens, the
experts' SwiGLU as two batched matmuls, and the gate-weighted combine.

Routing order: ``jax.lax.top_k`` breaks ties toward the lower expert
index; a stable descending sort gives the same order on either device
(``torch.topk`` promises none on the card). The drop set depends on the
dispatch order, so it is kept exactly: position j of a token in expert e
is the count of earlier choices (earlier choice slots, then earlier tokens
in the same slot) routed to e. Each of the ``ne * C`` real slots receives
at most one token, so the out-of-place ``index_add`` is exact in any
order; the overflow row only ever receives zeros.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, padded_experts
from repro_torch.models.layers import rmsnorm

def expert_capacity(cfg: ArchConfig, n_tokens: int, tp: int = 1) -> int:
    """Static per-expert capacity, rounded up to a multiple of 8."""
    ne = padded_experts(cfg, tp)
    cap = math.ceil(n_tokens * cfg.experts_per_tok / ne * cfg.capacity_factor)
    return max(8, ((cap + 7) // 8) * 8)


def route(cfg: ArchConfig, probs: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each token's expert probabilities (T, E): (gate, eidx),
    values descending, ties to the lower expert index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_tok
    return vals[:, :k], idx[:, :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot over the last axis (``F.one_hot`` checks the index
    range on the host, a device sync on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def dispatch(eidx: torch.Tensor, ne: int, cap: int
             ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per choice slot j: each token's destination row in the (ne * cap + 1,
    d) buffer (the last row is the overflow row) and whether it was kept."""
    T = eidx.shape[0]
    ar = torch.arange(T, device=eidx.device)
    counts = torch.zeros((ne,), dtype=torch.int64, device=eidx.device)
    dests, keeps = [], []
    for j in range(eidx.shape[1]):
        e_j = eidx[:, j]
        oh = _one_hot(e_j, ne)                            # (T, E)
        pos_j = counts[e_j] + (torch.cumsum(oh, dim=0) - oh)[ar, e_j]
        counts = counts + oh.sum(dim=0)
        keep = pos_j < cap
        dests.append(torch.where(keep, e_j * cap + pos_j, ne * cap))
        keeps.append(keep)
    return dests, keeps


def moe_block(p: dict, cfg: ArchConfig, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE FFN. x: (B, S, d) -> (residual output, aux loss)."""
    ne = padded_experts(cfg, 1)
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    B, S, d = h.shape
    T = B * S
    ht = h.reshape(T, d)
    C = expert_capacity(cfg, T)

    logits = (ht @ p["router"].to(ht.dtype)).to(torch.float32)
    valid = torch.arange(ne, device=x.device) < cfg.n_experts
    logits = torch.where(valid, logits, -1e30)   # mask padded experts
    probs = torch.softmax(logits, dim=-1)        # (T, E)
    gate, eidx = route(cfg, probs)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    # Switch-style load-balance aux: E * sum_e mean(route_e) * mean(p_e);
    # the routed fraction is a count and carries no gradient
    route_frac = torch.mean(torch.sum(
        _one_hot(eidx, ne).to(torch.float32), dim=1), dim=0)
    prob_frac = torch.mean(probs, dim=0)
    aux = cfg.n_experts * torch.sum(route_frac * prob_frac)

    dests, keeps = dispatch(eidx, ne, C)
    buf = torch.zeros((ne * C + 1, d), dtype=ht.dtype, device=x.device)
    for dest, keep in zip(dests, keeps):
        buf = buf.index_add(0, dest, ht * keep[:, None].to(ht.dtype))

    eb = buf[:-1].reshape(ne, C, d)
    wi = p["experts"]["wi"].to(ht.dtype)          # (ne, d, 2ff)
    wo = p["experts"]["wo"].to(ht.dtype)          # (ne, ff, d)
    gu = torch.einsum("ecd,edf->ecf", eb, wi)
    g_part, u_part = torch.chunk(gu, 2, dim=-1)
    eo = torch.einsum("ecf,efd->ecd", F.silu(g_part) * u_part, wo)
    eo = torch.cat([eo.reshape(ne * C, d),
                    torch.zeros((1, d), dtype=ht.dtype, device=x.device)])

    y = torch.zeros((T, d), dtype=ht.dtype, device=x.device)
    for j, (dest, keep) in enumerate(zip(dests, keeps)):
        w_j = (gate[:, j] * keep.to(torch.float32)).to(ht.dtype)
        y = y + eo[dest] * w_j[:, None]
    return x + y.reshape(B, S, d).to(x.dtype), aux
