"""Mixture-of-Experts block with expert parallelism over the model axis.

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

Expert parallelism (tp > 1, rank-stacked activations): every rank sees
every token and routes it alike (the router is replicated), and keeps
only the choices routed to its ``ne / tp`` local experts, from expert
``e0 = rank * ne_loc``; the rest go to its overflow row. The combine is
the psum the row-parallel projections use.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ArchConfig, ShardCtx, padded_experts
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
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot over the last axis (``F.one_hot`` checks the index
    range on the host, a device sync on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def dispatch(eidx: torch.Tensor, ne: int, cap: int
             ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per choice slot j: each token's destination row in the (ne * cap + 1,
    d) buffer (the last row is the overflow row) and whether it was kept.
    ``eidx`` (T, k), or rank-stacked (tp, T, k): each rank counts alike."""
    counts = torch.zeros(eidx.shape[:-2] + (ne,), dtype=torch.int64,
                         device=eidx.device)
    dests, keeps = [], []
    for j in range(eidx.shape[-1]):
        e_j = eidx[..., j]
        oh = _one_hot(e_j, ne)                            # (T, E)
        before = torch.gather(torch.cumsum(oh, dim=-2) - oh, -1,
                              e_j[..., None])[..., 0]
        pos_j = torch.gather(counts, -1, e_j) + before
        counts = counts + oh.sum(dim=-2)
        keep = pos_j < cap
        dests.append(torch.where(keep, e_j * cap + pos_j, ne * cap))
        keeps.append(keep)
    return dests, keeps


def moe_block(p: dict, cfg: ArchConfig, x: torch.Tensor,
              ctx: ShardCtx | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE FFN. x: (B, S, d) -> (residual output, aux loss); at
    tp > 1 rank-stacked, (tp, B, S, d) -> (.., (tp,) aux)."""
    tp = ctx.tp if ctx is not None else 1
    nr = ctx.lead if ctx is not None else 1   # ranks held (rank dimension)
    ne = padded_experts(cfg, tp)
    ne_loc = ne // tp
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    B, S, d = h.shape[-3:]
    lead = h.shape[:-3]
    T = B * S
    ht = h.reshape(lead + (T, d))
    C = expert_capacity(cfg, T, tp)

    logits = (ht @ p["router"].to(ht.dtype)).to(torch.float32)
    valid = torch.arange(ne, device=x.device) < cfg.n_experts
    logits = torch.where(valid, logits, -1e30)   # mask padded experts
    probs = torch.softmax(logits, dim=-1)        # (T, E)
    gate, eidx = route(cfg, probs)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    # Switch-style load-balance aux: E * sum_e mean(route_e) * mean(p_e);
    # the routed fraction is a count and carries no gradient
    route_frac = torch.mean(torch.sum(
        _one_hot(eidx, ne).to(torch.float32), dim=-2), dim=-2)
    prob_frac = torch.mean(probs, dim=-2)
    aux = cfg.n_experts * (torch.sum(route_frac * prob_frac, dim=-1) if lead
                           else torch.sum(route_frac * prob_frac))

    dests, keeps = dispatch(eidx, ne, C)
    if lead:   # this rank's experts [e0, e0 + ne_loc); the rest overflow
        e0 = ctx.rank_offsets(ne_loc, 2, x.device)
        rows = ne_loc * C + 1
        for j in range(len(dests)):
            e_j = eidx[..., j]
            keeps[j] = keeps[j] & (e_j >= e0) & (e_j < e0 + ne_loc)
            dests[j] = (torch.where(keeps[j], dests[j] - e0 * C, ne_loc * C)
                        + torch.arange(nr, device=x.device)[:, None] * rows)
        buf = torch.zeros((nr * rows, d), dtype=ht.dtype, device=x.device)
        for dest, keep in zip(dests, keeps):
            buf = buf.index_add(0, dest.reshape(-1),
                                (ht * keep[..., None].to(ht.dtype))
                                .reshape(-1, d))
        eb = buf.reshape(nr, rows, d)[:, :-1].reshape(nr, ne_loc, C, d)
        eq = ("recd,redf->recf", "recf,refd->recd")
    else:
        buf = torch.zeros((ne * C + 1, d), dtype=ht.dtype, device=x.device)
        for dest, keep in zip(dests, keeps):
            buf = buf.index_add(0, dest, ht * keep[:, None].to(ht.dtype))
        eb = buf[:-1].reshape(ne, C, d)
        eq = ("ecd,edf->ecf", "ecf,efd->ecd")
    wi = p["experts"]["wi"].to(ht.dtype)          # ([tp,] ne_loc, d, 2ff)
    wo = p["experts"]["wo"].to(ht.dtype)          # ([tp,] ne_loc, ff, d)
    gu = torch.einsum(eq[0], eb, wi)
    g_part, u_part = torch.chunk(gu, 2, dim=-1)
    eo = torch.einsum(eq[1], F.silu(g_part) * u_part, wo)
    eo = torch.cat([eo.reshape(lead + (ne_loc * C, d)),
                    torch.zeros(lead + (1, d), dtype=ht.dtype,
                                device=x.device)], dim=-2)
    if lead:   # every rank's rows of one flat table, as ``dests`` index it
        eo = eo.reshape(nr * (ne_loc * C + 1), d)

    y = torch.zeros(lead + (T, d), dtype=ht.dtype, device=x.device)
    for j, (dest, keep) in enumerate(zip(dests, keeps)):
        w_j = (gate[..., j] * keep.to(torch.float32)).to(ht.dtype)
        y = y + eo[dest] * w_j[..., None]
    if ctx is not None:
        y = ctx.psum_tp(y)
    return x + y.reshape(x.shape).to(x.dtype), aux
