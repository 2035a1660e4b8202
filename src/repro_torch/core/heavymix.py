"""HEAVYMIX (paper Algorithm 2): recover Top-k coordinates from a summed sketch.

Port of ``repro/core/heavymix.py``, greedy fill (the train path's
default). The paper-faithful random fill draws ``jax.random`` numbers and
is left to a later slice.

Tie-break: ``jax.lax.top_k`` breaks ties toward the LOWER index, and
``torch.topk`` promises no order among ties. Heavy scores collapse to
exactly 1e30 in f32, so ties are common; ``topk_lower_index`` reproduces
the reference's order exactly.
"""

from __future__ import annotations

import torch

from repro_torch.core import count_sketch as cs

_BIG = 1e30  # priority boost guaranteeing heavy coords beat all fillers
_CHUNK = 1 << 22  # coords per selection chunk (hierarchical top-k)


def topk_lower_index(score: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` of a 1-d tensor: values descending, ties by the
    lower index.

    O(d): the k-th largest value v comes from ``torch.topk`` (its values
    are right whatever its tie order); every index scoring above v is
    kept, and the lowest-index entries equal to v fill the rest. A stable
    descending sort of the k survivors, taken in ascending index order,
    then orders them as the reference does.
    """
    n = score.shape[0]
    k = int(k)
    if k >= n:
        order = torch.sort(score, descending=True, stable=True).indices
        return score[order], order
    kth = torch.topk(score, k, sorted=False).values.min()
    above = torch.nonzero(score > kth).reshape(-1)
    ties = torch.nonzero(score == kth).reshape(-1)[:k - above.numel()]
    cand = torch.sort(torch.cat([above, ties])).values
    order = torch.sort(score[cand], descending=True, stable=True).indices
    idx = cand[order]
    return score[idx], idx


def heavymix(cfg: cs.SketchConfig, sketch: torch.Tensor, k: int, d: int, *,
             estimates: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Select k indices from a summed sketch. Returns (idx (k,), est (k,)).

    For d beyond 2^22 coords (and d > 4k) the selection runs
    hierarchically, as the reference: per-chunk top-k, then a top-k over
    the union of the per-chunk winners.

    ``estimates`` (precomputed, e.g. the TS-sketch decode) skips the
    decode and the chunked route at every d, as in the reference: the
    boosted-score top-k then keeps the lowest-index heavy coordinates
    when the heavy set outnumbers k.
    """
    if estimates is None and d > _CHUNK and d > 4 * k:
        return _heavymix_chunked(cfg, sketch, k, d)
    est = cs.decode(cfg, sketch, d) if estimates is None else estimates
    l2sq = cs.l2sq_estimate(sketch)
    heavy = est * est >= l2sq / k
    score = torch.where(heavy, torch.abs(est) + _BIG, torch.abs(est))
    _, idx = topk_lower_index(score, k)
    return idx, est[idx]


def _heavymix_chunked(cfg: cs.SketchConfig, sketch: torch.Tensor, k: int,
                      d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy-fill HEAVYMIX with chunked decode + hierarchical top-k.

    Greedy fill orders by |estimate| and the heavy set is exactly the
    top-|H| by |estimate|, so a plain top-k by |est| selects H plus the
    greedy fill. Chunks cover whole ``_CHUNK`` ranges; the tail padding
    scores -1, as in the reference.
    """
    sk = sketch.to(torch.float32)
    n = (d + _CHUNK - 1) // _CHUNK
    k_c = min(k, _CHUNK)
    vals, idxs, ests = [], [], []
    for i in range(n):
        base = i * _CHUNK
        idx = torch.arange(base, base + _CHUNK, device=sk.device)
        est = cs.decode_at(cfg, sk, idx)
        score = torch.where(idx < d, torch.abs(est),
                            torch.full_like(est, -1.0))
        v, loc = topk_lower_index(score, k_c)
        vals.append(v)
        idxs.append(loc + base)
        ests.append(est[loc])
    vals, idxs, ests = torch.cat(vals), torch.cat(idxs), torch.cat(ests)
    _, sel = topk_lower_index(vals, k)
    return idxs[sel], ests[sel]
