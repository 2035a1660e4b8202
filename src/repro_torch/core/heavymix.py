"""HEAVYMIX (paper Algorithm 2): recover Top-k coordinates from a summed sketch.

Port of ``repro/core/heavymix.py``: greedy fill (the train path's
default) and the paper-faithful random fill. The reference draws the
faithful fill's priorities with ``jax.random.uniform(key, (d,))``, which
torch cannot reproduce; the port takes them as a tensor (``filler``), or
draws them from a ``torch.Generator`` seeded 0 (``draw_filler``). Parity
tests feed it the reference's filler, exported as numpy.

Tie-break: ``jax.lax.top_k`` breaks ties toward the LOWER index, and
``torch.topk`` promises no order among ties. Heavy scores collapse to
exactly 1e30 in f32, so ties are common; ``topk_lower_index`` reproduces
the reference's order exactly, NaN keys included (they rank first).
"""

from __future__ import annotations

import torch

from repro_torch.core import count_sketch as cs

_BIG = 1e30  # priority boost guaranteeing heavy coords beat all fillers
_CHUNK = 1 << 22  # coords per selection chunk (hierarchical top-k)


def _order_key(score: torch.Tensor) -> torch.Tensor:
    """The int32 key whose integer order is ``jax.lax.top_k``'s order of
    the f32 ``score``: IEEE total order, so NaN ranks above +inf, -0 below
    +0, and -NaN below -inf. For non-negative floats the key is their bits,
    the radix select's key (``kernels/topk_select.key_bits``)."""
    b = score.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def topk_lower_index(score: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` of a 1-d f32 tensor: values descending, ties by
    the lower index, NaN first (``_order_key``).

    O(d): the k-th largest key v comes from ``torch.topk`` over the keys
    (its values are right whatever its tie order); every index keyed above
    v is kept, and the lowest-index entries equal to v fill the rest. A
    stable descending sort of the k survivors, taken in ascending index
    order, then orders them as the reference does.
    """
    n = score.shape[0]
    k = int(k)
    key = _order_key(score)
    if k >= n:
        order = torch.sort(key, descending=True, stable=True).indices
        return score[order], order
    kth = torch.topk(key, k, sorted=False).values.min()
    above = torch.nonzero(key > kth).reshape(-1)
    ties = torch.nonzero(key == kth).reshape(-1)[:k - above.numel()]
    cand = torch.sort(torch.cat([above, ties])).values
    order = torch.sort(key[cand], descending=True, stable=True).indices
    idx = cand[order]
    return score[idx], idx


def draw_filler(d: int, device) -> torch.Tensor:
    """The faithful fill's (d,) f32 priorities, uniform in [0, 1), from a
    generator on ``device`` seeded 0 (the counterpart of the reference's
    ``PRNGKey(0)`` when no key is given)."""
    generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand((d,), generator=generator, dtype=torch.float32,
                      device=device)


def heavymix(cfg: cs.SketchConfig, sketch: torch.Tensor, k: int, d: int, *,
             faithful: bool = False,
             estimates: torch.Tensor | None = None,
             filler: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Select k indices from a summed sketch. Returns (idx (k,), est (k,)).

    faithful=True pads the heavy set with uniformly random non-heavy
    coordinates exactly as Alg. 2: a non-heavy coordinate scores
    ``filler[i]`` (default ``draw_filler(d, device)``); the default
    pads with the next-largest estimates instead.

    For d beyond 2^22 coords (and d > 4k) the selection runs
    hierarchically, as the reference: per-chunk top-k, then a top-k over
    the union of the per-chunk winners.

    ``estimates`` (precomputed, e.g. the TS-sketch decode) skips the
    decode and the chunked route at every d, as in the reference: the
    boosted-score top-k then keeps the lowest-index heavy coordinates
    when the heavy set outnumbers k.
    """
    if estimates is None and not faithful and d > _CHUNK and d > 4 * k:
        return _heavymix_chunked(cfg, sketch, k, d)
    est = cs.decode(cfg, sketch, d) if estimates is None else estimates
    l2sq = cs.l2sq_estimate(sketch)
    heavy = est * est >= l2sq / k
    if faithful:
        if filler is None:
            filler = draw_filler(d, est.device)
        score = torch.where(heavy, torch.abs(est) + _BIG, filler)
    else:
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
