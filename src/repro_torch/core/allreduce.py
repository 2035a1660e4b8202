"""All-reduce schedules for sketch aggregation over a leading worker axis.

Port of ``repro/core/allreduce.py``. The reference runs under
``jax.vmap(..., axis_name=...)`` with named-axis collectives; here the P
workers are dim 0 of the tensor:

* ``psum_allreduce`` — sum over dim 0, broadcast back to every worker.
* ``tree_allreduce`` — the paper's Algorithm 1: recursive halving to rank
  0 in <= ceil(log2 P) rounds with the Fig. 1 parking rule for
  non-power-of-two P, then the same tree back. A ``ppermute`` becomes
  indexing by the completed permutation (receiver ``dst`` reads row
  ``src``). Each round runs under a ``tree/reduce{r}`` /
  ``tree/bcast{r}`` span of the ambient tracer (``obs.trace``), as the
  reference's rounds do.

On a process mesh (``over(axis)``, a ``core.pgroup.Axis``) the leading
axis holds only this process's worker and the same functions cross
processes: ``psum_allreduce`` is one all-reduce over the group, and each
round of ``masked_permute`` (so the tree and gTop-k's merge) is one
``batch_isend_irecv`` of its (src, dst) pairs, the group's indices as
the worker ids. The adds are the simulation's: a rank that receives
nothing still adds ``where(mask, received, 0)``, so its -0.0 turns to
+0.0 as in the simulation.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from repro_torch.core import pgroup
from repro_torch.obs import trace as obtrace

_OVER: list[pgroup.Axis] = []


@contextlib.contextmanager
def over(axis: pgroup.Axis | None):
    """Run this module's worker-axis collectives over the process group
    ``axis`` while open (None: the simulated worker axis)."""
    _OVER.append(axis)
    try:
        yield
    finally:
        _OVER.pop()


def current_axis() -> pgroup.Axis | None:
    """The process group the collectives run over, None when simulated."""
    return _OVER[-1] if _OVER else None


def reduce_schedule(p: int) -> list[list[tuple[int, int]]]:
    """Static (src, dst) pairs per round for recursive halving to rank 0.

    Odd active counts park the largest-id node (paper Fig. 1b/1c).
    """
    rounds: list[list[tuple[int, int]]] = []
    active = list(range(p))
    while len(active) > 1:
        parked = [active[-1]] if len(active) % 2 == 1 else []
        paired = active[: len(active) - len(parked)]
        pairs = [(paired[i + 1], paired[i]) for i in range(0, len(paired), 2)]
        rounds.append(pairs)
        active = paired[::2] + parked
    return rounds


@functools.lru_cache(maxsize=None)
def reduce_schedule_arrays(p: int) -> tuple[tuple[np.ndarray, np.ndarray], ...]:
    """``reduce_schedule(p)`` as per-round ``(src_ranks, dst_ranks)`` int64
    arrays (read-only, shared through the cache)."""
    rounds: list[tuple[np.ndarray, np.ndarray]] = []
    active = np.arange(p, dtype=np.int64)
    while active.size > 1:
        m = int(active.size) & ~1
        src = active[1:m:2].copy()
        dst = active[0:m:2].copy()
        src.setflags(write=False)
        dst.setflags(write=False)
        rounds.append((src, dst))
        active = np.concatenate([active[0:m:2], active[m:]])
    return tuple(rounds)


def _complete_perm(pairs: list[tuple[int, int]], p: int) -> list[tuple[int, int]]:
    """Extend a partial (src, dst) map to a full permutation of range(p)."""
    srcs = {s for s, _ in pairs}
    dsts = {d for _, d in pairs}
    free_src = [r for r in range(p) if r not in srcs]
    free_dst = [r for r in range(p) if r not in dsts]
    return pairs + list(zip(free_src, free_dst))


def masked_permute(x: torch.Tensor, pairs: list[tuple[int, int]],
                   p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Permute rows along real (src, dst) pairs -> (received, is_receiver).

    ``received[dst] = x[src]``; rows that receive nothing real get a
    leftover row and are masked out by the caller. ``is_receiver`` is a
    (P, 1, ...) bool mask broadcastable against ``x``. On a process mesh
    ``x`` is this worker's (1, ...) row and the pairs are sent.
    """
    ax = current_axis()
    if ax is not None:
        if ax.size != p:
            raise ValueError(f"permute over {p} workers on a group of "
                             f"{ax.size} processes")
        received, got = pgroup.permute(x, pairs, ax)
        return received, torch.full((1,) * x.dim(), got, dtype=torch.bool,
                                    device=x.device)
    src_of = [0] * p
    for s, d in _complete_perm(pairs, p):
        src_of[d] = s
    received = x[torch.tensor(src_of, device=x.device)]
    mask = torch.zeros((p,), dtype=torch.bool, device=x.device)
    mask[[d for _, d in pairs]] = True
    return received, mask.reshape((p,) + (1,) * (x.dim() - 1))


def tree_allreduce(x: torch.Tensor, p: int) -> torch.Tensor:
    """Paper Alg. 1 all-reduce of ``x`` over its leading worker axis."""
    if p == 1:
        return x
    tr = obtrace.current()
    sched = reduce_schedule(p)
    for r, pairs in enumerate(sched):
        with tr.span(f"tree/reduce{r}", cat="comm",
                     args={"round": r, "pairs": len(pairs)}) as sp:
            received, mask = masked_permute(x, pairs, p)
            x = sp.sync(x + torch.where(mask, received,
                                        torch.zeros_like(received)))
    for r, pairs in enumerate(reversed(sched)):
        back = [(dst, src) for (src, dst) in pairs]
        with tr.span(f"tree/bcast{r}", cat="comm",
                     args={"round": r, "pairs": len(pairs)}) as sp:
            received, mask = masked_permute(x, back, p)
            x = sp.sync(torch.where(mask, received, x))
    return x


def tree_allreduce_rounds(p: int) -> int:
    """Communication rounds used by tree_allreduce = 2 * ceil(log2 P)."""
    return 2 * max(1, math.ceil(math.log2(p))) if p > 1 else 0


def psum_allreduce(x: torch.Tensor, p: int | None = None) -> torch.Tensor:
    """Sum over the worker axis as a left fold in worker order
    (``pgroup.fold_sum``), broadcast back (a view, not P copies); on a
    process mesh one all-reduce over the group, which adds in the same
    order."""
    ax = current_axis()
    if ax is not None:
        return pgroup.all_reduce(x, ax)
    return pgroup.fold_sum(x, keepdim=True).expand_as(x)


def allreduce(x: torch.Tensor, p: int, *, mode: str = "psum") -> torch.Tensor:
    """Dispatch: mode in {'psum', 'tree'}."""
    if mode == "psum":
        return psum_allreduce(x, p)
    if mode == "tree":
        return tree_allreduce(x, p)
    raise ValueError(f"unknown all-reduce mode {mode!r}")
