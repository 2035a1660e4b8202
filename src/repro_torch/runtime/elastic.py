"""Elastic worker-set management: re-plan the run when workers come and go.

Port of ``repro/runtime/elastic.py`` over the port's
``core/allreduce.reduce_schedule`` and ``obs.trace``.

gs-SGD is *natively* elastic in P: the paper's Fig. 1 tree all-reduce is
defined for any worker count (odd counts park the largest id per round), the
sketch geometry is P-independent, and the Count-Sketch sum over any subset
of workers is still a valid sketch of that subset's gradient sum. So a
failure requires no algorithmic change — only a re-plan:

  1. survivors are re-ranked densely (0..P'-1),
  2. the tree schedule regenerates for P' (``allreduce.reduce_schedule``),
  3. the data stream re-partitions the SAME global batch over P' shards
     (counter-based pipeline — no data loss, no duplication),
  4. the LR is rescaled by the linear-scaling rule if the global batch
     shrinks with P (configurable),
  5. error-feedback accumulators of dead workers are *dropped*: their
     residual gradient mass is lost, which EF theory tolerates (it is a
     one-step perturbation bounded by the compression error) — noted from
     the paper's convergence frame.

``ElasticPlan`` is pure data; drivers apply it between steps. The serving
replica set (``serve/replica.py``) re-plans through it on a failover.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import allreduce as ar
from repro_torch.obs import trace as obtrace


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """One epoch of membership: dense ranks for the surviving workers."""

    n_workers: int
    survivor_ids: tuple[int, ...]       # original ids, dense-rank order
    generation: int                     # bumped every re-plan
    lr_scale: float = 1.0

    @property
    def schedule(self):
        """Paper Alg. 1 tree schedule for the current P (any P >= 1)."""
        return ar.reduce_schedule(self.n_workers)

    def rank_of(self, worker_id: int) -> int | None:
        try:
            return self.survivor_ids.index(worker_id)
        except ValueError:
            return None


def initial_plan(n_workers: int) -> ElasticPlan:
    return ElasticPlan(n_workers, tuple(range(n_workers)), generation=0)


def replan(plan: ElasticPlan, failed: set[int] | frozenset[int],
           *, joined: tuple[int, ...] = (),
           rescale_lr: bool = True) -> ElasticPlan:
    """Drop ``failed`` original ids, append ``joined``, re-rank densely."""
    survivors = tuple(i for i in plan.survivor_ids if i not in failed)
    survivors = survivors + tuple(joined)
    if not survivors:
        raise RuntimeError("all workers failed")
    scale = (len(survivors) / plan.n_workers) if rescale_lr else 1.0
    new = ElasticPlan(
        n_workers=len(survivors),
        survivor_ids=survivors,
        generation=plan.generation + 1,
        lr_scale=plan.lr_scale * scale,
    )
    obtrace.current().instant(
        "elastic.replan", cat="runtime",
        args={"generation": new.generation, "p": new.n_workers,
              "failed": sorted(failed), "joined": list(joined),
              "lr_scale": new.lr_scale})
    return new
