"""Per-worker compute-time models for the cluster simulator.

Port of ``repro/sim/workers.py`` (numpy, unchanged).

One simulated training step's compute phase (forward + backward + local
encode staging) is drawn per worker from a seeded distribution around a
mean, scaled by a per-worker speed factor (static hardware skew) and any
transient straggle factors injected by the fault trace. Sampling is
counter-based — ``durations(step, ids)`` derives its Generator from
``(seed, step)`` — so a worker's draw depends only on (seed, step, id),
never on membership history: replays after an elastic replan stay
deterministic and two sweeps with the same seed are comparable
step-by-step.

Two samplers share that contract:

* ``batched`` (default) — ONE Generator per (seed, step) fills a dense
  lognormal vector indexed by absolute worker id. Because the Generator
  emits values sequentially, entry ``w`` is independent of how many ids
  are requested — the per-(seed, step, id) property holds and a whole
  membership draws in one vectorized call (the P=100k engine's hot path).
* ``perworker`` — the seed scheme: one Generator per (seed, step, worker).
  O(P) Generator constructions per step; kept as the baseline for
  ``benchmarks/sim_scale.py`` and for traces recorded against old runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ComputeModel:
    """Lognormal step-time model: heavy right tail, never negative —
    the empirical shape of real step-time distributions.

    mean    — target mean seconds per step (per worker, unskewed)
    jitter  — coefficient of variation of the lognormal (0 = constant)
    speed   — optional {worker_id: factor}; factor 2.0 = twice as slow
    seed    — base seed for the counter-based per-step Generators
              (None = inherit the enclosing SimConfig's seed)
    sampler — 'batched' (one Generator per step, dense-by-id vector) or
              'perworker' (one Generator per worker — the legacy scheme)
    """

    mean: float = 0.1
    jitter: float = 0.05
    speed: dict[int, float] = dataclasses.field(default_factory=dict)
    seed: int | None = None
    sampler: str = "batched"

    def durations(self, step: int, ids,
                  straggle: "dict[int, float] | np.ndarray | None" = None
                  ) -> np.ndarray:
        """Seconds of compute for each live worker at this step.

        ``ids`` is any int sequence (tuple or array); ``straggle`` is
        either a sparse {worker_id: factor} dict or a dense factor array
        aligned with ``ids``. A worker's draw is independent of who else
        is in the membership — what makes a faulted run comparable
        step-by-step with its fault-free twin (pinned in tests).
        """
        ids = np.asarray(ids, dtype=np.int64)
        if self.jitter > 0:
            # lognormal with mean `self.mean` and cv `self.jitter`
            sigma2 = np.log1p(self.jitter ** 2)
            mu = np.log(self.mean) - sigma2 / 2
            sigma = np.sqrt(sigma2)
            if self.sampler == "perworker":
                base = np.array([
                    np.random.default_rng(np.random.SeedSequence(
                        [self.seed or 0, step, int(w)])).lognormal(mu, sigma)
                    for w in ids])
            elif self.sampler == "batched":
                rng = np.random.default_rng(np.random.SeedSequence(
                    [self.seed or 0, int(step)]))
                hi = int(ids.max()) + 1 if ids.size else 0
                base = rng.lognormal(mu, sigma, size=hi)[ids]
            else:
                raise ValueError(f"unknown sampler {self.sampler!r}")
        else:
            base = np.full(ids.size, float(self.mean))
        scale = self._scale(ids, straggle)
        return base if scale is None else base * scale

    def _scale(self, ids: np.ndarray, straggle) -> np.ndarray | None:
        """speed * straggle factor per id (None = all ones, skip the
        multiply — x * 1.0 is exact, so the shortcut is bit-neutral)."""
        if isinstance(straggle, np.ndarray):
            sf = np.asarray(straggle, dtype=np.float64)
        elif straggle:
            sf = np.fromiter((straggle.get(int(w), 1.0) for w in ids),
                             dtype=np.float64, count=ids.size)
        else:
            sf = None
        if self.speed:
            sp = np.ones(ids.size, dtype=np.float64)
            for w, f in self.speed.items():
                sp[ids == w] = f
            sf = sp if sf is None else sp * sf
        return sf
