"""Deterministic search over the exchange-configuration space.

Port of ``repro/tune/search.py``.

``search`` enumerates the space's valid candidates (runtime-validated by
``space.enumerate_valid``), prices each through ``cost.CostModel`` (real
sim replay + error probe), optionally subsamples under an evaluation
``budget`` (seeded, and each method's all-defaults baseline candidate is
always kept when present so "tuned <= default" stays certifiable), filters on a
``max_error`` fidelity constraint, and ranks:

    minimize step_time, tie-break on error_proxy, then the canonical
    candidate key — a total order, so the same (space, env, seed) yields
    the same ``TunePlan`` byte-for-byte.
"""

from __future__ import annotations

import numpy as np

from repro_torch.tune.cost import CostModel
from repro_torch.tune.plan import TunePlan, from_search
from repro_torch.tune.space import (Candidate, Env, SearchSpace,
                                    enumerate_valid)


def rank_key(cand: Candidate, cost) -> tuple:
    return (cost.step_time, cost.error_proxy, cand.key())


def search(space: SearchSpace, env: Env, *, top: int = 5,
           budget: int | None = None, seed: int = 0,
           error_probe: bool = True, probe_d: int = 1 << 14,
           max_error: float | None = None,
           cost_model: CostModel | None = None,
           spec=None, device=None) -> TunePlan:
    """Run the tuner; returns the winning ``TunePlan``.

    budget: max candidates to evaluate (None = full grid). Subsampling is
    a seeded permutation of the valid list — deterministic — and always
    retains each method's all-defaults baseline if it survived validation.
    max_error: drop candidates whose error proxy exceeds this (recorded
    in ``plan.skipped`` with the measured value).
    device: where the error probe encodes and recovers (None = the card).
    spec: the base ``repro_torch.api.RunSpec`` the winning candidate is applied
    onto (``plan.spec``); None reconstructs one from ``env`` — for CLI
    runs pass the resolved spec so arch/steps/seed provenance rides along.
    """
    valid, skipped = enumerate_valid(space, env)
    n_valid = len(valid)
    if budget is not None and budget < len(valid):
        rng = np.random.default_rng(seed)
        keep = set(rng.permutation(len(valid))[:budget].tolist())
        baselines = {Candidate(method=m) for m in space.methods}
        for i, (c, _) in enumerate(valid):
            if c in baselines:
                keep.add(i)
        dropped = [valid[i][0] for i in range(len(valid)) if i not in keep]
        skipped = skipped + [{"candidate": c.to_json(),
                              "reason": f"over evaluation budget {budget}"}
                             for c in dropped]
        valid = [valid[i] for i in sorted(keep)]

    cm = cost_model or CostModel(env, error_probe=error_probe,
                                 probe_d=probe_d, probe_seed=seed,
                                 device=device)
    ranked = []
    for cand, rep in valid:
        cost = cm.evaluate(cand, rep)
        geo = {"k": rep.k, "rows": rep.rows, "width": rep.width,
               "buckets": rep.bc.spec.n,
               "bucket_sizes": list(rep.bc.spec.sizes)}
        if max_error is not None and cost.error_proxy > max_error:
            skipped.append({"candidate": cand.to_json(),
                            "reason": (f"error_proxy {cost.error_proxy:.4f}"
                                       f" > max_error {max_error}")})
            continue
        ranked.append((cand, cost, geo))
    ranked.sort(key=lambda t: rank_key(t[0], t[1]))
    return from_search(env, space, ranked, skipped, seed=seed,
                       n_valid=n_valid, error_probe=error_probe,
                       probe_d=probe_d, top=max(1, top), spec=spec)
