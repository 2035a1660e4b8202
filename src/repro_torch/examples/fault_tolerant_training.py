"""Fault-tolerance demo: odd worker counts, mid-run failure, stragglers.

Port of ``examples/fault_tolerant_training.py``, on the card unless
``--device cpu``. gs-SGD's tree all-reduce is defined for ANY P (paper
Fig. 1 parks the largest odd rank per round), so the framework treats
elasticity as a re-plan, not an error:

  phase 1: P=5 workers (odd — exercises Fig. 1's non-power-of-two tree)
  phase 2: worker 3 dies -> replan to P=4, training continues from the
           surviving replicas (state is replicated; nothing is lost)
  phase 3: worker 1 straggles on one step -> its sketch is dropped,
           the update is rescaled P/live (unbiased), and its gradient
           survives in its error-feedback accumulator

    python -m repro_torch.examples.fault_tolerant_training [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import SMOKES
from repro_torch.core.gs_sgd import MeshAxes, make_state, make_train_step
from repro_torch.data import LMStream
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.train import shard_batch
from repro_torch.models.flatten import init_flat_params
from repro_torch.optim import make as make_opt
from repro_torch.runtime import (DeadlinePolicy, carry_survivors,
                                 initial_plan, replan)

CFG = SMOKES["qwen3-4b"]
B, S = 2, 32


def build(P, device):
    ma = MeshAxes(tp=1, data=P, tp_axis=None, data_axis="data")
    opt = make_opt("adamw", lr=2e-3)
    ts = make_train_step(CFG, ma, opt, dp_mode="dp", compressor_name="gs-sgd",
                         compressor_kw=dict(k=4096, rows=5, width=8192,
                                            allreduce_mode="tree"),
                         remat=False, dtype=torch.float32, device=device)
    return ts, opt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    stream = LMStream(vocab_size=CFG.vocab_size, seq_len=S,
                      global_batch=20, seed=0)  # divisible by 5 and 4
    out: dict = {"losses": []}

    def step(ts, state, i, include):
        batch = shard_batch(stream.global_batch_at(i, device), ts.nworkers)
        state, m = ts.fn(state, batch, include.to(device))
        out["losses"].append(float(m["loss"]))
        return state, out["losses"][-1]

    plan = initial_plan(5)
    print(f"phase 1: P={plan.n_workers} (odd) — faithful Alg. 1 tree, "
          f"{len(plan.schedule)} reduce rounds")
    ts, opt = build(5, device)
    params = init_flat_params(CFG, torch.Generator().manual_seed(0), 1,
                              ts.fs)
    state = make_state({k: v.to(device) for k, v in params.items()}, opt,
                       ts.compressor, ts.d_local, 5)
    for i in range(4):
        state, loss = step(ts, state, i, torch.ones(5))
        print(f"  step {i}: loss {loss:.4f}")

    print("phase 2: worker 3 fails -> replan")
    old, plan = plan, replan(plan, failed={3})
    print(f"  survivors {plan.survivor_ids}, P={plan.n_workers}, "
          f"lr_scale {plan.lr_scale:.2f}, generation {plan.generation}")
    state = carry_survivors(state, [old.rank_of(w) for w in
                                    plan.survivor_ids])
    ts4, _ = build(4, device)
    for i in range(4, 7):
        state, loss = step(ts4, state, i, torch.ones(4))
        print(f"  step {i}: loss {loss:.4f}")

    print("phase 3: worker 1 straggles on one step -> drop + rescale")
    pol = DeadlinePolicy(factor=3.0)
    pol.observe([1.0, 1.0, 1.0, 1.0])
    mask = pol.mask([1.0, 30.0, 1.0, 1.0])  # worker 1 is 30x slower
    print(f"  deadline policy include-mask: {mask.tolist()}")
    state, loss = step(ts4, state, 7, torch.tensor(mask,
                                                   dtype=torch.float32))
    print(f"  step 7 (dropped straggler): loss {loss:.4f}")
    state, loss = step(ts4, state, 8, torch.ones(4))
    print(f"  step 8 (straggler's EF re-injects its gradient): "
          f"loss {loss:.4f}")
    div = max(float((v - v[0:1]).abs().max())
              for v in state["params"].values())
    print(f"replica divergence through failure + straggler: {div:.1e}")
    out.update(p_before=old.n_workers, p_after=plan.n_workers,
               survivors=list(plan.survivor_ids), mask=mask.tolist(),
               divergence=div)
    return out


if __name__ == "__main__":
    main()
