"""Quickstart: the gs-SGD pieces in one minute.

Port of ``examples/quickstart.py``, on the card unless ``--device cpu``:

1. Count-Sketch a gradient, merge sketches from 4 workers by addition,
   recover the global top-k with HEAVYMIX — no coordinates on the wire.
   On the card the encode and the recovery run the hand-written kernels
   (``kernels.ops``: the encode and its finish, the scores kernel and the
   top-k select); on the CPU their plain versions.
2. Run 10 steps of distributed training (4 simulated workers on a leading
   dimension, collective-exact) with gs-SGD compressing the exchange.

    python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.api import ClusterSpec, ExchangeSpec, RunSpec, SketchSpec
from repro_torch.core import count_sketch as cs
from repro_torch.kernels import ops
from repro_torch.kernels.dispatch import resolve_device


def part1_sketch_and_recover(device) -> dict:
    print("=== 1. sketch -> merge -> HEAVYMIX ===")
    d, k, P = 100_000, 16, 4
    cfg = cs.SketchConfig(rows=5, width=4096, seed=0)

    # a gradient with 16 planted heavy coordinates, split across 4 workers
    gen = torch.Generator(device).manual_seed(0)
    g = 0.01 * torch.randn((d,), generator=gen, device=device)
    hot = torch.randperm(d, generator=gen, device=device)[:k]
    g[hot] = 5.0
    parts = torch.stack([g / P] * P)  # each worker holds 1/P of it

    sketches = [ops.encode(cfg, p) for p in parts]       # local compress
    summed = cs.merge(*sketches)                         # linear merge!
    idx, est = ops.heavymix_recover(cfg, summed, k, d)   # global top-k
    found = set(idx.tolist()) & set(hot.tolist())
    print(f"  sketch: {d} floats -> {cfg.rows}x{cfg.width} "
          f"({cfg.size / d:.1%} of d)")
    print(f"  recovered {len(found)}/{k} planted heavy coords, "
          f"est[0] = {float(est[0]):.2f} (true 5.00)")
    return {"recovered": len(found), "k": k, "est0": float(est[0])}


def part2_distributed_training(device) -> dict:
    print("=== 2. 4-worker gs-SGD training (simulated workers, "
          "collective-exact) ===")
    # ONE spec describes the whole run (repro_torch.api) — the same
    # object the train/simulate/tune CLIs build from their flags.
    spec = RunSpec(
        arch="qwen3-4b", smoke=True, lr=2e-3, remat=False,
        exchange=ExchangeSpec(compressor="gs-sgd",
                              sketch=SketchSpec(k=4096, rows=5, width=8192)),
        cluster=ClusterSpec(p=4))
    spec.validate()
    cfg, P = spec.arch_config(), spec.cluster.p
    opt = spec.make_optimizer()
    ts = spec.make_train_step(opt=opt, device=device)
    state = ts.init_state(opt, torch.Generator(device).manual_seed(0))
    losses = []
    for i in range(10):
        gen = torch.Generator(device).manual_seed(i)
        toks = torch.randint(0, cfg.vocab_size, (P, 2, 32), generator=gen,
                             device=device)
        state, m = ts.fn(state, {"tokens": toks, "labels": toks})
        losses.append(float(m["loss"]))
        if i % 3 == 0:
            print(f"  step {i}: loss {losses[-1]:.4f}")
    sync = max(float((v - v[0:1]).abs().max())
               for v in state["params"].values())
    print(f"  replica divergence after 10 compressed steps: {sync:.1e} "
          "(bit-exact)")
    return {"losses": losses, "divergence": sync}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return {"sketch": part1_sketch_and_recover(device),
            "train": part2_distributed_training(device)}


if __name__ == "__main__":
    main()
