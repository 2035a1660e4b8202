"""End-to-end run: train a ~100M-parameter LM with gs-SGD.

Port of ``examples/train_lm_e2e.py``, on the card unless ``--device
cpu``. A GPT-2-small-scale llama-style model (12L, d=768, 12H, vocab 32k
— ~110M params), 4 simulated data-parallel workers, gs-SGD gradient
compression (k = 0.5% of d, W = 2^20), warmup-cosine LR, periodic async
checkpointing (``ckpt.AsyncCheckpointer``) with resume, on the
deterministic learnable token stream.

    python -m repro_torch.examples.train_lm_e2e --steps 200
    python -m repro_torch.examples.train_lm_e2e --steps 300 --resume

Checkpoints go to ``experiments/lm_e2e_ckpt_torch/`` unless
``--ckpt-dir`` says otherwise. ``main(argv, cfg=...)`` trains another
``ArchConfig`` (the tests pass a narrow one).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import ckpt as ckpt_lib
from repro_torch.core.gs_sgd import MeshAxes, make_state, make_train_step
from repro_torch.data import LMStream
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.train import shard_batch
from repro_torch.models.common import ArchConfig
from repro_torch.models.flatten import init_flat_params
from repro_torch.optim import make as make_opt
from repro_torch.optim.schedule import warmup_cosine

LM_100M = ArchConfig(
    name="lm-110m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=2048, vocab_size=32768,
    notes="GPT-2-small-scale llama-style demo model (~110M params)",
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
CKPT_DIR = os.path.join(ROOT, "experiments", "lm_e2e_ckpt_torch")


def main(argv=None, cfg: ArchConfig = LM_100M) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--k", type=int, default=524288, help="~0.5%% of d")
    ap.add_argument("--width", type=int, default=2 ** 20)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    P = args.workers
    ma = MeshAxes(tp=1, data=P, tp_axis=None, data_axis="data")
    opt = make_opt("adamw",
                   lr=warmup_cosine(3e-4, warmup=20, total=args.steps))
    ts = make_train_step(cfg, ma, opt, dp_mode="dp",
                         compressor_name="gs-sgd",
                         compressor_kw=dict(k=args.k, rows=5,
                                            width=args.width),
                         remat=True, dtype=torch.float32, device=device)
    print(f"model: {ts.fs.total / 1e6:.1f}M params, "
          f"compressing to k={args.k} ({args.k / ts.fs.total:.2%}) "
          f"over {P} workers")

    params = init_flat_params(cfg, torch.Generator(device).manual_seed(0),
                              1, ts.fs, device=device)
    state = make_state(params, opt, ts.compressor, ts.d_local, P)
    del params

    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch * P, seed=0)
    saver = ckpt_lib.AsyncCheckpointer(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        state, meta = ckpt_lib.restore(args.ckpt_dir, state)
        start = meta["step"]
        print(f"resumed at step {start}")

    losses: dict[int, float] = {}
    t0 = time.time()
    for i in range(start, args.steps):
        batch = shard_batch(stream.global_batch_at(i, device), P)
        state, m = ts.fn(state, batch)
        losses[i] = float(m["loss"])
        if i % 10 == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(f"step {i:4d}  loss {losses[i]:.4f}  "
                  f"gnorm {float(m['grad_norm'][0]):.3f}  [{dt:.0f}s]")
        if (i + 1) % 50 == 0:
            saver.save(i + 1, state, {"loss": losses[i]})
    train_s = time.time() - t0
    saver.save(args.steps, state, {})
    saver.wait()
    print(f"done; checkpoints in {args.ckpt_dir}")
    return {"params": ts.fs.total, "start": start, "losses": losses,
            "train_s": train_s, "seconds": time.time() - t0,
            "ckpt_dir": args.ckpt_dir}


if __name__ == "__main__":
    main()
