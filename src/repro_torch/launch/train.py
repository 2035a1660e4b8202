"""Training driver — spec-first (``repro_torch.api.RunSpec``).

Port of ``repro/launch/train.py``: the flags are generated from the spec
fields, ``--spec SPEC.json`` loads a full spec as the base, and
explicitly-passed flags override it. P data-parallel workers are
simulated on the leading axis of the state (see ``core/gs_sgd.py``). The
run goes on the CUDA card unless ``--device cpu`` is given; with no card
and no ``--device`` it stops with an error.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --smoke \
      --workers 2 --steps 3 --device cpu

Not ported yet: checkpoints, ``--trace``, ``--json`` traces, the drift
watchdog and ``--auto-tune``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import api
from repro_torch.api import RunSpec
from repro_torch.data import LMStream


def build(spec: RunSpec, device=None):
    """cfg/opt/ma/TrainStep from the spec — the one construction path."""
    cfg = spec.arch_config()
    opt = spec.make_optimizer()
    ma = spec.mesh_axes()
    ts = spec.make_train_step(opt=opt, dtype=torch.float32, device=device)
    if ts.n_buckets > 1:
        sizes = ts.compressor.spec.sizes
        print(f"bucketed exchange: {ts.n_buckets} buckets "
              f"(sizes {list(sizes)}), "
              f"overlap={'on' if spec.exchange.overlap else 'off'}")
    return cfg, opt, ma, ts


def resolve_spec(args) -> RunSpec:
    """base (--spec file or defaults) <- CLI flags."""
    base = RunSpec.load(args.spec) if args.spec else RunSpec()
    spec = api.apply_args(base, args, "train")
    spec.validate()
    if spec.ckpt_dir:
        raise NotImplementedError("checkpoints are not ported yet")
    if spec.trace:
        raise NotImplementedError("span tracing is not ported yet")
    if (spec.watch or {}).get("enabled"):
        raise NotImplementedError("the drift watchdog is not ported yet")
    return spec


def shard_batch(gb: dict, nworkers: int) -> dict:
    """(B, S) global batch -> (P, B/P, S) per-worker rows."""
    out = {}
    for k, v in gb.items():
        if v.shape[0] % nworkers:
            raise ValueError(f"global batch {v.shape[0]} is not divisible "
                             f"by {nworkers} workers")
        out[k] = v.reshape((nworkers, v.shape[0] // nworkers) + v.shape[1:])
    return out


def train_loop(ts, state: dict, batch_at, steps, *, log_every: int = 10,
               last: int | None = None):
    """Run ``ts.fn`` over ``steps``; ``batch_at(step)`` gives the global
    batch. Returns (state, losses, per-step seconds). Each step ends in a
    device synchronise, so its time is the whole step's."""
    history, times = [], []
    t0 = time.time()
    for step in steps:
        batch = shard_batch(batch_at(step), ts.nworkers)
        t_step0 = time.time()
        state, m = ts.fn(state, batch)
        if ts.device.type == "cuda":
            torch.cuda.synchronize(ts.device)
        loss = float(m["loss"])
        times.append(time.time() - t_step0)
        history.append(loss)
        if step % log_every == 0 or step == last:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"({(time.time() - t0):.1f}s)", flush=True)
    return state, history, times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="gs-SGD training driver "
                                             "(PyTorch port)")
    api.add_spec_args(ap, "train")
    ap.add_argument("--spec", default=None, metavar="SPEC.json",
                    help="load a RunSpec as the base config (explicit "
                         "flags still override)")
    ap.add_argument("--dump-spec", default=None, metavar="PATH",
                    help="write the fully-resolved RunSpec JSON and continue")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain path)")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    spec = resolve_spec(args)
    if args.dump_spec:
        spec.save(args.dump_spec)
        print(f"wrote resolved spec to {args.dump_spec}")
    cfg, opt, ma, ts = build(spec, args.device)
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                      global_batch=spec.batch, seed=spec.seed)
    gen = torch.Generator(device=ts.device).manual_seed(spec.seed)
    state = ts.init_state(opt, gen)
    state, history, _ = train_loop(
        ts, state, lambda s: stream.global_batch_at(s, ts.device),
        range(spec.steps), log_every=args.log_every, last=spec.steps - 1)
    print(json.dumps({"final_loss": history[-1], "steps": len(history)}))
    return {"history": history, "final_loss": history[-1]}


if __name__ == "__main__":
    main()
