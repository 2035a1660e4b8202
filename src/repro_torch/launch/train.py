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
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json \
      --buckets 4 --bwd-chunks 2 --fuse-encode --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json \
      --microbatch 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json \
      --steps 4 --ckpt-dir /tmp/ck --ckpt-every 1 --kill-at 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --spec examples/specs/qwen3_smoke.json \
      --steps 4 --ckpt-dir /tmp/ck --ckpt-every 1 --resume --device cpu

Checkpoints (``--ckpt-dir``, ``--ckpt-every``) hold the whole train state
(params, optimizer moments, error feedback, step) and the data cursor; the
stream is counter-based (a step's batch depends on the step alone), so a
run resumed with ``--resume`` from the latest checkpoint continues
bit-exactly. ``--kill-at N`` stops after step N as a crash would (tests).

Not ported yet: ``--trace``, ``--json`` traces, the drift watchdog and
``--auto-tune``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import api
from repro_torch import ckpt as ckpt_lib
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
    if ts.bwd_chunks:
        ready = list(ts.plan.readiness) if ts.plan is not None else None
        print(f"backward-interleaved readiness: {ts.bwd_chunks} chunk(s), "
              f"bucket readiness {ready}, "
              f"fuse_encode={'on' if ts.fuse_encode else 'off'}")
    return cfg, opt, ma, ts


def resolve_spec(args) -> RunSpec:
    """base (--spec file or defaults) <- CLI flags."""
    base = RunSpec.load(args.spec) if args.spec else RunSpec()
    spec = api.apply_args(base, args, "train")
    spec.validate()
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
               last: int | None = None, after_step=None):
    """Run ``ts.fn`` over ``steps``; ``batch_at(step)`` gives the global
    batch. Returns (state, losses, per-step seconds). Each step ends in a
    device synchronise, so its time is the whole step's.
    ``after_step(step, state, loss)``, if given, runs after each step (the
    checkpoint hook); the loop stops when it returns True."""
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
        if after_step is not None and after_step(step, state, loss):
            break
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
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="simulate a crash after this step (tests)")
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
    start, saver = 0, None
    if spec.ckpt_dir:
        saver = ckpt_lib.AsyncCheckpointer(spec.ckpt_dir, keep=3)
        if args.resume and ckpt_lib.latest_step(spec.ckpt_dir) is not None:
            state, meta = ckpt_lib.restore(spec.ckpt_dir, state,
                                           device=ts.device)
            start = meta["step"]
            gen.set_state(torch.tensor(meta["generator_state"],
                                       dtype=torch.uint8))
            print(f"resumed from step {start}")

    def meta_at(step: int, loss: float) -> dict:
        return {"loss": loss, "data_cursor": step, "seed": spec.seed,
                "generator_state": gen.get_state().tolist(),
                "device": str(ts.device)}

    def after_step(step: int, state: dict, loss: float) -> bool:
        if saver and (step + 1) % spec.ckpt_every == 0:
            saver.save(step + 1, state, meta_at(step + 1, loss))
        if args.kill_at is not None and step + 1 >= args.kill_at:
            print(f"simulated crash at step {step + 1}")
            return True
        return False

    state, history, _ = train_loop(
        ts, state, lambda s: stream.global_batch_at(s, ts.device),
        range(start, spec.steps), log_every=args.log_every,
        last=spec.steps - 1, after_step=after_step)
    if args.kill_at is not None and start + len(history) >= args.kill_at:
        if saver:
            saver.wait()
        return {"history": history, "crashed_at": start + len(history)}
    if saver:
        saver.save(spec.steps, state, meta_at(spec.steps, history[-1]))
        saver.wait()
    print(json.dumps({"final_loss": history[-1], "steps": len(history)}))
    return {"history": history, "final_loss": history[-1], "state": state}


if __name__ == "__main__":
    main()
