"""Time the full-width training paths that ``chip_smoke.py`` drives, so two
trees can be compared in one run on the card:

    python src/repro_torch/bench/time_paths.py [--src DIR] [--tag T]
        [--paths train,train_ts,train_interleave,train_bucketed4,train_minicpm]

``--src`` is the ``src`` directory whose ``repro_torch`` runs (default:
this checkout's); unpack the other tree (``git archive``) into a directory
``.gitignore`` lists and run this script once for each, in turns.

Each path is ``chip_smoke.py``'s cell (qwen3-4b widths, 2 layers, P = 2,
batch 8, seq 64, AdamW, R = 5): ``train`` (buckets = 2), ``train_ts`` (the
same with ``encoder="ts"``), ``train_interleave`` (buckets = 4,
bwd_chunks = 2, fuse_encode) and ``train_bucketed4`` (buckets = 4); and
``train_minicpm`` (``chip_smoke.minicpm_step``: minicpm-2b widths, 2
layers, microbatch 2, clip 1.0, wsd, the faithful fill), which a tree
without those modules reports as skipped. It runs
three steps from seed 0 (host clock around each step, which ends in a
synchronize; the first is warm-up), then one step under ``torch.profiler``
(``chip_smoke.profile_phase``: device time per span, idle share). Prints
one JSON line a path: the losses (JSON floats, so two trees' losses can be
compared bit for bit), the step seconds, the peak device memory over the
three steps, the profiled step's spans, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
PATHS = ("train", "train_ts", "train_interleave", "train_bucketed4",
         "train_minicpm")


def run_path(torch, cs_, name, device):
    """Three steps and a profiled one of path ``name``; its JSON record."""
    from repro_torch.data import LMStream
    from repro_torch.launch.train import train_loop
    if name == "train_minicpm":
        try:
            cfg, opt, ts, _, _ = cs_.minicpm_step(torch, device)
        except (ImportError, NotImplementedError) as e:
            return {"path": name, "skipped": f"{type(e).__name__}: {e}"}
    elif name in ("train", "train_ts"):
        cfg, opt, ts = cs_.full_width_step(torch, device)
        if name == "train_ts":
            ts = cs_.full_width_ts_step(torch, device, ts, opt)
    else:
        cfg, opt, ts = cs_.full_width_step(
            torch, device, buckets=cs_.INTERLEAVE_BUCKETS,
            bwd_chunks=(cs_.INTERLEAVE_CHUNKS
                        if name == "train_interleave" else None),
            fuse_encode=name == "train_interleave")
    state = ts.init_state(opt, torch.Generator(device=ts.device)
                          .manual_seed(0))
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=cs_.TRAIN_SEQ,
                      global_batch=cs_.TRAIN_BATCH, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses, times = train_loop(
        ts, state, lambda s: stream.global_batch_at(s, ts.device),
        range(cs_.TRAIN_STEPS), log_every=cs_.TRAIN_STEPS,
        last=cs_.TRAIN_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    state, prof = cs_.profile_phase(torch, ts, state, stream,
                                    tag=f"paths_{name}")
    del state, ts
    torch.cuda.empty_cache()
    return {"path": name, "losses": losses, "step_s": times,
            "max_memory_allocated": peak,
            "profiled": {key: prof[key] for key in (
                "step_wall_ms", "device_busy_ms", "idle_share",
                "span_device_ms", "outside_spans_ms", "unlinked_ms")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--paths", default=",".join(PATHS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_paths: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs_
    sys.path.insert(0, os.path.abspath(args.src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs_.card_line()
    for name in args.paths.split(","):
        if name not in PATHS:
            raise SystemExit(f"time_paths: unknown path {name!r}")
        rec = run_path(torch, cs_, name, torch.device("cuda"))
        print(json.dumps({"tag": args.tag, **rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
