#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build     — compile every kernel from ``src/repro_torch/csrc`` with
                ``nvcc`` (one process per source, all started together) and
                load them.
2. kernels   — call each kernel's wrapper on the card at the shapes the
                full-width step gives it (the exact encode bit-equal to its
                plain version, to a second launch and to a launch with
                other splits and pass size, and with NaN, +-inf and
                out-of-range elements planted; the decode with and
                without its first-digit histogram and the top-k select at
                both buckets, with their launch geometry, and the encode
                also at the CLI's default sketch width; the others at
                bucket 0) plus small odd cases and a scores-regime case
                whose heavy set far outnumbers k, hold it against its plain
                PyTorch version, and time kernel, plain version, library
                yardstick and bound; the recovery's old route (decode +
                ``topk_lower_index``) against its new one (decode with
                histogram + select), and one recovery under
                ``torch.cuda.set_sync_debug_mode("error")``. The TS encode
                at both buckets and the CLI's default width, with the plan's
                kernel and (where that is the one-pass kernel) the R-pass
                kernel; the TS route's recovery at both buckets (the row
                transpose, then the TS-map scores kernel with its histogram
                reading it, then the select) against its plain version and
                its old route (``ts.decode`` + ``heavymix(estimates=)``),
                once under the sync check; the transpose and the TS-map
                scores also at the CLI's default width (n_r reaches W).
                NaN: bucket 1's sketch with NaN planted, through the decode,
                the scores and the TS-map scores kernels (bits equal to
                plain, NaN at the same coordinates) and the select (the
                reference's order, NaN first). The select with its slabs
                forced to overflow, in every CTA and in some, on bucket 0's
                est, on the TS scores (all heavy keys tied at 1e30) and on
                the NaN keys: equal to ``topk_lower_index``, the device
                counter equal to the CTAs over capacity.
3. train     — the main path: three gs-SGD steps of qwen3-4b at its
                published widths (depth cut to 2 layers), P=2 workers,
                buckets=2, psum, AdamW, SketchSpec(rows=5, width=None,
                k=None). Both buckets are past 2^22 coordinates, so the
                recovery runs the decode kernel (with its histogram) and
                the select, not the scores kernel; the encode (its
                accumulate and its finish, each a launch counted on its
                own), the decode and the select launch once per recovery:
                12 times each.
4. profile   — one more full-width step under ``torch.profiler``: device
                time per span (loss_and_grad / encode / allreduce / recover
                / optimizer; each device event counted once, in the span
                that holds its launch) and the device's idle share. Not
                counted.
4b. train_traced — the driver's loop (``launch.train.drive``, as ``--trace
                --json`` runs it) at the same cell, from a RunSpec whose d
                is the 2-layer d: three steps untraced, then the same three
                steps with the tracer and the trace@2 recorder (losses
                bit-equal). The trace validates; one probe span (the second
                step's inputs on a copy of the state, output discarded) and
                a step span a step (step 0 warmup); the probe's phases
                backward, encode, comm, recover, optimizer all > 0, a span
                a bucket; the trace@2 document has a record a step,
                ``predicted`` without ``error``, ``recovery_error_probe``
                (its encode and scores-route recovery launched on the card)
                and provenance naming the card. Prints the probe's phases
                beside ``profile``'s spans, the traced steps against the
                untraced, the copy's bytes and the peak; the launches are
                the path's (3 steps + the probe).
4c. train_watched — the same cell with the drift watchdog forced hot
                (warmup 1, delta -1, threshold 0, budget 4): every detection
                reaches a decision, an applied re-plan clears the 1% gain
                bar, and the rebuilt step (the re-plan's exchange at the
                cell's widths) runs at least two steps with finite losses
                and launches what its geometry implies.
5. train_ts  — three steps of the same cell with gs-SGD's TS-sketch encoder
                (``compressor_kw`` ``encoder="ts"``): the TS encode kernel,
                and the recovery through the TS-map scores kernel and the
                select (once per recovery: 12 times); then one more step
                under the profiler, as in 4 (not counted).
6. train_interleave — the same full-width cell at buckets=4 with the
                chunked backward and the fused encode (bwd_chunks=2,
                fuse_encode=True): the partial encodes timed at the
                fragment sizes the cell gives them against the whole-bucket
                encode; three steps, counted (sketch_encode 14 times a step:
                7 fragments x 2 workers; sketch_encode_finish once a bucket
                and step, for both workers; the decode for buckets 0-2, the
                scores kernel for bucket 3, the select for each; no plain
                version called); one more step with each fused sketch held
                against the whole-bucket encode of the same u; one
                profiled step (profile_interleave: split, idle share, peak
                memory); then three steps of the same cell with
                bwd_chunks=None from the same seed (train_bucketed4): the
                first losses equal, the later ones within
                INTERLEAVE_LOSS_RTOL, and after the three steps the same
                selected coordinates (EF zero pattern) and the params within
                INTERLEAVE_PARAM_RTOL / _ATOL; one profiled step of it
                (profile_bucketed4). The fragments merged and each fused
                sketch are bit-equal to the whole-bucket encode (the encode
                is exact), and the finish kernel that converts the merged
                exact sketch is timed (its own row). Each bucket's row also
                times the zeroing of one exact accumulator, which every
                partial encode pays.
6b. train_minicpm — minicpm-2b at its published widths (2 layers, tied
                embeddings), P=2, buckets=2, batch 8, seq 64, microbatch 2,
                clip 1.0, AdamW under wsd (lr 0, TRAIN_LR, 0.55 TRAIN_LR at
                steps 0-2), HEAVYMIX's faithful fill: three counted steps
                (sketch_encode, sketch_encode_finish, heavymix_scores with
                its filler operand and topk_select 12 times each, the
                decode never, no plain
                version called); step 0's microbatched loss against the
                full-batch loss and the applied gradient's norm against
                min(grad_norm, clip), within MINICPM_RTOL; a profiled step
                (profile_minicpm); the filler scores kernel at the cell's
                shapes, bit-equal to plain.
6c. train_moe — granite-moe-3b-a800m at its published widths (d_model
                1,536, 24/8 heads, 40 experts top-8 of d_ff 512, vocab
                49,155 padded to 49,280, tied embeddings), 32 -> 4 layers,
                under the main path's exchange (P=2, buckets=2, batch 8,
                seq 64, AdamW, psum, R = 5): d = 478,606,848 in buckets
                (277,022,208, 201,584,640), both past 2^22, so three
                counted steps launch the encode, its finish, the decode and
                the select 12 times each and the scores kernel never; the
                capacity and each step's dropped share of the (token,
                choice) pairs (an untimed no-grad forward before each
                step); one profiled step (profile_moe); then one more step
                whose worker-0 packed gradient of each bucket is run
                through the path's kernels (the encode and its finish, the
                decode, the select) and held bit-equal to their plain
                versions (route checks).
6d. train_hybrid — zamba2-2.7b at its published widths (d_model 2,560,
                32 heads, d_ff 10,240, ssm_state 64, vocab 32,000), 54 ->
                12 layers (two cycles of six Mamba2 blocks and the shared
                attention block): d = 663,336,448; three counted steps as
                in 6c and one profiled step (profile_hybrid); then three
                steps at buckets=4, bwd_chunks=2 (one cycle a chunk),
                fuse_encode (train_hybrid_interleave) against three at
                bwd_chunks=None from the same seed (train_hybrid_bucketed4),
                held as in 6: the first losses equal, the later ones within
                INTERLEAVE_LOSS_RTOL, the same selected coordinates and the
                params within INTERLEAVE_PARAM_RTOL / _ATOL. The route
                checks of 6c after the profiled step and after the
                interleave (there on each fused sketch too, against the
                plain encode; bucket 3's 30,720 coordinates go the scores
                route); the interleave's decode and scores launches as
                each bucket's size and k route it.
6e. train_elastic — the train_minicpm cell's step (minicpm-2b widths, 2
                layers, d = 405,220,864, buckets 2, microbatch 2, clip, wsd,
                the faithful fill) on the Alg. 1 tree, global batch
                ELASTIC_BATCH: two steps at P = 4; worker 2 stops beating
                and the heartbeat monitor (an explicit clock) reports it;
                ``replan`` to generation 1 (lr_scale printed); the
                survivors' state rows carried leaf by leaf
                (``runtime.carry_survivors``), the P = 4 state freed; a
                step built fresh at P = 3 (the tree parks the odd rank)
                runs two steps, then one in which
                ``DeadlinePolicy`` (fed those steps' times, then one 30x
                outlier) drops worker 1, and one with every worker. Each
                step: a finite loss and bit-equal replicas. The drop step's
                exchange held (``checked_drop``): the update on each
                bucket's selection the live sum x P/live, the dropped
                worker's EF its error-corrected gradient bit for bit.
                Counted: encode, finish, scores (with the filler) and
                select 40 times each, the decode never, no plain version;
                the route checks of 6c on the last step's worker-0
                gradient; step seconds at P = 4 and 3, peak memory.
7. parity    — two steps of examples/specs/qwen3_smoke.json on the card
                (kernels) and on the CPU (plain versions) from the same
                params and batches: losses and selected coordinates agree.
                Its buckets are below 2^22: the scores kernel's path (with
                its histogram, then the select). The same for the smoke
                configs of yi-9b, minicpm-2b and starcoder2-3b.
7a. parity_elastic — examples/fault_tolerant_training.py's scenario at
                the smoke config (P = 5 on the tree, worker 3 fails,
                ``replan`` and the survivors' rows at P = 4, a
                ``DeadlinePolicy`` drop, a step with all; k 4096, W 8192,
                ``LMStream(global_batch=20)``) on the card and on the CPU
                port: the selected coordinates equal every step, losses
                within PARITY_LOSS_RTOL, replica divergence 0 on both.
7b. parity_families — the same for the smoke configs of granite-moe,
                qwen3-moe, rwkv6, zamba2, llama-3.2-vision and musicgen;
                llama-3.2-vision once more with seeded ``cross_kv`` patch
                embeddings in its batches, and qwen3-moe once more with its
                override row's SGD with momentum and bf16 EF, passed in.
7c. train_cnn — the paper's experiment at full size (bench/cnn_dist.py):
                ResNet-20 (d = 272,282) and VGG-16 (d = 14,724,042), P = 4,
                global batch 32, gs-SGD at time_breakdown.paper_geometry's
                (k, W) ((1,089, 1,024) and (58,896, 32,768)), R = 5, SGD
                with momentum at lr 0.02, cuDNN deterministic and TF32 off:
                five counted steps each (the encode, its finish and the
                select once a worker and step; ResNet-20 the scores kernel
                and never the decode, VGG-16 the reverse; no plain version
                called); a second run with the same loss bits; five steps
                with cuDNN nondeterministic and its autotuner (the cost of
                the deterministic mode); one more step whose worker-0
                gradient runs through the cell's kernels, bit-equal to
                plain and timed at its shapes (``cnn_shapes`` in the kernels
                line); the CPU port's steps from the same params and
                batches (ResNet-20 all five, VGG-16 the first): losses
                within PARITY_LOSS_RTOL, and the first step's selection
                equal but for near-ties (CNN_TIE_RTOL).
7d. paper_table2 — ``bench.throughput.main`` on the card (Table II at full
                size): each method's t_compu, t_compr, t_commu (Eq. 1 at
                1 GbE), images/s measured and modelled, g/k and g/s; no
                ratio asserted.
7e. paper_figs — ``bench.convergence.main`` and ``bench.k_sensitivity.main``
                (Figs. 2-3, 6-7) for 10 steps on the card: finite losses.
8. baselines — every compressor of the registry, two smoke-spec steps on the
                card and on the CPU from the same params and batches.
9. cli       — ``python -m repro_torch.launch.train --spec
                examples/specs/qwen3_smoke.json`` on the card, then the same
                with ``--buckets 4 --bwd-chunks 2 --fuse-encode``; then four
                steps with a checkpoint every step and ``--kill-at 2``,
                ``--resume`` to step 4, and four steps straight: the final
                losses and the step-4 checkpoints' tensors bit-equal.
10. cli_tune — ``train --trace --json`` on the card at the smoke spec and
                two more ``--json`` captures (buckets 1; buckets 1 at width
                1,024), ``python -m repro_torch.launch.tune --spec SPEC
                --calibrate`` on the three trace@2 files ``--out PLAN``,
                then ``train --auto-tune PLAN`` and ``train`` with
                ``plan.train_argv()``: loss histories bit-equal.
10b. cli_simulate — ``python -m repro_torch.launch.simulate`` (host only):
                P = 1,024, buckets 8, ``--fault-trace
                examples/traces/fail_rejoin.json`` on ``--engine batched``
                and ``loop`` (the ``--out`` files equal, the ``--json``
                curves a step each), and a ``--watch --congest`` run that
                re-plans, its ``--trace`` validated; the simulator's own
                wall seconds printed as host time.
11. serve     — qwen3-4b at its published widths and all 36 layers (f32,
                4,022,468,096 parameters) through ``ServeEngine`` with the
                paged cache: 8 slots, block 16, max_len 256, 12 seeded
                prompts of 16-192 tokens, 64 new tokens each. A cold and a
                steady run (tok/s, TTFT and per-token wall p50/p95/p99,
                peak memory); a lockstep against ``ContiguousKVCache``
                (the same emissions every step, the gathered KV bit-equal
                on every valid position of every active slot, the state
                on every slot); each request alone in an engine of its own
                (continuous batching's tokens equal); prefill/decode
                consistency (tokens equal unless the prefill's top-2 logit
                margin is within SERVE_TIE_ATOL); one decode step with 8
                active slots under the profiler (profile_serve); a
                ``ReplicaSet`` of 2 with one killed after 3 rounds against
                one replica (the same tokens, re-planned once, replays).
                No kernel of the sketch path may launch (counts zeroed
                before, read after: all 0).
11b. serve_families — the same checks (without the profile and the
                replicas) at published widths for zamba2-2.7b (Mamba2
                state + the shared block's KV), rwkv6-7b (state only) and
                granite-moe-3b-a800m (MoE decode); the depth each runs at
                is in SERVE_CELLS.
11c. serve_parity — the ten smoke configs' ``prefill_fn`` (logits within
                SERVE_PARITY_ATOL) and two ``decode_fn`` steps (scalar,
                then per-row ``kv_len``: ids equal unless the CPU's top-2
                margin is within SERVE_TIE_ATOL), card against the CPU
                port from the same params, the vlm with ``cross_kv``; the
                engine for the nine non-vlm ones: the same completions.
11d. serve_load, cli_serve — ``python -m repro_torch.bench.serve_load``
                on the card (all four checks), ``python -m
                repro_torch.launch.serve --smoke`` (the demo) and ``--smoke
                --load-test`` on the card; JSON into a temporary directory.

Every path that launches kernels (train, train_traced, train_watched,
train_ts, train_interleave, train_minicpm, train_elastic, train_moe,
train_hybrid and its interleave, parity, parity_elastic, parity_families,
train_cnn) runs with every
launch counter set to 0 just before and read just after; each kernel of
the path must have launched, and the JSON line reports those counts. The
serve phases run no kernel of the sketch path: their counts, summed
(``launches_serve``), must be 0. The
select's slab-overflow counter is zeroed before each path too and read
after it (a host sync, outside the path).

The last lines are the card's name and power limit (nvidia-smi), one JSON
object with every kernel's numbers (bucket 0's; a kernel timed at several
shapes lists each under ``shapes``), and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12   # f32 outside the tensor cores

# Full-width cell of the main path.
TRAIN_P, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 8, 64, 3, 1e-3

# Tolerances.
ENCODE_REL_TOL = 1e-4   # |kernel - plain| / max|S|: the TS encoder adds in
#                         another order (its kernel's fixed per-bucket
#                         order); n*eps*sum|x|/max|S| stays below. The exact
#                         encoder (integer limb sums) is held bit-equal to
#                         plain, with this bound checked beside it
PARITY_LOSS_RTOL = 1e-3  # card vs CPU: f32 matmuls and sketch sums in
#                          another order, then AdamW (the CPU port matches
#                          the JAX package at 1e-4)
INTERLEAVE_LOSS_RTOL = 1e-5  # interleaved (fused) vs bucketed step on the
#                          card, after the first step (whose losses are
#                          equal: the same forward). The fused sketch is
#                          within ENCODE_REL_TOL * max|S| of the whole-bucket
#                          encode, so the runs' estimates differ by at most
#                          2e-4 * max|S|, and only coordinates in that band
#                          of the k-th key can change places in the
#                          selection; the rest is the same ops on the same
#                          values (the selected coordinates' exact values are
#                          fetched). A swap moves one param by one AdamW step
#                          (about lr) and the loss by about lr * |g_i|, g_i
#                          near the k-th key: well below 1e-5 of a loss near
#                          12. The selection and the params are compared
#                          directly too (INTERLEAVE_PARAM_*)
INTERLEAVE_PARAM_RTOL, INTERLEAVE_PARAM_ATOL = 1e-5, 1e-6  # params after the
#                          counted steps, as tests/test_torch_fused_encode.py
#                          holds fused against unfused; a swapped coordinate
#                          moves its param by about lr, far beyond atol
INTERLEAVE_BUCKETS, INTERLEAVE_CHUNKS = 4, 2

# The train_minicpm cell: minicpm-2b at its published widths, 40 -> 2
# layers, microbatch 2 (two slices a worker), the global-norm clip at 1.0,
# AdamW under wsd(TRAIN_LR, warmup=1, stable=0, decay=2), HEAVYMIX's
# faithful fill (filler drawn from a generator seeded 0).
MINICPM_LAYERS, MINICPM_MICROBATCH, MINICPM_CLIP = 2, 2, 1.0
MINICPM_RTOL = 1e-5  # step 0's microbatched loss (the mean of two slices'
#                      losses) against the full-batch loss of the same
#                      params, and the applied gradient's norm against
#                      min(grad_norm, clip): f32 sums in another grouping,
#                      a few ulp of values near 12 and near the norm
NEW_SMOKE_ARCHS = ("yi-9b", "minicpm-2b", "starcoder2-3b")

# The model zoo's other families at their published widths: granite-moe-
# 3b-a800m cut from 32 to 4 layers and zamba2-2.7b from 54 to 12 (two
# cycles of six Mamba2 blocks and the shared block), each under the main
# path's exchange; zamba2 also at buckets 4 with the chunked backward
# (one cycle a chunk) and the fused encode. d as tests/test_torch_families.py
# pins them.
MOE_LAYERS, MOE_D = 4, 478_606_848
MOE_BUCKETS = (277_022_208, 201_584_640)
HYBRID_LAYERS, HYBRID_D, HYBRID_CHUNKS = 12, 663_336_448, 2
FAMILY_SMOKE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
                      "rwkv6-7b", "zamba2-2.7b", "llama-3.2-vision-11b",
                      "musicgen-large")

# The paper's experiment (train_cnn): ResNet-20 and VGG-16 at full size,
# P = 4, global batch 32, gs-SGD at time_breakdown.paper_geometry's (k, W),
# R = 5, SGD with momentum 0.9 at lr 0.02 (bench/cnn_dist.py). d as
# tests/test_torch_paper_bench.py pins them; VGG-16's d is past 2^22 and
# 4k (the decode route), ResNet-20's is not (the scores route). The CPU
# side runs ResNet-20's steps in full and VGG-16's first step (its plain
# encode and decode take ~8 s a worker on a CPU).
CNN_P, CNN_BATCH, CNN_STEPS, CNN_LR, CNN_FIG_STEPS = 4, 32, 5, 0.02, 10
CNN_CELLS = (("resnet20", 272_282, False, CNN_STEPS),
             ("vgg16", 14_724_042, True, 1))
CNN_TIE_RTOL = 1e-3  # a coordinate the card and the CPU select differently
#                      must score within this of the k-th score (or its
#                      est^2 of the heavy threshold) in the card's recovery:
#                      the two f32 backwards round their convolutions in
#                      another order, and a pre-activation within rounding
#                      of 0 moves a few gradients by up to ~2e-3
#                      (tests/test_torch_cnn_dist.py)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------


def build_phase(torch):
    from repro_torch.kernels import (build, heavymix_topk, sketch_decode,
                                     sketch_encode, topk_select, ts_encode)
    names = ("sketch_encode", "heavymix_scores", "sketch_decode",
             "ts_encode", "topk_select")
    t0 = time.time()
    logs = build.build_all(names)
    for mod in (sketch_encode, heavymix_topk, sketch_decode, ts_encode,
                topk_select):
        mod._lib()
    log(f"[build] {len(names)} kernels built and loaded in "
        f"{time.time() - t0:.1f} s (nvcc {build.nvcc_path()})")
    for name, text in logs.items():
        for line in (text or "cached build\n").splitlines():
            if ("registers" in line or "spill" in line
                    or line == "cached build"):
                log(f"[build] {name}: {line.strip()}")


def main_exchange():
    """The main path's exchange: gs-SGD, 2 buckets, psum, R = 5, k and W
    derived from d."""
    from repro_torch.api import ExchangeSpec, SketchSpec
    return ExchangeSpec(compressor="gs-sgd", buckets=2, overlap=True,
                        allreduce_mode="psum",
                        sketch=SketchSpec(rows=5, width=None, k=None))


def full_width_step(torch, device, buckets=2, bwd_chunks=None,
                    fuse_encode=False, exchange=None, cfg=None):
    """The main path's train step (no state allocated yet); with other
    ``buckets`` / ``bwd_chunks`` / ``fuse_encode``, or a whole ``exchange``
    spec (a re-plan's), the same cell with that exchange schedule; with
    ``cfg``, that arch's cell under the same exchange, P, optimizer and
    lr."""
    from repro_torch.configs.qwen3_4b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes, make_train_step
    from repro_torch.optim import make as make_opt
    cfg = cfg or dataclasses.replace(CONFIG, n_layers=2)
    opt = make_opt("adamw", lr=TRAIN_LR)
    spec = exchange or dataclasses.replace(
        main_exchange(), buckets=buckets, bwd_chunks=bwd_chunks,
        fuse_encode=fuse_encode)
    ma = MeshAxes(tp=1, data=TRAIN_P, tp_axis=None)
    ts = make_train_step(cfg, ma, opt, spec=spec, dtype=torch.float32,
                         device=device)
    return cfg, opt, ts


def _row(name, source, replaces, err, ms, plain_ms, bound, library_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def _index_add_ms(torch, device, R, W, d, ids_vals):
    """Library yardstick of an encode: one ``index_add_`` over the flat
    (R*W) table, bucket ids and signed values precomputed (not timed).
    ``ids_vals(lo, hi)`` gives the (R, hi-lo) bucket ids and values.
    Returns (ms, the table it computed)."""
    flat_idx = torch.empty((R, d), dtype=torch.int64, device=device)
    flat_val = torch.empty((R, d), dtype=torch.float32, device=device)
    rows_off = (torch.arange(R, device=device) * W)[:, None]
    step = 1 << 24
    for lo in range(0, d, step):
        hi = min(d, lo + step)
        b, v = ids_vals(lo, hi)
        flat_idx[:, lo:hi] = b + rows_off
        flat_val[:, lo:hi] = v
    flat_idx, flat_val = flat_idx.reshape(-1), flat_val.reshape(-1)
    out = torch.zeros(R * W, dtype=torch.float32, device=device)

    def call():
        out.zero_()
        out.index_add_(0, flat_idx, flat_val)

    ms = time_ms(torch, call, reps=3)
    del flat_idx, flat_val
    torch.cuda.empty_cache()
    return ms, out.view(R, W)


def _shapes_row(name, source, replaces, shapes):
    """A kernel's row timed at several shapes: the first's (bucket 0's)
    numbers at the top level, every shape's under ``shapes``."""
    s0 = shapes[0]
    row = _row(name, source, replaces, s0["max_abs_err"], s0["ms"],
               s0["plain_ms"], (s0["bound_ms"], s0["bound_by"]),
               s0["library_ms"])
    row["shapes"] = shapes
    return row


def encode_checks(torch, device, gen, buckets) -> tuple[dict, list]:
    """sketch_encode: small odd cases, then every bucket of the main path
    (``buckets``: (cfg, g) each), then bucket 0's g at the CLI's default
    width (few tiles, so several accumulating CTAs a tile): bit-equal to
    plain (and within ENCODE_REL_TOL * max|S|), a second launch bit-equal
    to the first, a launch with other splits and pass size bit-equal;
    non-finite and out-of-range elements planted at known coordinates.
    Returns its row and the kernel's sketch of each main-path bucket."""
    from repro_torch.api import SketchSpec
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels.sketch_encode import (encode_plan, sketch_encode,
                                                   sketch_encode_plain)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for rows, width, off in ((3, 300, 4099), (64, 1 << 12, 2**32 - 700),
                                 (1, 1, 0)):
            c = cs.SketchConfig(rows=rows, width=width, seed=5)
            x = torch.randn(1537, generator=gen, device=device).to(dt)
            got = sketch_encode(c, x, index_offset=off)
            want = sketch_encode_plain(c, x, off)
            err = float((got - want).abs().max())
            lim = ENCODE_REL_TOL * float(want.abs().max())
            log(f"[kernels] sketch_encode small d=1537 R={rows} W={c.width} "
                f"off={off} {dt}: bit-equal to plain "
                f"{_bits_equal(torch, got, want)} (max_abs_err {err:.3g}, "
                f"limit {lim:.3g})")
            if not (_bits_equal(torch, got, want) and err <= lim):
                fail(f"sketch_encode small {dt} R={rows} W={c.width} is not "
                     f"bit-equal to plain: {err}")
    encode_special_checks(torch, device, gen)
    cfg0, g0 = buckets[0]
    cases = [(f"bucket {b}", cfg, g) for b, (cfg, g) in enumerate(buckets)]
    cases.append(("CLI default width at bucket 0's d", cs.SketchConfig(
        rows=cfg0.rows, width=SketchSpec().width, seed=cfg0.seed), g0))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes, sketches = [], []
    for what, cfg, g in cases:
        d, R, W = g.shape[0], cfg.rows, cfg.width
        plan = encode_plan(R, cfg.log2_width, d, sms)
        log(f"[kernels] sketch_encode plan at {what} (d={d}, R={R}, W={W}): "
            f"{plan.ntiles} tiles of 2^13 cells, {plan.splits} accumulating "
            f"CTA(s) a tile; binning CTAs of {plan.block} elements "
            f"({plan.bin_smem} bytes of shared memory), {plan.nblocks} a "
            f"pass; passes of {plan.chunk} elements: {-(-d // plan.chunk)}, "
            f"scratch {plan.scratch_bytes} bytes")
        sk = sketch_encode(cfg, g)
        sk_p = sketch_encode_plain(cfg, g)
        err = float((sk - sk_p).abs().max())
        lim = ENCODE_REL_TOL * float(sk_p.abs().max())
        other = encode_plan(R, cfg.log2_width, d, sms,
                            splits=max(1, plan.splits // 2 + 3),
                            chunk=max(plan.block, plan.chunk // 3
                                      // plan.block * plan.block))
        same = {"plain": _bits_equal(torch, sk, sk_p),
                "second launch": _bits_equal(torch, sk,
                                             sketch_encode(cfg, g)),
                f"splits {other.splits}, passes of {other.chunk}":
                    _bits_equal(torch, sk, sketch_encode(cfg, g,
                                                         plan=other))}
        log(f"[kernels] sketch_encode {what} d={d}: bit-equal to {same}; "
            f"max_abs_err {err:.4g} (limit {lim:.4g} = {ENCODE_REL_TOL} * "
            "max|S|)")
        if not (all(same.values()) and err <= lim):
            fail(f"sketch_encode at {what} is not bit-equal: {same}, "
                 f"max_abs_err {err}")
        del sk_p
        ms = time_ms(torch, lambda: sketch_encode(cfg, g), reps=10)
        plain_ms = time_ms(torch, lambda: sketch_encode_plain(cfg, g), reps=2)

        def ids_vals(lo, hi):
            bk, sg = cs.hash_buckets(cfg, torch.arange(lo, hi, device=device))
            return bk, sg * g[lo:hi]

        lib_ms, lib_out = _index_add_ms(torch, device, R, W, d, ids_vals)
        log(f"[kernels] index_add_ yardstick vs kernel at {what}: "
            f"max_abs_err {float((lib_out - sk).abs().max()):.4g}")
        del lib_out
        bound = bound_ms(d * g.element_size() + R * W * 4, d * R * 7.0)
        shapes.append({"shape": what, "d": d, "rows": R, "width": W,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "library_ms": lib_ms})
        if len(sketches) < len(buckets):
            sketches.append(sk)
    return _shapes_row("sketch_encode", "src/repro_torch/csrc/sketch_encode.cu",
                       "src/repro/kernels/sketch_encode.py:87",
                       shapes), sketches


def encode_special_checks(torch, device, gen):
    """NaN, +inf, -inf, an element of 3e9 and one of -2^31 planted at known
    coordinates of a 100,000-element g (R = 5, W = 1024): the kernel's
    sketch bit-equal to plain; each planted element's cells NaN or inf by
    the encode's rules (NaN, or both infinities: NaN; one infinity: it;
    |v| >= 2^31: NaN)."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels.sketch_encode import (sketch_encode,
                                                   sketch_encode_plain)
    cfg = cs.SketchConfig(rows=5, width=1024, seed=3)
    g = torch.randn(100_000, generator=gen, device=device).mul_(1e-3)
    plants = {10: float("nan"), 20: float("inf"), 30: -float("inf"),
              40: 3e9, 50: -2.0**31}
    for j, v in plants.items():
        g[j] = v
    got, want = sketch_encode(cfg, g), sketch_encode_plain(cfg, g)
    if not _bits_equal(torch, got, want):
        fail("sketch_encode with non-finite elements is not bit-equal to "
             "plain")
    bk, sg = cs.hash_buckets(cfg, torch.tensor(list(plants), device=device))
    cells: dict = {}
    for n, v in enumerate(plants.values()):
        for r in range(cfg.rows):
            cells.setdefault((r, int(bk[r, n])), []).append(float(sg[r, n]) * v)
    for (r, w), vals in cells.items():
        pos = any(x == math.inf for x in vals)
        neg = any(x == -math.inf for x in vals)
        nan = any(math.isnan(x) for x in vals) or (pos and neg)
        want = ("nan" if nan else "+inf" if pos else "-inf" if neg
                else "nan")  # otherwise only |v| >= 2^31: NaN
        cell = float(got[r, w])
        have = ("nan" if math.isnan(cell) else "+inf" if cell == math.inf
                else "-inf" if cell == -math.inf else "finite")
        if have != want:
            fail(f"sketch_encode: cell ({r}, {w}) of planted {vals} is "
                 f"{cell}, want {want}")
    log(f"[kernels] sketch_encode with NaN, +inf, -inf, 3e9, -2^31 planted: "
        f"bit-equal to plain; {int(torch.isnan(got).sum())} NaN and "
        f"{int(torch.isinf(got).sum())} inf cells where the rules put them")


def _spiky(torch, gen, device, n, n_spikes):
    """A gradient-like vector: small noise and ``n_spikes`` large entries."""
    g = torch.randn(n, generator=gen, device=device).mul_(1e-3)
    spikes = torch.randint(0, n, (n_spikes,), generator=gen, device=device)
    g[spikes] = torch.randn(spikes.numel(), generator=gen, device=device)
    return g


def check_select(torch, what, key, k, hist):
    """topk_select of ``key`` (with the kernel's first-digit histogram)
    against ``topk_lower_index(|key|, k)``: idx equal as returned, values
    bit-equal. Returns the largest value difference (0)."""
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.kernels.topk_select import topk_select
    v, i = topk_select(key, k, hist)
    v_o, i_o = topk_lower_index(key.abs(), k)
    if not torch.equal(i, i_o):
        fail(f"topk_select at {what} (k={k}) selects other indices than "
             f"topk_lower_index: {int((i != i_o).sum())} of {k} differ")
    if not torch.equal(v.view(torch.int32), v_o.view(torch.int32)):
        fail(f"topk_select at {what}: values not bit-equal")
    return float((v - v_o).abs().max())


def check_scores_hist(torch, what, c, s, thr, n, filler=None):
    """heavymix_scores with its histogram (and the faithful fill's
    ``filler``, where given): scores and est bit-equal to plain, histogram
    equal to the plain one of the same scores. Returns (scores, est, hist,
    max |est - plain est|)."""
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.topk_select import radix_hist_plain
    sc, est, hist = heavymix_scores_hist(c, s, thr, n, filler)
    sc_p, est_p = heavymix_scores_plain(c, s, thr, n, filler)
    est_err = float((est - est_p).abs().max())
    if not (torch.equal(est, est_p) and torch.equal(sc, sc_p)):
        fail(f"heavymix_scores at {what} (d={n}, R={c.rows}, W={c.width}) "
             f"disagrees: max est err {est_err}")
    if not torch.equal(hist, radix_hist_plain(sc_p)):
        fail(f"heavymix_scores' histogram at {what} differs from the plain "
             "histogram of the same scores")
    return sc, est, hist, est_err


def smoke_scores_checks(torch, device, gen):
    """heavymix_scores at the shapes its own path (parity, cli: the smoke
    spec, every bucket below 2^22) gives it, each bucket with its own k
    and threshold, then a scores-regime case whose heavy set outnumbers k
    many times over (all those keys tie at 1e30): est, scores and the
    fused histogram equal to plain, the select's idx and values equal to
    ``topk_lower_index``'s, and the recovery's indices equal to the plain
    HEAVYMIX's."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sketch_encode import sketch_encode_plain
    from repro_torch.launch import train as ttrain
    comp = ttrain.build(smoke_spec(), device)[3].compressor
    cases = [(f"smoke bucket {i}", part.sketch, part.k, n) for i, (part, n)
             in enumerate(zip(comp.parts, comp.spec.sizes))]
    cases.append(("heavy set >> k", cs.SketchConfig(rows=5, width=1024,
                                                    seed=9), 2048,
                  (1 << 22) - 1))
    for what, c, k, n in cases:
        s = sketch_encode_plain(c, _spiky(torch, gen, device, n, k // 4))
        thr = cs.l2sq_estimate(s) / k
        sc, est, hist, _ = check_scores_hist(torch, what, c, s, thr, n)
        n_heavy = int((sc >= 1e30).sum())
        if what.startswith("heavy") and not n_heavy > 10 * k:
            fail(f"{what}: only {n_heavy} heavy coordinates for k={k}")
        check_select(torch, what, sc, k, hist)
        idx = ops.heavymix_recover(c, s, k, n)[0]
        if not torch.equal(idx, ref.heavymix_recover(c, s, k, n)[0]):
            fail(f"heavymix_recover at {what} selects other coordinates "
                 "than the plain HEAVYMIX")
        log(f"[kernels] {what} d={n} R={c.rows} W={c.width} k={k} "
            f"({n_heavy} heavy): scores, est and histogram equal to plain; "
            "select idx and values equal to topk_lower_index's; recovered "
            "idx equal")


def _decode_library_ms(torch, device, cfg, sk, d):
    """Library yardstick of the decode: gather + sign + median over rows,
    bucket ids and signs precomputed (not timed); R is odd here, so
    torch.median's lower middle is the median. Returns (ms, its est)."""
    from repro_torch.core import count_sketch as cs
    R = cfg.rows
    ids = torch.empty((R, d), dtype=torch.int64, device=device)
    sgn = torch.empty((R, d), dtype=torch.float32, device=device)
    for lo in range(0, d, 1 << 24):
        hi = min(d, lo + (1 << 24))
        ids[:, lo:hi], sgn[:, lo:hi] = cs.hash_buckets(
            cfg, torch.arange(lo, hi, device=device))
    lib = {}

    def lib_call():
        lib["est"] = torch.median(torch.gather(sk, 1, ids).mul_(sgn),
                                  dim=0).values

    ms = time_ms(torch, lib_call, reps=2)
    del ids, sgn
    torch.cuda.empty_cache()
    return ms, lib["est"]


def scores_decode_checks(torch, device, gen, buckets) -> list[dict]:
    """heavymix_scores, sketch_decode and topk_select: small cases
    (offsets, R = 1, 4, 5, 29, widths below 512), the smoke spec's buckets
    and a heavy-set case (the scores kernel's path), then every bucket of
    the main path (``buckets``: (cfg, sketch, d, k) each): outputs
    bit-equal to plain, fused histograms equal to plain, the select equal
    to ``topk_lower_index``; the recovery's indices at bucket 0 against
    the plain HEAVYMIX, once under ``set_sync_debug_mode("error")``;
    times."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.sketch_decode import (sketch_decode,
                                                   sketch_decode_hist,
                                                   sketch_decode_plain)
    from repro_torch.kernels.sketch_encode import sketch_encode_plain
    from repro_torch.kernels.topk_select import (radix_hist_plain,
                                                 slab_overflows, topk_select,
                                                 topk_select_plain)
    for rows, n, width, off in ((1, 3000, 512, 0), (4, 3000, 300, 4099),
                                (5, 3001, 512, 4099), (29, 5000, 200, 17)):
        c = cs.SketchConfig(rows=rows, width=width, seed=rows)
        x = torch.randn(n, generator=gen, device=device)
        s = sketch_encode_plain(c, x)
        thr = cs.l2sq_estimate(s) / 40
        check_scores_hist(torch, f"small R={rows}", c, s, thr, n)
        e = sketch_decode(c, s, n, index_offset=off)
        if not torch.equal(e, sketch_decode_plain(c, s, n, off)):
            fail(f"sketch_decode small R={rows} W={c.width} off={off} "
                 "disagrees with its plain version")
        log(f"[kernels] small R={rows} W={c.width} d={n}: scores and est "
            f"bit-equal, histogram equal; decode at offset {off} bit-equal")
    smoke_scores_checks(torch, device, gen)

    cfg, sk, d, k = buckets[0]
    R, W = cfg.rows, cfg.width
    thr = cs.l2sq_estimate(sk) / k
    sc, est, _, hm_err = check_scores_hist(torch, f"bucket 0's d={d}", cfg,
                                           sk, thr, d)
    del sc, est
    # the main path's selection (ops.heavymix_recover: the decode kernel
    # with its histogram and the select at this d) against the port's plain
    # chunked HEAVYMIX, then once more with any host sync an error
    idx = ops.heavymix_recover(cfg, sk, k, d)[0]
    idx_p = ref.heavymix_recover(cfg, sk, k, d)[0]
    if not torch.equal(idx, idx_p):
        fail("heavymix_recover selects other coordinates than the plain "
             f"HEAVYMIX: {int((idx != idx_p).sum())} of k={k} differ")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx_s = ops.heavymix_recover(cfg, sk, k, d)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(idx_s, idx_p):
        fail("heavymix_recover under set_sync_debug_mode differs")
    log(f"[kernels] d={d}: heavymix_scores est, scores and histogram equal "
        "to plain; recovered idx equal to the plain HEAVYMIX; a recovery "
        "under set_sync_debug_mode('error') raised nothing")
    del idx, idx_p, idx_s
    hm_ms = time_ms(torch, lambda: heavymix_scores_hist(cfg, sk, thr, d),
                    reps=10)
    hm_plain_ms = time_ms(
        torch, lambda: heavymix_scores_plain(cfg, sk, thr, d), reps=2)
    log(f"[kernels] heavymix_scores (with its histogram) at d={d}: "
        f"{hm_ms:.3f} ms, max est err {hm_err}")
    ops_per = R * 6.0 + R * (R - 1)   # hashes + compare-exchanges
    hm_row = _row("heavymix_scores", "src/repro_torch/csrc/heavymix_scores.cu",
                  "src/repro/kernels/heavymix_topk.py:91", hm_err, hm_ms,
                  hm_plain_ms, bound_ms(R * W * 4 + 4 + 2 * d * 4 + 2048 * 4,
                                        d * (ops_per + 4)), None)

    dec_shapes, sel_shapes = [], []
    for b, (cfg, sk, d, k) in enumerate(buckets):
        R, W = cfg.rows, cfg.width
        sms = torch.cuda.get_device_properties(sk.device).multi_processor_count
        log(f"[kernels] sketch_decode plan at bucket {b} (d={d}, R={R}, "
            f"W={W}): one thread a coordinate, grid-stride, 256 threads, "
            f"{min(-(-d // 256), sms * 16)} CTAs")
        est, hist = sketch_decode_hist(cfg, sk, d)
        dec_p = sketch_decode_plain(cfg, sk, d)
        dec_err = float((est - dec_p).abs().max())
        if not torch.equal(est, dec_p):
            fail(f"sketch_decode not bit-equal at bucket {b} (d={d}): max "
                 f"err {dec_err}")
        if not torch.equal(hist, radix_hist_plain(dec_p)):
            fail(f"sketch_decode's histogram at bucket {b} differs from the "
                 "plain histogram of the same est")
        del dec_p
        log(f"[kernels] sketch_decode bucket {b} d={d}: est bit-equal, "
            f"histogram equal to plain ({int((hist > 0).sum())} of 2048 bins "
            "used)")
        sel_err = check_select(torch, f"bucket {b}", est, k, hist)
        log(f"[kernels] topk_select bucket {b} d={d} k={k}: idx equal to "
            "topk_lower_index's, values bit-equal")
        dech_ms = time_ms(torch, lambda: sketch_decode_hist(cfg, sk, d),
                          reps=10)
        dec_plain_ms = time_ms(torch, lambda: sketch_decode_plain(cfg, sk, d),
                               reps=2)
        slab_overflows(est.device, reset=True)
        sel_ms = time_ms(torch, lambda: topk_select(est, k, hist), reps=10)
        sel_over = slab_overflows(est.device, reset=True) / 11
        if b == 0:
            select_overflow_checks(torch, [(f"est of bucket {b}", est, k,
                                            hist)])
        sel_plain_ms = time_ms(
            torch, lambda: topk_select_plain(est, k, hist), reps=2)
        topk_ms = time_ms(torch, lambda: topk_lower_index(est.abs(), k),
                          reps=3)
        key = est.abs()
        lib_topk_ms = time_ms(torch, lambda: torch.topk(key, k, sorted=False),
                              reps=3)
        del key

        def old_route():
            e = sketch_decode(cfg, sk, d)
            return topk_lower_index(e.abs(), k)

        def new_route():
            e, h = sketch_decode_hist(cfg, sk, d)
            return topk_select(e, k, h)

        old_ms = time_ms(torch, old_route, reps=3)
        new_ms = time_ms(torch, new_route, reps=3)
        log(f"[kernels] bucket {b} (d={d}, k={k}): decode with histogram "
            f"{dech_ms:.3f} ms; select {sel_ms:.3f} ms ({sel_over:g} slab "
            "overflows a call); "
            f"topk_lower_index of |est| {topk_ms:.3f} ms; torch.topk "
            f"(sorted=False) {lib_topk_ms:.3f} ms; old route (decode + "
            f"topk_lower_index) {old_ms:.3f} ms, new route (decode with "
            f"histogram + select) {new_ms:.3f} ms")
        lib_ms, lib_est = _decode_library_ms(torch, device, cfg, sk, d)
        log(f"[kernels] gather+median yardstick equal to the decode kernel "
            f"at bucket {b}: {torch.equal(lib_est, est)}")
        del est, hist, lib_est
        torch.cuda.empty_cache()
        bound = bound_ms(R * W * 4 + d * 4 + 2048 * 4, d * ops_per)
        dec_shapes.append({"shape": f"bucket {b}", "d": d, "rows": R,
                           "width": W, "max_abs_err": dec_err, "ms": dech_ms,
                           "plain_ms": dec_plain_ms, "bound_ms": bound[0],
                           "bound_by": bound[1], "library_ms": lib_ms})
        # read the keys and the histogram once, write k int64 indices and
        # k f32 values; one compare a key per digit pass
        bound = bound_ms(d * 4 + 2048 * 4 + k * 12, d * 3.0)
        sel_shapes.append({"shape": f"bucket {b}", "d": d, "k": k,
                           "max_abs_err": sel_err, "ms": sel_ms,
                           "plain_ms": sel_plain_ms, "bound_ms": bound[0],
                           "bound_by": bound[1], "library_ms": lib_topk_ms,
                           "slab_overflows_a_call": sel_over,
                           "topk_lower_index_ms": topk_ms,
                           "old_route_ms": old_ms, "new_route_ms": new_ms})
    return [hm_row,
            _shapes_row("sketch_decode",
                        "src/repro_torch/csrc/sketch_decode.cu",
                        "src/repro/kernels/sketch_decode.py:85", dec_shapes),
            _shapes_row("topk_select", "src/repro_torch/csrc/topk_select.cu",
                        "jax.lax.top_k, src/repro/core/heavymix.py:65,88,93",
                        sel_shapes)]


def ts_checks(torch, device, gen, buckets) -> tuple[dict, list]:
    """ts_encode: small cases (f32/bf16/f16; rows with n_r > W; geometries
    that take the one-pass kernel, each also through the R-pass kernel),
    then every bucket of the main path (``buckets``: (cfg, g) each; bucket 0
    also in bf16) and bucket 0's g at the CLI's default width: held to the
    plain version at ENCODE_REL_TOL * max|S| and bit-equal between two
    launches (fixed order, no atomics), for the plan's kernel and, where
    the plan picks the one-pass kernel, the R-pass kernel too. Returns its
    row and the TS sketch of each main-path bucket."""
    from repro_torch.api import SketchSpec
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.ts_sketch import TSketchConfig, buckets_at, signs_at
    from repro_torch.kernels.ts_encode import (onepass_plan, rows_plan,
                                               ts_encode, ts_encode_plain,
                                               ts_encode_plan)
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def check(c, x, what, plan=None):
        got = ts_encode(c, x, plan)
        want = ts_encode_plain(c, x)
        err = float((got - want).abs().max())
        lim = ENCODE_REL_TOL * float(want.abs().max())
        kernel = (plan or ts_encode_plan(c, sms)).kernel
        if not err <= lim:
            fail(f"ts_encode ({kernel}) {what} disagrees: {err} > {lim}")
        if not torch.equal(got, ts_encode(c, x, plan)):
            fail(f"ts_encode ({kernel}) {what} differs between two launches")
        log(f"[kernels] ts_encode ({kernel} kernel) {what}: max_abs_err "
            f"{err:.4g} (limit {lim:.4g}); two launches bit-equal")
        return got, err

    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for n, rows, width in ((100_000, 5, 512), (70_000, 5, 16),
                               (1537, 1, 300), (3_000_001, 5, 1 << 16),
                               (600_001, 3, 1 << 14)):
            c = TSketchConfig(d=n, rows=rows, width=width, seed=5)
            x = torch.randn(n, generator=gen, device=device).to(dt)
            what = f"small d={n} R={rows} W={c.width} {dt}"
            check(c, x, what)
            one = onepass_plan(c)
            if one is not None:
                check(c, x, what, one if ts_encode_plan(c, sms).kernel ==
                      "rows" else rows_plan(c))
    cfg0, g0 = buckets[0]
    cases = [(f"bucket {b}", cfg, g) for b, (cfg, g) in enumerate(buckets)]
    cases.append(("CLI default width at bucket 0's d", cs.SketchConfig(
        rows=cfg0.rows, width=SketchSpec().width, seed=cfg0.seed), g0))
    shapes, sketches = [], []
    for what, cfg, g in cases:
        d = g.shape[0]
        tcfg = TSketchConfig(d=d, rows=cfg.rows, width=cfg.width,
                             seed=cfg.seed)
        R, W = tcfg.rows, tcfg.width
        plan = ts_encode_plan(tcfg, sms)
        log(f"[kernels] ts_encode plan at {what} (d={d}, R={R}, W={W}, "
            f"d_pad={tcfg.d_pad}, n_r={[1 << (tcfg.bits - a) for a in tcfg.log_m]}"
            f"): {plan}")
        if what == "bucket 0":
            check(tcfg, g.to(torch.bfloat16), f"{what} d={d} bf16")
        got, err = check(tcfg, g, f"{what} d={d} f32")
        shape = {"shape": what, "d": d, "rows": R, "width": W,
                 "kernel": plan.kernel, "ctas": plan.ctas,
                 "threads": plan.threads}
        ms = time_ms(torch, lambda: ts_encode(tcfg, g), reps=10)
        if plan.kernel == "onepass":
            # the R-pass kernel at the same shape, timed between two runs
            # of the plan's kernel
            rp = rows_plan(tcfg)
            check(tcfg, g, f"{what} d={d} f32", rp)
            shape["rows_kernel_ms"] = time_ms(
                torch, lambda: ts_encode(tcfg, g, rp), reps=10)
            shape["ms_runs"] = [ms, time_ms(torch, lambda: ts_encode(tcfg, g),
                                            reps=10)]
            ms = sum(shape["ms_runs"]) / 2
        plain_ms = time_ms(torch, lambda: ts_encode_plain(tcfg, g), reps=2)

        def ids_vals(lo, hi):
            i = torch.arange(lo, hi, device=device)
            return buckets_at(tcfg, i), signs_at(tcfg, i) * g[lo:hi]

        lib_ms, lib_out = _index_add_ms(torch, device, R, W, d, ids_vals)
        log(f"[kernels] index_add_ yardstick vs ts kernel at {what}: "
            f"max_abs_err {float((lib_out - got).abs().max()):.4g}")
        del lib_out
        # per (row, element): bucket map (add, and, and, shift, shift, or,
        # and), sign (mul, add, shift), sign-apply and add
        bound = bound_ms(d * g.element_size() + R * W * 4, d * R * 12.0)
        shape.update({"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound[0], "bound_by": bound[1],
                      "library_ms": lib_ms})
        log(f"[kernels] ts_encode {what}: {plan.kernel} kernel {ms:.3f} ms"
            + (f", R-pass kernel {shape['rows_kernel_ms']:.3f} ms"
               if "rows_kernel_ms" in shape else "")
            + f"; bound {bound[0]:.4f} ms")
        shapes.append(shape)
        sketches.append((tcfg, got))
    return _shapes_row("ts_encode", "src/repro_torch/csrc/ts_encode.cu",
                       "src/repro/kernels/ts_encode.py:73", shapes), sketches


def ts_transpose_check(torch, what, tcfg, sk):
    """ts_transpose against its plain version (equal); returns its
    transposed sketch."""
    from repro_torch.kernels.heavymix_topk import (ts_transpose,
                                                   ts_transpose_plain)
    st = ts_transpose(tcfg, sk)
    if not torch.equal(st, ts_transpose_plain(tcfg, sk)):
        fail(f"ts_transpose at {what} (R={tcfg.rows}, W={tcfg.width}) "
             "differs from its plain version")
    return st


def ts_recover_checks(torch, buckets, wide) -> list[dict]:
    """The TS route's recovery at every bucket of the main path
    (``buckets``: (TS config, TS sketch, d, k) each, the sketch from the
    spiky g, whose heavy set far outnumbers k): the row-transposed sketch
    equal to the plain transpose, the TS-map scores and est (read through
    it) bit-equal to their plain version (``ts.decode`` and the
    reference's boost), the fused histogram equal to the plain one, and
    ``ops.ts_heavymix_recover``'s idx equal to the plain route's
    (``ts.decode`` + ``heavymix(estimates=)``), once under
    ``set_sync_debug_mode("error")``; times of the transpose, the kernel,
    the select and both routes. ``wide``: (TS config, sketch, d, k) at the
    CLI's default width, where n_r reaches W: the transpose and the scores
    held to plain there too. Returns the rows of heavymix_scores_ts and
    ts_transpose."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core import heavymix as hm
    from repro_torch.core import ts_sketch as tsk
    from repro_torch.kernels import ops
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_ts_hist,
                                                   heavymix_scores_ts_plain,
                                                   ts_transpose,
                                                   ts_transpose_plain)
    from repro_torch.kernels.topk_select import (radix_hist_plain,
                                                 slab_overflows, topk_select)
    shapes, tr_shapes = [], []
    for b, (tcfg, sk, d, k) in enumerate(buckets + [wide]):
        what = f"bucket {b}" if b < len(buckets) else "CLI default width"
        R, W = tcfg.rows, tcfg.width
        ccfg = cs.SketchConfig(rows=R, width=W, seed=tcfg.seed)
        ts_transpose_check(torch, what, tcfg, sk)
        tr_ms = time_ms(torch, lambda: ts_transpose(tcfg, sk), reps=10)
        tr_plain_ms = time_ms(torch, lambda: ts_transpose_plain(tcfg, sk),
                              reps=2)
        tr_bound = bound_ms(2 * R * W * 4, 0.0)
        log(f"[kernels] ts_transpose {what} (R={R}, W={W}, n_r="
            f"{[1 << (tcfg.bits - a) for a in tcfg.log_m]}): equal to plain; "
            f"{tr_ms:.4f} ms (plain {tr_plain_ms:.3f} ms, bound "
            f"{tr_bound[0]:.4f} ms)")
        tr_shapes.append({"shape": what, "rows": R, "width": W,
                          "max_abs_err": 0.0, "ms": tr_ms,
                          "plain_ms": tr_plain_ms, "bound_ms": tr_bound[0],
                          "bound_by": tr_bound[1], "library_ms": None})
        thr = cs.l2sq_estimate(sk) / k
        sc, est, hist = heavymix_scores_ts_hist(tcfg, sk, thr, d)
        sc_p, est_p = heavymix_scores_ts_plain(tcfg, sk, thr, d)
        err = float((est - est_p).abs().max())
        if not (torch.equal(est, est_p) and torch.equal(sc, sc_p)):
            fail(f"heavymix_scores_ts at {what} (d={d}, W={W}) disagrees "
                 f"with its plain version: max est err {err}")
        if not torch.equal(hist, radix_hist_plain(sc_p)):
            fail(f"heavymix_scores_ts' histogram at {what} differs from "
                 "the plain histogram of the same scores")
        n_heavy = int((sc >= 1e30).sum())
        del sc_p, est_p
        if b == len(buckets):
            log(f"[kernels] heavymix_scores_ts at {what} (d={d}, W={W}): "
                "est and scores bit-equal to plain, histogram equal")
            del sc, est, hist
            continue
        if not n_heavy > 2 * k:
            fail(f"TS recovery at bucket {b}: only {n_heavy} heavy "
                 f"coordinates for k={k}")
        idx = ops.ts_heavymix_recover(tcfg, sk, k, d)[0]

        def old_route():
            e = tsk.decode(tcfg, sk, d)
            return hm.heavymix(ccfg, sk, k, d, estimates=e)[0]

        idx_p = old_route()
        if not torch.equal(idx, idx_p):
            fail(f"ts_heavymix_recover at bucket {b} selects other "
                 f"coordinates than ts.decode + heavymix(estimates=): "
                 f"{int((idx != idx_p).sum())} of k={k} differ")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            idx_s = ops.ts_heavymix_recover(tcfg, sk, k, d)[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not torch.equal(idx_s, idx_p):
            fail("ts_heavymix_recover under set_sync_debug_mode differs")
        del idx, idx_p, idx_s
        log(f"[kernels] TS recovery bucket {b} d={d} k={k} ({n_heavy} "
            "heavy): scores and est bit-equal to plain, histogram equal; "
            "idx equal to ts.decode + heavymix(estimates=); a recovery under "
            "set_sync_debug_mode('error') raised nothing")
        ms = time_ms(torch, lambda: heavymix_scores_ts_hist(tcfg, sk, thr, d),
                     reps=10)
        plain_ms = time_ms(
            torch, lambda: heavymix_scores_ts_plain(tcfg, sk, thr, d), reps=2)
        slab_overflows(sk.device, reset=True)
        sel_ms = time_ms(torch, lambda: topk_select(sc, k, hist), reps=10)
        sel_over = slab_overflows(sk.device, reset=True) / 11
        if b == 0:
            select_overflow_checks(torch, [(
                f"the TS scores of bucket {b} ({n_heavy} tied at 1e30)", sc,
                k, hist)])
        new_ms = time_ms(torch, lambda: ops.ts_heavymix_recover(tcfg, sk, k, d),
                         reps=3)
        old_ms = time_ms(torch, old_route, reps=2)
        del sc, est, hist
        torch.cuda.empty_cache()
        # per coordinate and row: the transposed TS map (add, and, shift,
        # compare, shift, and, or) and sign (mul, add, and, negate); the
        # median's compare-exchanges; the boost and the histogram key
        ops_per = R * 11.0 + R * (R - 1) + 4
        bound = bound_ms(R * W * 4 + 4 + 2 * d * 4 + 2048 * 4, d * ops_per)
        log(f"[kernels] TS recovery bucket {b}: heavymix_scores_ts with its "
            f"histogram {ms:.3f} ms (the transpose {tr_ms:.4f} ms, launched "
            f"by it; plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms); "
            f"select {sel_ms:.3f} ms ({sel_over:g} slab overflows a call); "
            f"new route (ts_heavymix_recover) {new_ms:.3f} ms, old route "
            f"(ts.decode + heavymix(estimates=)) {old_ms:.3f} ms")
        shapes.append({"shape": what, "d": d, "rows": R, "width": W,
                       "k": k, "n_heavy": n_heavy, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                       "bound_by": bound[1], "library_ms": None,
                       "transpose_ms": tr_ms,
                       "transpose_bound_ms": tr_bound[0],
                       "select_ms": sel_ms,
                       "select_slab_overflows_a_call": sel_over,
                       "new_route_ms": new_ms, "old_route_ms": old_ms})
    return [_shapes_row("heavymix_scores_ts",
                        "src/repro_torch/csrc/heavymix_scores.cu",
                        "src/repro/kernels/heavymix_topk.py:91", shapes),
            _shapes_row("ts_transpose",
                        "src/repro_torch/csrc/heavymix_scores.cu",
                        "src/repro/kernels/heavymix_topk.py:91 (the TS-map "
                        "instance's layout; the reference's ts.decode, "
                        "src/repro/core/ts_sketch.py:150, has no Pallas "
                        "kernel)", tr_shapes)]


def select_overflow_checks(torch, cases):
    """The select with slabs forced to overflow: for each (what, keys, k,
    hist) of ``cases``, at capacity 0 (every segment with keys in the first
    digit's bin reads them from x) and at a capacity between the CTAs'
    fewest and most such keys in a segment (some CTAs overflow), idx equal
    to ``topk_lower_index``'s and values with the same bits (NaN at the
    same places), and the device counter equal to the CTAs with a segment
    over its slots (every CTA where the bin outnumbers all the slots: then
    the slabs are off)."""
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.kernels.topk_select import (RADIX_SHIFT, key_bits,
                                                 select_plan, slab_overflows,
                                                 topk_select)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    segments = 8   # a CTA's segments, one a warp (csrc/topk_select.cu)
    for what, x, k, hist in cases:
        n = x.shape[0]
        grid, chunk = select_plan(n, sms)
        counts, rest = hist.tolist(), k
        b1 = len(counts) - 1
        while rest > counts[b1]:   # the first digit's bin of the k-th key
            rest -= counts[b1]
            b1 -= 1
        inb = (key_bits(x) >> RADIX_SHIFT) == b1
        per = torch.zeros(grid * chunk, dtype=torch.int32, device=x.device)
        per[:n] = inb.to(torch.int32)
        most = per.view(grid, segments, chunk // segments).sum(2).amax(1)
        lo, hi = int(most.min()), int(most.max())
        caps = [0] + ([(lo + hi) // 8 * 4 * segments] if hi - lo >= 8
                      else [])
        v_o, i_o = topk_lower_index(x.abs(), k)
        for cap in caps:
            slab_overflows(x.device, reset=True)
            v, i = topk_select(x, k, hist, capacity=cap)
            got = slab_overflows(x.device, reset=True)
            # the slabs are off where the bin outnumbers all their slots:
            # then every CTA reads its keys in x
            off = counts[b1] > grid * cap
            want = grid if off else int((most > cap // segments).sum())
            if not (torch.equal(i, i_o) and _same_values(torch, v, v_o)):
                fail(f"topk_select at {what} with slab capacity {cap} "
                     "differs from topk_lower_index")
            if got != want:
                fail(f"topk_select at {what}, capacity {cap}: {got} CTAs "
                     f"overflowed, {want} hold a segment over its slots")
            log(f"[kernels] topk_select at {what} (n={n}, k={k}) with slab "
                f"capacity {cap} ({cap // segments} a segment): {got} of "
                f"{grid} CTAs overflowed (the most bin keys in a CTA's "
                f"segment: {lo}..{hi}); idx equal to topk_lower_index's, "
                "values bit-equal")


def _plant_nan(torch, sk, seed):
    """A copy of sketch ``sk`` with NaN in 12 cells of row 0 and 12 of row
    2 (one of them -NaN)."""
    s = sk.clone()
    gen = torch.Generator(device=s.device).manual_seed(seed)
    cols = torch.randint(0, s.shape[1], (2, 12), generator=gen,
                         device=s.device)
    s[0, cols[0]] = float("nan")
    s[2, cols[1]] = float("nan")
    s[2, cols[1, 0]] = -float("nan")
    return s


def _bits_equal(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _same_values(torch, a, b) -> bool:
    """NaN at the same places and the other values bit-equal (torch.abs on
    the card writes NaN as 0x7FFFFFFF; the select returns |x|'s own bits)."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and _bits_equal(torch, a[~nan], b[~nan]))


def nan_checks(torch, cfg, sk, d, k):
    """A NaN among a coordinate's R values makes its estimate NaN, as
    ``jnp.median``. On a copy of a main-path bucket's sketch with NaN
    planted: the decode, the scores and the TS-map scores kernels give the
    plain version's bits (NaN at the same coordinates) and its histogram;
    the select of each one's keys gives ``topk_lower_index``'s indices and
    values, the reference's ``jax.lax.top_k`` order (NaN first, by
    index)."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.core.ts_sketch import TSketchConfig
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain,
                                                   heavymix_scores_ts_hist,
                                                   heavymix_scores_ts_plain)
    from repro_torch.kernels.sketch_decode import (sketch_decode_hist,
                                                   sketch_decode_plain)
    from repro_torch.kernels.topk_select import radix_hist_plain, topk_select
    s = _plant_nan(torch, sk, 3)
    thr = cs.l2sq_estimate(s) / k
    tcfg = TSketchConfig(d=d, rows=cfg.rows, width=cfg.width, seed=cfg.seed)
    runs = (("sketch_decode", lambda: sketch_decode_hist(cfg, s, d),
             lambda: (sketch_decode_plain(cfg, s, d),)),
            ("heavymix_scores", lambda: heavymix_scores_hist(cfg, s, thr, d),
             lambda: heavymix_scores_plain(cfg, s, thr, d)),
            ("heavymix_scores_ts",
             lambda: heavymix_scores_ts_hist(tcfg, s, thr, d),
             lambda: heavymix_scores_ts_plain(tcfg, s, thr, d)))
    for name, kernel, plain in runs:
        got = kernel()
        want = plain()
        for a, b in zip(got[:-1], want):
            if not _bits_equal(torch, a, b):
                fail(f"{name} on a sketch with NaN (d={d}) is not bit-equal "
                     f"to plain: NaN at {int(torch.isnan(a).sum())} against "
                     f"{int(torch.isnan(b).sum())} coordinates")
        key, hist = got[0], got[-1]
        if not torch.equal(hist, radix_hist_plain(want[0])):
            fail(f"{name}'s histogram on a sketch with NaN differs from plain")
        n_nan = int(torch.isnan(want[0]).sum())
        if not 0 < n_nan < k:
            fail(f"{name}: {n_nan} NaN keys, want between 0 and k={k}")
        v, i = topk_select(key, k, hist)
        v_o, i_o = topk_lower_index(want[0].abs(), k)
        if not (torch.equal(i, i_o) and _same_values(torch, v, v_o)):
            fail(f"topk_select of {name}'s keys with NaN differs from "
                 "topk_lower_index")
        nan_idx = torch.nonzero(torch.isnan(want[0])).reshape(-1)
        if not (bool(torch.isnan(v[:n_nan]).all())
                and torch.equal(i[:n_nan], nan_idx)):
            fail(f"topk_select of {name}'s keys does not rank the NaN keys "
                 "first, by index")
        log(f"[kernels] NaN: {name} at d={d} R={cfg.rows} W={cfg.width}: "
            f"{n_nan} NaN estimates, bits equal to plain, histogram equal; "
            f"the select (k={k}) equal to topk_lower_index, NaN first")
        if name == "sketch_decode":
            select_overflow_checks(torch, [
                (f"{name}'s keys with NaN", key, kk, hist)
                for kk in (n_nan, k)])
        del got, want, key, hist, v, i, v_o, i_o
    del s


def kernels_phase(torch, device, ts) -> list[dict]:
    """Every kernel at the full-width step's shapes (the encodes, the
    decode, the TS transpose, the TS-map scores and the select at both
    buckets; the select also with its slabs forced to overflow), and small
    cases."""
    gen = torch.Generator(device=device).manual_seed(1)
    parts, sizes = ts.compressor.parts, ts.compressor.spec.sizes
    for b, (part, d) in enumerate(zip(parts, sizes)):
        log(f"[kernels] main-path shapes, bucket {b}: d={d} "
            f"R={part.sketch.rows} W={part.sketch.width} k={part.k}")
    gs = [_spiky(torch, gen, device, d, part.k // 4)
          for part, d in zip(parts, sizes)]
    enc, sks = encode_checks(
        torch, device, gen, [(p.sketch, g) for p, g in zip(parts, gs)])
    out = [enc] + scores_decode_checks(
        torch, device, gen, [(p.sketch, sk, d, p.k) for p, sk, d in
                             zip(parts, sks, sizes)])
    nan_checks(torch, parts[1].sketch, sks[1], sizes[1], parts[1].k)
    del sks
    ts_row, ts_sks = ts_checks(torch, device, gen,
                               [(p.sketch, g) for p, g in zip(parts, gs)])
    del gs
    torch.cuda.empty_cache()
    cases = [(tcfg, sk, d, p.k) for (tcfg, sk), d, p in
             zip(ts_sks, sizes, parts)]
    wide_cfg, wide_sk = ts_sks[len(parts)]
    out += [ts_row] + ts_recover_checks(
        torch, cases, (wide_cfg, wide_sk, sizes[0], parts[0].k))
    del ts_sks, cases, wide_sk
    for kr in out:
        log("[kernels] " + json.dumps({key: kr[key] for key in (
            "name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")}))
    return out


def check_launches(tag, counts, launched, not_launched=()):
    for name in launched:
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the {tag} path")
    for name in not_launched:
        if counts.get(name, 0) != 0:
            fail(f"kernel {name} launched {counts[name]} times on the {tag} "
                 "path, which should not run it")


def train_phase(torch, cfg, opt, ts, tag="train", between=None) -> dict:
    """Three full-width steps; counts set to 0 just before, read after.
    Returns the state, the stream, the counts, the step seconds, the losses,
    the peak device memory and the select's CTAs whose slab overflowed
    (the device counter, zeroed before the steps and read after them).
    ``between(state, global batch)``: called before each step with the
    state and batch that step gets, outside the step's timing."""
    from repro_torch.data import LMStream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.kernels.topk_select import slab_overflows
    from repro_torch.launch.train import train_loop
    state = ts.init_state(opt, torch.Generator(device=ts.device)
                          .manual_seed(0))
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    sizes = ts.compressor.spec.sizes
    log(f"[{tag}] {ts.fs.cfg.name} widths, {cfg.n_layers} layers: d={ts.d_local} "
        f"buckets {list(sizes)} bwd_chunks {ts.bwd_chunks} fuse_encode "
        f"{ts.fuse_encode} "
        f"(k, W) {[(c.k, c.sketch.width) for c in ts.compressor.parts]} "
        f"encoder {ts.compressor.parts[0].encoder} "
        f"P={ts.nworkers} batch {TRAIN_BATCH} seq {TRAIN_SEQ}")
    def before(step, st, *_):
        if between is not None and step < TRAIN_STEPS:
            between(st, stream.global_batch_at(step, ts.device))

    before(0, state)
    slab_overflows(ts.device, reset=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    state, hist, times = train_loop(
        ts, state, lambda s: stream.global_batch_at(s, ts.device),
        range(TRAIN_STEPS), log_every=1, last=TRAIN_STEPS - 1,
        after_step=lambda s, st, _: before(s + 1, st))
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    overflows = slab_overflows(ts.device, reset=True)
    for s, (loss, t) in enumerate(zip(hist, times)):
        log(f"[{tag}] step {s}: loss {loss!r}  step_s {t:.4f}")
    log(f"[{tag}] max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB); launches {counts}; select CTAs whose "
        f"slab overflowed: {overflows} over {counts.get('topk_select', 0)} "
        "selects")
    if not all(math.isfinite(x) for x in hist):
        fail(f"non-finite loss on the {tag} path: {hist}")
    return {"state": state, "stream": stream, "counts": counts,
            "times": times, "losses": hist, "peak": peak,
            "slab_overflows": overflows}


def full_width_ts_step(torch, device, ts, opt):
    """The full-width cell with gs-SGD's TS-sketch encoder: the main path's
    resolved geometry and buckets, ``encoder="ts"`` through
    ``compressor_kw`` (the spec has no encoder field, as in the
    reference)."""
    from repro_torch.core.gs_sgd import make_train_step
    base = ts.compressor.base
    kw = dict(k=base.k, rows=base.sketch.rows, width=base.sketch.width,
              seed=base.sketch.seed, allreduce_mode=base.allreduce_mode,
              wire_dtype=base.wire_dtype, encoder="ts")
    return make_train_step(ts.fs.cfg, ts.ma, opt, compressor_name="gs-sgd",
                           compressor_kw=kw, buckets=ts.n_buckets,
                           overlap=ts.overlap, dtype=torch.float32,
                           device=device)


PHASES = ("loss_and_grad", "forward", "backward", "encode", "allreduce",
          "recover", "exchange", "optimizer")


def span_split(events) -> dict:
    """Device time per span from a Chrome trace's events, each device event
    (kernel, memcpy, memset) counted once: it goes to the innermost span
    whose host time range holds its launch, the runtime or driver call with
    the same correlation id, whatever thread made that call (the backward
    launches from autograd's device thread inside ``loss_and_grad``; the
    hand kernels launch through ctypes and link the same way). A device
    event with no such call counts as unlinked."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"].split("/")[0])
                   for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].split("/")[0] in PHASES)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    us = {p: 0.0 for p in PHASES}
    outside = unlinked = busy = 0.0
    by_kernel: dict[str, float] = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        dur = float(e["dur"])
        busy += dur
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + dur
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        inner = [sp for sp in spans if t is not None and sp[0] <= t < sp[1]]
        if t is None:
            unlinked += dur
        elif inner:
            us[max(inner)[2]] += dur   # latest start: the innermost
        else:
            outside += dur
    return {"device_busy_ms": busy / 1e3,
            "span_device_ms": {p: v / 1e3 for p, v in us.items()},
            "outside_spans_ms": outside / 1e3,
            "unlinked_ms": unlinked / 1e3,
            "by_kernel_ms": {k: v / 1e3 for k, v in by_kernel.items()}}


def profile_phase(torch, ts, state, stream, tag="profile"):
    """One more step under torch.profiler: device time per span. Returns
    the state and the split (wall, busy, spans, idle share, peak)."""
    from repro_torch.launch.train import shard_batch
    batch = shard_batch(stream.global_batch_at(TRAIN_STEPS, ts.device),
                        ts.nworkers)

    def step():
        st, m = ts.fn(state, batch)
        float(m["loss"])
        return st

    return profile_call(torch, tag, step)


def profile_call(torch, tag, fn):
    """``fn()`` once under torch.profiler: device time per span (``PHASES``;
    a path without spans has all of it outside them), the idle share, the
    peak memory and the largest kernels. Returns (fn's result, the
    split)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        result = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    path = os.path.join(ROOT, "build", f"{tag}_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    split = span_split(trace["traceEvents"] if isinstance(trace, dict)
                       else trace)
    by_kernel = split.pop("by_kernel_ms")
    wall_ms, busy_ms = wall * 1e3, split["device_busy_ms"]
    parts_ms = (sum(split["span_device_ms"].values())
                + split["outside_spans_ms"] + split["unlinked_ms"])
    if abs(parts_ms - busy_ms) > 1e-6 * max(busy_ms, 1.0):
        fail(f"{tag}: spans add up to {parts_ms} ms of {busy_ms} ms busy")
    out = {"step_wall_ms": wall_ms, **split,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"[{tag}] " + json.dumps(out))
    log(f"[{tag}] spans + outside + unlinked = {parts_ms:.3f} ms = device "
        "busy (each device event counted once)")
    log(f"[{tag}] recover span {split['span_device_ms']['recover']:.3f} ms "
        f"of {busy_ms:.3f} ms busy; step wall {wall_ms:.3f} ms")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:16]
    for name, ms in top:
        log(f"[{tag}] kernel {ms:10.3f} ms  {name[:110]}")
    if busy_ms <= 0:
        log(f"[{tag}] the profiler saw no device time: not measured")
    return result, out


def fragment_encode_checks(torch, device, ts) -> tuple[list[dict], dict]:
    """The fused encode's launches at the fragment sizes the interleaved
    cell gives them: each fragment of each bucket added at its offset into
    an exact sketch of its own, the partials summed (as integers) and
    finished (the merge): bit-equal to the plain whole-bucket encode and to
    the kernel's, and within ENCODE_REL_TOL * max|S|; times of each partial
    encode, of the merge and of the whole-bucket encode. Returns the rows
    and the finish kernel's row (timed at bucket 0: both workers' exact
    sketches, as the merge finishes them)."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels.sketch_encode import (sketch_encode,
                                                   sketch_encode_finish,
                                                   sketch_encode_finish_plain,
                                                   sketch_encode_into,
                                                   sketch_encode_plain)
    gen = torch.Generator(device=device).manual_seed(2)
    rows, finish_row = [], None
    for b, (part, d, fr) in enumerate(zip(ts.compressor.parts,
                                          ts.compressor.spec.sizes,
                                          ts.plan.fragments())):
        cfg, R, W = part.sketch, part.sketch.rows, part.sketch.width
        g = _spiky(torch, gen, device, d, max(1, part.k // 4))
        want = sketch_encode_plain(cfg, g)
        lim = ENCODE_REL_TOL * float(want.abs().max())

        def partial(o, n):
            acc = cs.exact_zeros(cfg, device=device)
            return sketch_encode_into(cfg, g[o:o + n], acc, index_offset=o)

        parts = [partial(o, n) for o, n in fr]

        def merge():
            out = parts[-1]
            for p in parts[-2::-1]:
                out = out + p
            return sketch_encode_finish(out)

        merged = merge()
        err = float((merged - want).abs().max())
        same = (_bits_equal(torch, merged, want)
                and _bits_equal(torch, merged, sketch_encode(cfg, g)))
        if not (same and err <= lim):
            fail(f"the partial encodes of bucket {b} merged are not "
                 f"bit-equal to the whole-bucket encode (max_abs_err {err}, "
                 f"limit {lim})")
        del want, merged
        frag_ms = [time_ms(torch, lambda o=o, n=n: partial(o, n), reps=10)
                   for o, n in fr]
        whole_ms = time_ms(torch, lambda: sketch_encode(cfg, g), reps=10)
        merge_ms = time_ms(torch, merge, reps=10)
        zero_ms = time_ms(torch, lambda: cs.exact_zeros(cfg, device=device),
                          reps=10)
        bounds = [bound_ms(n * 4 + R * W * 4, n * R * 7.0)[0] for _, n in fr]
        row = {"bucket": b, "d": d, "rows": R, "width": W,
               "fragments": [{"offset": o, "n": n, "ms": ms, "bound_ms": bd}
                             for (o, n), ms, bd in zip(fr, frag_ms, bounds)],
               "partials_ms": sum(frag_ms), "merge_ms": merge_ms,
               "exact_zeros_ms": zero_ms,
               "whole_ms": whole_ms,
               "whole_bound_ms": bound_ms(d * 4 + R * W * 4, d * R * 7.0)[0],
               "max_abs_err": err, "bit_equal": same}
        log(f"[train_interleave] encode bucket {b} (d={d}, R={R}, W={W}): "
            f"{len(fr)} partial(s) {[round(x, 4) for x in frag_ms]} ms = "
            f"{sum(frag_ms):.4f} ms + merge (integer sum and finish) "
            f"{merge_ms:.4f} ms, whole-bucket encode {whole_ms:.4f} ms; "
            f"zeroing one exact accumulator {zero_ms:.4f} ms; "
            f"merged partials bit-equal to the whole-bucket encode "
            f"(max_abs_err {err:.4g}, limit {lim:.4g})")
        rows.append(row)
        if b == 0:
            both = cs.exact_zeros(cfg, (ts.nworkers,), device=device)
            for p in range(ts.nworkers):
                sketch_encode_into(cfg, g, both.worker(p))
            fin, fin_p = sketch_encode_finish(both), \
                sketch_encode_finish_plain(both)
            if not _bits_equal(torch, fin, fin_p):
                fail("sketch_encode_finish is not bit-equal to plain")
            ms = time_ms(torch, lambda: sketch_encode_finish(both), reps=10)
            plain_ms = time_ms(
                torch, lambda: sketch_encode_finish_plain(both), reps=2)
            cells = ts.nworkers * R * W
            finish_row = _row(
                "sketch_encode_finish", "src/repro_torch/csrc/sketch_encode.cu",
                "src/repro/kernels/sketch_encode.py:87",
                float((fin - fin_p).abs().max()), ms, plain_ms,
                bound_ms(cells * (24 + 4 + 4), cells * 12.0), None)
            log(f"[train_interleave] sketch_encode_finish of {ts.nworkers} x "
                f"({R}, {W}) exact sketches: {ms:.4f} ms, bit-equal to plain "
                f"({plain_ms:.3f} ms)")
            del both, fin, fin_p
        del g, parts
        torch.cuda.empty_cache()
    return rows, finish_row


class plain_calls:
    """Counts the calls of every kernel's plain version while it is open
    (the wrappers call them by their module's global name)."""

    NAMES = {"sketch_encode": ("sketch_encode_plain",
                               "sketch_encode_into_plain",
                               "sketch_encode_finish_plain"),
             "sketch_decode": ("sketch_decode_plain", "radix_hist_plain"),
             "heavymix_topk": ("heavymix_scores_plain",
                               "heavymix_scores_ts_plain",
                               "ts_transpose_plain", "radix_hist_plain"),
             "topk_select": ("topk_select_plain",),
             "ts_encode": ("ts_encode_plain",)}

    def __enter__(self):
        import importlib
        self.counts, self.saved = {}, []
        for mod_name, names in self.NAMES.items():
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            for name in names:
                f = getattr(mod, name)

                def counted(*a, _f=f, _n=name, **kw):
                    self.counts[_n] = self.counts.get(_n, 0) + 1
                    return _f(*a, **kw)

                setattr(mod, name, counted)
                self.saved.append((mod, name, f))
        return self.counts

    def __exit__(self, *exc):
        for mod, name, f in self.saved:
            setattr(mod, name, f)


def fused_sketch_check(torch, ts, state, stream):
    """One more interleaved step (not counted) in which every bucket's
    merged sketch is held against the whole-bucket encode of the same u
    (``GsSGD.stage_encode_merge``, wrapped for this step only): bit-equal,
    and within ENCODE_REL_TOL * max|S|."""
    from repro_torch.core import compression as comp
    from repro_torch.launch.train import shard_batch
    orig = comp.GsSGD.stage_encode_merge
    sizes = list(ts.compressor.spec.sizes)
    seen = {}

    def checked(self, pieces):
        u, sk = orig(self, pieces)
        whole = self._encode_workers(u)
        err = float((sk.to(torch.float32) - whole).abs().max())
        lim = ENCODE_REL_TOL * float(whole.abs().max())
        same = _bits_equal(torch, sk.to(torch.float32).contiguous(), whole)
        seen[sizes.index(u.shape[-1])] = (len(pieces), err, lim, same)
        return u, sk

    comp.GsSGD.stage_encode_merge = checked
    try:
        batch = shard_batch(stream.global_batch_at(TRAIN_STEPS + 1, ts.device),
                            ts.nworkers)
        state, m = ts.fn(state, batch)
        float(m["loss"])
    finally:
        comp.GsSGD.stage_encode_merge = orig
    if sorted(seen) != list(range(len(sizes))):
        fail(f"the fused merge ran for buckets {sorted(seen)} only")
    for b, (n, err, lim, same) in sorted(seen.items()):
        log(f"[train_interleave] fused sketch bucket {b} ({n} fragment(s)): "
            f"bit-equal to the whole-bucket encode of the same u: {same}; "
            f"max_abs_err {err:.4g} (limit {lim:.4g} = {ENCODE_REL_TOL} * "
            "max|S|)")
        if not err <= lim:
            fail(f"fused sketch of bucket {b} differs from the whole-bucket "
                 f"encode: {err} > {lim}")
        if not same:
            fail(f"fused sketch of bucket {b} is not bit-equal to the "
                 "whole-bucket encode")
    return state


def _snapshot(state) -> dict:
    """Worker 0's params and every worker's EF zero pattern (the last
    step's selected coordinates), copied to the host."""
    return {"params": {k: v[0].cpu() for k, v in state["params"].items()},
            "selected": [(e == 0).cpu() for e in state["ef"]]}


def compare_snapshots(got, want, tag="train_interleave") -> None:
    """The interleaved run's params and selection against the bucketed
    run's after the same counted steps: the selected coordinates equal,
    the params within INTERLEAVE_PARAM_RTOL / _ATOL."""
    n_sel = sum(int(s.sum()) for s in want["selected"])
    sel_diff = sum(int((a != b).sum())
                   for a, b in zip(got["selected"], want["selected"]))
    bad, worst = 0, 0.0
    for k, b in want["params"].items():
        diff = (got["params"][k] - b).abs()
        bad += int((diff > INTERLEAVE_PARAM_ATOL
                    + INTERLEAVE_PARAM_RTOL * b.abs()).sum())
        worst = max(worst, float(diff.max()))
    log(f"[{tag}] after {TRAIN_STEPS} steps: selected "
        f"coordinates {n_sel} (EF zero pattern), {sel_diff} differ; params "
        f"max_abs_diff {worst:.4g}, {bad} beyond rtol "
        f"{INTERLEAVE_PARAM_RTOL} / atol {INTERLEAVE_PARAM_ATOL}")
    if sel_diff:
        fail(f"the interleaved run selected other coordinates than the "
             f"bucketed run: {sel_diff} of {n_sel} differ")
    if bad:
        fail(f"the interleaved run's params differ from the bucketed run's "
             f"at {bad} coordinates (max {worst})")


def train_interleave_phase(torch, device) -> dict:
    """The full-width cell at buckets=4 with the chunked backward and the
    fused encode, against the same cell's bucketed step (see the module
    docstring, phase 6). Returns the launch counts and the fragment rows."""
    cfg, opt, ts = full_width_step(torch, device, buckets=INTERLEAVE_BUCKETS,
                                   bwd_chunks=INTERLEAVE_CHUNKS,
                                   fuse_encode=True)
    frags = ts.plan.fragments()
    n_frags = sum(len(f) for f in frags)
    log(f"[train_interleave] plan: sizes {list(ts.plan.sizes)}, readiness "
        f"{list(ts.plan.readiness)}, order {list(ts.plan.order)}, chunks "
        f"{list(ts.plan.chunks)}; fragments {frags} ({n_frags} a worker)")
    frag_rows, finish_row = fragment_encode_checks(torch, device, ts)
    with plain_calls() as plain:
        run = train_phase(torch, cfg, opt, ts, tag="train_interleave")
    counts = run["counts"]
    check_interleave_launches("train_interleave", ts, counts, plain)
    snap = _snapshot(run["state"])
    state = fused_sketch_check(torch, ts, run.pop("state"), run["stream"])
    state, _ = profile_phase(torch, ts, state, run["stream"],
                             tag="profile_interleave")
    del state
    torch.cuda.empty_cache()
    _, _, ts_b = full_width_step(torch, device, buckets=INTERLEAVE_BUCKETS)
    base = train_phase(torch, cfg, opt, ts_b, tag="train_bucketed4")
    compare_snapshots(snap, _snapshot(base["state"]))
    del snap
    state, _ = profile_phase(torch, ts_b, base.pop("state"),
                             base["stream"], tag="profile_bucketed4")
    del state, ts_b
    torch.cuda.empty_cache()
    check_interleaved_losses("train_interleave", run, base)
    return {"counts": counts, "fragments": frag_rows,
            "finish_row": finish_row}


def decode_route(part, d: int) -> bool:
    """Does ``ops.heavymix_recover`` take the decode route for a bucket of
    ``d`` coordinates under compressor ``part``? (d > 2^22 and d > 4k,
    greedy fill; else the scores kernel.)"""
    from repro_torch.core.heavymix import _CHUNK
    return not part.faithful_heavymix and d > _CHUNK and d > 4 * part.k


def check_interleave_launches(tag, ts, counts, plain) -> int:
    """The fused interleave's launch counts: a partial encode per fragment
    and worker, one finish per bucket (each merge finishes every worker's
    sketch), a select per recovery, and the decode or the scores kernel
    per recovery as each bucket's size and k route it (``decode_route``);
    no plain version. Returns the fragments a worker."""
    n_frags = sum(len(f) for f in ts.plan.fragments())
    n_dec = sum(decode_route(c, d) for c, d in zip(ts.compressor.parts,
                                                    ts.compressor.spec.sizes))
    per = ts.nworkers * TRAIN_STEPS
    want = {"sketch_encode": n_frags * per,
            "sketch_encode_finish": ts.n_buckets * TRAIN_STEPS,
            "topk_select": ts.n_buckets * per,
            "sketch_decode": n_dec * per,
            "heavymix_scores": (ts.n_buckets - n_dec) * per}
    for name, n in want.items():
        if counts.get(name, 0) != n:
            fail(f"{name} launched {counts.get(name, 0)} times on the {tag} "
                 f"path, not {n}")
    check_launches(tag, counts, (), ("ts_encode", "heavymix_scores_ts",
                                     "ts_transpose"))
    if plain:
        fail(f"plain versions called on the {tag} path: {plain}")
    log(f"[{tag}] sketch_encode launches {want['sketch_encode']} = "
        f"{n_frags} fragments x {ts.nworkers} workers x {TRAIN_STEPS} "
        f"steps; {n_dec} bucket(s) on the decode route, "
        f"{ts.n_buckets - n_dec} on the scores route ({want}); no plain "
        "version called")
    return n_frags


def check_interleaved_losses(tag, run, base) -> None:
    """The interleaved run's losses against the bucketed run's from the
    same seed: the first equal (the same forward), the later ones within
    INTERLEAVE_LOSS_RTOL."""
    li, lb = run["losses"], base["losses"]
    log(f"[{tag}] losses interleaved {li} / bucketed {lb}; "
        f"steps after the first {run['times'][1:]} / {base['times'][1:]} s; "
        f"peak memory {run['peak']} / {base['peak']} bytes "
        f"({(run['peak'] - base['peak']) / 2**30:+.3f} GiB)")
    if li[0] != lb[0]:
        fail(f"the first interleaved loss {li[0]!r} differs from the "
             f"bucketed step's {lb[0]!r}")
    if not _close(lb[1:], li[1:], INTERLEAVE_LOSS_RTOL):
        fail(f"interleaved losses {li} differ from the bucketed step's {lb} "
             f"beyond rtol {INTERLEAVE_LOSS_RTOL}")
    log(f"[{tag}] first losses equal; later ones within rtol "
        f"{INTERLEAVE_LOSS_RTOL} (largest relative difference "
        f"{max(abs(a - b) / abs(b) for a, b in zip(li, lb)):.3g})")


def minicpm_step(torch, device, p=TRAIN_P, allreduce_mode="psum",
                 record=True):
    """The train_minicpm cell's step (no state allocated yet): minicpm-2b
    at its published widths, MINICPM_LAYERS layers, P = ``p`` (TRAIN_P),
    buckets = 2, ``allreduce_mode`` (psum), SketchSpec(rows=5, width=None,
    k=None) resolved at its d, microbatch MINICPM_MICROBATCH, clip
    MINICPM_CLIP, the faithful fill; AdamW under wsd(TRAIN_LR, warmup=1,
    stable=0, decay=2), with ``record`` its apply wrapped to record the
    squared norm of each worker's applied gradient at step 0. Returns
    (cfg, opt, ts, schedule, the recorded norms by step)."""
    from repro_torch.api import ExchangeSpec, SketchSpec
    from repro_torch.configs.minicpm_2b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes, make_train_step
    from repro_torch.optim import make as make_opt
    from repro_torch.optim import wsd
    cfg = dataclasses.replace(CONFIG, n_layers=MINICPM_LAYERS)
    sched = wsd(TRAIN_LR, warmup=1, stable=0, decay=2)
    base = make_opt("adamw", lr=sched)
    applied: dict[int, torch.Tensor] = {}

    def apply(p, g, state, step):
        if step == 0:  # the checked step only: the f64 sum costs ~10 ms
            sq = torch.sum(g.double() ** 2, dim=tuple(range(1, g.dim())))
            applied[step] = applied.get(step, 0) + sq
        return base.apply(p, g, state, step)

    opt = dataclasses.replace(base, apply=apply) if record else base
    spec = ExchangeSpec(compressor="gs-sgd", buckets=2, overlap=True,
                        allreduce_mode=allreduce_mode,
                        sketch=SketchSpec(rows=5, width=None, k=None))
    ma = MeshAxes(tp=1, data=p, tp_axis=None)
    d = make_train_step(cfg, ma, opt, spec=spec, device=device).d_local
    kw = dict(spec.compressor_kw(d), faithful_heavymix=True)
    ts = make_train_step(cfg, ma, opt, compressor_name="gs-sgd",
                         compressor_kw=kw, buckets=2, overlap=True,
                         microbatch=MINICPM_MICROBATCH,
                         clip_norm=MINICPM_CLIP, dtype=torch.float32,
                         device=device)
    return cfg, opt, ts, sched, applied


def minicpm_filler_checks(torch, device, ts) -> list[dict]:
    """heavymix_scores with the faithful fill's filler at the cell's bucket
    shapes: scores and est bit-equal to plain, the histogram equal to the
    plain one; times of the kernel and of the plain version."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import draw_filler
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.sketch_encode import sketch_encode
    from repro_torch.kernels.topk_select import radix_hist_plain
    gen = torch.Generator(device=device).manual_seed(5)
    shapes = []
    for b, (part, d) in enumerate(zip(ts.compressor.parts,
                                      ts.compressor.spec.sizes)):
        cfg, k = part.sketch, part.k
        sk = sketch_encode(cfg, _spiky(torch, gen, device, d, k // 4))
        thr = cs.l2sq_estimate(sk) / k
        fill = draw_filler(d, device)
        sc, est, hist = heavymix_scores_hist(cfg, sk, thr, d, fill)
        sc_p, est_p = heavymix_scores_plain(cfg, sk, thr, d, fill)
        if not (_bits_equal(torch, sc, sc_p) and _bits_equal(torch, est,
                                                             est_p)):
            fail(f"heavymix_scores with the filler at minicpm bucket {b} is "
                 "not bit-equal to plain")
        if not torch.equal(hist, radix_hist_plain(sc_p)):
            fail(f"heavymix_scores' histogram with the filler at minicpm "
                 f"bucket {b} differs from plain")
        n_heavy = int((sc >= 1e30).sum())
        del sc, est, hist, sc_p, est_p
        ms = time_ms(torch, lambda: heavymix_scores_hist(cfg, sk, thr, d,
                                                         fill), reps=10)
        plain_ms = time_ms(torch, lambda: heavymix_scores_plain(
            cfg, sk, thr, d, fill), reps=2)
        R, W = cfg.rows, cfg.width
        bound = bound_ms(R * W * 4 + 4 + 3 * d * 4 + 2048 * 4,
                         d * (R * 6.0 + R * (R - 1) + 4))
        log(f"[train_minicpm] heavymix_scores with the filler at bucket {b} "
            f"(d={d}, R={R}, W={W}, k={k}, {n_heavy} heavy): bit-equal to "
            f"plain, histogram equal; {ms:.3f} ms (plain {plain_ms:.1f} ms)")
        shapes.append({"shape": f"train_minicpm bucket {b}, faithful filler",
                       "d": d, "rows": R, "width": W, "max_abs_err": 0.0,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                       "bound_by": bound[1], "library_ms": None})
        del sk, fill
        torch.cuda.empty_cache()
    return shapes


def train_minicpm_phase(torch, device) -> dict:
    """minicpm-2b at its published widths with microbatch, clip, wsd and
    the faithful fill (see MINICPM_*): three counted steps (sketch_encode,
    heavymix_scores with its filler and topk_select once per bucket and
    worker each, the decode never, no plain version called); step 0's
    microbatched loss against the full-batch loss of the same params (lr
    is 0 at step 0, so they do not move) and the applied gradient's norm
    against min(grad_norm, clip); one profiled step; the filler scores
    kernel at the cell's shapes. Returns the counts and those shapes."""
    from repro_torch.models import model as mdl
    from repro_torch.models.flatten import SEG_NAMES
    cfg, opt, ts, sched, applied = minicpm_step(torch, device)
    lrs = [float(sched(s)) for s in range(TRAIN_STEPS)]
    log(f"[train_minicpm] minicpm-2b widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"tied embeddings {cfg.tie_embeddings}), {cfg.n_layers} layers; "
        f"microbatch {MINICPM_MICROBATCH}, clip {MINICPM_CLIP}, faithful "
        f"fill; wsd lr at steps 0-{TRAIN_STEPS - 1}: {lrs}")
    first = {}
    fn = ts.fn

    def step_fn(state, batch):
        """The counted step; after step 0 (lr 0: the params did not move)
        the full-batch loss of each worker's params, with no microbatch."""
        new, m = fn(state, batch)
        if not first:
            with torch.no_grad():
                first["full"] = [float(mdl.loss_fn(
                    cfg, ts.fs, {k: new["params"][k][p] for k in SEG_NAMES},
                    {k: batch[k][p] for k in ("tokens", "labels")},
                    dtype=torch.float32)) for p in range(ts.nworkers)]
            first["m"] = m
        return new, m

    with plain_calls() as plain:
        run = train_phase(torch, cfg, opt, dataclasses.replace(ts, fn=step_fn),
                          tag="train_minicpm")
    counts = run["counts"]
    recoveries = ts.nworkers * ts.n_buckets * TRAIN_STEPS
    for name in ("sketch_encode", "sketch_encode_finish", "heavymix_scores",
                 "topk_select"):
        if counts.get(name) != recoveries:
            fail(f"{name} launched {counts.get(name)} times on the "
                 f"train_minicpm path, not {recoveries} (once a bucket, "
                 "worker and step)")
    check_launches("train_minicpm", counts, (),
                   ("sketch_decode", "ts_encode", "heavymix_scores_ts",
                    "ts_transpose"))
    if plain:
        fail(f"plain versions called on the train_minicpm path: {plain}")
    log(f"[train_minicpm] launches {counts}: each of sketch_encode, "
        f"sketch_encode_finish, heavymix_scores (with the filler) and "
        f"topk_select {recoveries} = "
        f"{ts.nworkers} workers x {ts.n_buckets} buckets x {TRAIN_STEPS} "
        "steps; sketch_decode 0; no plain version called")
    m, full = first["m"], first["full"]
    micro = [float(x) for x in m["worker_loss"]]
    gnorm = m["grad_norm"].double().cpu()
    want = torch.clamp(MINICPM_CLIP / gnorm, max=1.0) * gnorm
    got = applied[0].sqrt().cpu()
    log(f"[train_minicpm] step 0: microbatched worker losses {micro}, the "
        f"full-batch losses of the same params {full}; grad_norm "
        f"{gnorm.tolist()}, applied gradient's norm {got.tolist()} (clip "
        f"{MINICPM_CLIP}: {'active' if bool((gnorm > MINICPM_CLIP).all()) else 'inactive'})")
    if not _close(full, micro, MINICPM_RTOL):
        fail(f"step 0's microbatched losses {micro} differ from the full-batch "
             f"losses {full} beyond rtol {MINICPM_RTOL}")
    if not bool(torch.allclose(got, want, rtol=MINICPM_RTOL, atol=0.0)):
        fail(f"the applied gradient's norm {got.tolist()} is not "
             f"min(grad_norm, clip) = {want.tolist()}")
    state, prof = profile_phase(torch, ts, run.pop("state"), run["stream"],
                                tag="profile_minicpm")
    del state, first, m
    torch.cuda.empty_cache()
    shapes = minicpm_filler_checks(torch, device, ts)
    return {"counts": counts, "filler_shapes": shapes, "losses":
            run["losses"], "times": run["times"], "peak": run["peak"],
            "profile": prof}


# ---------------------------------------------------------------------------
# Fault-tolerant training: train_elastic, parity_elastic, cli_simulate
# ---------------------------------------------------------------------------

# train_elastic: the train_minicpm cell on the Alg. 1 tree at P = 4, then
# P = 3 after a heartbeat-detected failure of worker ELASTIC_FAILED. The
# global batch divides by 4 and 3 into local batches the microbatch (2)
# divides: 6 rows a worker at P = 4, 8 at P = 3. Heartbeats ride an
# explicit clock (ELASTIC_HB_PERIOD simulated seconds a step, timeout
# ELASTIC_HB_TIMEOUT): no phase sleeps.
ELASTIC_P, ELASTIC_FAILED, ELASTIC_BATCH = 4, 2, 24
ELASTIC_HB_PERIOD, ELASTIC_HB_TIMEOUT = 10.0, 5.0
ELASTIC_OUTLIER = 30.0   # the straggler's step time over its peers'
ELASTIC_DROP_FRAC = 0.34  # DeadlinePolicy's cap; the default 0.25 floors
#                          to no drop at all at P = 3
ELASTIC_SUM_RTOL = 1e-4  # a selected coordinate's applied update against
#                          the live workers' exact sum x P/live, beyond the
#                          f32 rounding of that sum (4 eps x sum of |terms|)
# parity_elastic: examples/fault_tolerant_training.py's scenario
ELASTIC_SMOKE_KW = dict(k=4096, rows=5, width=8192, allreduce_mode="tree")
ELASTIC_SMOKE_LR, ELASTIC_SMOKE_BATCH, ELASTIC_SMOKE_SEQ = 2e-3, 20, 32


def replicas_equal(torch, params) -> bool:
    return all(torch.equal(v, v[:1].expand_as(v)) for v in params.values())


class checked_drop:
    """While open, every ``exchange_bucketed`` call with an ``include``
    mask is held, at the shapes it runs at, as tests/test_runtime.py holds
    the reference's: each bucket's update on its selected coordinates is
    the live workers' sum of the error-corrected gradient u = ef + g times
    P/live (within ELASTIC_SUM_RTOL, or the f32 rounding of the sum), the
    same on every worker; the dropped workers' new EF is their u bit for
    bit; the live workers' new EF is 0 on the selection. Records what it
    checked in ``self.seen``."""

    def __init__(self, torch):
        self.torch, self.seen = torch, []

    def __enter__(self):
        from repro_torch.core import gs_sgd
        self.mod, self.orig = gs_sgd, gs_sgd.exchange_bucketed
        gs_sgd.exchange_bucketed = self.wrapped
        return self

    def __exit__(self, *exc):
        self.mod.exchange_bucketed = self.orig

    def wrapped(self, bc, ef_state, g_flat, *, nworkers, overlap=True,
                include=None):
        out = self.orig(bc, ef_state, g_flat, nworkers=nworkers,
                        overlap=overlap, include=include)
        if include is not None:
            self.check(bc, ef_state, g_flat, include, *out[:2])
        return out

    def check(self, bc, ef_state, g_flat, include, upd, ef_new):
        torch = self.torch
        inc = include > 0
        live = torch.nonzero(inc).flatten()
        dropped = torch.nonzero(~inc).flatten().tolist()
        nworkers = inc.numel()
        scale = nworkers / live.numel()
        if not all(torch.equal(upd[w], upd[0]) for w in range(nworkers)):
            fail("train_elastic: the workers apply different updates at the "
                 "drop step")
        eps = float(torch.finfo(torch.float32).eps)
        for b, (o, n) in enumerate(zip(bc.spec.offsets, bc.spec.sizes)):
            u = ef_state[b] + g_flat[:, o:o + n]
            for w in dropped:
                if not torch.equal(ef_new[b][w], u[w]):
                    fail(f"train_elastic: dropped worker {w}'s EF in bucket "
                         f"{b} is not its error-corrected gradient")
            got = upd[0, o:o + n]
            sel = torch.nonzero(got).flatten()
            terms = u.index_select(1, sel).index_select(0, live).double()
            want = terms.sum(0) * scale
            slack = 4 * eps * terms.abs().sum(0) * scale
            err = (got[sel].double() - want).abs()
            bad = int((err > ELASTIC_SUM_RTOL * want.abs() + slack).sum())
            if bad or not sel.numel():
                fail(f"train_elastic bucket {b}: {bad} of {sel.numel()} "
                     "selected coordinates are not the live sum x P/live")
            for w in live.tolist():
                if bool((ef_new[b][w].index_select(0, sel) != 0).any()):
                    fail(f"train_elastic: live worker {w}'s EF in bucket {b} "
                         "is not 0 on the selection")
            rel = float((err / want.abs().clamp(min=1e-30)).max())
            self.seen.append({"bucket": b, "d": n, "selected": sel.numel(),
                              "dropped": dropped, "scale": scale,
                              "max_rel_err": rel})
            del u, terms, want, slack, err, got, sel


def train_elastic_phase(torch, device) -> dict:
    """The train_minicpm cell (minicpm-2b widths, MINICPM_LAYERS layers,
    buckets 2, microbatch, clip, wsd, the faithful fill) on the Alg. 1
    tree: two steps at P = ELASTIC_P; worker ELASTIC_FAILED stops beating
    and the heartbeat monitor (explicit clock) reports it; ``replan`` to
    generation 1; the survivors' state rows carried leaf by leaf and the
    P = 4 state freed; a step built fresh at P = 3 runs two steps, one in
    which ``DeadlinePolicy`` drops a worker (the exchange held by
    ``checked_drop``), and one with every worker. Every step: a finite
    loss and bit-equal replicas. Counted: the whole run (encode, finish,
    scores with the filler, select once a bucket, worker and step; the
    decode never; no plain version). Then worker 0's packed gradient of
    the last step through the kernels, bit-equal to plain."""
    from repro_torch.data import LMStream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import shard_batch
    from repro_torch.runtime import (DeadlinePolicy, HeartbeatMonitor,
                                     carry_survivors, initial_plan, replan)
    cfg, opt, ts, _, _ = minicpm_step(torch, device, p=ELASTIC_P,
                                      allreduce_mode="tree", record=False)
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=ELASTIC_BATCH, seed=0)
    plan = initial_plan(ELASTIC_P)
    log(f"[train_elastic] minicpm-2b widths, {cfg.n_layers} layers: d = "
        f"{ts.d_local}, buckets {list(ts.compressor.spec.sizes)}, "
        f"allreduce tree ({len(plan.schedule)} reduce rounds at P = "
        f"{ELASTIC_P}), microbatch {MINICPM_MICROBATCH}, clip "
        f"{MINICPM_CLIP}, wsd, faithful fill; global batch {ELASTIC_BATCH}"
        f", seq {TRAIN_SEQ}")
    clock = [0.0]
    hb = HeartbeatMonitor(range(ELASTIC_P), clock=lambda: clock[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_state(opt, torch.Generator(device=device).manual_seed(0))
    losses, times, steps = [], {ELASTIC_P: [], ELASTIC_P - 1: []}, []

    def run(ts, state, s, include=None):
        batch = shard_batch(stream.global_batch_at(s, device), ts.nworkers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = ts.fn(state, batch, include)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times[ts.nworkers].append(dt)
        losses.append(loss)
        same = replicas_equal(torch, state["params"])
        log(f"[train_elastic] step {s} (P = {ts.nworkers}"
            f"{'' if include is None else ', include ' + str(include.tolist())}"
            f"): loss {loss!r}  step_s {dt:.4f}; replicas bit-equal: {same}")
        if not math.isfinite(loss) or not same:
            fail(f"train_elastic step {s}: loss {loss}, replicas equal {same}")
        steps.append(s)
        return state, m

    with plain_calls() as plain:
        LAUNCHES.clear()
        for s in range(2):
            state, _ = run(ts, state, s)
            clock[0] += ELASTIC_HB_PERIOD
            for w in plan.survivor_ids:
                if not (w == ELASTIC_FAILED and s >= 1):
                    hb.beat(w)
        peak4 = torch.cuda.max_memory_allocated()
        failed = hb.dead(ELASTIC_HB_TIMEOUT)
        if failed != {ELASTIC_FAILED}:
            fail(f"train_elastic: the heartbeat monitor reported {failed}, "
                 f"not {{{ELASTIC_FAILED}}}")
        for w in failed:
            hb.remove(w)
        old, plan = plan, replan(plan, failed)
        log(f"[train_elastic] heartbeat: worker(s) {sorted(failed)} silent "
            f"past {ELASTIC_HB_TIMEOUT} s (explicit clock at {clock[0]}); "
            f"replan -> generation {plan.generation}, survivors "
            f"{plan.survivor_ids}, P = {plan.n_workers}, lr_scale "
            f"{plan.lr_scale!r}, {len(plan.schedule)} tree rounds "
            f"{plan.schedule}")
        t0 = time.perf_counter()
        state = carry_survivors(state, [old.rank_of(w)
                                        for w in plan.survivor_ids])
        del ts
        torch.cuda.synchronize()
        carry_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        _, _, ts3, _, _ = minicpm_step(torch, device, p=plan.n_workers,
                                       allreduce_mode="tree", record=False)
        log(f"[train_elastic] survivors' state carried leaf by leaf in "
            f"{carry_s:.3f} s; {held} bytes ({held / 2**30:.2f} GiB) "
            "allocated after the P = 4 state was freed")
        pol = DeadlinePolicy(factor=3.0, max_drop_frac=ELASTIC_DROP_FRAC)
        for s in range(2, 4):
            state, _ = run(ts3, state, s)
            pol.observe([times[3][-1]] * 3)
        durs = [times[3][-1]] * 3
        durs[1] *= ELASTIC_OUTLIER
        mask = pol.mask(durs)
        log(f"[train_elastic] DeadlinePolicy(factor 3, max_drop_frac "
            f"{ELASTIC_DROP_FRAC}) on step durations {durs}: include "
            f"{mask.tolist()}")
        if mask.tolist() != [True, False, True]:
            fail(f"train_elastic: the policy's mask is {mask.tolist()}")
        include = torch.tensor(mask, dtype=torch.float32, device=device)
        with checked_drop(torch) as drop:
            state, _ = run(ts3, state, 4, include)
        if len(drop.seen) != ts3.n_buckets:
            fail(f"train_elastic: the drop step's exchange was checked for "
                 f"{len(drop.seen)} buckets, not {ts3.n_buckets}")
        for c in drop.seen:
            log(f"[train_elastic] drop step, bucket {c['bucket']} (d = "
                f"{c['d']}): {c['selected']} selected coordinates are the "
                f"live workers' sum x {c['scale']!r} (largest relative "
                f"difference {c['max_rel_err']:.3g}); dropped worker(s) "
                f"{c['dropped']} keep their error-corrected gradient in the "
                "EF, bit for bit; the live workers' EF 0 on the selection")
        with captured_buckets(ts3.compressor.parts) as got:
            state, _ = run(ts3, state, 5)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    recoveries = ts3.n_buckets * (ELASTIC_P * 2 + 3 * 4)
    for name in ("sketch_encode", "sketch_encode_finish", "heavymix_scores",
                 "topk_select"):
        if counts.get(name) != recoveries:
            fail(f"{name} launched {counts.get(name)} times on the "
                 f"train_elastic path, not {recoveries} (once a bucket, "
                 "worker and step)")
    check_launches("train_elastic", counts, (),
                   ("sketch_decode", "ts_encode", "heavymix_scores_ts",
                    "ts_transpose"))
    if plain:
        fail(f"plain versions called on the train_elastic path: {plain}")
    log(f"[train_elastic] launches {counts}: encode, finish, scores (with "
        f"the filler) and select {recoveries} each = 2 buckets x (4 workers "
        "x 2 steps + 3 x 4); no plain version called")
    log(f"[train_elastic] peak memory {peak4} bytes ({peak4 / 2**30:.2f} "
        f"GiB) through the P = 4 steps, {peak} ({peak / 2**30:.2f} GiB) "
        f"over the phase; step_s at P = 4 {times[4]}, at P = 3 {times[3]} "
        f"({card_line()})")
    del state
    torch.cuda.empty_cache()
    route_checks(torch, "train_elastic", ts3.compressor.parts, got)
    return {"counts": counts, "times": times, "losses": losses,
            "peak": peak, "peak_p4": peak4, "drop": drop.seen}


def elastic_scenario(torch, device):
    """examples/fault_tolerant_training.py's three phases at the smoke
    config through the port on ``device`` (params from a CPU generator
    seeded 0, the same on either device): P = 5 on
    the tree (steps 0-3), ``replan`` after worker 3 fails, the survivors'
    rows and a fresh P = 4 step (steps 4-6), ``DeadlinePolicy`` drops
    worker 1 (30x slower) at step 7, step 8 includes all. Returns the
    losses, each step's EF zero pattern (on the CPU), the final replica
    divergence and, on the card, the launch counts of the run."""
    from repro_torch.configs import SMOKES
    from repro_torch.core.gs_sgd import MeshAxes, make_state, make_train_step
    from repro_torch.data import LMStream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import shard_batch
    from repro_torch.models.flatten import init_flat_params
    from repro_torch.optim import make as make_opt
    from repro_torch.runtime import (DeadlinePolicy, carry_survivors,
                                     initial_plan, replan)
    cfg = SMOKES["qwen3-4b"]
    opt = make_opt("adamw", lr=ELASTIC_SMOKE_LR)

    def build(p):
        return make_train_step(cfg, MeshAxes(tp=1, data=p, tp_axis=None), opt,
                               compressor_name="gs-sgd",
                               compressor_kw=ELASTIC_SMOKE_KW, remat=False,
                               dtype=torch.float32, device=device)

    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=ELASTIC_SMOKE_SEQ,
                      global_batch=ELASTIC_SMOKE_BATCH, seed=0)
    ts = build(5)
    params = init_flat_params(cfg, torch.Generator().manual_seed(0), 1,
                              ts.fs)
    state = make_state({k: v.to(device) for k, v in params.items()}, opt,
                       ts.compressor, ts.d_local, 5)
    losses, zeros = [], []
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        LAUNCHES.clear()

    def step(ts, state, s, include):
        batch = shard_batch(stream.global_batch_at(s, device), ts.nworkers)
        state, m = ts.fn(state, batch, include.to(device))
        losses.append(float(m["loss"]))
        ef = state["ef"] if isinstance(state["ef"], tuple) else (state["ef"],)
        zeros.append([(e == 0).cpu() for e in ef])
        return state

    for s in range(4):
        state = step(ts, state, s, torch.ones(5))
    old = initial_plan(5)
    plan = replan(old, failed={3})
    state = carry_survivors(state, [old.rank_of(w) for w in
                                    plan.survivor_ids])
    ts = build(plan.n_workers)
    for s in range(4, 7):
        state = step(ts, state, s, torch.ones(4))
    pol = DeadlinePolicy(factor=3.0)
    pol.observe([1.0, 1.0, 1.0, 1.0])
    mask = torch.tensor(pol.mask([1.0, 30.0, 1.0, 1.0]), dtype=torch.float32)
    state = step(ts, state, 7, mask)
    state = step(ts, state, 8, torch.ones(4))
    counts = {}
    if on_card:
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
    div = max(float((v - v[:1]).abs().max()) for v in state["params"].values())
    return {"losses": losses, "zeros": zeros, "divergence": div,
            "mask": mask.tolist(), "plan": plan, "counts": counts}


def parity_elastic_phase(torch, card="cuda") -> dict:
    """``elastic_scenario`` on the card and on the CPU port from the same
    params: the selected coordinates (every worker's EF zero pattern)
    equal on every step, the losses within PARITY_LOSS_RTOL, the replica
    divergence 0 on both; the scores route's kernels launched on the card
    (the smoke buckets are below 2^22)."""
    cpu = elastic_scenario(torch, "cpu")
    with plain_calls() as plain:
        gpu = elastic_scenario(torch, card)
    counts = gpu["counts"]
    log(f"[parity_elastic] plan {gpu['plan'].survivor_ids} generation "
        f"{gpu['plan'].generation} lr_scale {gpu['plan'].lr_scale!r}; "
        f"drop mask {gpu['mask']}; losses cpu {cpu['losses']} card "
        f"{gpu['losses']}; replica divergence cpu {cpu['divergence']} card "
        f"{gpu['divergence']}; card launches {counts}")
    if not _close(cpu["losses"], gpu["losses"], PARITY_LOSS_RTOL):
        fail("parity_elastic: card and CPU losses differ")
    for s, (a, b) in enumerate(zip(cpu["zeros"], gpu["zeros"])):
        for i, (x, y) in enumerate(zip(a, b)):
            if not torch.equal(x, y):
                fail(f"parity_elastic: selected coordinates differ at step "
                     f"{s} bucket {i}")
    if cpu["divergence"] != 0.0 or gpu["divergence"] != 0.0:
        fail("parity_elastic: the replicas diverged")
    if card != "cpu":
        if plain:
            fail(f"plain versions called on the parity_elastic card path: "
                 f"{plain}")
        check_launches("parity_elastic", counts,
                       ("sketch_encode", "sketch_encode_finish",
                        "heavymix_scores", "topk_select"),
                       ("sketch_decode", "ts_encode", "heavymix_scores_ts",
                        "ts_transpose"))
    log(f"[parity_elastic] {len(cpu['losses'])} steps: losses within rtol "
        f"{PARITY_LOSS_RTOL}, selected coordinates equal every step, replica "
        "divergence 0 on both")
    return counts


def cli_simulate_phase() -> None:
    """``python -m repro_torch.launch.simulate`` (host only: it runs
    nothing on a device): README's fail_rejoin run at P = 1,024, buckets 8
    on ``--engine batched`` and ``--engine loop`` (their ``--out`` files
    equal, ``--json`` curves a step each); a ``--watch --congest`` run
    that re-plans, with ``--trace`` validated by ``obs.trace.validate``.
    Prints the simulator's own wall seconds, host time."""
    from repro_torch.obs import trace as obtrace
    out_dir = os.path.join(ROOT, "build", "cli_simulate")
    os.makedirs(out_dir, exist_ok=True)
    path = {n: os.path.join(out_dir, n) for n in (
        "batched.json", "loop.json", "curves.json", "watch.json",
        "trace.json")}
    base = ["--p", "1024", "--method", "gs-sgd", "--buckets", "8",
            "--fault-trace", os.path.join("examples", "traces",
                                          "fail_rejoin.json")]
    walls = {}
    for engine in ("batched", "loop"):
        extra = ["--json", path["curves.json"]] if engine == "batched" else []
        lines = run_cli("repro_torch.launch.simulate",
                        base + ["--engine", engine, "--out",
                                path[f"{engine}.json"], *extra],
                        tag="cli_simulate")
        walls[engine] = next(ln for ln in lines if "host wall" in ln)
    with open(path["batched.json"], "rb") as f, \
            open(path["loop.json"], "rb") as g:
        if f.read() != g.read():
            fail("cli_simulate: the batched and loop engines' --out files "
                 "differ")
    with open(path["curves.json"]) as f:
        curves = json.load(f)
    with open(path["batched.json"]) as f:
        res = json.load(f)
    if (len(curves["curves"]) != res["totals"]["steps"]
            or set(curves) < {"model", "curves", "checks"}
            or [r["p"] for r in res["replans"]] != [1023]):
        fail(f"cli_simulate: unexpected result {res['totals']} "
             f"{res['replans']}")
    lines = run_cli("repro_torch.launch.simulate",
                    ["--p", "8", "--d", "1000000", "--steps", "20",
                     "--compute-jitter", "0", "--watch", "--congest", "8:6",
                     "--out", path["watch.json"], "--trace",
                     path["trace.json"]], tag="cli_simulate")
    walls["watch"] = next(ln for ln in lines if "host wall" in ln)
    if not any(ln.startswith("watchdog: re-planned") for ln in lines):
        fail("cli_simulate: the watched congested run did not re-plan")
    with open(path["trace.json"]) as f:
        doc = json.load(f)
    n_spans = obtrace.validate(doc)
    if doc["source"] != "sim" or not n_spans:
        fail("cli_simulate: the --trace document is not a sim trace")
    log(f"[cli_simulate] batched and loop --out files equal "
        f"({res['totals']['steps']} steps, replans "
        f"{[(r['step'], r['p']) for r in res['replans']]}); the watched "
        f"run re-planned; its trace validates ({n_spans} spans); the "
        "simulator's own wall time, host clock (a model's timeline, no "
        "device time):")
    for k, ln in walls.items():
        log(f"[cli_simulate]   {k}: {ln}")


def check_route(tag, counts, plain, recoveries, decode=True) -> None:
    """A path whose recoveries all take one route: the encode, its finish,
    the select and the route's kernel (``sketch_decode``, or with
    ``decode=False`` ``heavymix_scores``) ``recoveries`` times each (once a
    bucket, worker and step); the other route's kernel, the TS kernels and
    the plain versions never."""
    route, other = (("sketch_decode", "heavymix_scores") if decode
                    else ("heavymix_scores", "sketch_decode"))
    for name in ("sketch_encode", "sketch_encode_finish", route,
                 "topk_select"):
        if counts.get(name) != recoveries:
            fail(f"{name} launched {counts.get(name)} times on the {tag} "
                 f"path, not {recoveries} (once a bucket, worker and step)")
    check_launches(tag, counts, (), (other, "heavymix_scores_ts",
                                     "ts_transpose", "ts_encode"))
    if plain:
        fail(f"plain versions called on the {tag} path: {plain}")
    log(f"[{tag}] launches {counts}: encode, finish, {route} and select "
        f"{recoveries} each (buckets x workers x steps); no plain version "
        "called")


def family_cell(torch, device, cfg, want_d, **kw):
    """``cfg`` under the main path's exchange (``full_width_step``), its d
    checked against the value the tests pin."""
    cfg, opt, ts = full_width_step(torch, device, cfg=cfg, **kw)
    if ts.d_local != want_d:
        fail(f"{cfg.name} at {cfg.n_layers} layers: d = {ts.d_local}, "
             f"not {want_d}")
    return cfg, opt, ts


class recorded_drops:
    """While open, ``models.moe.dispatch`` (which ``moe_block`` calls by its
    module's global name) also appends, per call, a (2,) device tensor:
    the kept (token, choice) pairs and all of them. Only the untimed
    forwards of ``drop_share`` run under it."""

    def __enter__(self):
        import torch

        from repro_torch.models import moe
        self.mod, self.f, drops = moe, moe.dispatch, []

        def counted(eidx, ne, cap, _f=self.f):
            dests, keeps = _f(eidx, ne, cap)
            kept = torch.stack([k.sum() for k in keeps]).sum()
            drops.append(torch.stack([kept,
                                      torch.full_like(kept, eidx.numel())]))
            return dests, keeps

        moe.dispatch = counted
        return drops

    def __exit__(self, *exc):
        self.mod.dispatch = self.f


def drop_share(torch, cfg, ts, state, gb) -> float:
    """The dropped share of the (token, choice) pairs in the forward that
    the next step runs: every worker's params on its shard of global batch
    ``gb``, one no-grad ``loss_fn`` each under ``recorded_drops`` (the
    routing is the step's: the same f32 forward)."""
    from repro_torch.launch.train import shard_batch
    from repro_torch.models import model as mdl
    from repro_torch.models.flatten import SEG_NAMES
    batch = shard_batch(gb, ts.nworkers)
    with torch.no_grad(), recorded_drops() as drops:
        for p in range(ts.nworkers):
            mdl.loss_fn(cfg, ts.fs, {k: state["params"][k][p]
                                     for k in SEG_NAMES},
                        {k: v[p] for k, v in batch.items()},
                        dtype=torch.float32)
    kept, total = (int(v) for v in torch.stack(drops).sum(0))
    return 1.0 - kept / total


class captured_buckets:
    """While open, ``GsSGD.stage_encode`` and ``stage_encode_merge`` (the
    fused interleave's) also keep, once per bucket (one compressor of
    ``parts``), a copy of worker 0's packed vector u (the EF plus its
    gradient: the encode's input) and of the f32 sketch the step made of
    it. Returns the dict bucket -> (u, sketch)."""

    def __init__(self, parts):
        self.index = {id(c): b for b, c in enumerate(parts)}

    def __enter__(self):
        from repro_torch.core import compression as comp
        self.cls, got = comp.GsSGD, {}
        self.saved = {n: getattr(self.cls, n)
                      for n in ("stage_encode", "stage_encode_merge")}

        def wrap(f):
            def kept(part, *a, **kw):
                u, sk = f(part, *a, **kw)
                got.setdefault(self.index[id(part)],
                               (u[0].clone(), sk[0].float().clone()))
                return u, sk
            return kept

        for n, f in self.saved.items():
            setattr(self.cls, n, wrap(f))
        return got

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.cls, n, f)


def capture_step(torch, ts, state, stream):
    """One more step (not counted, not timed) under ``captured_buckets``.
    Returns the state and worker 0's (u, sketch) of each bucket."""
    from repro_torch.launch.train import shard_batch
    batch = shard_batch(stream.global_batch_at(TRAIN_STEPS + 1, ts.device),
                        ts.nworkers)
    with captured_buckets(ts.compressor.parts) as got:
        state, m = ts.fn(state, batch)
        float(m["loss"])
    if sorted(got) != list(range(ts.n_buckets)):
        fail(f"captured the encode of buckets {sorted(got)} only")
    return state, got


def route_checks(torch, tag, parts, got, timed=False) -> dict:
    """The path's kernels at the path's own shapes, on worker 0's packed
    vector u of each bucket (``capture_step``; bucket b's compressor is
    ``parts[b]``): the sketch the step made and ``sketch_encode`` (the
    accumulate and its finish) of u bit-equal to ``sketch_encode_plain``;
    on that sketch the bucket's route kernel (``sketch_decode`` with its
    histogram, or ``heavymix_scores`` with its histogram, as
    ``decode_route`` says) bit-equal to its plain version and the
    histogram equal to the plain one; ``topk_select`` of those keys equal
    to ``topk_select_plain``, indices and value bits. ``timed``: also
    time each kernel, its plain version and its library call at these
    shapes; returns kernel name -> [shape row, a bucket]."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import draw_filler
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.sketch_decode import (sketch_decode_hist,
                                                   sketch_decode_plain)
    from repro_torch.kernels.sketch_encode import (sketch_encode,
                                                   sketch_encode_plain)
    from repro_torch.kernels.topk_select import (radix_hist_plain,
                                                 topk_select,
                                                 topk_select_plain)
    rows: dict = {}
    for b in range(len(parts)):
        u, sk_step = got.pop(b)
        part = parts[b]
        cfg, k, d = part.sketch, part.k, u.shape[0]
        R, W = cfg.rows, cfg.width
        sk = sketch_encode(cfg, u)
        sk_p = sketch_encode_plain(cfg, u)
        same = {"step's sketch": _bits_equal(torch, sk_step, sk_p),
                "sketch_encode": _bits_equal(torch, sk, sk_p)}
        if not all(same.values()):
            fail(f"{tag} bucket {b} (d={d}, R={R}, W={W}): the encode is not "
                 f"bit-equal to plain: {same}")
        del sk_p, sk_step
        shape = f"{tag} bucket {b} (d={d}, R={R}, W={W}, k={k})"
        if timed:
            def ids_vals(lo, hi):
                bk, sg = cs.hash_buckets(cfg, torch.arange(lo, hi,
                                                           device=u.device))
                return bk, sg * u[lo:hi]

            rows.setdefault("sketch_encode", []).append(_timed_shape(
                torch, shape, lambda: sketch_encode(cfg, u),
                lambda: sketch_encode_plain(cfg, u),
                _index_add_ms(torch, u.device, R, W, d, ids_vals)[0],
                bound_ms(d * 4 + R * W * 4, d * R * 7.0)))
        ops_per = R * 6.0 + R * (R - 1)   # hashes + compare-exchanges
        if decode_route(part, d):
            route = "sketch_decode"
            key, hist = sketch_decode_hist(cfg, sk, d)
            key_p = sketch_decode_plain(cfg, sk, d)
            if not torch.equal(key, key_p):
                fail(f"{tag} bucket {b} (d={d}): sketch_decode is not "
                     f"bit-equal to plain ({int((key != key_p).sum())} "
                     "coordinates differ)")
            if not torch.equal(hist, radix_hist_plain(key_p)):
                fail(f"{tag} bucket {b} (d={d}): sketch_decode's histogram "
                     "differs from the plain one")
            del key_p
            if timed:
                rows.setdefault(route, []).append(_timed_shape(
                    torch, shape, lambda: sketch_decode_hist(cfg, sk, d),
                    lambda: sketch_decode_plain(cfg, sk, d),
                    _decode_library_ms(torch, u.device, cfg, sk, d)[0],
                    bound_ms(R * W * 4 + d * 4 + 2048 * 4, d * ops_per)))
        else:   # scores, est and histogram held against plain inside
            route = "heavymix_scores"
            thr = cs.l2sq_estimate(sk) / k
            fill = (draw_filler(d, u.device) if part.faithful_heavymix
                    else None)
            key, est, hist, _ = check_scores_hist(
                torch, f"{tag} bucket {b}", cfg, sk, thr, d, fill)
            del est, fill
            if timed:
                rows.setdefault(route, []).append(_timed_shape(
                    torch, shape, lambda: heavymix_scores_hist(cfg, sk, thr,
                                                               d),
                    lambda: heavymix_scores_plain(cfg, sk, thr, d), None,
                    bound_ms(R * W * 4 + 4 + 2 * d * 4 + 2048 * 4,
                             d * (ops_per + 4))))
        v, i = topk_select(key, k, hist)
        v_p, i_p = topk_select_plain(key, k, hist)
        if not (torch.equal(i, i_p)
                and torch.equal(v.view(torch.int32), v_p.view(torch.int32))):
            fail(f"{tag} bucket {b} (d={d}, k={k}): topk_select differs from "
                 f"plain ({int((i != i_p).sum())} of {k} indices)")
        if timed:
            rows.setdefault("topk_select", []).append(_timed_shape(
                torch, shape, lambda: topk_select(key, k, hist),
                lambda: topk_select_plain(key, k, hist),
                time_ms(torch, lambda: torch.topk(key, k, sorted=False),
                        reps=3),
                bound_ms(d * 4 + 2048 * 4 + k * 12, d * 3.0)))
        log(f"[{tag}] bucket {b} (d={d}, R={R}, W={W}, d*R={d * R}, k={k}), "
            f"worker 0's packed gradient: the step's sketch and "
            f"sketch_encode bit-equal to plain; {route} and its histogram "
            "equal to plain; topk_select equal to plain (indices, value "
            "bits)")
        del key, hist, v, i, v_p, i_p, sk, u
        torch.cuda.empty_cache()
    return rows


def _timed_shape(torch, shape, call, plain, library_ms, bound) -> dict:
    """A kernel's numbers at one shape (bit-equal to plain: checked by
    the caller)."""
    return {"shape": shape, "max_abs_err": 0.0,
            "ms": time_ms(torch, call, reps=10),
            "plain_ms": time_ms(torch, plain, reps=2),
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms}


def train_moe_phase(torch, device) -> dict:
    """granite-moe-3b-a800m at its published widths, MOE_LAYERS layers:
    three counted steps on the decode route, the capacity and each step's
    dropped share of the (token, choice) pairs, one profiled step."""
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG
    from repro_torch.models import moe
    from repro_torch.models.common import padded_vocab
    cfg, opt, ts = family_cell(
        torch, device, dataclasses.replace(CONFIG, n_layers=MOE_LAYERS),
        MOE_D)
    if tuple(ts.compressor.spec.sizes) != MOE_BUCKETS:
        fail(f"train_moe buckets {ts.compressor.spec.sizes}, not "
             f"{MOE_BUCKETS}")
    T = TRAIN_BATCH // TRAIN_P * TRAIN_SEQ
    cap = moe.expert_capacity(cfg, T)
    log(f"[train_moe] granite-moe-3b-a800m widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts "
        f"top-{cfg.experts_per_tok}, expert d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size} padded to {padded_vocab(cfg, 1)}, tied "
        f"{cfg.tie_embeddings}), {cfg.n_layers} layers; capacity C = {cap} "
        f"for {T} tokens a worker and layer (mean load "
        f"{T * cfg.experts_per_tok / cfg.n_experts:.1f})")
    shares = []
    with plain_calls() as plain:
        run = train_phase(torch, cfg, opt, ts, tag="train_moe",
                          between=lambda st, gb: shares.append(
                              drop_share(torch, cfg, ts, st, gb)))
    check_route("train_moe", run["counts"], plain,
                ts.nworkers * ts.n_buckets * TRAIN_STEPS)
    log(f"[train_moe] dropped share of the (token, choice) pairs per step "
        f"({cfg.n_layers} MoE blocks x {ts.nworkers} workers a step, "
        f"capacity {cap}; each from an untimed no-grad forward of the "
        f"step's params and batch): {shares}")
    state, prof = profile_phase(torch, ts, run.pop("state"), run["stream"],
                                tag="profile_moe")
    state, got = capture_step(torch, ts, state, run["stream"])
    del state
    torch.cuda.empty_cache()
    route_checks(torch, "train_moe", ts.compressor.parts, got)
    del ts
    torch.cuda.empty_cache()
    return {**run, "profile": prof, "capacity": cap, "drop_shares": shares}


def train_hybrid_phase(torch, device) -> dict:
    """zamba2-2.7b at its published widths, HYBRID_LAYERS layers (two
    cycles of six Mamba2 blocks and the shared block): three counted steps
    on the decode route and one profiled step; then three steps at
    buckets=4 with the chunked backward (one cycle a chunk) and the fused
    encode against three steps at bwd_chunks=None from the same seed,
    held as ``train_interleave`` holds the main cell."""
    from repro_torch.configs.zamba2_2_7b import CONFIG
    hcfg = dataclasses.replace(CONFIG, n_layers=HYBRID_LAYERS)
    cfg, opt, ts = family_cell(torch, device, hcfg, HYBRID_D)
    log(f"[train_hybrid] zamba2-2.7b widths (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, ssm_state {cfg.ssm_state}, "
        f"vocab {cfg.vocab_size}), {cfg.n_layers} Mamba2 layers in "
        f"{cfg.n_cycles} cycles, each closed by the shared block")
    with plain_calls() as plain:
        run = train_phase(torch, cfg, opt, ts, tag="train_hybrid")
    check_route("train_hybrid", run["counts"], plain,
                ts.nworkers * ts.n_buckets * TRAIN_STEPS)
    state, prof = profile_phase(torch, ts, run.pop("state"), run["stream"],
                                tag="profile_hybrid")
    state, got = capture_step(torch, ts, state, run["stream"])
    del state
    torch.cuda.empty_cache()
    route_checks(torch, "train_hybrid", ts.compressor.parts, got)
    del ts
    torch.cuda.empty_cache()
    _, _, ts_i = family_cell(torch, device, hcfg, HYBRID_D,
                             buckets=INTERLEAVE_BUCKETS,
                             bwd_chunks=HYBRID_CHUNKS, fuse_encode=True)
    log(f"[train_hybrid_interleave] plan: sizes {list(ts_i.plan.sizes)}, "
        f"readiness {list(ts_i.plan.readiness)}, chunks "
        f"{list(ts_i.plan.chunks)}; fragments {ts_i.plan.fragments()}")
    with plain_calls() as plain:
        inter = train_phase(torch, cfg, opt, ts_i,
                            tag="train_hybrid_interleave")
    check_interleave_launches("train_hybrid_interleave", ts_i,
                              inter["counts"], plain)
    state = inter.pop("state")
    snap = _snapshot(state)
    state, got = capture_step(torch, ts_i, state, inter["stream"])
    del state
    torch.cuda.empty_cache()
    route_checks(torch, "train_hybrid_interleave", ts_i.compressor.parts,
                 got)
    del ts_i
    torch.cuda.empty_cache()
    _, _, ts_b = family_cell(torch, device, hcfg, HYBRID_D,
                             buckets=INTERLEAVE_BUCKETS)
    base = train_phase(torch, cfg, opt, ts_b, tag="train_hybrid_bucketed4")
    compare_snapshots(snap, _snapshot(base.pop("state")), tag="train_hybrid")
    del snap, ts_b
    torch.cuda.empty_cache()
    check_interleaved_losses("train_hybrid", inter, base)
    return {**run, "profile": prof, "interleave_counts": inter["counts"],
            "interleave": {k: inter[k] for k in ("losses", "times", "peak")},
            "bucketed4": {k: base[k] for k in ("losses", "times", "peak")}}


class kept_recoveries:
    """While open, ``GsSGD.stage_reduce`` and ``_SketchBased._recover``
    also keep worker 0's copy of each summed sketch and of the indices
    HEAVYMIX selects from it: {"sums": [...], "idx": [...]}, in call
    order."""

    def __enter__(self):
        from repro_torch.core import compression as comp
        kept = {"sums": [], "idx": []}
        self.saved = [(comp.GsSGD, "stage_reduce", comp.GsSGD.stage_reduce),
                      (comp._SketchBased, "_recover",
                       comp._SketchBased._recover)]

        def reduce(part, *a, _f=self.saved[0][2], **kw):
            sk_sum, scale = _f(part, *a, **kw)
            kept["sums"].append(sk_sum[0].clone())
            return sk_sum, scale

        def recover(part, *a, _f=self.saved[1][2], **kw):
            upd, idx = _f(part, *a, **kw)
            kept["idx"].append(idx[0].clone())
            return upd, idx

        comp.GsSGD.stage_reduce, comp._SketchBased._recover = reduce, recover
        return kept

    def __exit__(self, *exc):
        for cls, name, f in self.saved:
            setattr(cls, name, f)


def cnn_steps(torch, model, part, device, steps):
    """``steps`` steps of the paper's step (``cnn_dist.make_step``) from
    seed 0's params (drawn on the CPU, so every device starts equal) and
    ``ImageStream`` seed 0. Returns (step fn, state, losses, host seconds
    a step)."""
    from repro_torch.bench import cnn_dist
    params = cnn_dist.init_params(model, "cpu")
    step, state, _, _ = cnn_dist.make_step(
        model, part, CNN_P, lr=CNN_LR, device=device,
        params={k: {j: v.to(device) for j, v in blk.items()}
                for k, blk in params.items()})
    losses, times = [], []
    for i in range(steps):
        b = cnn_batch(i, device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, (loss, _) = step(state, *b)
        losses.append(float(loss))   # a device sync
        times.append(time.perf_counter() - t0)
    return step, state, losses, times


def unexplained_swaps(torch, part, sk_sum, d, coords, decode) -> list:
    """The coordinates of ``coords`` that a near-tie does not explain in
    the recovery from ``sk_sum``: |score - k-th score| and |est^2 - l2^2/k|
    both above CNN_TIE_RTOL of their reference (the decode route ranks
    |est| alone)."""
    from repro_torch.core import count_sketch as cs
    if not coords:
        return []
    est = cs.decode(part.sketch, sk_sum.cpu(), d)
    thr = float(cs.l2sq_estimate(sk_sum.cpu())) / part.k
    score = est.abs() if decode else torch.where(
        est * est >= thr, est.abs() + 1e30, est.abs())
    kth = float(torch.topk(score, part.k).values[-1])
    return [i for i in coords
            if abs(float(score[i]) - kth) > CNN_TIE_RTOL * kth
            and abs(float(est[i]) ** 2 - thr) > CNN_TIE_RTOL * thr]


def train_cnn_phase(torch, device) -> dict:
    """The paper's experiment at full size, each model: CNN_STEPS counted
    steps on the route its d gives it, a second run with the same bits,
    the cost of cuDNN's deterministic mode, the route checks (timed) on
    worker 0's gradient of one more step, and the CPU port's steps from the
    same params and batches (losses, the first step's selection); one
    profiled step."""
    from repro_torch.bench import cnn_dist
    from repro_torch.bench.time_breakdown import paper_geometry
    from repro_torch.core.count_sketch import l2sq_estimate as cs_l2sq
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.kernels.sketch_decode import sketch_decode
    out = {}
    for model, want_d, decode, cpu_steps in CNN_CELLS:
        tag = f"train_cnn_{model}"
        d = sum(x.numel() for blk in cnn_dist.init_params(model, "cpu")
                .values() for x in blk.values())
        if d != want_d:
            fail(f"{model}: d = {d}, not {want_d}")
        k, width = paper_geometry(d)
        part = cnn_dist.make_compressor("gs-sgd", k=k, rows=5, width=width)
        log(f"[{tag}] full size, d={d}, P={CNN_P}, global batch "
            f"{CNN_BATCH}, gs-SGD k={k} R=5 W={width}, SGD momentum 0.9 "
            f"lr {CNN_LR}; route {'decode' if decode else 'scores'}")
        with plain_calls() as plain, kept_recoveries() as kept:
            torch.cuda.synchronize()
            LAUNCHES.clear()
            step, state, losses, times = cnn_steps(torch, model, part,
                                                   device, CNN_STEPS)
            counts = dict(LAUNCHES)
        check_route(tag, counts, plain, CNN_P * CNN_STEPS, decode=decode)
        if not all(math.isfinite(x) for x in losses):
            fail(f"non-finite loss on the {tag} path: {losses}")
        again = cnn_steps(torch, model, part, device, CNN_STEPS)[2]
        if again != losses:
            fail(f"{tag}: a second run's losses {again} are not the first's "
                 f"{losses} (cuDNN deterministic)")
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        try:
            fast = cnn_steps(torch, model, part, device, CNN_STEPS)[3]
        finally:
            cnn_dist.prepare_device(device)
        ms = sorted(t * 1e3 for t in times[1:])
        fast_ms = sorted(t * 1e3 for t in fast[1:])
        log(f"[{tag}] losses {losses}; the same bits in a second run; step "
            f"ms after the first {ms} (median {ms[len(ms) // 2]:.3f}); "
            f"cuDNN nondeterministic with its autotuner: {fast_ms} (median "
            f"{fast_ms[len(fast_ms) // 2]:.3f})")
        prof = profile_call(torch, f"profile_cnn_{model}", lambda: float(
            step(state, *cnn_batch(CNN_STEPS, device))[1][0]))[1]
        with captured_buckets([part]) as got:
            step(state, *cnn_batch(CNN_STEPS + 1, device))
        del state
        shapes = route_checks(torch, tag, [part], got, timed=True)
        with kept_recoveries() as kept_cpu:
            cpu_losses = cnn_steps(torch, model, part, torch.device("cpu"),
                                   cpu_steps)[2]
        if not _close(losses[:cpu_steps], cpu_losses, PARITY_LOSS_RTOL):
            fail(f"{tag}: card losses {losses[:cpu_steps]}, CPU {cpu_losses}")
        swaps = sorted(set(kept["idx"][0].tolist())
                       ^ set(kept_cpu["idx"][0].tolist()))
        bad = unexplained_swaps(torch, part, kept["sums"][0], d, swaps,
                                decode)
        sk0 = kept["sums"][0]
        est = sketch_decode(part.sketch, sk0, d)
        heavy = int((est * est >= cs_l2sq(sk0) / k).sum())
        del est
        if bad or len(swaps) > part.k // 100:
            fail(f"{tag}: the first step selects {len(swaps)} coordinates "
                 f"differently on the card and the CPU; not near-ties: {bad}")
        log(f"[{tag}] card vs CPU: losses within rtol {PARITY_LOSS_RTOL} "
            f"over {cpu_steps} step(s) (CPU {cpu_losses}); the first step's "
            f"heavy set {heavy} (k={k}); its selection: {len(swaps)} "
            f"coordinates differ, each a "
            f"near-tie (within {CNN_TIE_RTOL} of the k-th score or the "
            "heavy threshold)")
        out[model] = {"counts": counts, "shapes": shapes, "losses": losses,
                      "step_ms": ms, "nondeterministic_step_ms": fast_ms,
                      "profile": prof}
        del step, part
        torch.cuda.empty_cache()
    return out


def cnn_batch(i, device):
    """Step i's global batch of ``ImageStream`` seed 0, split over the
    CNN cell's workers: (images (P, b, 32, 32, 3), labels (P, b))."""
    from repro_torch.data import ImageStream
    b = ImageStream(global_batch=CNN_BATCH, seed=0).global_batch_at(i, device)
    per = CNN_BATCH // CNN_P
    return (b["images"].reshape(CNN_P, per, 32, 32, 3),
            b["labels"].reshape(CNN_P, per))


def paper_table2_phase(torch, device) -> dict:
    """Table II on the card: ``bench.throughput.main`` at full size. Prints
    each method's t_compu, t_compr and t_commu (Eq. 1 at 1 GbE), images/s
    measured and modelled, and g/k, g/s; asserts no ratio."""
    from repro_torch.bench import throughput
    res = throughput.main(device=device)
    for model in ("resnet20", "vgg16"):
        per = res[model]
        for m in throughput.METHODS:
            r = per[m]
            log(f"[paper_table2] {model} {m}: d={r['d']} k={r['k']} "
                f"W={r['width']} t_compu {r['t_compu'] * 1e3:.4f} ms "
                f"t_compr {r['t_compr'] * 1e3:.4f} ms t_commu "
                f"{r['t_commu'] * 1e3:.4f} ms (Eq. 1, 1 GbE: {r['rounds']} "
                f"rounds, {r['bytes']:.0f} B); images/s measured "
                f"{r['img_per_s']:.2f}, modelled {r['img_per_s_accel']:.2f}")
        log(f"[paper_table2] {model}: g/k measured "
            f"{per['speedup_vs_gtopk_img_per_s']:.4f}x modelled "
            f"{per['speedup_vs_gtopk_img_per_s_accel']:.4f}x; g/s measured "
            f"{per['speedup_vs_sketched_img_per_s']:.4f}x modelled "
            f"{per['speedup_vs_sketched_img_per_s_accel']:.4f}x (paper: g/k "
            "1.3-3.1x, g/s 1.1-1.2x)")
    return res


def paper_figs_phase(torch, device) -> None:
    """Figs. 2-3 and 6-7 on the card: ``bench.convergence.main`` and
    ``bench.k_sensitivity.main`` for CNN_FIG_STEPS steps; finite losses."""
    from repro_torch.bench import convergence, k_sensitivity
    conv = convergence.main(steps=CNN_FIG_STEPS, device=device)
    ks = k_sensitivity.main(steps=CNN_FIG_STEPS, device=device)
    finals = {f"{m} {meth}": r["losses"][-1] for m in ("resnet20", "vgg16")
              for meth, r in conv[m].items()}
    finals.update({f"resnet20 gs-sgd k={k}": r["losses"][-1]
                   for k, r in ks.items()})
    bad = {n: v for n, v in finals.items() if not math.isfinite(v)}
    if bad:
        fail(f"paper_figs: non-finite final losses {bad}")
    log(f"[paper_figs] final losses after {CNN_FIG_STEPS} steps: {finals}")


def cross_batch(torch, cfg, spec, step):
    """The vlm's stub frontend: seeded (batch, n_cross_tokens, d_model)
    patch embeddings for ``step``, the same on either device."""
    import numpy as np
    rs = np.random.RandomState(1000 * spec.seed + step)
    return torch.from_numpy(rs.randn(spec.batch, cfg.n_cross_tokens,
                                     cfg.d_model).astype(np.float32))


def smoke_runs(torch, spec, steps=2, card="cuda", ef_dtype=None,
               cross_kv=False):
    """``steps`` steps of ``spec`` on the CPU and on ``card`` from the same
    params and batches. Returns ((losses, ef states) on the CPU, the same
    on the card) and the card run's launch counts (set to 0 just before
    it, read just after). ``ef_dtype``: the EF's storage dtype
    (``make_state``); ``cross_kv``: the batches carry the vlm's seeded
    patch embeddings (``cross_batch``)."""
    from repro_torch.core.gs_sgd import make_state
    from repro_torch.data import LMStream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.kernels.topk_select import slab_overflows
    from repro_torch.launch import train as ttrain
    from repro_torch.models.flatten import init_flat_params
    results, counts, params_cpu = [], {}, None
    for dev in ("cpu", card):
        cfg, opt, _, ts = ttrain.build(spec, dev)
        if params_cpu is None:
            params_cpu = init_flat_params(
                cfg, torch.Generator().manual_seed(spec.seed), 1, ts.fs)
        state = make_state({k: v.to(ts.device) for k, v in
                            params_cpu.items()}, opt, ts.compressor,
                           ts.d_local, ts.nworkers,
                           ef_dtype=ef_dtype or torch.float32)
        stream = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                          global_batch=spec.batch, seed=spec.seed)
        losses, efs = [], []
        on_card = len(results) == 1
        if on_card:
            slab_overflows(ts.device, reset=True)
            torch.cuda.synchronize()
            LAUNCHES.clear()
        for step in range(steps):
            gb = stream.global_batch_at(step, dev)
            if cross_kv:
                gb["cross_kv"] = cross_batch(torch, cfg, spec, step).to(dev)
            batch = ttrain.shard_batch(gb, ts.nworkers)
            state, m = ts.fn(state, batch)
            losses.append(float(m["loss"]))
            efs.append(state["ef"])
        if on_card:
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            counts["slab_overflows"] = slab_overflows(ts.device, reset=True)
        results.append((losses, efs))
    return results, counts


def _close(a, b, rtol):
    return all(abs(x - y) <= rtol * abs(x) for x, y in zip(a, b))


def smoke_spec():
    from repro_torch.api import RunSpec
    return RunSpec.load(os.path.join(ROOT, "examples", "specs",
                                     "qwen3_smoke.json"))


def parity_phase(torch, card="cuda") -> dict:
    """The smoke spec (gs-SGD), two steps, card against CPU from the same
    inputs; its buckets are below 2^22, so the scores kernel runs."""
    results, counts = smoke_runs(torch, smoke_spec(), card=card)
    (lc, ec), (lg, eg) = results
    log(f"[parity] smoke losses cpu {lc} cuda {lg}; card launches {counts}")
    if not _close(lc, lg, PARITY_LOSS_RTOL):
        fail(f"card and CPU losses differ: {lc} vs {lg}")
    for s, (a, b) in enumerate(zip(ec, eg)):
        for i, (x, y) in enumerate(zip(a, b)):
            if not torch.equal(x == 0, (y == 0).cpu()):
                fail(f"selected coordinates differ at step {s} bucket {i}")
    check_launches("parity", counts, ("sketch_encode", "sketch_encode_finish",
                                      "heavymix_scores", "topk_select"),
                   ("sketch_decode", "ts_encode", "heavymix_scores_ts",
                    "ts_transpose"))
    log("[parity] losses within rtol "
        f"{PARITY_LOSS_RTOL}; selected coordinates equal every step")
    return counts


def hold_parity(torch, tag, label, results, counts) -> None:
    """Card against CPU: losses within PARITY_LOSS_RTOL, the selected
    coordinates (the EF zero pattern) equal every step, the EF in the same
    dtype, and the scores route's kernels launched."""
    (lc, ec), (lg, eg) = results
    log(f"[{tag}] {label} smoke losses cpu {lc} cuda {lg}; card launches "
        f"{counts}")
    if not _close(lc, lg, PARITY_LOSS_RTOL):
        fail(f"{label}: card and CPU losses differ: {lc} vs {lg}")
    for s, (a, b) in enumerate(zip(ec, eg)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x.dtype != y.dtype:
                fail(f"{label}: EF dtype {y.dtype} on the card, {x.dtype} "
                     "on the CPU")
            if not torch.equal(x == 0, (y == 0).cpu()):
                fail(f"{label}: selected coordinates differ at step {s} "
                     f"bucket {i}")
    check_launches(f"{tag} {label}", counts, ("sketch_encode",
                                              "sketch_encode_finish",
                                              "heavymix_scores",
                                              "topk_select"))


def parity_configs_phase(torch, card="cuda") -> dict:
    """Two steps of each new dense smoke config (the smoke spec with the
    arch replaced), card against CPU from the same params and batches:
    losses within PARITY_LOSS_RTOL, selected coordinates equal."""
    counts = {}
    for arch in NEW_SMOKE_ARCHS:
        spec = dataclasses.replace(smoke_spec(), arch=arch)
        results, c = smoke_runs(torch, spec, card=card)
        hold_parity(torch, "parity", arch, results, c)
        counts[arch] = c
    log(f"[parity] {', '.join(NEW_SMOKE_ARCHS)}: losses within rtol "
        f"{PARITY_LOSS_RTOL}; selected coordinates equal every step")
    return counts


def parity_families_phase(torch, card="cuda") -> dict:
    """Two steps of each other family's smoke config (the smoke spec with
    the arch replaced), card against CPU as ``parity_configs_phase``
    holds the dense ones; the vlm once more with ``cross_kv`` in its
    batches, and qwen3-moe once more under its override row's optimizer
    and EF dtype (SGD with momentum, a bf16 EF), passed in: the row is
    keyed by the full config's name. Returns the summed card launches."""
    runs = [(arch, arch, {}) for arch in FAMILY_SMOKE_ARCHS]
    runs += [("llama-3.2-vision-11b", "llama-3.2-vision-11b + cross_kv",
              {"cross_kv": True}),
             ("qwen3-moe-235b-a22b", "qwen3-moe-235b-a22b + sgdm, bf16 EF",
              {"optimizer": "sgdm", "ef_dtype": torch.bfloat16})]
    total: dict = {}
    for arch, label, kw in runs:
        spec = dataclasses.replace(smoke_spec(), arch=arch,
                                   optimizer=kw.get("optimizer"))
        results, c = smoke_runs(torch, spec, card=card,
                                ef_dtype=kw.get("ef_dtype"),
                                cross_kv=kw.get("cross_kv", False))
        hold_parity(torch, "parity_families", label, results, c)
        if kw.get("ef_dtype") is not None and results[1][1][-1][0].dtype \
                != kw["ef_dtype"]:
            fail(f"{label}: the EF is {results[1][1][-1][0].dtype} after "
                 "the steps")
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    log(f"[parity_families] {len(runs)} runs: losses within rtol "
        f"{PARITY_LOSS_RTOL}; selected coordinates equal every step")
    return total


def baselines_phase(torch, card="cuda"):
    """Every compressor of the registry: two smoke-spec steps on the card
    and on the CPU, losses within PARITY_LOSS_RTOL."""
    from repro_torch.core.compression import REGISTRY
    base = smoke_spec()
    for name in sorted(REGISTRY):
        spec = dataclasses.replace(base, exchange=dataclasses.replace(
            base.exchange, compressor=name))
        t0 = time.time()
        results, counts = smoke_runs(torch, spec, card=card)
        (lc, _), (lg, _) = results
        log(f"[baselines] {name}: losses cpu {lc} cuda {lg}; card launches "
            f"{counts} ({time.time() - t0:.1f} s)")
        if not all(math.isfinite(x) for x in lc + lg):
            fail(f"{name}: non-finite loss")
        if not _close(lc, lg, PARITY_LOSS_RTOL):
            fail(f"{name}: card and CPU losses differ: {lc} vs {lg}")
    log(f"[baselines] {len(REGISTRY)} compressors: card and CPU losses "
        f"within rtol {PARITY_LOSS_RTOL}")


def _ckpt_files(d, step):
    path = os.path.join(d, f"step_{step}")
    return {f: os.path.join(path, f) for f in sorted(os.listdir(path))
            if f.endswith(".npy")}


def cli_resume_phase():
    """The train CLI on the card, smoke spec, four steps: once with
    checkpoints every step and a simulated crash after step 2, then
    ``--resume`` to step 4; once straight to step 4. The final losses (the
    JSON floats) and every tensor of the two step-4 checkpoints must be
    bit-equal."""
    import numpy as np
    base = os.path.join(ROOT, "build", "cli_ckpt")
    if os.path.isdir(base):
        import shutil
        shutil.rmtree(base)
    d_res, d_str = os.path.join(base, "resumed"), os.path.join(base, "straight")
    common = ("--steps", "4", "--ckpt-every", "1")
    cli_phase((*common, "--ckpt-dir", d_res, "--kill-at", "2"),
              final=False)
    resumed = cli_phase((*common, "--ckpt-dir", d_res, "--resume"))
    straight = cli_phase((*common, "--ckpt-dir", d_str))
    a, b = _ckpt_files(d_res, 4), _ckpt_files(d_str, 4)
    same = list(a) == list(b) and all(
        np.array_equal(np.load(a[f]), np.load(b[f])) for f in a)
    log(f"[cli] resumed final_loss {resumed['final_loss']!r}, straight "
        f"{straight['final_loss']!r}; step-4 checkpoints ({len(a)} tensors) "
        f"bit-equal: {same}")
    if resumed["final_loss"] != straight["final_loss"] or not same:
        fail("the resumed CLI run differs from the straight one")


def cli_phase(extra=(), final=True):
    lines = run_cli("repro_torch.launch.train",
                    ["--spec", os.path.join("examples", "specs",
                                            "qwen3_smoke.json"), *extra],
                    tag="cli")
    if not final:
        return None
    last = json.loads(lines[-1])
    if not math.isfinite(last["final_loss"]):
        fail(f"the train CLI gave a non-finite loss: {last}")
    return last

# ---------------------------------------------------------------------------
# The driver's observability and re-planning loop: train_traced,
# train_watched, cli_tune
# ---------------------------------------------------------------------------

WATCH_STEPS = 6   # re-plan at step 2 (warmup 1, forced hot), rebuilt steps
#                   3-5 (3 tagged warmup, 4 the new baseline, 5 may decide)
TRACED_PHASES = ("backward", "encode", "comm", "recover", "optimizer")


def cell_spec(ts, exchange, steps=TRAIN_STEPS, **kw):
    """The RunSpec of a full-width cell: qwen3-4b with ``d`` set to the
    2-layer d (the CLI cannot build qwen3-4b at 2 layers), so the
    simulator, the tuner and the watchdog price the cell that runs."""
    from repro_torch.api import ClusterSpec, RunSpec
    return RunSpec(arch="qwen3-4b", d=ts.d_local, steps=steps,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, seed=0,
                   exchange=exchange, cluster=ClusterSpec(p=ts.nworkers),
                   **kw)


def _on_card(ts) -> bool:
    return ts.device.type == "cuda"


def drive_cell(torch, ts, opt, spec, steps, state=None, **kw):
    """``launch.train.drive`` over steps ``steps`` of the cell's stream
    (seed 0), from a fresh state (seed 0) unless ``state`` is given."""
    from repro_torch.data import LMStream
    from repro_torch.launch.train import drive
    if state is None:
        state = ts.init_state(opt, torch.Generator(device=ts.device)
                              .manual_seed(0))
    stream = LMStream(vocab_size=ts.fs.cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    steps = list(steps)
    return drive(spec, ts, state,
                 lambda s: stream.global_batch_at(s, ts.device), steps,
                 log_every=1, last=steps[-1], **kw)


def step_launches(ts) -> dict:
    """The launches one step of ``ts`` makes on the card: per worker and
    bucket an encode, its finish (once a bucket for a fused merge, which
    finishes every worker's sketch), the decode past the reference's
    chunked threshold (d > 2^22 and d > 4k) or the scores kernel below it,
    and the select."""
    import collections

    from repro_torch.core.heavymix import _CHUNK
    want = collections.Counter()
    p = ts.nworkers
    sizes = ts.compressor.spec.sizes
    frags = ts.plan.fragments() if ts.fuse_encode else None
    for i, (c, d) in enumerate(zip(ts.compressor.parts, sizes)):
        if frags is not None:
            want["sketch_encode"] += p * len(frags[i])
            want["sketch_encode_finish"] += 1
        else:
            want["sketch_encode"] += p
            want["sketch_encode_finish"] += p
        route = ("sketch_decode" if d > _CHUNK and d > 4 * c.k
                 else "heavymix_scores")
        want[route] += p
        want["topk_select"] += p
    return dict(want)


def _diff(after: dict, before: dict) -> dict:
    out = {k: v - before.get(k, 0) for k, v in after.items()}
    return {k: v for k, v in out.items() if v}


def train_traced_phase(torch, ts, opt, exchange, profiled=None,
                       train_peak=None) -> dict:
    """The main cell, three steps untraced, then the same three steps with
    the tracer and the trace@2 recorder (``launch.train.drive``, as
    ``--trace --json`` runs it): losses bit-equal; the trace valid, one
    probe span, a step span a step (step 0 warmup), every phase > 0, a span
    a bucket; the trace@2 document complete. ``profiled``: the ``profile``
    phase's split, printed beside the probe's phases."""
    from repro_torch import obs
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import Trace2Recorder, state_bytes
    from repro_torch.obs import trace as obtrace
    tag = "train_traced"
    spec = cell_spec(ts, exchange)
    LAUNCHES.clear()
    plain = drive_cell(torch, ts, opt, spec, range(TRAIN_STEPS))
    plain_counts = dict(LAUNCHES)
    del plain["state"]
    if _on_card(ts):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tracer = obs.Tracer()
    prov = obs.provenance(spec, ts.device)
    rec = Trace2Recorder(spec, ts, prov)
    LAUNCHES.clear()
    traced = drive_cell(torch, ts, opt, spec, range(TRAIN_STEPS),
                        tracer=tracer, recorder=rec)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if _on_card(ts) else None
    state_b = state_bytes(traced.pop("state"))
    if _on_card(ts):
        torch.cuda.empty_cache()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    doc2 = rec.document(ts.fs.cfg.name)
    probe_s = time.perf_counter() - t0
    probe_counts = dict(LAUNCHES)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    doc = tracer.save(os.path.join(out_dir, f"{tag}_trace.json"), spec=spec,
                      provenance=prov, source="train")
    obs.dump(doc2, os.path.join(out_dir, f"{tag}_trace2.json"))

    lp, lt = plain["history"], traced["history"]
    log(f"[{tag}] losses untraced {lp} / traced {lt}")
    if lp != lt:
        fail(f"traced losses {lt} differ from the untraced run's {lp}")
    if not all(math.isfinite(x) for x in lt):
        fail(f"non-finite loss on the {tag} path: {lt}")
    n_spans = obtrace.validate(doc)
    probes = obtrace.spans(doc, cat="probe")
    steps = obtrace.spans(doc, cat="step")
    warm = {s["args"]["step"]: s["args"]["warmup"] for s in steps}
    totals = obtrace.phase_totals(doc)
    per_bucket = {cat: obtrace.bucket_durations(doc, cat, prefix)
                  for cat, prefix in (("encode", "encode/b"),
                                      ("comm", "allreduce/b"),
                                      ("recover", "recover/b"))}
    if len(probes) != 1 or len(steps) != TRAIN_STEPS:
        fail(f"{tag}: {len(probes)} probe spans and {len(steps)} step spans")
    if warm != {s: s == 0 for s in range(TRAIN_STEPS)}:
        fail(f"{tag}: warmup tags {warm}")
    missing = [ph for ph in TRACED_PHASES if not totals.get(ph, 0.0) > 0]
    if missing:
        fail(f"{tag}: no time in the probe's phases {missing}: {totals}")
    for cat, durs in per_bucket.items():
        if len(durs) != ts.n_buckets:
            fail(f"{tag}: {len(durs)} {cat} bucket spans, not "
                 f"{ts.n_buckets}")
    pred, gauges = doc2["predicted"], doc2["metrics"]["gauges"]
    if "error" in pred or "step_time" not in pred:
        fail(f"{tag}: the trace@2 predicted block is {pred}")
    if "recovery_error_probe" not in gauges:
        fail(f"{tag}: the trace@2 document has no recovery_error_probe")
    if len(doc2["records"]) != TRAIN_STEPS:
        fail(f"{tag}: {len(doc2['records'])} trace@2 records")
    pv = doc2["provenance"]
    if _on_card(ts) and (pv["backend"] != "cuda" or pv["device_kind"]
                         != torch.cuda.get_device_name(0)):
        fail(f"{tag}: provenance does not name the card: {pv}")
    launched = ("sketch_encode", "sketch_encode_finish", "sketch_decode",
                "topk_select")
    check_launches(tag, counts, launched,
                   ("heavymix_scores", "heavymix_scores_ts", "ts_transpose",
                    "ts_encode"))
    per_step = step_launches(ts)
    for name, cnt in per_step.items():
        if plain_counts.get(name, 0) != cnt * TRAIN_STEPS:
            fail(f"{name} launched {plain_counts.get(name, 0)} times on the "
                 f"untraced {tag} run, not {cnt * TRAIN_STEPS}")
        if counts.get(name, 0) != cnt * (TRAIN_STEPS + 1):
            fail(f"{name} launched {counts.get(name, 0)} times on the "
                 f"traced {tag} run, not {cnt * (TRAIN_STEPS + 1)} "
                 f"({TRAIN_STEPS} steps and the probe)")
    check_launches(f"{tag} recovery probe", probe_counts,
                   ("sketch_encode", "sketch_encode_finish",
                    "heavymix_scores", "topk_select"),
                   ("sketch_decode",))

    probe = traced["probe"]
    phase_ms = {ph: totals.get(ph, 0.0) * 1e3 for ph in
                ("forward",) + TRACED_PHASES}
    log(f"[{tag}] trace: {n_spans} spans valid; probe at step "
        f"{probe['step']} {probes[0]['dur'] * 1e3:.3f} ms; probe phases "
        f"(host clock, a device sync at each span's end) "
        + json.dumps({k: round(v, 3) for k, v in phase_ms.items()}))
    log(f"[{tag}] probe per bucket (ms): " + json.dumps(
        {cat: [round(x * 1e3, 3) for x in durs]
         for cat, durs in per_bucket.items()}))
    if profiled is not None:
        log(f"[{tag}] beside the profile phase's device time per span "
            f"(ms): " + json.dumps({k: round(v, 3) for k, v in
                                    profiled["span_device_ms"].items()
                                    if v}))
    tp, tt = plain["times"], traced["times"]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    log(f"[{tag}] step seconds untraced {tp} / traced {tt}; after the "
        f"first: {mean(tp[1:]):.4f} / {mean(tt[1:]):.4f} s "
        f"({(mean(tt[1:]) / mean(tp[1:]) - 1) * 100:+.2f}%)")
    log(f"[{tag}] probe's state copy {probe['copy_bytes']} bytes "
        f"({probe['copy_bytes'] / 2**30:.2f} GiB, the state is {state_b} "
        f"bytes); probe step {probe['seconds']:.4f} s; peak "
        f"{peak} bytes"
        + (f" ({peak / 2**30:.2f} GiB; train's {train_peak / 2**30:.2f} "
           "GiB)" if peak is not None and train_peak else ""))
    log(f"[{tag}] trace@2: predicted {json.dumps(pred)}; "
        f"recovery_error_probe {gauges['recovery_error_probe']!r} "
        f"({probe_s:.3f} s, launches {probe_counts}); t_step "
        f"{[r['t_step'] for r in doc2['records']]}; provenance "
        f"{pv['backend']} {pv['device_kind']} x {pv['device_count']}")
    log(f"[{tag}] launches untraced {plain_counts} / traced {counts} "
        f"(= {TRAIN_STEPS} steps + the probe)")
    return {"counts": counts, "phase_ms": phase_ms, "times": tt,
            "plain_times": tp, "copy_bytes": probe["copy_bytes"],
            "peak": peak}


def train_watched_phase(torch, ts, opt, exchange, make_step) -> dict:
    """The main cell with the drift watchdog forced hot (warmup 1, delta
    -1, threshold 0, budget 4, as the reference's test arms it): every
    detection reaches a decision, an applied re-plan clears the 1% gain
    bar, and the rebuilt step (``make_step(exchange)``, the re-plan's
    exchange at the cell's widths) runs at least two steps with finite
    losses and launches what its geometry implies."""
    from repro_torch.api import WatchSpec
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.tune.watch import Watchdog
    tag = "train_watched"
    spec = cell_spec(ts, exchange, steps=WATCH_STEPS,
                     watch=WatchSpec(enabled=True, warmup=1, delta=-1.0,
                                     threshold=0.0, replan_budget=4))
    wd = Watchdog(spec)
    snaps: dict[int, dict] = {}

    def after(step, state, loss):
        snaps[step] = dict(LAUNCHES)
        return False

    def rebuild(new_spec):
        t = make_step(new_spec.exchange)
        log(f"[{tag}] rebuilt the step: buckets {list(t.compressor.spec.sizes)}"
            f", bwd_chunks {t.bwd_chunks}, (k, W) "
            f"{[(c.k, c.sketch.width) for c in t.compressor.parts]}")
        return t

    LAUNCHES.clear()
    out = drive_cell(torch, ts, opt, spec, range(WATCH_STEPS), watchdog=wd,
                     rebuild=rebuild, after_step=after)
    hist, times = list(out["history"]), list(out["times"])
    for e in wd.log:
        log(f"[{tag}] " + json.dumps({k: e[k] for k in (
            "kind", "step", "phase", "choice", "predicted", "current",
            "gain", "direction", "rel") if k in e}))
    kinds = [e["kind"] for e in wd.log]
    if "drift.detected" not in kinds:
        fail(f"{tag}: the forced-hot watchdog detected nothing")
    if len(kinds) != 2 * kinds.count("drift.detected"):
        fail(f"{tag}: a detection reached no decision: {kinds}")
    for e in wd.log:
        if e["kind"] == "watch.replan" and not e["gain"] >= 0.01:
            fail(f"{tag}: a re-plan under the 1% gain bar: {e}")
    replans = out["replans"]
    if replans:
        rp = replans[-1]
        last, new_ts = rp["step"], out["ts"]
        ran = WATCH_STEPS - 1 - last
        if ran < 2:   # a re-plan at the last steps: run the rebuilt step on
            more = drive_cell(torch, new_ts, opt, out["spec"],
                              range(WATCH_STEPS, WATCH_STEPS + 2 - ran),
                              state=out["state"], after_step=after)
            hist += more["history"]
            times += more["times"]
            ran = 2
            del more
        counts = _diff(dict(LAUNCHES), snaps[last])
        want = {k: v * ran for k, v in step_launches(new_ts).items()}
        log(f"[{tag}] re-planned at step {last} (error feedback "
            f"{'kept' if rp['ef_kept'] else 'reset'}); the rebuilt step ran "
            f"{ran} steps: launches {counts}, its geometry implies {want}")
        if counts != want:
            fail(f"{tag}: the rebuilt step launched {counts}, not {want}")
        log(f"[{tag}] choice {rp['choice']}: predicted step "
            f"{rp['predicted'] * 1e3:.3f} ms against the current spec's "
            f"{rp['current'] * 1e3:.3f} ms (gain {rp['gain']:.2%}); measured "
            f"step {times[last]:.4f} s before, "
            f"{times[last + 2:]} s after (the first rebuilt step is warm-up)")
    else:
        log(f"[{tag}] every decision kept the plan; step seconds {times}")
    del out
    if not all(math.isfinite(x) for x in hist):
        fail(f"non-finite loss on the {tag} path: {hist}")
    log(f"[{tag}] losses {hist}")
    return {"log": wd.log, "replans": replans, "losses": hist,
            "times": times}


def run_cli(module, args, tag="cli_tune") -> list[str]:
    """``python -m module args`` from the repository root; its last output
    lines logged, a non-zero exit a failure. Returns its output lines."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", module, *args]
    log(f"[{tag}] {' '.join(cmd[1:])}")
    t0 = time.time()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    for line in lines[-3:]:
        log(f"[{tag}] {line}")
    if r.returncode != 0:
        log(r.stderr[-4000:])
        fail(f"{module} exited {r.returncode}")
    log(f"[{tag}] ran in {time.time() - t0:.1f} s")
    return lines


def cli_tune_phase(device_args=()):
    """The smoke spec through the CLIs: ``train --trace --json`` on the
    card, two more ``--json`` captures at other bucket counts and widths
    (so the Eq. 1 fit is identifiable: rounds and bytes must both vary),
    ``repro_torch.launch.tune --calibrate`` on the three trace@2 files, then
    ``train --auto-tune PLAN`` and ``train`` with ``plan.train_argv()``:
    their loss histories (the trace@2 records' losses) bit-equal."""
    import shutil

    from repro_torch.obs import trace as obtrace
    from repro_torch.tune import TunePlan
    base = os.path.join(ROOT, "build", "cli_tune")
    if os.path.isdir(base):
        shutil.rmtree(base)
    os.makedirs(base)
    path = lambda name: os.path.join(base, name)  # noqa: E731
    spec = os.path.join("examples", "specs", "qwen3_smoke.json")
    train = "repro_torch.launch.train"
    common = ["--spec", spec, "--steps", "3", *device_args]
    run_cli(train, [*common, "--trace", path("trace.json"),
                    "--json", path("steps_b2.json")])
    run_cli(train, [*common, "--buckets", "1", "--json", path("steps_b1.json")])
    run_cli(train, [*common, "--buckets", "1", "--width", "1024",
                    "--json", path("steps_b1_w1024.json")])
    run_cli("repro_torch.launch.tune",
            ["--spec", spec, "--calibrate", path("steps_b2.json"),
             path("steps_b1.json"), path("steps_b1_w1024.json"),
             "--out", path("plan.json"), *device_args])
    plan = TunePlan.load(path("plan.json"))
    run_cli(train, [*common, "--auto-tune", path("plan.json"),
                    "--json", path("auto.json")])
    run_cli(train, [*common, *plan.train_argv(), "--json",
                    path("manual.json")])
    doc = obtrace.load(path("trace.json"))
    n = obtrace.validate(doc)
    totals = obtrace.phase_totals(doc)
    if len(obtrace.spans(doc, cat="probe")) != 1 or any(
            not totals.get(ph, 0) > 0 for ph in TRACED_PHASES):
        fail(f"cli_tune: the CLI's trace lacks its probe or a phase: "
             f"{totals}")
    with open(path("steps_b2.json")) as f:
        t2 = json.load(f)
    if "error" in t2["predicted"] or "recovery_error_probe" not in \
            t2["metrics"]["gauges"]:
        fail(f"cli_tune: the CLI's trace@2 document is incomplete: "
             f"{t2['predicted']} {t2['metrics']['gauges']}")
    losses = {}
    for name in ("auto", "manual"):
        with open(path(f"{name}.json")) as f:
            losses[name] = [r["loss"] for r in json.load(f)["records"]]
    log(f"[cli_tune] trace {n} spans valid, probe phases (ms) "
        + json.dumps({k: round(v * 1e3, 3) for k, v in totals.items()}))
    log(f"[cli_tune] plan {plan.summary()}; calibrated alpha "
        f"{plan.spec.cluster.link_alpha!r} beta {plan.spec.cluster.link_beta!r}"
        f" t_compute {plan.spec.cluster.compute_mean!r}; train flags "
        f"{' '.join(plan.train_argv())}")
    log(f"[cli_tune] losses --auto-tune {losses['auto']} / manual flags "
        f"{losses['manual']}")
    if losses["auto"] != losses["manual"] or not losses["auto"]:
        fail("cli_tune: --auto-tune and the plan's manual flags differ")
    return {"plan": plan.choice.label(), "losses": losses["auto"]}


# ---------------------------------------------------------------------------
# Serving: serve, serve_families, serve_parity, serve_load, cli_serve
# ---------------------------------------------------------------------------

SERVE_SLOTS, SERVE_BLOCK, SERVE_MAX_LEN = 8, 16, 256
# (tag, arch, layers (None: all), requests, prompt lengths lo-hi, gen)
SERVE_CELLS = (
    ("serve", "qwen3-4b", None, 12, 16, 192, 64),
    ("serve_zamba2", "zamba2-2.7b", 12, 10, 16, 192, 32),
    ("serve_rwkv6", "rwkv6-7b", 8, 10, 16, 192, 32),
    ("serve_granite", "granite-moe-3b-a800m", 4, 10, 16, 192, 32),
)
SERVE_REPLICA_REQUESTS, SERVE_REPLICA_GEN = 6, 16
SERVE_TIE_ATOL = 1e-3  # a greedy token may differ between two computations
#                        of the same logits (prefill against decode; the
#                        card against the CPU) only where the top two
#                        logits are within this: f32 sums in another order
#                        move logits near 1 by ~1e-6
SERVE_PARITY_ATOL = 1e-4  # smoke logits card vs CPU (f32, TF32 off)


def serve_spec(arch, slots, block, max_len, prompt_hi, gen):
    from repro_torch.api import RunSpec, ServeSpec
    spec = RunSpec(arch=arch, serve=ServeSpec(
        batch=slots, block_size=block, max_len=max_len,
        prompt_len=prompt_hi, gen=gen))
    spec.validate()
    return spec


def serve_requests(vocab, n, lo, hi, gen, seed=7):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(i, tuple(int(x) for x in rng.integers(
        1, vocab, int(rng.integers(lo, hi + 1)))), gen) for i in range(n)]


def top2_margin(torch, logits):
    v = torch.topk(logits.float(), 2, dim=-1).values
    return (v[..., 0] - v[..., 1]).cpu()


def check_near_ties(tag, what, got, want, margin):
    """Greedy ids equal, or differing only where the reference logits'
    top-2 margin is within SERVE_TIE_ATOL. Returns the near-tie count."""
    diff = (got.cpu() != want.cpu()).nonzero().flatten().tolist()
    bad = [i for i in diff if float(margin[i]) > SERVE_TIE_ATOL]
    if bad:
        fail(f"{tag}: {what} differ at rows {bad} (top-2 margins "
             f"{[float(margin[i]) for i in bad]})")
    return len(diff)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_cell(torch, device, cfg, tag, n_req, lo, hi, gen, *,
               slots=SERVE_SLOTS, block=SERVE_BLOCK, max_len=SERVE_MAX_LEN,
               profile=False, replicas=False) -> dict:
    """One architecture through the serving engine on ``device``; see the
    module docstring (phase 11). Returns the measured numbers."""
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.flatten import init_flat_params, make_flat_spec
    from repro_torch.serve import ReplicaSet, Request, ServeEngine
    from repro_torch.serve.loadtest import _latency_report
    from repro_torch.serve.scheduler import serve_fns
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_phase = time.time()
    fs = make_flat_spec(cfg, 1)
    segs = init_flat_params(cfg, torch.Generator(device=device).manual_seed(
        0), 1, fs, device=device)
    n_params = fs.total
    spec = serve_spec(cfg.name, slots, block, max_len, hi, gen)
    reqs = serve_requests(cfg.vocab_size, n_req, lo, hi, gen)
    fns = serve_fns(cfg, fs)

    def engine(paged=True, subset=None):
        sp = dataclasses.replace(spec, serve=dataclasses.replace(
            spec.serve, paged=paged))
        eng = ServeEngine(cfg, fs, segs, sp, fns=fns)
        for rid, prompt, max_new in (reqs if subset is None else subset):
            eng.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        return eng

    def timed(eng):
        _sync(torch, device)
        t0 = time.perf_counter()
        comps = eng.run()
        _sync(torch, device)
        return comps, time.perf_counter() - t0

    cold_eng = engine()
    cold, t_cold = timed(cold_eng)
    steady_eng = engine()
    steady, t_steady = timed(steady_eng)
    toks = {c.rid: c.tokens for c in steady}
    if {c.rid: c.tokens for c in cold} != toks:
        fail(f"{tag}: the cold and steady runs emitted different tokens")
    if any(c.finish != "length" or len(c.tokens) != gen for c in steady):
        fail(f"{tag}: a request did not run to its length: "
             f"{[(c.rid, c.finish, len(c.tokens)) for c in steady]}")
    n_tok = sum(len(t) for t in toks.values())
    rep = _latency_report(steady_eng, steady)
    first: dict = {}
    for rid, _tok, _tv, tw in steady_eng.emissions:
        first.setdefault(rid, tw)
    ttft = sorted(first.values())
    q = lambda v, p: v[min(len(v) - 1, int(math.ceil(p * len(v))) - 1)]  # noqa: E731
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "requests": n_req, "tokens": n_tok,
           "decode_steps": steady_eng.n_steps,
           "tok_per_s_steady": n_tok / t_steady,
           "tok_per_s_cold": n_tok / t_cold,
           "steady_s": t_steady, "cold_s": t_cold,
           "ttft_wall_s": {p: q(ttft, v) for p, v in
                           (("p50", .5), ("p95", .95), ("p99", .99))},
           "per_token_wall_s": {k: rep["per_token_wall"][k]
                                for k in ("p50", "p95", "p99")},
           "num_blocks": steady_eng.cache.num_blocks}
    del cold_eng, steady_eng
    log(f"[{tag}] {cfg.name} {cfg.n_layers} layers, {n_params:,} params: "
        f"{n_tok} tokens, steady {out['tok_per_s_steady']:.1f} tok/s "
        f"({t_steady:.3f} s), cold {out['tok_per_s_cold']:.1f} tok/s "
        f"({t_cold:.3f} s); TTFT wall {out['ttft_wall_s']}; per-token wall "
        f"{out['per_token_wall_s']}; {out['decode_steps']} decode steps")

    # the paged cache in lockstep with the contiguous one
    ep, ec = engine(True), engine(False)
    steps = checked = 0
    while ep.pending() or ec.pending():
        if ep.step() != ec.step():
            fail(f"{tag}: paged and contiguous emissions differ at step "
                 f"{steps}")
        steps += 1
        kvp, stp = M.split_cache(ep.cache.gather())
        kvc, stc = M.split_cache(ec.cache.gather())
        for i, sl in enumerate(ep.slots):
            if sl is None:
                continue
            for (path, a), (_, b) in zip(tree_leaves(kvp), tree_leaves(kvc)):
                if not torch.equal(a[:, :, i, :sl.pos], b[:, :, i, :sl.pos]):
                    fail(f"{tag}: paged KV {path} of slot {i} differs from "
                         f"the contiguous cache at step {steps}")
                checked += 1
        for (path, a), (_, b) in zip(tree_leaves(stp), tree_leaves(stc)):
            if not torch.equal(a, b):
                fail(f"{tag}: recurrent state {path} differs at step {steps}")
        del kvp, stp, kvc, stc
    if {c.rid: c.tokens for c in ep.run()} != toks or \
            {c.rid: c.tokens for c in ec.run()} != toks:
        fail(f"{tag}: the lockstep runs' tokens differ from the steady run")
    del ep, ec
    log(f"[{tag}] paged == contiguous: {steps} lockstep steps, the same "
        f"emissions, {checked} (slot, KV leaf) valid regions bit-equal")

    # continuous batching against one request at a time
    for rid, prompt, max_new in reqs:
        solo = engine(subset=[(rid, prompt, max_new)])
        [c] = solo.run()
        if c.tokens != toks[rid]:
            fail(f"{tag}: request {rid} alone emitted other tokens than in "
                 "the continuous batch")
    log(f"[{tag}] continuous batching == sequential for all {n_req} "
        "requests")

    # prefill/decode consistency (tests/test_models_smoke.py's check). An
    # MoE prefill drops (token, choice) pairs past the expert capacity, so
    # a prefill over S tokens and a decode of the S-th differ by design
    # where a drop hits; its rows run one at a time with S = 8 <= the
    # capacity floor of 8 (a token picks an expert at most once), so no
    # pair can be dropped
    moe = bool(cfg.n_experts)
    B, S, T = 4, (8 if moe else 12), 32
    rs = np.random.RandomState(11)
    tk = torch.from_numpy(rs.randint(1, cfg.vocab_size, (B, S))).to(device)
    ties = 0
    for rows in ([slice(i, i + 1) for i in range(B)] if moe
                 else [slice(0, B)]):
        t, b = tk[rows], tk[rows].shape[0]
        lg, _ = M.prefill_fn(cfg, fs, segs, {"tokens": t},
                             M.init_cache(cfg, b, T, torch.float32, device))
        _, cache = M.prefill_fn(cfg, fs, segs, {"tokens": t[:, :S - 1]},
                                M.init_cache(cfg, b, T, torch.float32,
                                             device))
        got, cache = M.decode_fn(cfg, fs, segs, t[:, S - 1:], S - 1, cache)
        ties += check_near_ties(tag, "prefill and decode tokens", got,
                                torch.argmax(lg, -1), top2_margin(torch, lg))
        got2, _ = M.decode_fn(cfg, fs, segs, got[:, None].long(), S, cache)
        if got2.shape != (b,) or not torch.isfinite(lg).all():
            fail(f"{tag}: decode after the consistency step failed")
        del cache
    log(f"[{tag}] prefill/decode consistency on {B} rows of {S} tokens"
        f"{' (one row a prefill)' if moe else ''}: equal ({ties} near-ties "
        f"within {SERVE_TIE_ATOL})")

    if profile:
        eng = engine(subset=reqs[:slots])
        eng.step()
        eng.step()
        if eng.active() != slots:
            fail(f"{tag}: {eng.active()} of {slots} slots active")
        _, out["profile"] = profile_call(torch, f"profile_{tag}", eng.step)
        del eng

    if replicas:
        rgen = min(SERVE_REPLICA_GEN, gen)
        sub = [(rid, prompt, rgen) for rid, prompt, _ in
               reqs[:SERVE_REPLICA_REQUESTS]]
        one = ReplicaSet([engine(subset=[])])
        two = ReplicaSet([engine(subset=[]) for _ in range(2)],
                         heartbeat_timeout=1.5)
        for rset in (one, two):
            for rid, prompt, max_new in sub:
                rset.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        for _ in range(3):
            two.step_round()
        two.kill(1)
        want = {c.rid: c.tokens for c in one.run()}
        got_c = two.run()
        if {c.rid: c.tokens for c in got_c} != want:
            fail(f"{tag}: the failed-over replica set emitted other tokens")
        if any(want[rid] != toks[rid][:rgen] for rid in want):
            fail(f"{tag}: the replicas' tokens are not the steady run's "
                 "prefix")
        if two.plan.generation != 1 or 1 in two.live() or \
                not any(c.replays for c in got_c):
            fail(f"{tag}: no failover happened ({two.plan}, replays "
                 f"{[c.replays for c in got_c]})")
        log(f"[serve_replica] 2 replicas, replica 1 killed after 3 rounds: "
            f"{len(got_c)} requests replayed identically (replays "
            f"{[c.replays for c in got_c]}, generation "
            f"{two.plan.generation})")
        del one, two

    if on_card:
        _sync(torch, device)
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        out["card"] = card_line()
        log(f"[{tag}] peak memory {out['peak_bytes'] / 2 ** 30:.2f} GiB on "
            f"{out['card']}")
    del segs
    out["phase_s"] = time.time() - t_phase
    return out


def serve_phases(torch, device) -> dict:
    """Phases 11 and 11b: every SERVE_CELLS row at its published widths.
    Returns the launch counts of the whole run (which must be 0) and each
    cell's numbers."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.dispatch import LAUNCHES
    cells = {}
    _sync(torch, device)
    LAUNCHES.clear()
    for tag, arch, layers, n_req, lo, hi, gen in SERVE_CELLS:
        cfg = ARCHS[arch]
        if layers is not None and layers != cfg.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        first = tag == "serve"
        cells[tag] = serve_cell(torch, device, cfg, tag, n_req, lo, hi, gen,
                                profile=first, replicas=first)
        log(f"[{tag}] phase took {cells[tag]['phase_s']:.1f} s")
    _sync(torch, device)
    counts = dict(LAUNCHES)
    if any(counts.values()):
        fail(f"the serve path launched sketch kernels: {counts}")
    log(f"[serve] launches on the serve path: {counts} (none)")
    log("[serve] cells " + json.dumps(cells))
    return counts


def serve_parity_phase(torch, card="cuda") -> dict:
    """Phase 11c. Returns the card's launch counts (which must be 0)."""
    import numpy as np
    from repro_torch.configs import SMOKES
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_map
    from repro_torch.models.flatten import init_flat_params, make_flat_spec
    from repro_torch.models.layers import lm_logits
    from repro_torch.serve import Request, ServeEngine
    card = torch.device(card)
    cpu = torch.device("cpu")

    def decode_logits(cfg, fs, segs, tok, kl, cache, ck):
        """decode_fn's logits (its ids are their argmax) on a copy of the
        cache: the recurrent state advances in place."""
        cache = tree_map(lambda a: a.clone(), cache)
        B, S = tok.shape
        kl = torch.as_tensor(kl, device=tok.device)
        pos = (kl[:, None] if kl.ndim else kl).expand(B, S)
        with torch.no_grad():
            hid, _, top = M._backbone(cfg, fs, segs, tok, pos, torch.float32,
                                      ck, "decode", cache, kl)
            return lm_logits(hid, M._head_w(cfg, top), cfg)[:, 0]

    _sync(torch, card)
    LAUNCHES.clear()
    worst, ties, engines = 0.0, 0, 0
    for arch, cfg in SMOKES.items():
        fs = make_flat_spec(cfg, 1)
        segs = init_flat_params(cfg, torch.Generator().manual_seed(0), 1, fs)
        rs = np.random.RandomState(3)
        B, S, T = 2, 7, 16
        tokens = torch.from_numpy(rs.randint(1, cfg.vocab_size, (B, S)))
        ck = (torch.from_numpy(rs.randn(B, cfg.n_cross_tokens, cfg.d_model)
                               .astype(np.float32))
              if cfg.family == "vlm" else None)
        res = {}
        for key, dev in (("cpu", cpu), ("card", card)):
            sg = {k: v.to(dev) for k, v in segs.items()}
            ckd = None if ck is None else ck.to(dev)
            batch = {"tokens": tokens.to(dev)}
            if ckd is not None:
                batch["cross_kv"] = ckd
            lg, cache = M.prefill_fn(cfg, fs, sg, batch, M.init_cache(
                cfg, B, T, torch.float32, dev))
            res[key] = {"prefill": lg.cpu(), "steps": []}
            tok = torch.argmax(res["cpu"]["prefill"], -1)[:, None]
            for step, kl in enumerate((S, torch.tensor([S + 1, S + 1]))):
                if step:
                    tok = res["cpu"]["steps"][0][0][:, None].long()
                kld = kl.to(dev) if torch.is_tensor(kl) else kl
                dl = decode_logits(cfg, fs, sg, tok.to(dev), kld, cache, ckd)
                ids, cache = M.decode_fn(cfg, fs, sg, tok.to(dev), kld,
                                         cache, cross_kv=ckd)
                if not torch.equal(ids.long(), torch.argmax(dl, -1)):
                    fail(f"serve_parity {arch}: decode_fn's ids are not the "
                         f"argmax of its logits on {dev.type}")
                res[key]["steps"].append((ids.cpu(), dl.cpu()))
        err = float((res["cpu"]["prefill"] - res["card"]["prefill"]).abs()
                    .max())
        worst = max(worst, err)
        if err > SERVE_PARITY_ATOL:
            fail(f"serve_parity {arch}: prefill logits differ by {err}")
        for (ic, lc), (ig, _) in zip(res["cpu"]["steps"],
                                     res["card"]["steps"]):
            ties += check_near_ties(f"serve_parity {arch}", "decode ids",
                                    ig, ic, top2_margin(torch, lc))
        if cfg.family != "vlm":
            spec = serve_spec(arch, 3, 4, 16, 8, 4)
            spec = dataclasses.replace(spec, smoke=True)
            reqs = serve_requests(cfg.vocab_size, 6, 1, 7, 4, seed=1)
            comps = []
            for dev in (cpu, card):
                eng = ServeEngine(cfg, fs, {k: v.to(dev) for k, v in
                                            segs.items()}, spec)
                for rid, prompt, max_new in reqs:
                    eng.submit(Request(rid=rid, prompt=prompt,
                                       max_new=max_new))
                comps.append([dataclasses.asdict(c) for c in eng.run()])
            if comps[0] != comps[1]:
                fail(f"serve_parity {arch}: the card's engine completions "
                     "differ from the CPU's")
            engines += 1
    _sync(torch, card)
    counts = dict(LAUNCHES)
    if any(counts.values()):
        fail(f"serve_parity launched sketch kernels: {counts}")
    log(f"[serve_parity] {len(SMOKES)} smoke configs: prefill logits within "
        f"{worst:.3g} (atol {SERVE_PARITY_ATOL}), two decode steps' ids "
        f"equal ({ties} near-ties within {SERVE_TIE_ATOL}); {engines} "
        "engines' completions equal, card against CPU")
    return counts


def cli_serve_phase(device_args=()):
    """Phase 11d: the load-test audit and the serve CLI on the card
    (``device_args`` ("--device", "cpu") rehearses it on the CPU)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        bench = os.path.join(tmp, "BENCH_serve.json")
        run_cli("repro_torch.bench.serve_load",
                ["--out", bench, *device_args], tag="serve_load")
        with open(bench) as f:
            doc = json.load(f)
        if not all(doc["checks"].values()) or \
                doc["provenance"]["backend"] != (device_args[-1]
                                                 if device_args else "cuda"):
            fail(f"serve_load: checks {doc['checks']}, backend "
                 f"{doc['provenance']['backend']}")
        w = doc["wall"]
        log(f"[serve_load] checks {doc['checks']}; wall steady "
            f"{w['tok_per_s_steady']:.1f} tok/s, cold "
            f"{w['tok_per_s_cold']:.1f} tok/s")
        lines = run_cli("repro_torch.launch.serve",
                        ["--smoke", *device_args], tag="cli_serve")
        if not any("steady" in ln and "cold" in ln for ln in lines):
            fail("the serve demo printed no steady/cold tok/s line")
        path = os.path.join(tmp, "serve.json")
        run_cli("repro_torch.launch.serve",
                ["--smoke", "--load-test", "--json", path, *device_args],
                tag="cli_serve")
        with open(path) as f:
            rep = json.load(f)
        if not (rep["tokens_match_static"]
                and rep["continuous"]["dropped"] == 0
                and rep["speedup_vs_static"] > 1.0
                and rep["provenance"]["backend"] == doc["provenance"][
                    "backend"]):
            fail("the serve CLI's load test failed its checks: tokens "
                 f"match {rep['tokens_match_static']}, speedup "
                 f"{rep['speedup_vs_static']}")
        log(f"[cli_serve] load test: speedup vs static "
            f"{rep['speedup_vs_static']:.3f}, tokens match static")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.time()
    log(f"[card] {card_line()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    build_phase(torch)
    cfg, opt, ts = full_width_step(torch, device)
    t0 = time.time()
    kernels = kernels_phase(torch, device, ts)
    torch.cuda.empty_cache()
    log(f"[kernels] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    run = train_phase(torch, cfg, opt, ts)
    state, stream, counts = run["state"], run["stream"], run["counts"]
    train_peak = run["peak"]
    del run
    check_launches("train", counts, ("sketch_encode", "sketch_encode_finish",
                                     "sketch_decode", "topk_select"),
                   ("heavymix_scores", "heavymix_scores_ts", "ts_transpose",
                    "ts_encode"))
    recoveries = TRAIN_P * ts.n_buckets * TRAIN_STEPS
    for name in ("topk_select", "sketch_encode", "sketch_encode_finish"):
        if counts[name] != recoveries:
            fail(f"{name} launched {counts[name]} times on the train path, "
                 f"not once per recovery ({recoveries})")
    log(f"[train] topk_select launches {counts['topk_select']} = "
        f"{TRAIN_P} workers x {ts.n_buckets} buckets x {TRAIN_STEPS} steps")
    log(f"[train] phase took {time.time() - t0:.1f} s")
    state, profiled = profile_phase(torch, ts, state, stream)
    del state
    torch.cuda.empty_cache()
    t0 = time.time()
    traced = train_traced_phase(torch, ts, opt, main_exchange(),
                                profiled=profiled, train_peak=train_peak)
    log(f"[train_traced] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    train_watched_phase(
        torch, ts, opt, main_exchange(),
        lambda ex: full_width_step(torch, device, exchange=ex)[2])
    log(f"[train_watched] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    ts_step = full_width_ts_step(torch, device, ts, opt)
    run = train_phase(torch, cfg, opt, ts_step, tag="train_ts")
    state, stream, ts_counts = run["state"], run["stream"], run["counts"]
    del run
    check_launches("train_ts", ts_counts, ("ts_encode", "ts_transpose",
                                           "heavymix_scores_ts",
                                           "topk_select"),
                   ("sketch_encode", "sketch_encode_finish", "sketch_decode",
                    "heavymix_scores"))
    if ts_counts["topk_select"] != recoveries:
        fail(f"topk_select launched {ts_counts['topk_select']} times on the "
             f"train_ts path, not once per recovery ({recoveries})")
    log(f"[train_ts] topk_select launches {ts_counts['topk_select']} = "
        f"{TRAIN_P} workers x {ts_step.n_buckets} buckets x {TRAIN_STEPS} "
        "steps")
    log(f"[train_ts] phase took {time.time() - t0:.1f} s")
    state, _ = profile_phase(torch, ts_step, state, stream,
                             tag="profile_ts")
    del state, ts_step, ts
    torch.cuda.empty_cache()
    t0 = time.time()
    inter = train_interleave_phase(torch, device)
    log(f"[train_interleave] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    mini = train_minicpm_phase(torch, device)
    log(f"[train_minicpm] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    moe_run = train_moe_phase(torch, device)
    log(f"[train_moe] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    hybrid = train_hybrid_phase(torch, device)
    log(f"[train_hybrid] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    elastic = train_elastic_phase(torch, device)
    log(f"[train_elastic] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    parity_counts = parity_phase(torch)
    parity_configs_phase(torch)
    log(f"[parity] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    parity_elastic = parity_elastic_phase(torch)
    log(f"[parity_elastic] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    families = parity_families_phase(torch)
    log(f"[parity_families] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    cnn = train_cnn_phase(torch, device)
    log(f"[train_cnn] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    paper_table2_phase(torch, device)
    log(f"[paper_table2] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    paper_figs_phase(torch, device)
    log(f"[paper_figs] phase took {time.time() - t0:.1f} s")
    kernels.append(inter["finish_row"])
    launches = {"sketch_encode": counts, "sketch_decode": counts,
                "topk_select": counts, "ts_encode": ts_counts,
                "heavymix_scores_ts": ts_counts, "ts_transpose": ts_counts,
                "heavymix_scores": mini["counts"],
                "sketch_encode_finish": counts}
    for kr in kernels:
        kr["launches"] = launches[kr["name"]].get(kr["name"], 0)
        kr["launches_interleave"] = inter["counts"].get(kr["name"], 0)
        kr["launches_minicpm"] = mini["counts"].get(kr["name"], 0)
        kr["launches_parity"] = parity_counts.get(kr["name"], 0)
        kr["launches_traced"] = traced["counts"].get(kr["name"], 0)
        kr["launches_moe"] = moe_run["counts"].get(kr["name"], 0)
        kr["launches_hybrid"] = hybrid["counts"].get(kr["name"], 0)
        kr["launches_hybrid_interleave"] = hybrid["interleave_counts"].get(
            kr["name"], 0)
        kr["launches_parity_families"] = families.get(kr["name"], 0)
        kr["launches_elastic"] = elastic["counts"].get(kr["name"], 0)
        kr["launches_parity_elastic"] = parity_elastic.get(kr["name"], 0)
        for model, run in cnn.items():
            kr[f"launches_cnn_{model}"] = run["counts"].get(kr["name"], 0)
            kr.setdefault("cnn_shapes", []).extend(
                run["shapes"].get(kr["name"], []))
        if kr["name"] == "sketch_encode":
            kr["interleave_fragments"] = inter["fragments"]
        if kr["name"] == "heavymix_scores":  # the main path's shapes first
            old = {k: kr[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")}
            old["shape"] = "bucket 0's d of train, greedy (parity's variant)"
            kr["shapes"] = mini["filler_shapes"] + [old]
            kr.update({k: mini["filler_shapes"][0][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
    t0 = time.time()
    baselines_phase(torch)
    log(f"[baselines] phase took {time.time() - t0:.1f} s")
    cli_phase()
    cli_phase(("--buckets", "4", "--bwd-chunks", "2", "--fuse-encode"))
    cli_resume_phase()
    t0 = time.time()
    cli_tune_phase()
    log(f"[cli_tune] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    cli_simulate_phase()
    log(f"[cli_simulate] phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    serve_counts = serve_phases(torch, device)
    t0 = time.time()
    for k, v in serve_parity_phase(torch).items():
        serve_counts[k] = serve_counts.get(k, 0) + v
    log(f"[serve_parity] phase took {time.time() - t0:.1f} s")
    t0 = time.time()
    cli_serve_phase()
    log(f"[serve_load, cli_serve] phases took {time.time() - t0:.1f} s")
    for kr in kernels:
        kr["launches_serve"] = serve_counts.get(kr["name"], 0)
    log(f"[done] in {time.time() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
