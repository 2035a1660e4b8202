#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build    — compile every kernel of the main path from
               ``src/repro_torch/csrc`` with ``nvcc`` (one process per
               source, all started together) and load them.
2. kernels  — call each kernel's wrapper on the card at the shapes the main
               path gives it (bucket 0 of the full-width step below) plus
               small odd cases, hold it against its plain PyTorch version,
               and time kernel, plain version, library yardstick and bound.
3. train    — the main path: three gs-SGD steps of qwen3-4b at its
               published widths (depth cut to 2 layers), P=2 workers,
               buckets=2, psum, AdamW, SketchSpec(rows=5, width=None,
               k=None). Every launch counter is set to 0 just before and
               read just after; each kernel must have launched.
4. profile  — one more full-width step under ``torch.profiler``: device
               time per span (loss_and_grad / encode / allreduce / recover /
               optimizer) and the device's idle share. Not counted.
5. parity   — two steps of examples/specs/qwen3_smoke.json on the card
               (kernels) and on the CPU (plain versions) from the same
               params and batches: losses and selected coordinates agree.
6. cli      — ``python -m repro_torch.launch.train --spec
               examples/specs/qwen3_smoke.json`` on the card.

The last lines are the card's name and power limit (nvidia-smi), one JSON
object with every kernel's numbers, and ``{"ok": true, "device": ...}``.
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
ENCODE_REL_TOL = 1e-4   # |kernel - plain| / max|S|: f32 atomics add in
#                         another order; n*eps*sum|x|/max|S| stays below it
PARITY_LOSS_RTOL = 1e-3  # card vs CPU: f32 matmuls and sketch sums in
#                          another order, then AdamW (the CPU port matches
#                          the JAX package at 1e-4)


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
    from repro_torch.kernels import build, heavymix_topk, sketch_encode
    names = ("sketch_encode", "heavymix_scores")
    t0 = time.time()
    logs = build.build_all(names)
    sketch_encode._lib()
    heavymix_topk._lib()
    log(f"[build] {len(names)} kernels built and loaded in "
        f"{time.time() - t0:.1f} s (nvcc {build.nvcc_path()})")
    for name, text in logs.items():
        for line in (text or "cached build\n").splitlines():
            if "registers" in line or "spill" in line or line == "cached build":
                log(f"[build] {name}: {line.strip()}")


def full_width_step(torch, device):
    """The main path's train step (no state allocated yet)."""
    from repro_torch.api import ExchangeSpec, SketchSpec
    from repro_torch.configs.qwen3_4b import CONFIG
    from repro_torch.core.gs_sgd import MeshAxes, make_train_step
    from repro_torch.optim import make as make_opt
    cfg = dataclasses.replace(CONFIG, n_layers=2)
    opt = make_opt("adamw", lr=TRAIN_LR)
    spec = ExchangeSpec(compressor="gs-sgd", buckets=2, overlap=True,
                        allreduce_mode="psum",
                        sketch=SketchSpec(rows=5, width=None, k=None))
    ma = MeshAxes(tp=1, data=TRAIN_P, tp_axis=None)
    ts = make_train_step(cfg, ma, opt, spec=spec, dtype=torch.float32,
                         device=device)
    return cfg, opt, ts


def kernels_phase(torch, device, ts) -> list[dict]:
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.heavymix_topk import (heavymix_scores,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.sketch_encode import (sketch_encode,
                                                   sketch_encode_plain)

    # ---- small odd cases: offsets, half inputs, every scores code path --
    gen = torch.Generator(device=device).manual_seed(1)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        cfg = cs.SketchConfig(rows=3, width=300, seed=5)
        g = torch.randn(1537, generator=gen, device=device).to(dt)
        got = sketch_encode(cfg, g, index_offset=4099)
        want = sketch_encode_plain(cfg, g, 4099)
        err = float((got - want).abs().max())
        lim = ENCODE_REL_TOL * float(want.abs().max())
        log(f"[kernels] sketch_encode small d=1537 off=4099 {dt}: "
            f"max_abs_err {err:.3g} (limit {lim:.3g})")
        if not err <= lim:
            fail(f"sketch_encode small {dt} disagrees: {err} > {lim}")
    for rows, d in ((4, 3000), (5, 3001), (29, 5000)):
        cfg = cs.SketchConfig(rows=rows, width=512, seed=rows)
        g = torch.randn(d, generator=gen, device=device)
        sk = sketch_encode_plain(cfg, g)
        thr = cs.l2sq_estimate(sk) / 40
        sc, est = heavymix_scores(cfg, sk, thr, d)
        sc_p, est_p = heavymix_scores_plain(cfg, sk, thr, d)
        if not (torch.equal(est, est_p) and torch.equal(sc, sc_p)):
            fail(f"heavymix_scores small R={rows} disagrees: max err "
                 f"{float((est - est_p).abs().max())}")
        log(f"[kernels] heavymix_scores small R={rows} d={d}: est and "
            f"scores bit-equal")

    # ---- main-path shapes: bucket 0 of the full-width step --------------
    part = ts.compressor.parts[0]
    d, cfg, k = ts.compressor.spec.sizes[0], part.sketch, part.k
    R, W = cfg.rows, cfg.width
    log(f"[kernels] main-path shapes: d={d} R={R} W={W} k={k}")
    g = torch.randn(d, generator=gen, device=device).mul_(1e-3)
    spikes = torch.randint(0, d, (k // 4,), generator=gen, device=device)
    g[spikes] = torch.randn(spikes.numel(), generator=gen, device=device)

    sk = sketch_encode(cfg, g)
    sk_p = sketch_encode_plain(cfg, g)
    enc_err = float((sk - sk_p).abs().max())
    enc_lim = ENCODE_REL_TOL * float(sk_p.abs().max())
    log(f"[kernels] sketch_encode d={d}: max_abs_err {enc_err:.4g} "
        f"(limit {enc_lim:.4g} = {ENCODE_REL_TOL} * max|S|)")
    if not enc_err <= enc_lim:
        fail(f"sketch_encode disagrees with its plain version: {enc_err}")
    enc_ms = time_ms(torch, lambda: sketch_encode(cfg, g), reps=10)
    enc_plain_ms = time_ms(torch, lambda: sketch_encode_plain(cfg, g), reps=2)
    del sk_p

    # library yardstick: one index_add_ over the flattened (R*W) table with
    # the bucket ids and signed values precomputed (hashing not timed)
    flat_idx = torch.empty((R, d), dtype=torch.int64, device=device)
    flat_val = torch.empty((R, d), dtype=torch.float32, device=device)
    rows_off = (torch.arange(R, device=device) * W)[:, None]
    step = 1 << 24
    for lo in range(0, d, step):
        hi = min(d, lo + step)
        b, s = cs.hash_buckets(cfg, torch.arange(lo, hi, device=device))
        flat_idx[:, lo:hi] = b + rows_off
        flat_val[:, lo:hi] = s * g[lo:hi]
    flat_idx, flat_val = flat_idx.reshape(-1), flat_val.reshape(-1)
    lib_out = torch.zeros(R * W, dtype=torch.float32, device=device)

    def lib_call():
        lib_out.zero_()
        lib_out.index_add_(0, flat_idx, flat_val)

    enc_lib_ms = time_ms(torch, lib_call, reps=3)
    lib_err = float((lib_out.view(R, W) - sk).abs().max())
    log(f"[kernels] index_add_ yardstick vs kernel: max_abs_err "
        f"{lib_err:.4g}")
    del flat_idx, flat_val, lib_out
    torch.cuda.empty_cache()
    enc_bound, enc_by = bound_ms(d * g.element_size() + R * W * 4,
                                 d * R * 7.0)

    thr = cs.l2sq_estimate(sk) / k
    sc, est = heavymix_scores(cfg, sk, thr, d)
    sc_p, est_p = heavymix_scores_plain(cfg, sk, thr, d)
    hm_err = float((est - est_p).abs().max())
    if not torch.equal(est, est_p):
        fail(f"heavymix_scores est not bit-equal: max err {hm_err}")
    if not torch.equal(sc, sc_p):
        fail("heavymix_scores scores not bit-equal")
    n_heavy = int((sc >= 1e30).sum())
    del sc_p, est_p
    # the main path's selection (ops.heavymix_recover, through the kernel)
    # against the port's plain HEAVYMIX, which takes the reference's
    # chunked route at this d
    idx = ops.heavymix_recover(cfg, sk, k, d)[0]
    idx_p = ref.heavymix_recover(cfg, sk, k, d)[0]
    if not torch.equal(idx, idx_p):
        fail("heavymix_recover selects other coordinates than the plain "
             f"HEAVYMIX: {int((idx != idx_p).sum())} of k={k} differ")
    log(f"[kernels] heavymix_scores d={d}: est and scores bit-equal; "
        f"recovered idx equal to the plain HEAVYMIX ({n_heavy} heavy of "
        f"k={k})")
    del idx, idx_p
    hm_ms = time_ms(torch, lambda: heavymix_scores(cfg, sk, thr, d), reps=10)
    hm_plain_ms = time_ms(
        torch, lambda: heavymix_scores_plain(cfg, sk, thr, d), reps=2)
    hm_bound, hm_by = bound_ms(R * W * 4 + 4 + 2 * d * 4,
                               d * (R * 6.0 + R * (R - 1) + 4))
    topk_ms = time_ms(torch, lambda: topk_lower_index(est.abs(), k), reps=3)
    log(f"[kernels] top-k of |est| with lower-index ties (outside the "
        f"kernel) at d={d}, k={k}: {topk_ms:.3f} ms")
    out = [
        {"name": "sketch_encode", "route": "cuda",
         "source": "src/repro_torch/csrc/sketch_encode.cu",
         "replaces": "src/repro/kernels/sketch_encode.py:87",
         "launches": None, "max_abs_err": enc_err, "ms": enc_ms,
         "plain_ms": enc_plain_ms, "bound_ms": enc_bound,
         "bound_by": enc_by, "library_ms": enc_lib_ms},
        {"name": "heavymix_scores", "route": "cuda",
         "source": "src/repro_torch/csrc/heavymix_scores.cu",
         "replaces": "src/repro/kernels/heavymix_topk.py:91",
         "launches": None, "max_abs_err": hm_err, "ms": hm_ms,
         "plain_ms": hm_plain_ms, "bound_ms": hm_bound,
         "bound_by": hm_by, "library_ms": None},
    ]
    for kr in out:
        log("[kernels] " + json.dumps({key: kr[key] for key in (
            "name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")}))
    return out


def train_phase(torch, cfg, opt, ts):
    from repro_torch.data import LMStream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import train_loop
    state = ts.init_state(opt, torch.Generator(device=ts.device)
                          .manual_seed(0))
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    sizes = ts.compressor.spec.sizes
    log(f"[train] qwen3-4b widths, {cfg.n_layers} layers: d={ts.d_local} "
        f"buckets {list(sizes)} "
        f"(k, W) {[(c.k, c.sketch.width) for c in ts.compressor.parts]} "
        f"P={ts.nworkers} batch {TRAIN_BATCH} seq {TRAIN_SEQ}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    state, hist, times = train_loop(
        ts, state, lambda s: stream.global_batch_at(s, ts.device),
        range(TRAIN_STEPS), log_every=1, last=TRAIN_STEPS - 1)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for s, (loss, t) in enumerate(zip(hist, times)):
        log(f"[train] step {s}: loss {loss:.6f}  step_s {t:.4f}")
    log(f"[train] max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB); launches {counts}")
    if not all(math.isfinite(x) for x in hist):
        fail(f"non-finite loss: {hist}")
    for name in ("sketch_encode", "heavymix_scores"):
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the main path")
    return state, stream, counts, times


def profile_phase(torch, ts, state, stream):
    """One more step under torch.profiler: device time per span."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import shard_batch
    batch = shard_batch(stream.global_batch_at(TRAIN_STEPS, ts.device),
                        ts.nworkers)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        state, m = ts.fn(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    # Kernels launched through ctypes are not linked to the span that was
    # open when they launched, so each hand kernel is added to its phase by
    # name (sketch_encode runs only in encode spans, the scores kernel only
    # in recover spans).
    own = {"encode_kernel": "encode", "scores_": "recover"}
    phase = {p: 0.0 for p in ("loss_and_grad", "encode", "allreduce",
                              "recover", "exchange", "optimizer")}
    busy_us = 0.0
    by_kernel: dict[str, float] = {}
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    for e in prof.events():
        if e.device_type == cuda:
            if e.is_user_annotation:   # a span's range on the GPU timeline
                continue
            us = e.time_range.elapsed_us()
            busy_us += us
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + us
            for key, p in own.items():
                if key in e.name:
                    phase[p] += us
        elif e.device_type == cpu and e.name.split("/")[0] in phase:
            phase[e.name.split("/")[0]] += e.device_time_total
    wall_ms, busy_ms = wall * 1e3, busy_us / 1e3
    out = {"step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "span_device_ms": {p: us / 1e3 for p, us in phase.items()},
           "outside_spans_ms": busy_ms - sum(phase.values()) / 1e3}
    log("[profile] " + json.dumps(out))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:16]
    for name, us in top:
        log(f"[profile] kernel {us / 1e3:10.3f} ms  {name[:110]}")
    if busy_us <= 0:
        log("[profile] the profiler saw no device time: not measured")
    return state


def parity_phase(torch, devices=("cpu", "cuda")):
    """The smoke spec, two steps, card against CPU from the same inputs."""
    from repro_torch.api import RunSpec
    from repro_torch.core.gs_sgd import make_state
    from repro_torch.data import LMStream
    from repro_torch.launch import train as ttrain
    from repro_torch.models.flatten import init_flat_params
    spec = RunSpec.load(os.path.join(ROOT, "examples", "specs",
                                     "qwen3_smoke.json"))
    results = {}
    params_cpu = None
    for dev in devices:
        cfg, opt, _, ts = ttrain.build(spec, dev)
        if params_cpu is None:
            params_cpu = init_flat_params(
                cfg, torch.Generator().manual_seed(spec.seed), 1, ts.fs)
        state = make_state({k: v.to(ts.device) for k, v in
                            params_cpu.items()}, opt, ts.compressor,
                           ts.d_local, ts.nworkers)
        stream = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                          global_batch=spec.batch, seed=spec.seed)
        losses, zeros = [], []
        for step in range(2):
            batch = ttrain.shard_batch(stream.global_batch_at(step, dev),
                                       ts.nworkers)
            state, m = ts.fn(state, batch)
            losses.append(float(m["loss"]))
            zeros.append([(e == 0).cpu() for e in state["ef"]])
        results[dev] = (losses, zeros)
    (lc, zc), (lg, zg) = (results[dev] for dev in devices)
    log(f"[parity] smoke losses cpu {lc} cuda {lg}")
    for a, b in zip(lc, lg):
        if not abs(a - b) <= PARITY_LOSS_RTOL * abs(a):
            fail(f"card and CPU losses differ: {lc} vs {lg}")
    for s, (a, b) in enumerate(zip(zc, zg)):
        for i, (x, y) in enumerate(zip(a, b)):
            if not torch.equal(x, y):
                fail(f"selected coordinates differ at step {s} bucket {i}")
    log("[parity] losses within rtol "
        f"{PARITY_LOSS_RTOL}; selected coordinates equal every step")


def cli_phase():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--spec",
           os.path.join("examples", "specs", "qwen3_smoke.json")]
    t0 = time.time()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    lines = r.stdout.strip().splitlines()
    for line in lines[-4:]:
        log(f"[cli] {line}")
    if r.returncode != 0:
        log(r.stderr[-4000:])
        fail(f"the train CLI exited {r.returncode}")
    last = json.loads(lines[-1])
    if not math.isfinite(last["final_loss"]):
        fail(f"the train CLI gave a non-finite loss: {last}")
    log(f"[cli] ran in {time.time() - t0:.1f} s")


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
    state, stream, counts, _ = train_phase(torch, cfg, opt, ts)
    for kr in kernels:
        kr["launches"] = counts[kr["name"]]
    log(f"[train] phase took {time.time() - t0:.1f} s")
    state = profile_phase(torch, ts, state, stream)
    del state
    torch.cuda.empty_cache()
    parity_phase(torch)
    cli_phase()
    log(f"[done] in {time.time() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
