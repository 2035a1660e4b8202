#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build     — compile every kernel from ``src/repro_torch/csrc`` with
                ``nvcc`` (one process per source, all started together) and
                load them.
2. kernels   — call each kernel's wrapper on the card at the shapes the
                full-width step gives it (bucket 0 below) plus small odd
                cases, hold it against its plain PyTorch version, and time
                kernel, plain version, library yardstick and bound.
3. train     — the main path: three gs-SGD steps of qwen3-4b at its
                published widths (depth cut to 2 layers), P=2 workers,
                buckets=2, psum, AdamW, SketchSpec(rows=5, width=None,
                k=None). Both buckets are past 2^22 coordinates, so the
                recovery runs the decode kernel, not the scores kernel.
4. profile   — one more full-width step under ``torch.profiler``: device
                time per span (loss_and_grad / encode / allreduce / recover
                / optimizer; each device event counted once, in the span
                that holds its launch) and the device's idle share. Not
                counted.
5. train_ts  — three steps of the same cell with gs-SGD's TS-sketch encoder
                (``compressor_kw`` ``encoder="ts"``): the TS encode kernel;
                then one more step under the profiler, as in 4 (not
                counted).
6. parity    — two steps of examples/specs/qwen3_smoke.json on the card
                (kernels) and on the CPU (plain versions) from the same
                params and batches: losses and selected coordinates agree.
                Its buckets are below 2^22: the scores kernel's path.
7. baselines — every compressor of the registry, two smoke-spec steps on the
                card and on the CPU from the same params and batches.
8. cli       — ``python -m repro_torch.launch.train --spec
                examples/specs/qwen3_smoke.json`` on the card.

Every path that launches kernels (train, train_ts, parity) runs with every
launch counter set to 0 just before and read just after; each kernel of
the path must have launched, and the JSON line reports those counts.

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
ENCODE_REL_TOL = 1e-4   # |kernel - plain| / max|S|: the encoders add in
#                         another order (atomics, or the TS kernel's fixed
#                         per-bucket order); n*eps*sum|x|/max|S| stays below
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
    from repro_torch.kernels import (build, heavymix_topk, sketch_decode,
                                     sketch_encode, ts_encode)
    names = ("sketch_encode", "heavymix_scores", "sketch_decode",
             "ts_encode")
    t0 = time.time()
    logs = build.build_all(names)
    for mod in (sketch_encode, heavymix_topk, sketch_decode, ts_encode):
        mod._lib()
    log(f"[build] {len(names)} kernels built and loaded in "
        f"{time.time() - t0:.1f} s (nvcc {build.nvcc_path()})")
    for name, text in logs.items():
        for line in (text or "cached build\n").splitlines():
            if ("registers" in line or "spill" in line
                    or line == "cached build"):
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


def encode_checks(torch, device, gen, cfg, g) -> tuple[dict, torch.Tensor]:
    """sketch_encode: small odd cases, then bucket 0. Returns its row and
    the kernel's bucket-0 sketch."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels.sketch_encode import (sketch_encode,
                                                   sketch_encode_plain)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        c = cs.SketchConfig(rows=3, width=300, seed=5)
        x = torch.randn(1537, generator=gen, device=device).to(dt)
        got = sketch_encode(c, x, index_offset=4099)
        want = sketch_encode_plain(c, x, 4099)
        err = float((got - want).abs().max())
        lim = ENCODE_REL_TOL * float(want.abs().max())
        log(f"[kernels] sketch_encode small d=1537 off=4099 {dt}: "
            f"max_abs_err {err:.3g} (limit {lim:.3g})")
        if not err <= lim:
            fail(f"sketch_encode small {dt} disagrees: {err} > {lim}")
    d, R, W = g.shape[0], cfg.rows, cfg.width
    sk = sketch_encode(cfg, g)
    sk_p = sketch_encode_plain(cfg, g)
    err = float((sk - sk_p).abs().max())
    lim = ENCODE_REL_TOL * float(sk_p.abs().max())
    log(f"[kernels] sketch_encode d={d}: max_abs_err {err:.4g} "
        f"(limit {lim:.4g} = {ENCODE_REL_TOL} * max|S|)")
    if not err <= lim:
        fail(f"sketch_encode disagrees with its plain version: {err}")
    ms = time_ms(torch, lambda: sketch_encode(cfg, g), reps=10)
    plain_ms = time_ms(torch, lambda: sketch_encode_plain(cfg, g), reps=2)
    del sk_p

    def ids_vals(lo, hi):
        b, sg = cs.hash_buckets(cfg, torch.arange(lo, hi, device=device))
        return b, sg * g[lo:hi]

    lib_ms, lib_out = _index_add_ms(torch, device, R, W, d, ids_vals)
    log(f"[kernels] index_add_ yardstick vs kernel: max_abs_err "
        f"{float((lib_out - sk).abs().max()):.4g}")
    bound = bound_ms(d * g.element_size() + R * W * 4, d * R * 7.0)
    return _row("sketch_encode", "src/repro_torch/csrc/sketch_encode.cu",
                "src/repro/kernels/sketch_encode.py:87", err, ms, plain_ms,
                bound, lib_ms), sk


def _spiky(torch, gen, device, n, n_spikes):
    """A gradient-like vector: small noise and ``n_spikes`` large entries."""
    g = torch.randn(n, generator=gen, device=device).mul_(1e-3)
    spikes = torch.randint(0, n, (n_spikes,), generator=gen, device=device)
    g[spikes] = torch.randn(spikes.numel(), generator=gen, device=device)
    return g


def smoke_scores_checks(torch, device, gen):
    """heavymix_scores at the shapes its own path (parity, cli: the smoke
    spec, every bucket below 2^22) gives it, each bucket with its own k
    and threshold: est and scores bit-equal to plain, and the recovery's
    indices equal to the plain HEAVYMIX's."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.heavymix_topk import (heavymix_scores,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.sketch_encode import sketch_encode_plain
    from repro_torch.launch import train as ttrain
    comp = ttrain.build(smoke_spec(), device)[3].compressor
    for i, (part, n) in enumerate(zip(comp.parts, comp.spec.sizes)):
        c, k = part.sketch, part.k
        s = sketch_encode_plain(c, _spiky(torch, gen, device, n, k // 4))
        thr = cs.l2sq_estimate(s) / k
        sc, est = heavymix_scores(c, s, thr, n)
        sc_p, est_p = heavymix_scores_plain(c, s, thr, n)
        if not (torch.equal(est, est_p) and torch.equal(sc, sc_p)):
            fail(f"heavymix_scores at smoke bucket {i} (d={n}, R={c.rows}, "
                 f"W={c.width}, k={k}) disagrees: max est err "
                 f"{float((est - est_p).abs().max())}")
        idx = ops.heavymix_recover(c, s, k, n)[0]
        if not torch.equal(idx, ref.heavymix_recover(c, s, k, n)[0]):
            fail(f"heavymix_recover at smoke bucket {i} selects other "
                 "coordinates than the plain HEAVYMIX")
        log(f"[kernels] smoke bucket {i} d={n} R={c.rows} W={c.width} k={k}:"
            f" scores and est bit-equal; recovered idx equal")


def scores_decode_checks(torch, device, gen, cfg, sk, d, k) -> list[dict]:
    """heavymix_scores and sketch_decode: small cases (offsets, R = 1, 4,
    5, 29, widths below 512), the smoke spec's buckets (the scores
    kernel's path), then bucket 0, bit-equal to plain; the recovery's
    indices against the plain HEAVYMIX; times."""
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.heavymix_topk import (heavymix_scores,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.sketch_decode import (sketch_decode,
                                                   sketch_decode_plain)
    from repro_torch.kernels.sketch_encode import sketch_encode_plain
    for rows, n, width, off in ((1, 3000, 512, 0), (4, 3000, 300, 4099),
                                (5, 3001, 512, 4099), (29, 5000, 200, 17)):
        c = cs.SketchConfig(rows=rows, width=width, seed=rows)
        x = torch.randn(n, generator=gen, device=device)
        s = sketch_encode_plain(c, x)
        thr = cs.l2sq_estimate(s) / 40
        sc, est = heavymix_scores(c, s, thr, n)
        sc_p, est_p = heavymix_scores_plain(c, s, thr, n)
        if not (torch.equal(est, est_p) and torch.equal(sc, sc_p)):
            fail(f"heavymix_scores small R={rows} disagrees: max err "
                 f"{float((est - est_p).abs().max())}")
        e = sketch_decode(c, s, n, index_offset=off)
        if not torch.equal(e, sketch_decode_plain(c, s, n, off)):
            fail(f"sketch_decode small R={rows} W={c.width} off={off} "
                 "disagrees with its plain version")
        log(f"[kernels] small R={rows} W={c.width} d={n}: scores bit-equal;"
            f" decode at offset {off} bit-equal")
    smoke_scores_checks(torch, device, gen)

    R, W = cfg.rows, cfg.width
    thr = cs.l2sq_estimate(sk) / k
    sc, est = heavymix_scores(cfg, sk, thr, d)
    sc_p, est_p = heavymix_scores_plain(cfg, sk, thr, d)
    hm_err = float((est - est_p).abs().max())
    if not (torch.equal(est, est_p) and torch.equal(sc, sc_p)):
        fail(f"heavymix_scores not bit-equal at d={d}: max err {hm_err}")
    del sc, sc_p
    dec = sketch_decode(cfg, sk, d)
    dec_err = float((dec - est_p).abs().max())
    if not torch.equal(dec, est_p):
        fail(f"sketch_decode not bit-equal at d={d}: max err {dec_err}")
    del est_p
    # the main path's selection (ops.heavymix_recover: decode kernel and
    # top-k of |est| at this d) against the port's plain chunked HEAVYMIX
    idx = ops.heavymix_recover(cfg, sk, k, d)[0]
    idx_p = ref.heavymix_recover(cfg, sk, k, d)[0]
    if not torch.equal(idx, idx_p):
        fail("heavymix_recover selects other coordinates than the plain "
             f"HEAVYMIX: {int((idx != idx_p).sum())} of k={k} differ")
    log(f"[kernels] d={d}: heavymix_scores est and scores bit-equal; "
        "sketch_decode est bit-equal; recovered idx equal to the plain "
        "HEAVYMIX")
    del idx, idx_p
    hm_ms = time_ms(torch, lambda: heavymix_scores(cfg, sk, thr, d), reps=10)
    hm_plain_ms = time_ms(
        torch, lambda: heavymix_scores_plain(cfg, sk, thr, d), reps=2)
    dec_ms = time_ms(torch, lambda: sketch_decode(cfg, sk, d), reps=10)
    dec_plain_ms = time_ms(torch, lambda: sketch_decode_plain(cfg, sk, d),
                           reps=2)
    topk_ms = time_ms(torch, lambda: topk_lower_index(dec.abs(), k), reps=3)
    log(f"[kernels] top-k of |est| with lower-index ties (outside the "
        f"kernel) at d={d}, k={k}: {topk_ms:.3f} ms")
    del est, dec
    torch.cuda.empty_cache()

    # library yardstick of the decode: gather + sign + median over rows,
    # bucket ids and signs precomputed (not timed); R is odd here, so
    # torch.median's lower middle is the median
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

    dec_lib_ms = time_ms(torch, lib_call, reps=2)
    same = torch.equal(lib["est"], sketch_decode(cfg, sk, d))
    log(f"[kernels] gather+median yardstick equal to the decode kernel: "
        f"{same}")
    del ids, sgn, lib
    torch.cuda.empty_cache()
    ops_per = R * 6.0 + R * (R - 1)   # hashes + compare-exchanges
    return [
        _row("heavymix_scores", "src/repro_torch/csrc/heavymix_scores.cu",
             "src/repro/kernels/heavymix_topk.py:91", hm_err, hm_ms,
             hm_plain_ms, bound_ms(R * W * 4 + 4 + 2 * d * 4,
                                   d * (ops_per + 4)), None),
        _row("sketch_decode", "src/repro_torch/csrc/sketch_decode.cu",
             "src/repro/kernels/sketch_decode.py:85", dec_err, dec_ms,
             dec_plain_ms, bound_ms(R * W * 4 + d * 4, d * ops_per),
             dec_lib_ms),
    ]


def ts_checks(torch, device, gen, cfg, g) -> dict:
    """ts_encode: small cases (f32/bf16/f16; rows with n_r > W), then
    bucket 0's TS geometry in f32 and bf16: held to
    the plain version at ENCODE_REL_TOL * max|S|, and bit-equal between
    two launches (fixed order, no atomics)."""
    from repro_torch.core.ts_sketch import TSketchConfig, buckets_at, signs_at
    from repro_torch.kernels.ts_encode import ts_encode, ts_encode_plain

    def check(c, x, what):
        got = ts_encode(c, x)
        want = ts_encode_plain(c, x)
        err = float((got - want).abs().max())
        lim = ENCODE_REL_TOL * float(want.abs().max())
        if not err <= lim:
            fail(f"ts_encode {what} disagrees: {err} > {lim}")
        if not torch.equal(got, ts_encode(c, x)):
            fail(f"ts_encode {what} differs between two launches")
        log(f"[kernels] ts_encode {what}: max_abs_err {err:.4g} (limit "
            f"{lim:.4g}); two launches bit-equal")
        return got, want, err

    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for n, rows, width in ((100_000, 5, 512), (70_000, 5, 16),
                               (1537, 1, 300)):
            c = TSketchConfig(d=n, rows=rows, width=width, seed=5)
            x = torch.randn(n, generator=gen, device=device).to(dt)
            check(c, x, f"small d={n} R={rows} W={c.width} {dt}")
    d = g.shape[0]
    tcfg = TSketchConfig(d=d, rows=cfg.rows, width=cfg.width, seed=cfg.seed)
    R, W = tcfg.rows, tcfg.width
    log(f"[kernels] TS geometry at bucket 0: d_pad={tcfg.d_pad} n_r="
        f"{[1 << (tcfg.bits - a) for a in tcfg.log_m]}")
    check(tcfg, g.to(torch.bfloat16), f"d={d} bf16")
    got, want, err = check(tcfg, g, f"d={d} f32")
    del want
    ms = time_ms(torch, lambda: ts_encode(tcfg, g), reps=10)
    plain_ms = time_ms(torch, lambda: ts_encode_plain(tcfg, g), reps=2)

    def ids_vals(lo, hi):
        i = torch.arange(lo, hi, device=device)
        return buckets_at(tcfg, i), signs_at(tcfg, i) * g[lo:hi]

    lib_ms, lib_out = _index_add_ms(torch, device, R, W, d, ids_vals)
    log(f"[kernels] index_add_ yardstick vs ts kernel: max_abs_err "
        f"{float((lib_out - got).abs().max()):.4g}")
    # per (row, element): bucket map (add, and, and, shift, shift, or, and),
    # sign (mul, add, shift), sign-apply and add
    bound = bound_ms(d * g.element_size() + R * W * 4, d * R * 12.0)
    return _row("ts_encode", "src/repro_torch/csrc/ts_encode.cu",
                "src/repro/kernels/ts_encode.py:73", err, ms, plain_ms,
                bound, lib_ms)


def kernels_phase(torch, device, ts) -> list[dict]:
    """Every kernel at bucket 0 of the full-width step, and small cases."""
    gen = torch.Generator(device=device).manual_seed(1)
    part = ts.compressor.parts[0]
    d, cfg, k = ts.compressor.spec.sizes[0], part.sketch, part.k
    log(f"[kernels] main-path shapes: d={d} R={cfg.rows} W={cfg.width} "
        f"k={k}")
    g = _spiky(torch, gen, device, d, k // 4)
    enc, sk = encode_checks(torch, device, gen, cfg, g)
    out = [enc] + scores_decode_checks(torch, device, gen, cfg, sk, d, k)
    del sk
    out.append(ts_checks(torch, device, gen, cfg, g))
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


def train_phase(torch, cfg, opt, ts, tag="train"):
    """Three full-width steps; counts set to 0 just before, read after."""
    from repro_torch.data import LMStream
    from repro_torch.kernels.dispatch import LAUNCHES
    from repro_torch.launch.train import train_loop
    state = ts.init_state(opt, torch.Generator(device=ts.device)
                          .manual_seed(0))
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    sizes = ts.compressor.spec.sizes
    log(f"[{tag}] qwen3-4b widths, {cfg.n_layers} layers: d={ts.d_local} "
        f"buckets {list(sizes)} "
        f"(k, W) {[(c.k, c.sketch.width) for c in ts.compressor.parts]} "
        f"encoder {ts.compressor.parts[0].encoder} "
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
        log(f"[{tag}] step {s}: loss {loss:.6f}  step_s {t:.4f}")
    log(f"[{tag}] max_memory_allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB); launches {counts}")
    if not all(math.isfinite(x) for x in hist):
        fail(f"non-finite loss on the {tag} path: {hist}")
    return state, stream, counts, times


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


PHASES = ("loss_and_grad", "encode", "allreduce", "recover", "exchange",
          "optimizer")


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
           "idle_share": max(0.0, 1 - busy_ms / wall_ms)}
    log(f"[{tag}] " + json.dumps(out))
    log(f"[{tag}] spans + outside + unlinked = {parts_ms:.3f} ms = device "
        "busy (each device event counted once)")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:16]
    for name, ms in top:
        log(f"[{tag}] kernel {ms:10.3f} ms  {name[:110]}")
    if busy_ms <= 0:
        log(f"[{tag}] the profiler saw no device time: not measured")
    return state


def smoke_runs(torch, spec, steps=2, card="cuda"):
    """``steps`` steps of ``spec`` on the CPU and on ``card`` from the same
    params and batches. Returns ((losses, ef states) on the CPU, the same
    on the card) and the card run's launch counts (set to 0 just before
    it, read just after)."""
    from repro_torch.core.gs_sgd import make_state
    from repro_torch.data import LMStream
    from repro_torch.kernels.dispatch import LAUNCHES
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
                           ts.d_local, ts.nworkers)
        stream = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                          global_batch=spec.batch, seed=spec.seed)
        losses, efs = [], []
        on_card = len(results) == 1
        if on_card:
            torch.cuda.synchronize()
            LAUNCHES.clear()
        for step in range(steps):
            batch = ttrain.shard_batch(stream.global_batch_at(step, dev),
                                       ts.nworkers)
            state, m = ts.fn(state, batch)
            losses.append(float(m["loss"]))
            efs.append(state["ef"])
        if on_card:
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
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
    check_launches("parity", counts, ("sketch_encode", "heavymix_scores"),
                   ("sketch_decode", "ts_encode"))
    log("[parity] losses within rtol "
        f"{PARITY_LOSS_RTOL}; selected coordinates equal every step")
    return counts


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
    check_launches("train", counts, ("sketch_encode", "sketch_decode"),
                   ("heavymix_scores", "ts_encode"))
    log(f"[train] phase took {time.time() - t0:.1f} s")
    state = profile_phase(torch, ts, state, stream)
    del state
    torch.cuda.empty_cache()
    t0 = time.time()
    ts_step = full_width_ts_step(torch, device, ts, opt)
    state, stream, ts_counts, _ = train_phase(torch, cfg, opt, ts_step,
                                              tag="train_ts")
    check_launches("train_ts", ts_counts, ("ts_encode",),
                   ("sketch_encode", "sketch_decode", "heavymix_scores"))
    log(f"[train_ts] phase took {time.time() - t0:.1f} s")
    state = profile_phase(torch, ts_step, state, stream, tag="profile_ts")
    del state, ts_step
    torch.cuda.empty_cache()
    t0 = time.time()
    parity_counts = parity_phase(torch)
    log(f"[parity] phase took {time.time() - t0:.1f} s")
    launches = {"sketch_encode": counts, "sketch_decode": counts,
                "ts_encode": ts_counts, "heavymix_scores": parity_counts}
    for kr in kernels:
        kr["launches"] = launches[kr["name"]][kr["name"]]
    t0 = time.time()
    baselines_phase(torch)
    log(f"[baselines] phase took {time.time() - t0:.1f} s")
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
