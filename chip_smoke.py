#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build     — compile every kernel from ``src/repro_torch/csrc`` with
                ``nvcc`` (one process per source, all started together) and
                load them.
2. kernels   — call each kernel's wrapper on the card at the shapes the
                full-width step gives it (the encode, the decode with and
                without its first-digit histogram and the top-k select at
                both buckets, with their launch geometry, and the encode
                also at the CLI's default sketch width; the others at
                bucket 0) plus small odd cases and a scores-regime case
                whose heavy set far outnumbers k, hold it against its plain
                PyTorch version, and time kernel, plain version, library
                yardstick and bound; the recovery's old route (decode +
                ``topk_lower_index``) against its new one (decode with
                histogram + select), and one recovery under
                ``torch.cuda.set_sync_debug_mode("error")``.
3. train     — the main path: three gs-SGD steps of qwen3-4b at its
                published widths (depth cut to 2 layers), P=2 workers,
                buckets=2, psum, AdamW, SketchSpec(rows=5, width=None,
                k=None). Both buckets are past 2^22 coordinates, so the
                recovery runs the decode kernel (with its histogram) and
                the select, not the scores kernel; the select launches once
                per recovery: 12 times.
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
                Its buckets are below 2^22: the scores kernel's path (with
                its histogram, then the select).
7. baselines — every compressor of the registry, two smoke-spec steps on the
                card and on the CPU from the same params and batches.
8. cli       — ``python -m repro_torch.launch.train --spec
                examples/specs/qwen3_smoke.json`` on the card.

Every path that launches kernels (train, train_ts, parity) runs with every
launch counter set to 0 just before and read just after; each kernel of
the path must have launched, and the JSON line reports those counts.

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
ENCODE_REL_TOL = 1e-4   # |kernel - plain| / max|S|: the encoders add in
#                         another order (shared-memory atomics, or the TS
#                         kernel's fixed per-bucket order); n*eps*sum|x|/max|S|
#                         stays below
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
    width (few tiles, so several accumulating CTAs a tile). Returns its row
    and the kernel's sketch of each main-path bucket."""
    from repro_torch.api import SketchSpec
    from repro_torch.core import count_sketch as cs
    from repro_torch.kernels.sketch_encode import (encode_plan, sketch_encode,
                                                   sketch_encode_plain)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for rows, width, off in ((3, 300, 4099), (64, 1 << 12, 2**32 - 700)):
            c = cs.SketchConfig(rows=rows, width=width, seed=5)
            x = torch.randn(1537, generator=gen, device=device).to(dt)
            got = sketch_encode(c, x, index_offset=off)
            want = sketch_encode_plain(c, x, off)
            err = float((got - want).abs().max())
            lim = ENCODE_REL_TOL * float(want.abs().max())
            log(f"[kernels] sketch_encode small d=1537 R={rows} W={c.width} "
                f"off={off} {dt}: max_abs_err {err:.3g} (limit {lim:.3g})")
            if not err <= lim:
                fail(f"sketch_encode small {dt} disagrees: {err} > {lim}")
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
            f"{plan.ntiles} tiles of 32 KB, {plan.splits} accumulating "
            f"CTA(s) a tile; binning CTAs of {plan.block} elements "
            f"({plan.bin_smem} bytes of shared memory), {plan.nblocks} a "
            f"pass; passes of {plan.chunk} elements: {-(-d // plan.chunk)}, "
            f"scratch {plan.scratch_bytes} bytes")
        sk = sketch_encode(cfg, g)
        sk_p = sketch_encode_plain(cfg, g)
        err = float((sk - sk_p).abs().max())
        lim = ENCODE_REL_TOL * float(sk_p.abs().max())
        log(f"[kernels] sketch_encode {what} d={d}: max_abs_err {err:.4g} "
            f"(limit {lim:.4g} = {ENCODE_REL_TOL} * max|S|)")
        if not err <= lim:
            fail(f"sketch_encode disagrees with its plain version at {what}: "
                 f"{err}")
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


def check_scores_hist(torch, what, c, s, thr, n):
    """heavymix_scores with its histogram: scores and est bit-equal to
    plain, histogram equal to the plain one of the same scores. Returns
    (scores, est, hist, max |est - plain est|)."""
    from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                                   heavymix_scores_plain)
    from repro_torch.kernels.topk_select import radix_hist_plain
    sc, est, hist = heavymix_scores_hist(c, s, thr, n)
    sc_p, est_p = heavymix_scores_plain(c, s, thr, n)
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
                                                 topk_select,
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
        log(f"[kernels] sketch_decode plan at bucket {b} (d={d}, R={R}, "
            f"W={W}): one thread a coordinate, grid-stride, 256 threads, "
            f"{min(-(-d // 256), 132 * 16)} CTAs")
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
        sel_ms = time_ms(torch, lambda: topk_select(est, k, hist), reps=10)
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
            f"{dech_ms:.3f} ms; select {sel_ms:.3f} ms; "
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
                           "topk_lower_index_ms": topk_ms,
                           "old_route_ms": old_ms, "new_route_ms": new_ms})
    return [hm_row,
            _shapes_row("sketch_decode",
                        "src/repro_torch/csrc/sketch_decode.cu",
                        "src/repro/kernels/sketch_decode.py:85", dec_shapes),
            _shapes_row("topk_select", "src/repro_torch/csrc/topk_select.cu",
                        "jax.lax.top_k, src/repro/core/heavymix.py:65,88,93",
                        sel_shapes)]


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
    """Every kernel at the full-width step's shapes (the encode and decode
    at both buckets, the TS encode at bucket 0), and small cases."""
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
    del sks
    out.append(ts_checks(torch, device, gen, parts[0].sketch, gs[0]))
    del gs
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
    check_launches("parity", counts, ("sketch_encode", "heavymix_scores",
                                      "topk_select"),
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
    check_launches("train", counts, ("sketch_encode", "sketch_decode",
                                     "topk_select"),
                   ("heavymix_scores", "ts_encode"))
    recoveries = TRAIN_P * ts.n_buckets * TRAIN_STEPS
    if counts["topk_select"] != recoveries:
        fail(f"topk_select launched {counts['topk_select']} times on the "
             f"train path, not once per recovery ({recoveries})")
    log(f"[train] topk_select launches {counts['topk_select']} = "
        f"{TRAIN_P} workers x {ts.n_buckets} buckets x {TRAIN_STEPS} steps")
    log(f"[train] phase took {time.time() - t0:.1f} s")
    state = profile_phase(torch, ts, state, stream)
    del state
    torch.cuda.empty_cache()
    t0 = time.time()
    ts_step = full_width_ts_step(torch, device, ts, opt)
    state, stream, ts_counts, _ = train_phase(torch, cfg, opt, ts_step,
                                              tag="train_ts")
    check_launches("train_ts", ts_counts, ("ts_encode",),
                   ("sketch_encode", "sketch_decode", "heavymix_scores",
                    "topk_select"))
    log(f"[train_ts] phase took {time.time() - t0:.1f} s")
    state = profile_phase(torch, ts_step, state, stream, tag="profile_ts")
    del state, ts_step
    torch.cuda.empty_cache()
    t0 = time.time()
    parity_counts = parity_phase(torch)
    log(f"[parity] phase took {time.time() - t0:.1f} s")
    launches = {"sketch_encode": counts, "sketch_decode": counts,
                "topk_select": counts, "ts_encode": ts_counts,
                "heavymix_scores": parity_counts}
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
