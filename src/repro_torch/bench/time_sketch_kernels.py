"""Time the Count-Sketch encode and decode kernels and the HEAVYMIX
recovery on one card at the main cell's bucket sizes and at several sketch
widths, and check them against their plain versions.

    python src/repro_torch/bench/time_sketch_kernels.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so two trees can be compared in one run on the card:
unpack the other tree (``git archive``) into a directory ``.gitignore``
lists and run this script once for each, in turns.

Shapes: the two gs-SGD buckets of the full-width qwen3-4b step that
``chip_smoke.py`` drives (d and R from that step), each sketched at its own
width (2^20, 2^19), at the CLI's default ``SketchSpec`` width (16,384) and
at the smoke spec's width (512): from hundreds of 32 KB tiles down to one.
The decode is timed at the step's own widths. The recovery
(``ops.heavymix_recover``, as the timed tree has it) and the old route
(decode + ``core.heavymix.topk_lower_index`` of |est|) are timed at the
step's widths and at 16,384, with the bucket's k; where the tree has the
radix select (``kernels/topk_select.py``), also the select alone. In such
a tree the decode kernel always counts the select's histogram, so timing
``sketch_decode`` in a tree without the select and in one with it gives
the decode alone and with its histogram. The recovery's indices are
checked against the old route's. The TS encode (``ts_encode``, the
plan's kernel of the timed tree) and the TS route's recovery (old route:
``ts.decode`` + ``heavymix(estimates=)``; where the tree has it,
``ops.ts_heavymix_recover``, the TS-map scores kernel + the select, its
indices checked against the old route's) are timed at the step's widths
and at 16,384, the encode held to its plain version. g is
``chip_smoke._spiky``;
the timing (``chip_smoke.time_ms``, 10 calls after a warm-up) and the
encode's tolerance (``ENCODE_REL_TOL`` * max|S|; the decode bit-equal) are
``chip_smoke.py``'s. Prints one JSON line per (kernel, width, bucket); with
``--breakdown`` also the device time of each CUDA kernel one call launches
(``torch.profiler``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def breakdown(torch, fn) -> dict:
    """Device microseconds per kernel name over one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            out[e.key[:80]] = {"us": us, "calls": e.count}
    return out


def recover_fns(torch, ops, sd, topk_lower_index, cfg, sk, d, k):
    """(name, call, check) of the recovery's old route (decode + top-k of
    |est| outside any kernel) and of the tree's ``ops.heavymix_recover``;
    with the radix select, also the select alone."""
    def old_route():
        est = sd.sketch_decode(cfg, sk, d)
        return topk_lower_index(est.abs(), k)[1]

    idx_old = old_route()
    idx_new = ops.heavymix_recover(cfg, sk, k, d)[0]
    out = [("recover_old_route", old_route, {"k": k}),
           ("heavymix_recover", lambda: ops.heavymix_recover(cfg, sk, k, d),
            {"k": k, "idx_equal": torch.equal(idx_old, idx_new)})]
    if hasattr(sd, "sketch_decode_hist"):
        from repro_torch.kernels.topk_select import topk_select
        est, hist = sd.sketch_decode_hist(cfg, sk, d)
        out.append(("topk_select", lambda: topk_select(est, k, hist),
                    {"k": k}))
    return out


def ts_fns(torch, ops, cs_, g, cfg, d, k):
    """(name, call, check) of the TS encode and of the TS route's recovery
    (old route, and ``ops.ts_heavymix_recover`` where the tree has it) at
    the exact sketch geometry ``cfg``; returns also whether all checks
    held."""
    from repro_torch.core import heavymix as hm
    from repro_torch.core import ts_sketch as tsk
    from repro_torch.kernels.ts_encode import ts_encode, ts_encode_plain
    tcfg = tsk.TSketchConfig(d=d, rows=cfg.rows, width=cfg.width,
                             seed=cfg.seed)
    sk = ts_encode(tcfg, g)
    want = ts_encode_plain(tcfg, g)
    err = float((sk - want).abs().max())
    lim = cs_.ENCODE_REL_TOL * float(want.abs().max())
    del want
    bit_equal = torch.equal(sk, ts_encode(tcfg, g))

    def old_route():
        est = tsk.decode(tcfg, sk, d)
        return hm.heavymix(cfg, sk, k, d, estimates=est)[0]

    out = [("ts_encode", lambda: ts_encode(tcfg, g),
            {"max_abs_err": err, "limit": lim, "ok": err <= lim,
             "two_launches_bit_equal": bit_equal}),
           ("ts_recover_old_route", old_route, {"k": k})]
    ok = err <= lim and bit_equal
    if hasattr(ops, "ts_heavymix_recover"):
        equal = torch.equal(old_route(),
                            ops.ts_heavymix_recover(tcfg, sk, k, d)[0])
        ok = ok and equal
        out.append(("ts_heavymix_recover",
                    lambda: ops.ts_heavymix_recover(tcfg, sk, k, d),
                    {"k": k, "idx_equal": equal}))
    return out, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--breakdown", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_sketch_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs_
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.api import SketchSpec
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import topk_lower_index
    from repro_torch.kernels import ops
    from repro_torch.kernels import sketch_decode as sd
    from repro_torch.kernels.sketch_decode import (sketch_decode,
                                                   sketch_decode_plain)
    from repro_torch.kernels.sketch_encode import (sketch_encode,
                                                   sketch_encode_plain)
    card = cs_.card_line()
    dev = torch.device("cuda")
    _, _, ts = cs_.full_width_step(torch, dev)
    parts, sizes = ts.compressor.parts, ts.compressor.spec.sizes
    widths = (None, SketchSpec().width,
              cs_.smoke_spec().exchange.sketch.width)
    gen = torch.Generator(device=dev).manual_seed(1)
    ok = True
    for b, (part, d) in enumerate(zip(parts, sizes)):
        g = cs_._spiky(torch, gen, dev, d, part.k // 4)
        for width in widths:
            cfg = part.sketch if width is None else cs.SketchConfig(
                rows=part.sketch.rows, width=width, seed=part.sketch.seed)
            sk = sketch_encode(cfg, g)
            want = sketch_encode_plain(cfg, g)
            err = float((sk - want).abs().max())
            lim = cs_.ENCODE_REL_TOL * float(want.abs().max())
            del want
            ok = ok and err <= lim
            fns = [("sketch_encode", lambda: sketch_encode(cfg, g),
                    {"max_abs_err": err, "limit": lim, "ok": err <= lim})]
            if width is None:
                est = sketch_decode(cfg, sk, d)
                equal = torch.equal(est, sketch_decode_plain(cfg, sk, d))
                del est
                ok = ok and equal
                fns.append(("sketch_decode",
                            lambda: sketch_decode(cfg, sk, d),
                            {"bit_equal": equal}))
            if width in (None, SketchSpec().width):
                fns += recover_fns(torch, ops, sd, topk_lower_index, cfg, sk,
                                   d, part.k)
                ok = ok and all(f[2].get("idx_equal", True) for f in fns)
                ts_f, ts_ok = ts_fns(torch, ops, cs_, g, cfg, d, part.k)
                fns += ts_f
                ok = ok and ts_ok
            for name, fn, check in fns:
                if args.breakdown:
                    print(json.dumps({"tag": args.tag, "kernel": name,
                                      "bucket": b, "width": cfg.width,
                                      "breakdown_us": breakdown(torch, fn)}),
                          flush=True)
                ms = cs_.time_ms(torch, fn, reps=10)
                print(json.dumps({"tag": args.tag, "kernel": name,
                                  "bucket": b, "d": d, "rows": cfg.rows,
                                  "width": cfg.width, "ms": ms, **check,
                                  "card": card}), flush=True)
            del sk
        del g
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
