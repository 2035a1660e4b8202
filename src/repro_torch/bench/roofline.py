"""Roofline analysis: three terms per (arch x shape x mesh) cell, priced
with one NVIDIA H100 SXM a rank.

Port of ``benchmarks/roofline.py``. The counts (FLOPs, HBM bytes, wire
bytes by mesh axis) are ``bench/comm_model.py``'s, equal to the
reference's; the rates are the H100's:

    compute    = FLOPs / PEAK_FLOPS       989.4e12 FLOP/s: dense bf16 on the
                                          tensor cores of an H100 SXM
                                          (NVIDIA's H100 datasheet); the
                                          production cells run bf16
    memory     = HBM bytes / HBM_BW       3.35e12 B/s: the H100 SXM's HBM3
                                          (the same datasheet)
    collective = sum_axis bytes / bw_axis the in-pod axes (model, data) at
                                          IN_POD_BW = 50e9 B/s: one 400 Gb/s
                                          NDR InfiniBand port a GPU. An axis
                                          of 16 ranks spans two 8-GPU NVLink
                                          nodes, so its ring runs at that
                                          port's rate. The pod axis at
                                          POD_BW = 6.25e9 B/s (50 Gbit/s,
                                          the slow cross-pod link the
                                          paper's regime models; --pod-bw)

Each row also joins the port's dry-run record of the cell
(``launch/dryrun.py``'s JSON, ``experiments/dryrun_torch/`` unless
``dryrun_dir`` says otherwise): its peak device memory, the FLOPs it
executed and its measured step seconds, beside the model's.

``measure_encode`` times the port's count-sketch encode on a device (the
card unless ``device="cpu"``), whole and as the fused interleave runs it
(``fragments`` offset slices into one exact sketch, then one finish), and
reports the bytes/s it reaches against HBM_BW.

Outputs ``experiments/roofline_torch/<mesh>.csv`` (or ``--out-dir``) and
a table. Usage:

    python -m repro_torch.bench.roofline [--mesh single|multi] \\
        [--pod-bw GBs] [--arch ...] [--dryrun-dir DIR] [--out-dir DIR] \\
        [--measure-encode [--encode-d D] [--device cpu]] [--json PATH]
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import time

import torch

from repro_torch.bench.comm_model import cell_model
from repro_torch.configs import ARCHS, DP_MODE
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.core.gs_sgd import MeshAxes
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch import dryrun

PEAK_FLOPS = 989.4e12        # dense bf16, H100 SXM (NVIDIA datasheet)
HBM_BW = 3.35e12             # HBM3 bytes/s, H100 SXM (the same datasheet)
IN_POD_BW = 50e9             # one 400 Gb/s NDR InfiniBand port a GPU
POD_BW = 6.25e9              # 50 Gbit/s cross-pod link (the slow link)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
OUT_DIR = os.path.join(ROOT, "experiments", "roofline_torch")

HINTS = {
    "compute": "raise arithmetic intensity: fewer remat passes, "
               "larger microbatch, tensor-core-aligned pads",
    "memory": "cut weight/state streaming: bf16 gathers, fuse "
              "elementwise optimizer/EF passes, smaller state dtypes",
    "collective": "cut wire bytes on the slow axis: smaller sketch "
                  "width / bf16 wire, or move compression to the "
                  "slower axis",
}


def mesh_axes(mesh_kind: str) -> MeshAxes:
    if mesh_kind == "multi":
        return MeshAxes(tp=16, data=16, pod=2, tp_axis="model",
                        data_axis="data", pod_axis="pod")
    return MeshAxes(tp=16, data=16, tp_axis="model", data_axis="data")


def analyze_cell(arch: str, shape: str, mesh_kind: str,
                 pod_bw: float = POD_BW, opts: dict | None = None, *,
                 dryrun_dir: str | None = None) -> dict | None:
    cfg = ARCHS[arch]
    if not applicable(cfg, shape):
        return None
    ma = mesh_axes(mesh_kind)
    dp_mode = DP_MODE[arch]
    m = cell_model(cfg, shape, ma, dp_mode, opts)

    t_compute = m.flops / PEAK_FLOPS
    t_memory = m.hbm_bytes / HBM_BW
    bw = {"model": IN_POD_BW, "data": IN_POD_BW, "pod": pod_bw}
    t_coll = sum(b / bw[ax] for ax, b in m.coll_bytes.items())
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = m.model_flops / max(m.flops, 1.0)

    # attach the port's dry-run record of the cell if present
    dj = os.path.join(dryrun_dir or dryrun.OUT_DIR,
                      f"{arch}__{shape}__{mesh_kind}.json")
    dry = {}
    if os.path.exists(dj):
        with open(dj) as f:
            dry = json.load(f)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "dp_mode": dp_mode,
        "flops": m.flops, "hbm_bytes": m.hbm_bytes,
        "coll_bytes_model": m.coll_bytes["model"],
        "coll_bytes_data": m.coll_bytes["data"],
        "coll_bytes_pod": m.coll_bytes["pod"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "step_time_bound_s": bound,
        "model_flops": m.model_flops, "useful_ratio": useful,
        # MFU upper bound: useful FLOPs at peak over the binding term.
        # (= useful_ratio when compute-bound; < that when comm/mem-bound.)
        "roofline_fraction": (m.model_flops / PEAK_FLOPS) / bound
        if bound else 0.0,
        "peak_bytes_dev": (dry.get("memory") or {}).get("peak_bytes"),
        # the dry-run's executed FLOPs and measured step, beside the model
        "dryrun_flops": (dry.get("cost") or {}).get("flops"),
        "dryrun_step_s": dry.get("step_seconds"),
        "hint": HINTS[dominant], "notes": "; ".join(m.notes),
    }


def _timed(fn, device: torch.device, iters: int) -> tuple[float, object]:
    """Mean seconds of ``fn()`` over ``iters`` back-to-back calls after one
    warm-up call (CUDA events on the card, the host clock on the CPU),
    and the last output."""
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) / iters, out


def measure_encode(d: int = 1 << 22, rows: int = 5, width: int = 1 << 14,
                   fragments: int = 4, iters: int = 5,
                   device=None) -> dict:
    """Time the port's count-sketch encode; report achieved bytes/s.

    Bytes convention: the minimal HBM traffic of one encode — read the
    (d,) f32 gradient once, write the (rows, width) f32 sketch once — so
    ``measured_Bps / hbm_bound_Bps`` is the fraction of the streaming
    roofline the encode reaches. Whole: ``kernels.ops.encode``. Fused:
    ``fragments`` offset slices of g encoded into one exact sketch
    (``ops.encode_into``), then one ``ops.encode_finish`` — the fused
    interleave's per-bucket work. The encode is exact, so both sketches
    are bit-equal; ``bit_equal`` says whether they were, and the
    sketches come back under ``sketches`` (whole, fused) for the caller.
    """
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.count_sketch import SketchConfig
    from repro_torch.kernels import ops

    device = resolve_device(device)
    cfg = SketchConfig(rows=rows, width=width, seed=0)
    gen = torch.Generator(device).manual_seed(0)
    g = torch.randn((d,), generator=gen, device=device, dtype=torch.float32)
    nbytes = d * 4 + cfg.rows * cfg.width * 4
    frag = d // fragments
    bounds = [(i * frag, d if i == fragments - 1 else (i + 1) * frag)
              for i in range(fragments)]

    def fused():
        acc = cs.exact_zeros(cfg, device=device)
        for lo, hi in bounds:
            ops.encode_into(cfg, g[lo:hi], acc, offset=lo)
        return ops.encode_finish(acc)

    t_whole, sk_whole = _timed(lambda: ops.encode(cfg, g), device, iters)
    t_fused, sk_fused = _timed(fused, device, iters)
    return {
        "backend": device.type,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "d": d, "rows": cfg.rows, "width": cfg.width,
        "fragments": fragments, "bytes": nbytes,
        "encode_s": t_whole, "fused_encode_s": t_fused,
        "measured_Bps": nbytes / t_whole,
        "fused_measured_Bps": nbytes / t_fused,
        "hbm_bound_Bps": HBM_BW,
        "hbm_fraction": (nbytes / t_whole) / HBM_BW,
        "fused_hbm_fraction": (nbytes / t_fused) / HBM_BW,
        "bit_equal": bool(torch.equal(sk_whole.view(torch.int32),
                                      sk_fused.view(torch.int32))),
        "sketches": (sk_whole, sk_fused),
    }


def check_rows(rows: list[dict]) -> list[str]:
    """Faults of a table: a non-finite term or bound, or a cell the dry-run
    ran (its record joined) without its peak."""
    bad = []
    for r in rows:
        nums = [r[k] for k in ("flops", "hbm_bytes", "t_compute_s",
                               "t_memory_s", "t_collective_s",
                               "step_time_bound_s", "roofline_fraction")]
        if not all(isinstance(x, (int, float)) and math.isfinite(x)
                   for x in nums):
            bad.append(f"{r['arch']} x {r['shape']} x {r['mesh']}: "
                       f"non-finite row {nums}")
        if r["dryrun_flops"] is not None and not r["peak_bytes_dev"]:
            bad.append(f"{r['arch']} x {r['shape']} x {r['mesh']}: the "
                       "dry-run record has no peak_bytes")
    return bad


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--pod-bw", type=float, default=POD_BW / 1e9,
                    help="cross-pod GB/s (default 6.25 = 50 Gbit/s)")
    ap.add_argument("--dryrun-dir", default=None,
                    help="the dry-run records to join (default "
                         "experiments/dryrun_torch/)")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="where <mesh>.csv goes")
    ap.add_argument("--measure-encode", action="store_true",
                    help="time the count-sketch encode and report "
                         "achieved bytes/s vs the HBM bound")
    ap.add_argument("--encode-d", type=int, default=1 << 22,
                    help="flat dimension for --measure-encode")
    ap.add_argument("--device", default=None,
                    help="--measure-encode's torch device (default: the "
                         "CUDA card)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write rows (+ encode measurement) as JSON")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    rows = []
    for arch in archs:
        for shape in SHAPES:
            r = analyze_cell(arch, shape, args.mesh,
                             pod_bw=args.pod_bw * 1e9,
                             dryrun_dir=args.dryrun_dir)
            if r:
                rows.append(r)

    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"{args.mesh}.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)

    hdr = (f"{'arch':22s} {'shape':12s} {'compute':>9s} {'memory':>9s} "
           f"{'collect':>9s} {'dominant':>10s} {'useful':>7s} {'RLfrac':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['arch']:22s} {r['shape']:12s} "
              f"{r['t_compute_s'] * 1e3:8.1f}m {r['t_memory_s'] * 1e3:8.1f}m "
              f"{r['t_collective_s'] * 1e3:8.1f}m {r['dominant']:>10s} "
              f"{r['useful_ratio']:6.2f} {r['roofline_fraction']:6.3f}")
    print(f"\nwrote {path}")

    measured = None
    if args.measure_encode:
        measured = measure_encode(d=args.encode_d, device=args.device)
        del measured["sketches"]
        print(f"\nencode [{measured['device_kind']}] d={measured['d']}: "
              f"{measured['measured_Bps'] / 1e9:.2f} GB/s whole, "
              f"{measured['fused_measured_Bps'] / 1e9:.2f} GB/s fused "
              f"({measured['hbm_fraction'] * 100:.1f}% of HBM bound), "
              f"bit-equal {measured['bit_equal']}")

    if args.json:
        from repro_torch.obs import provenance
        with open(args.json, "w") as f:
            json.dump({"mesh": args.mesh, "rows": rows,
                       "measured_encode": measured,
                       "provenance": provenance(device=args.device)}, f,
                      indent=2)
        print(f"wrote {args.json}")
    return rows


if __name__ == "__main__":
    main()
