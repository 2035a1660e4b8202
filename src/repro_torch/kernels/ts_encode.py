"""TS-sketch encode: CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/ts_encode.py:ts_encode`` (Pallas
body ``_kernel``: W-sized blocks walked in order, group-summed, placed at
stride n_r, rotated and accumulated into a VMEM tile). The Hopper kernel
(``csrc/ts_encode.cu``) gives each (row, bucket) one thread that sums all
of the bucket's contributors in a fixed order, so it needs no atomics and
its sketch is bit-reproducible run to run. ``g`` is not padded to
``d_pad`` in memory: coordinates i >= d count as zero.

Bound on the H100: one read of ``g`` (d * itemsize bytes) and one write of
the (R, W) sketch, over 3.35 TB/s. The kernel reads ``g`` once per row.

Tolerance: the kernel adds in another order than the plain version
(``core.ts_sketch.encode``, ``index_add_`` per row), so the two are held
to each other at 1e-4 * max|S| (see ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import ts_sketch as ts
from repro_torch.core.ts_sketch import TSketchConfig
from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES, resolve_dispatch
from repro_torch.kernels.sketch_encode import DTYPE_CODES


@functools.lru_cache(maxsize=64)
def row_params_on_device(cfg: TSketchConfig, device: str) -> torch.Tensor:
    """(R, 4) uint32 [log2 m, offset, sign c, sign d] as int32 on device."""
    p = np.stack([np.asarray(cfg.log_m, np.uint64),
                  np.asarray(cfg.offsets, np.uint64),
                  cfg.sign_params[:, 0].astype(np.uint64),
                  cfg.sign_params[:, 1].astype(np.uint64)], axis=1)
    return torch.from_numpy(
        np.ascontiguousarray(p.astype(np.uint32)).view(np.int32)).to(device)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("ts_encode")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ts_encode_launch.argtypes = [p, i64, i32, p, i32, i32, i32, p, p]
    lib.ts_encode_launch.restype = i32
    return lib


def ts_encode_plain(cfg: TSketchConfig, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch TS encode (the oracle): ``core.ts_sketch.encode``."""
    return ts.encode(cfg, g)


def ts_encode(cfg: TSketchConfig, g: torch.Tensor) -> torch.Tensor:
    """TS-sketch encode ``g`` (any shape, at most ``d_pad`` elements) ->
    (rows, width) f32. CPU tensors run the plain version; other devices
    launch the kernel (see ``kernels.dispatch``)."""
    g = g.reshape(-1)
    if not resolve_dispatch(g.device.type):
        return ts_encode_plain(cfg, g)
    lib = _lib()
    if g.device.type != "cuda":
        raise ValueError(f"ts_encode kernel needs a CUDA tensor, got "
                         f"{g.device}")
    if g.dtype not in DTYPE_CODES:
        raise TypeError(f"ts_encode takes f32/bf16/f16, got {g.dtype}")
    d = g.shape[0]
    if d > cfg.d_pad:
        raise ValueError(f"g has {d} coordinates; the config covers "
                         f"d_pad = {cfg.d_pad}")
    g = g.contiguous()
    out = torch.empty((cfg.rows, cfg.width), dtype=torch.float32,
                      device=g.device)
    if d == 0:
        return out.zero_()
    rp = row_params_on_device(cfg, str(g.device))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = lib.ts_encode_launch(
        g.data_ptr(), d, DTYPE_CODES[g.dtype], rp.data_ptr(), cfg.rows,
        cfg.bits, cfg.log2_width, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ts_encode launch failed: cudaError {rc}")
    LAUNCHES["ts_encode"] += 1
    return out
