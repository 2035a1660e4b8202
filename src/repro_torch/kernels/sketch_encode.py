"""Count-Sketch encode: CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/sketch_encode.py:sketch_encode``
(Pallas body ``_encode_kernel``, blocked signed one-hot matmuls — a design
forced by the TPU's lack of atomics and fast scatter). The Hopper kernel
(``csrc/sketch_encode.cu``) hashes each element and ``atomicAdd``s it into
its R buckets of a zeroed (R, W) f32 sketch.

Bound on the H100: the sketch is written through L2 atomics and, at the
gs-SGD widths (<= 20 MiB), stays resident in the 50 MB L2; device memory
sees one read of ``g`` (d * itemsize bytes) and one write of the sketch,
so the least time is those bytes over 3.35 TB/s.

Determinism: atomic adds land in a run-dependent order, so on the card the
sketch is not bit-reproducible. It is held to the plain version within a
tolerance relative to max|S| (see ``chip_smoke.py``). The plain version
(``index_add_`` per row) is deterministic and is what CPU tensors run.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import count_sketch as cs
from repro_torch.core.count_sketch import SketchConfig
from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES, resolve_dispatch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=64)
def hash_on_device(cfg: SketchConfig, device: str) -> torch.Tensor:
    """``cfg.hash_params`` (uint32 bits, as int32) on ``device``."""
    return torch.from_numpy(
        np.ascontiguousarray(cfg.hash_params).view(np.int32)).to(device)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("sketch_encode")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sketch_encode_launch.argtypes = [p, i64, i32, p, i32, i32, i64, p,
                                         i64, p]
    lib.sketch_encode_launch.restype = i32
    return lib


def sketch_encode_plain(cfg: SketchConfig, g: torch.Tensor,
                        index_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch encode (the oracle): ``index_add_`` per row."""
    return cs.encode(cfg, g, offset=index_offset)


def sketch_encode(cfg: SketchConfig, g: torch.Tensor, *,
                  index_offset: int = 0) -> torch.Tensor:
    """Count-Sketch encode ``g`` (any shape) -> (rows, width) f32 sketch.

    ``index_offset``: hash element j as coordinate index_offset + j.
    CPU tensors run the plain version; other devices launch the kernel
    (see ``kernels.dispatch``).
    """
    g = g.reshape(-1)
    if not resolve_dispatch(g.device.type):
        return sketch_encode_plain(cfg, g, index_offset)
    lib = _lib()
    if g.device.type != "cuda":
        raise ValueError(f"sketch_encode kernel needs a CUDA tensor, got "
                         f"{g.device}")
    if g.dtype not in DTYPE_CODES:
        raise TypeError(f"sketch_encode takes f32/bf16/f16, got {g.dtype}")
    g = g.contiguous()
    out = torch.zeros((cfg.rows, cfg.width), dtype=torch.float32,
                      device=g.device)
    d = g.shape[0]
    if d == 0:
        return out
    hp = hash_on_device(cfg, str(g.device))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = lib.sketch_encode_launch(
        g.data_ptr(), d, DTYPE_CODES[g.dtype], hp.data_ptr(), cfg.rows,
        32 - cfg.log2_width, int(index_offset), out.data_ptr(), cfg.width,
        stream)
    if rc != 0:
        raise RuntimeError(f"sketch_encode launch failed: cudaError {rc}")
    LAUNCHES["sketch_encode"] += 1
    return out


def sketch_encode_bucketed(cfgs, g: torch.Tensor, sizes) -> tuple:
    """Per-bucket encode of a flat vector: one launch per bucket."""
    g = g.reshape(-1)
    sizes = tuple(int(s) for s in sizes)
    if sum(sizes) != g.shape[0]:
        raise ValueError(
            f"bucket sizes {sizes} must sum to the flat gradient "
            f"dimension {g.shape[0]}")
    out, off = [], 0
    for cfg, s in zip(cfgs, sizes):
        out.append(sketch_encode(cfg, g[off:off + s]))
        off += s
    return tuple(out)
