"""AdamW's update of one segment: CUDA kernel wrapper and its plain PyTorch
version.

Replaces no TPU kernel: the JAX package's AdamW
(``repro/optim/optimizers.py``) is ``jnp`` ops. The plain version is the
port's op-by-op AdamW, sixteen torch ops that each stream whole (P, f)
segments. The Hopper kernel (``csrc/adamw.cu``) reads p, g, m and v once
and writes p_out, m and v once: 28 bytes a coordinate over 3.35 TB/s
bound it. It rounds every step as torch's CUDA ops do, in their order, so
on the card it is bit-equal to the plain version.

``adamw_update(p, g, m, v, ...)`` updates the moments m and v in place
and returns the new parameters as a new tensor. ``bc1`` and ``bc2`` are
the step's bias corrections, f32 values as Python floats
(``optim.optimizers.adamw``).

Layout: p, g, m and v have one shape; every tensor is rows of n
contiguous floats, evenly spaced by a row stride of its own
(``row_layout``). So ``g`` may be a column slice of the wider mean
gradient, as ``core/gs_sgd.update`` passes it, at any offset: the kernel
takes 16-byte accesses where a row's five starts share their alignment
and 4-byte ones where they do not.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import (LAUNCHES, meta_empty, on_meta,
                                          resolve_dispatch, sm_count)

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("adamw")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.adamw_launch.argtypes = [p, p, p, p, p, i64, p, i64, p, i32, p]
    lib.adamw_launch.restype = i32
    return lib


def adamw_update_plain(p, g, m, v, *, lr: float, b1: float, b2: float,
                       eps: float, weight_decay: float, bc1: float,
                       bc2: float) -> torch.Tensor:
    """Plain PyTorch AdamW (the oracle): m and v in place, new params."""
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    upd.add_(weight_decay * p)
    return p - lr * upd


def row_layout(tensors) -> tuple[int, list[int], int]:
    """Tensors of one shape as rows of n contiguous elements: (rows, each
    tensor's row stride, n). Size-1 dimensions are dropped, the trailing
    dimensions contiguous in every tensor make a row, and the dimensions
    before them merge into one where every tensor's strides allow it, as
    the column slices of a contiguous (tp, P, d) mean gradient do. Raises
    where the innermost dimension of a tensor is not contiguous, or where
    they do not merge."""
    shape = tuple(tensors[0].shape)
    dims = [i for i, s in enumerate(shape) if s != 1]
    strides = [t.stride() for t in tensors]
    n, k = 1, len(dims)
    while k and all(st[dims[k - 1]] == n for st in strides):
        n *= shape[dims[k - 1]]
        k -= 1
    if k == len(dims) and dims:
        raise ValueError(f"adamw: the innermost dimension must have stride "
                         f"1 in every tensor, got strides {strides}")
    rows, row = 1, [0] * len(tensors)
    for i in reversed(dims[:k]):
        if rows == 1:
            row = [st[i] for st in strides]
        elif any(st[i] != r * rows for st, r in zip(strides, row)):
            raise ValueError(f"adamw: the rows of shape {shape} are not "
                             f"evenly spaced (strides {strides})")
        rows *= shape[i]
    return rows, row, n


def adamw_update(p, g, m, v, *, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float, bc1: float,
                 bc2: float) -> torch.Tensor:
    """One AdamW step of a segment: m and v (f32, p's shape) in place;
    returns the new params. ``g`` has p's shape, any strides with a
    contiguous innermost dimension.

    CPU tensors run the plain version; other devices launch the kernel
    (see ``kernels.dispatch``), one launch with no host sync.
    """
    if on_meta(p):
        return meta_empty(p.shape)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              bc1=bc1, bc2=bc2)
    if not resolve_dispatch(p.device.type):
        return adamw_update_plain(p, g, m, v, **kw)
    ts = (p, g, m, v)
    if any(t.device != p.device for t in ts) or p.device.type != "cuda":
        raise ValueError(f"adamw kernel needs CUDA tensors on one device, "
                         f"got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"adamw kernel takes f32 tensors, got "
                         f"{[t.dtype for t in ts]}")
    if any(t.shape != p.shape for t in ts):
        raise ValueError(f"adamw: shapes differ: "
                         f"{[tuple(t.shape) for t in ts]}")
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    rows, strides, n = row_layout((*ts, out))
    # the f32 scalars torch's ops use: each Python float rounded once; a
    # division by a CPU scalar is a product with its f32 reciprocal
    f32 = np.float32
    coeffs = (ctypes.c_float * 9)(
        lr, b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
        float(f32(1) / f32(bc1)), float(f32(1) / f32(bc2)))
    rc = _lib().adamw_launch(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        out.data_ptr(), rows, (ctypes.c_int64 * 5)(*strides), n, coeffs,
        sm_count(p.device), torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adamw launch failed: cudaError {rc}")
    LAUNCHES["adamw"] += 1
    return out
