"""Learning-rate and compression-density schedules.

Port of ``repro/optim/schedule.py``. Every schedule is a ``step -> value``
function built from python hyper-parameters. The values are computed in
f32 scalar tensors, op for op as the reference computes them in f32
(python floats enter each op as f32, as JAX's weak types do), so they are
bit-equal to the reference's. The reference's f32 cosine on the CPU is the
C library's ``cosf`` (XLA lowers ``jnp.cos`` to a call of it); ``torch.cos``
rounds differently in the last bit for some arguments, so
``warmup_cosine`` calls ``cosf`` itself.

``warmup_density`` reproduces the paper's density warmup for sparsified
training: "the first 4 epochs use the dynamic densities
[0.25, 0.0725, 0.015, 0.004]" (Section IV-A) — epoch-indexed density
stairs that back off the compression while weights are still moving fast.
``wsd`` is the minicpm-2b warmup-stable-decay schedule.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch

PAPER_WARMUP_DENSITIES = (0.25, 0.0725, 0.015, 0.004)
PAPER_WARMUP_LRS = (0.1, 0.03, 0.01)

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=_F32)


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = lib.cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def _cos(x: torch.Tensor) -> torch.Tensor:
    """f32 cosine of an f32 scalar by the C library's ``cosf``."""
    return _f32(_libm_cosf()(float(x)))


def constant(lr: float):
    return lambda step: _f32(lr)


def warmup_cosine(lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = _f32(lr) * s / max(1, warmup)
        prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = _f32(lr) * (min_frac + (1 - min_frac) * 0.5
                          * (1 + _cos(_f32(math.pi) * prog)))
        return warm if bool(s < warmup) else cos
    return f


def wsd(lr: float, warmup: int, stable: int, decay: int,
        min_frac: float = 0.1):
    """Warmup-Stable-Decay (minicpm): linear warmup, flat, linear decay."""
    def f(step):
        s = _f32(step)
        if bool(s < warmup):
            return _f32(lr) * s / max(1, warmup)
        if bool(s < warmup + stable):
            return _f32(lr)
        prog = torch.clamp((s - warmup - stable) / max(1, decay), 0.0, 1.0)
        return _f32(lr) * (1.0 - (1.0 - min_frac) * prog)
    return f


def warmup_density(k_final: int, d: int, steps_per_epoch: int,
                   densities=PAPER_WARMUP_DENSITIES):
    """Paper Sec. IV-A: density stairs for the first ``len(densities)`` epochs.

    Returns ``step -> k`` (int32 scalar tensor). After the warmup epochs,
    k = k_final.
    """
    ks = [max(1, int(rho * d)) for rho in densities]

    def f(step):
        epoch = int(step) // max(1, steps_per_epoch)
        k = ks[epoch] if 0 <= epoch < len(ks) else k_final
        return torch.tensor(k, dtype=torch.int32)
    return f


SCHEDULES = {"constant": constant, "warmup_cosine": warmup_cosine, "wsd": wsd}
