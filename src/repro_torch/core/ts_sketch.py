"""TS-sketch: an O(d·R) Count-Sketch variant with structured bucket maps.

Port of ``repro/core/ts_sketch.py``. The sign hash is the multiply-shift
one of the exact sketch; the bucket hash is a per-row digit transpose
with a row offset ``b_r`` (a multiple of W):

    ib          = (i + b_r) mod d_pad
    p_r(i)      = (ib mod m_r) * n_r + ib div m_r   (m_r * n_r = d_pad)
    bucket_r(i) = p_r(i) mod W

``TSketchConfig``'s parameters (``d_pad``, ``log_m``, ``offsets``,
``sign_params``) are drawn from numpy exactly as the reference draws them,
so both packages hash every coordinate to the same buckets and signs.

Arithmetic is uint32 as in the reference, done in int64 masked to 32
bits (``count_sketch._mulmod32``), since PyTorch has no uint32 ops on
the CPU.

``encode`` here is the plain version of the ``kernels.ts_encode`` kernel.
It goes row by row and chunk by chunk with ``index_add_``, so it never
builds the reference's (R, d_pad) sign table or pads ``g`` to ``d_pad``.
Coordinates in [d, d_pad) are zero and add nothing. ``decode`` has no
kernel in either package; it is torch ops, chunked over coordinates.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.count_sketch import _M32, _mulmod32, median_rows

_CHUNK = 1 << 22  # coords per chunk: keeps (R, chunk) int64 transients small


@dataclasses.dataclass(frozen=True)
class TSketchConfig:
    """Static geometry. d must be known to fix the per-row factorizations."""

    d: int
    rows: int = 5
    width: int = 16384
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "width",
                           1 << max(1, (int(self.width) - 1).bit_length()))

    @property
    def log2_width(self) -> int:
        return int(self.width).bit_length() - 1

    @property
    def size(self) -> int:
        return self.rows * self.width

    @property
    def d_pad(self) -> int:
        """Power of two, >= d and >= 2W (so every row has m_r >= 2W)."""
        return max(1 << max(0, (int(self.d) - 1).bit_length()),
                   2 * self.width)

    @property
    def bits(self) -> int:
        """log2(d_pad)."""
        return (self.d_pad - 1).bit_length()

    @functools.cached_property
    def log_m(self) -> tuple[int, ...]:
        """Per-row log2(m_r), spread over [w+1, bits] (row 0 = identity)."""
        bits = self.bits
        lo = min(bits, self.log2_width + 1)
        if self.rows == 1:
            return (bits,)
        return tuple(bits - round(r * (bits - lo) / (self.rows - 1))
                     for r in range(self.rows))

    @functools.cached_property
    def offsets(self) -> tuple[int, ...]:
        """Per-row additive index offsets b_r (multiples of W)."""
        rng = np.random.RandomState(
            np.uint32((self.seed * 40503 + 7) % (2 ** 31)))
        nb = max(1, self.d_pad // self.width)
        return tuple(int(rng.randint(0, nb)) * self.width
                     for _ in range(self.rows))

    @functools.cached_property
    def sign_params(self) -> np.ndarray:
        """(R, 2) uint32 multiply-shift sign parameters [c, d]; c odd."""
        rng = np.random.RandomState(
            np.uint32((self.seed * 2654435761 + 12345) % (2 ** 31)))
        p = rng.randint(0, 2 ** 31, size=(self.rows, 2)).astype(np.uint64)
        p = (p * 2 + rng.randint(0, 2 ** 31, (self.rows, 2)).astype(
            np.uint64)) % (2 ** 32)
        p[:, 0] |= 1
        return p.astype(np.uint32)


def _row_signs(cfg: TSketchConfig, r: int, i: torch.Tensor) -> torch.Tensor:
    c, dd = (int(x) for x in cfg.sign_params[r])
    top = ((_mulmod32(c, i) + dd) & _M32) >> 31
    return 1.0 - 2.0 * top.to(torch.float32)


def _row_buckets(cfg: TSketchConfig, r: int, i: torch.Tensor) -> torch.Tensor:
    a, b = cfg.log_m[r], cfg.offsets[r]
    ib = (i + b) & (cfg.d_pad - 1)
    p = ((ib & ((1 << a) - 1)) << (cfg.bits - a)) + (ib >> a)
    return p & (cfg.width - 1)


def signs_at(cfg: TSketchConfig, idx: torch.Tensor) -> torch.Tensor:
    """(R, *idx.shape) f32 in {-1, +1}: multiply-shift top bit."""
    i = idx.to(torch.int64) & _M32
    return torch.stack([_row_signs(cfg, r, i) for r in range(cfg.rows)])


def buckets_at(cfg: TSketchConfig, idx: torch.Tensor) -> torch.Tensor:
    """(R, *idx.shape) int64 in [0, W): ((ib mod m)*n + ib div m) mod W."""
    i = idx.to(torch.int64) & _M32
    return torch.stack([_row_buckets(cfg, r, i) for r in range(cfg.rows)])


def encode(cfg: TSketchConfig, g: torch.Tensor) -> torch.Tensor:
    """(d,) any float -> (R, W) f32: per row, chunked ``index_add_``."""
    g = g.reshape(-1)
    d = g.shape[0]
    if d > cfg.d_pad:
        raise ValueError(f"g has {d} coordinates; the config covers "
                         f"d_pad = {cfg.d_pad}")
    out = torch.zeros((cfg.rows, cfg.width), dtype=torch.float32,
                      device=g.device)
    for lo in range(0, d, _CHUNK):
        hi = min(d, lo + _CHUNK)
        i = torch.arange(lo, hi, device=g.device)
        gc = g[lo:hi].to(torch.float32)
        for r in range(cfg.rows):
            out[r].index_add_(0, _row_buckets(cfg, r, i),
                              _row_signs(cfg, r, i) * gc)
    return out


def decode(cfg: TSketchConfig, sketch: torch.Tensor,
           d: int | None = None) -> torch.Tensor:
    """(R, W) -> (d,) median-of-rows estimates (chunked over coords)."""
    d = d or cfg.d
    sk = sketch.to(torch.float32)
    out = torch.empty((d,), dtype=torch.float32, device=sk.device)
    for lo in range(0, d, _CHUNK):
        idx = torch.arange(lo, min(d, lo + _CHUNK), device=sk.device)
        est = torch.gather(sk, 1, buckets_at(cfg, idx)) * signs_at(cfg, idx)
        out[lo:lo + idx.shape[0]] = median_rows(est)
    return out


def l2sq_estimate(sketch: torch.Tensor) -> torch.Tensor:
    """Estimate ||g||^2: median over rows of ||row||^2 (0-dim tensor)."""
    return median_rows(torch.sum(sketch.to(torch.float32) ** 2, dim=1))
