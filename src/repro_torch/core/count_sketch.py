"""Count-Sketch: the linear, mergeable gradient-compression structure of gs-SGD.

Port of ``repro/core/count_sketch.py``. A Count-Sketch of ``g in R^d`` is
an ``(R, W)`` table; row ``r`` accumulates ``sign_r(i) * g[i]`` into bucket
``h_r(i)``, with multiply-shift hashes (``W = 2^w``, uint32 wrap-around):

    bucket_r(i) = (a_r * i + b_r) >> (32 - w)
    sign_r(i)   = 1 - 2 * ((c_r * i + d_r) >> 31)

PyTorch has no uint32 arithmetic on the CPU, so hashing runs in int64
masked to 32 bits after every multiply and add; the multiply is split in
16-bit halves so no int64 product overflows. Bucket ids and signs are
bit-identical to the reference's uint32 arithmetic.

Median of R rows: for even R the estimate is the mean of the two middle
values (``jnp.median``'s rule), and NaN if any of the R values is NaN.
``torch.median`` returns the lower middle value instead, so it is never
used here.

These are the plain PyTorch paths; the CUDA kernels live in
``repro_torch.kernels``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Static geometry of a Count-Sketch.

    rows:  number of independent hash rows R (median-of-R estimates).
    width: number of buckets per row W (rounded up to a power of two).
    seed:  seed for the hash family; must be identical on all workers.
    """

    rows: int = 5
    width: int = 16384
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "width", _next_pow2(self.width))

    @property
    def log2_width(self) -> int:
        return int(self.width).bit_length() - 1

    @property
    def size(self) -> int:
        return self.rows * self.width

    @functools.cached_property
    def hash_params(self) -> np.ndarray:
        """(R, 4) uint32 multiply-shift parameters [a, b, c, d]; a, c odd."""
        rng = np.random.RandomState(np.uint32(self.seed * 2654435761 % (2**31)))
        p = rng.randint(0, 2**31, size=(self.rows, 4)).astype(np.uint64)
        p = (p * 2 + rng.randint(0, 2**31, size=(self.rows, 4)).astype(np.uint64)) % (2**32)
        p[:, 0] |= 1
        p[:, 2] |= 1
        return p.astype(np.uint32)

    def hash_tensor(self, device) -> torch.Tensor:
        """``hash_params`` as an (R, 4) int64 tensor on ``device``."""
        return torch.from_numpy(self.hash_params.astype(np.int64)).to(device)


def _mulmod32(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """(a * i) mod 2^32 for a, i in [0, 2^32), without int64 overflow."""
    lo = a * (i & _M16)
    hi = ((a * (i >> 16)) & _M16) << 16
    return (lo + hi) & _M32


def hash_buckets(cfg: SketchConfig, idx: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucket ids and signs for coordinate indices ``idx`` (any shape, int).

    Returns (buckets int64 (R, *idx.shape) in [0, W), signs float32 in
    {-1, +1}). ``idx`` is taken mod 2^32, as the reference's uint32 cast.
    """
    p = cfg.hash_tensor(idx.device)
    i = idx.to(torch.int64) & _M32
    view = (-1,) + (1,) * i.dim()
    a, b, c, d = (p[:, j].reshape(view) for j in range(4))
    shift = 32 - cfg.log2_width
    buckets = ((_mulmod32(a, i) + b) & _M32) >> shift
    top = ((_mulmod32(c, i) + d) & _M32) >> 31
    signs = 1.0 - 2.0 * top.to(torch.float32)
    return buckets, signs


_CHUNK = 1 << 22  # coords per chunk: keeps (R, chunk) int64 transients small


def encode(cfg: SketchConfig, g: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Sketch a vector: (d,) -> (R, W) float32 (``index_add_`` per row).

    ``offset`` hashes ``g[j]`` as coordinate ``offset + j`` — a PARTIAL
    encode of a contiguous slice (sketches of disjoint slices sum to the
    sketch of the whole, by linearity).
    """
    g = g.reshape(-1).to(torch.float32)
    d = g.shape[0]
    out = torch.zeros((cfg.rows, cfg.width), dtype=torch.float32,
                      device=g.device)
    for lo in range(0, d, _CHUNK):
        hi = min(d, lo + _CHUNK)
        idx = torch.arange(lo + int(offset), hi + int(offset),
                           device=g.device)
        buckets, signs = hash_buckets(cfg, idx)
        gc = g[lo:hi]
        for r in range(cfg.rows):
            out[r].index_add_(0, buckets[r], signs[r] * gc)
    return out


def median_rows(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 0; for an even count the mean of the two middles.
    NaN wherever any of the values is NaN, as ``jnp.median`` (``torch.sort``
    puts NaN last, so the sorted middle alone would drop it)."""
    n = x.shape[0]
    srt = torch.sort(x, dim=0).values
    if n % 2 == 1:
        med = srt[n // 2]
    else:
        med = 0.5 * (srt[n // 2 - 1] + srt[n // 2])
    return torch.where(torch.isnan(x).any(0), float("nan"), med)


def decode_at(cfg: SketchConfig, sketch: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """Estimate only the coordinates in ``idx``: -> (len(idx),)."""
    buckets, signs = hash_buckets(cfg, idx)
    est = torch.gather(sketch.to(torch.float32), 1, buckets) * signs
    return median_rows(est)


def decode(cfg: SketchConfig, sketch: torch.Tensor, d: int,
           offset: int = 0) -> torch.Tensor:
    """Median-of-rows estimate of every coordinate: (R, W) -> (d,)."""
    out = torch.empty((d,), dtype=torch.float32, device=sketch.device)
    for lo in range(0, d, _CHUNK):
        hi = min(d, lo + _CHUNK)
        idx = torch.arange(lo + int(offset), hi + int(offset),
                           device=sketch.device)
        out[lo:hi] = decode_at(cfg, sketch, idx)
    return out


def l2sq_estimate(sketch: torch.Tensor) -> torch.Tensor:
    """Estimate ||g||^2: median over rows of ||row||^2 (0-dim tensor)."""
    row_norms = torch.sum(sketch.to(torch.float32) ** 2, dim=1)
    return median_rows(row_norms)


def merge(*sketches: torch.Tensor) -> torch.Tensor:
    """Merge sketches of different vectors: S(a)+S(b) = S(a+b)."""
    out = sketches[0]
    for s in sketches[1:]:
        out = out + s
    return out
