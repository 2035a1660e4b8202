"""Plain Count-Sketch and HEAVYMIX arithmetic for the reference.

A frozen copy of the published hash family and median rule, written
again in plain PyTorch and NumPy (nothing of the program is imported):

    bucket_r(i) = (a_r * i + b_r mod 2^32) >> (32 - log2 W)
    sign_r(i)   = 1 - 2 * ((c_r * i + d_r mod 2^32) >> 31)

with (a, b, c, d) drawn per row from NumPy's RandomState seeded by
``seed * 2654435761 mod 2^31`` (a, c odd). A bucket of the exchange
hashes its own coordinates from 0 with its own seed.

The encode sums in float64 and rounds each cell to float32 once. The
estimate of a coordinate is the median over the R rows of its signed
cells (R odd). HEAVYMIX's greedy fill takes the heavy coordinates
(estimate^2 >= ||g||^2 / k, ||g||^2 the median of the rows' sums of
squares) and fills up to k with the next largest |estimate|, ties taken
at the lowest index (``heavymix`` says how that reads in float32).
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
CHUNK = 1 << 22


def hash_params(seed: int, rows: int) -> np.ndarray:
    """(rows, 4) uint32 multiply-shift parameters [a, b, c, d]."""
    rng = np.random.RandomState(np.uint32(seed * 2654435761 % (2 ** 31)))
    p = rng.randint(0, 2 ** 31, size=(rows, 4)).astype(np.uint64)
    p = (p * 2 + rng.randint(0, 2 ** 31, size=(rows, 4))
         .astype(np.uint64)) % (2 ** 32)
    p[:, 0] |= 1
    p[:, 2] |= 1
    return p.astype(np.uint32)


def _mulmod32(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    # a * i mod 2^32 in int64 without overflow: split i in 16-bit halves
    lo = a * (i & _M16)
    hi = ((a * (i >> 16)) & _M16) << 16
    return (lo + hi) & _M32


class Sketch:
    """The hash family of one bucket: R rows of W = 2^w cells."""

    def __init__(self, rows: int, width: int, seed: int, device):
        if width & (width - 1):
            raise ValueError(f"sketch width {width} is not a power of two")
        self.rows, self.width = int(rows), int(width)
        self.shift = 32 - (self.width.bit_length() - 1)
        p = torch.from_numpy(hash_params(int(seed), self.rows)
                             .astype(np.int64)).to(device)
        self.a, self.b, self.c, self.d = (p[:, j:j + 1] for j in range(4))

    def cells(self, lo: int, hi: int, device):
        """Bucket ids (R, n) int64 and signs (R, n) f32 of coordinates
        lo..hi-1."""
        i = torch.arange(lo, hi, device=device, dtype=torch.int64)[None]
        bucket = ((_mulmod32(self.a, i) + self.b) & _M32) >> self.shift
        top = ((_mulmod32(self.c, i) + self.d) & _M32) >> 31
        return bucket, 1.0 - 2.0 * top.to(torch.float32)

    def encode(self, u: torch.Tensor) -> torch.Tensor:
        """(n,) f32 -> (R, W) f32 sketch, summed in float64."""
        acc = torch.zeros((self.rows * self.width,), dtype=torch.float64,
                          device=u.device)
        rows = (torch.arange(self.rows, device=u.device)
                * self.width)[:, None]
        for lo in range(0, u.shape[0], CHUNK):
            hi = min(u.shape[0], lo + CHUNK)
            bucket, sign = self.cells(lo, hi, u.device)
            vals = (sign * u[lo:hi][None]).to(torch.float64)
            acc.index_add_(0, (bucket + rows).reshape(-1), vals.reshape(-1))
        return acc.to(torch.float32).reshape(self.rows, self.width)

    def estimates(self, sk: torch.Tensor, n: int) -> torch.Tensor:
        """The median estimate of every coordinate 0..n-1: (n,) f32."""
        out = torch.empty((n,), dtype=torch.float32, device=sk.device)
        for lo in range(0, n, CHUNK):
            hi = min(n, lo + CHUNK)
            bucket, sign = self.cells(lo, hi, sk.device)
            est = torch.gather(sk, 1, bucket) * sign
            out[lo:hi] = torch.sort(est, dim=0).values[self.rows // 2]
        return out


def topk_lowest_index(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of ``score``, ties at the k-th
    value taken from the lowest index up (unordered)."""
    kth = torch.topk(score, k, sorted=False).values.min()
    above = torch.nonzero(score > kth).reshape(-1)
    ties = torch.nonzero(score == kth).reshape(-1)[:k - above.numel()]
    return torch.cat([above, ties])


def heavymix(sk: torch.Tensor, sketch: Sketch, k: int, n: int
             ) -> torch.Tensor:
    """HEAVYMIX with the greedy fill over the summed sketch ``sk``: the k
    indices of the bucket's n coordinates to fetch exactly.

    A heavy coordinate scores |estimate| + 1e30 in float32, which is
    1e30 for every estimate below 1e22: so when the heavy set outnumbers
    k, its lowest-index members win. Above 2^22 coordinates (and 4k) the
    published algorithm selects hierarchically, per chunk of 2^22 and
    then over the chunks' winners, by |estimate| alone: the k largest
    |estimate| whatever the heavy set's size."""
    est = sketch.estimates(sk, n)
    score = est.abs()
    if not (n > CHUNK and n > 4 * k):
        l2sq = torch.sort(torch.sum(sk * sk, dim=1)).values[sketch.rows // 2]
        score = torch.where(est * est >= l2sq / k, score + 1e30, score)
    return topk_lowest_index(score, k)
