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

The encode is exact (``ExactSketch``): integer fixed-point sums, one
rounding to f32 a cell, so the sketch does not depend on the order of the
adds, and the encode kernel gives the same bits.

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

# Exact encode. Each contribution v = sign_r(i) * g[i] with |v| < 2^31 is
# the fixed-point integer X = sign(v) * floor(|v| * 2^64), held as three
# signed limbs (a, b, c) with |v| ~ a + b * 2^-32 + c * 2^-64: a = floor(|v|),
# b = floor(frac(|v|) * 2^32), c = floor(frac(frac(|v|) * 2^32) * 2^32),
# each computed exactly in f64 from the f32 |v|, all three negated where v
# is negative. Every |v| >= 2^-41 is exact; a smaller one loses under 2^-64
# toward zero. A cell sums each limb in int64 (no limb sum overflows for up
# to 2^31 contributions), and integer addition is associative, so the sums
# are a function of the multiset of contributions alone: the same bits for
# any order, launch geometry or cutting of the vector into fragments. The
# cell's f32 value comes once, from the limb sums normalized (carries
# propagated: b, c in [0, 2^32)), as f32((f64(A) + f64(b) * 2^-32)
# + f64(c) * 2^-64), the order the kernel's finish repeats.
# Non-finite input sets flag bits a cell: NaN in, or both infinities -> NaN
# (as the reference's f32 sum); one infinity -> that infinity; otherwise an
# element with |v| >= 2^31 -> NaN (the reference would sum it; the limbs
# cannot hold it, and a silent wrap is worse).
FLAG_NAN, FLAG_POS_INF, FLAG_NEG_INF, FLAG_BIG = 1, 2, 4, 8
LIMB_LIMIT = 2.0 ** 31
_TWO32 = 4294967296.0


@dataclasses.dataclass
class ExactSketch:
    """A Count-Sketch held exactly, before its conversion to f32.

    ``limbs`` (..., 3, R, W) int64: the (a, b, c) limb sums of every cell;
    ``flags`` (..., R, W) int32: the non-finite flag bits (``FLAG_*``).
    Leading dims are workers. ``a + b`` merges two (the sketch of the
    sum), exactly; ``finish`` (on the card the encode's finish kernel,
    ``kernels.ops.encode_finish``) converts to f32.
    """

    limbs: torch.Tensor
    flags: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.flags.device

    def __add__(self, other: "ExactSketch") -> "ExactSketch":
        return ExactSketch(self.limbs + other.limbs,
                           self.flags | other.flags)

    def worker(self, p: int) -> "ExactSketch":
        """Worker p's accumulator (views: the kernel adds into them)."""
        return ExactSketch(self.limbs[p], self.flags[p])


def exact_zeros(cfg: SketchConfig, lead: tuple = (),
                device="cpu") -> ExactSketch:
    """An empty exact sketch (every limb and flag 0) with leading dims
    ``lead``."""
    lead = tuple(lead)
    return ExactSketch(
        torch.zeros(lead + (3, cfg.rows, cfg.width), dtype=torch.int64,
                    device=device),
        torch.zeros(lead + (cfg.rows, cfg.width), dtype=torch.int32,
                    device=device))


def fixed_point_limbs(g: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """(a, b, c) int64 limbs of |g| (f32 in, any shape) and the mask of
    elements they hold (finite, |g| < 2^31); limbs are 0 elsewhere."""
    x = g.to(torch.float32).abs().to(torch.float64)
    ok = x < LIMB_LIMIT
    x = torch.where(ok, x, torch.zeros_like(x))
    a = torch.floor(x)
    r1 = (x - a) * _TWO32
    b = torch.floor(r1)
    c = torch.floor((r1 - b) * _TWO32)
    return a.to(torch.int64), b.to(torch.int64), c.to(torch.int64), ok


def encode_into(cfg: SketchConfig, g: torch.Tensor, acc: ExactSketch,
                offset: int = 0) -> ExactSketch:
    """Add the contributions of ``g`` (element j hashed as coordinate
    ``offset + j``) into one worker's exact sketch ``acc`` (limbs
    (3, R, W)), in place; returns ``acc``. ``index_add_`` per row and
    limb, in integers."""
    g = g.reshape(-1).to(torch.float32)
    d = g.shape[0]
    for lo in range(0, d, _CHUNK):
        hi = min(d, lo + _CHUNK)
        idx = torch.arange(lo + int(offset), hi + int(offset),
                           device=g.device)
        buckets, signs = hash_buckets(cfg, idx)
        gc = g[lo:hi]
        a, b, c, ok = fixed_point_limbs(gc)
        neg = torch.signbit(gc)
        for r in range(cfg.rows):
            s = torch.where(neg != (signs[r] < 0), -1, 1).to(torch.int64)
            for li, limb in enumerate((a, b, c)):
                acc.limbs[li, r].index_add_(0, buckets[r], s * limb)
        if bool((~ok).any()):
            _flag_into(acc.flags, buckets, signs, gc, ok)
    return acc


def _flag_into(flags: torch.Tensor, buckets: torch.Tensor,
               signs: torch.Tensor, g: torch.Tensor, ok: torch.Tensor):
    """OR the flag bits of the elements that the limbs cannot hold into
    their cells (NaN, +-inf by the sign of v = sign_r * g, |v| >= 2^31)."""
    nan, inf = torch.isnan(g), torch.isinf(g)
    big = ~ok & ~nan & ~inf
    for r in range(flags.shape[0]):
        pos = inf & ((g > 0) == (signs[r] > 0))
        for bit, m in ((FLAG_NAN, nan), (FLAG_POS_INF, pos),
                       (FLAG_NEG_INF, inf & ~pos), (FLAG_BIG, big)):
            if bool(m.any()):
                hit = torch.zeros_like(flags[r])
                hit.index_fill_(0, buckets[r][m], bit)
                flags[r] |= hit


def finish(acc: ExactSketch) -> torch.Tensor:
    """The f32 sketch of an exact one (any leading dims): normalized limb
    sums -> f32((f64(A) + f64(b) * 2^-32) + f64(c) * 2^-64), then the flag
    rules (see ``FLAG_*``)."""
    a, b, c = acc.limbs.unbind(-3)
    b = b + (c >> 32)
    c = c & _M32
    a = a + (b >> 32)
    b = b & _M32
    v = ((a.to(torch.float64) + b.to(torch.float64) * 2.0 ** -32)
         + c.to(torch.float64) * 2.0 ** -64).to(torch.float32)
    f = acc.flags
    pos, neg = (f & FLAG_POS_INF) != 0, (f & FLAG_NEG_INF) != 0
    nan = (((f & FLAG_NAN) != 0) | (pos & neg)
           | (((f & FLAG_BIG) != 0) & ~pos & ~neg))
    v = torch.where(pos, float("inf"), v)
    v = torch.where(neg, float("-inf"), v)
    return torch.where(nan, float("nan"), v)


def encode(cfg: SketchConfig, g: torch.Tensor,
           offset: int = 0) -> torch.Tensor:
    """Sketch a vector: (d,) -> (R, W) float32, exactly (see ``FLAG_*``
    above: integer limb sums, one rounding a cell).

    ``offset`` hashes ``g[j]`` as coordinate ``offset + j`` — a PARTIAL
    encode of a contiguous slice (exact sketches of disjoint slices sum to
    the exact sketch of the whole, bit for bit).
    """
    acc = exact_zeros(cfg, device=g.device)
    return finish(encode_into(cfg, g, acc, offset))


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


# ---------------------------------------------------------------------------
# Convenience: sketch a tree of tensors by raveling it into one flat vector.
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples, in the reference's
    (``jax.tree_util.tree_leaves``) order: a dict's entries by sorted key,
    a sequence's in order. The hashes read coordinate indices, so the
    flat vector must follow exactly this order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken from iterator ``leaves``
    in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        out = {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
        return {key: out[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def ravel_tree(tree) -> tuple[torch.Tensor, tuple]:
    """Flatten a tree of tensors into one f32 vector + its unravel info
    (the tree's structure, and each leaf's shape and dtype)."""
    leaves = tree_leaves(tree)
    flat = torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])
    skeleton = _rebuild(tree, iter([None] * len(leaves)))
    return flat, (skeleton, [(tuple(x.shape), x.dtype) for x in leaves])


def unravel_tree(flat: torch.Tensor, info: tuple):
    """The tree of ``ravel_tree``'s info with its leaves cut from ``flat``
    (views of it where the dtype is f32)."""
    tree, shapes = info
    leaves, off = [], 0
    for shape, dtype in shapes:
        n = int(np.prod(shape)) if shape else 1
        leaves.append(flat[off:off + n].reshape(shape).to(dtype))
        off += n
    return _rebuild(tree, iter(leaves))
