"""Gradient compressors: gs-SGD (the paper) and the dense baseline.

Port of ``repro/core/compression.py`` (the gs-SGD part). One contract:

    state              = compressor.init(d, nworkers, device)
    upd_sum, state, nfo = compressor.step(state, g, nworkers=P)

The reference runs each worker under ``jax.vmap(..., axis_name=...)``;
here every per-worker tensor carries the worker axis first: ``g`` and the
error-feedback state are (P, d), and ``upd_sum`` is (P, d), the SUM over
workers of the applied update as each worker holds it (caller divides by
P). Collectives are the worker-axis reductions of ``core.allreduce``.

Recovery goes through ``kernels.ops.heavymix_recover`` — the HEAVYMIX
scoring kernel and a top-k with the reference's tie order — where the
reference calls the pure-jnp ``heavymix.heavymix``; the two select the
same indices in the same order, below and above the reference's chunked
threshold d > 2^22 (pinned in tests/test_torch_compression.py and
tests/test_torch_kernels.py).

Baselines (topk, gtopk, sketched-sgd, fetchsgd, signsgd, powersgd) are
left to a later slice.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any

import torch

from repro_torch.core import allreduce as ar
from repro_torch.core import count_sketch as cs
from repro_torch.core import error_feedback as ef
from repro_torch.kernels import ops as kops

_F32 = 4  # wire bytes per float32
_I32 = 4


@dataclasses.dataclass(frozen=True)
class CommStats:
    """Per-worker communication volume of one aggregation step."""

    bytes_out: float  # payload bytes this worker injects into the network
    rounds: int       # latency term: sequential communication rounds
    label: str = ""

    def time(self, alpha: float, beta: float) -> float:
        """Paper Eq.1 cost model: rounds*alpha + bytes*beta."""
        return self.rounds * alpha + self.bytes_out * beta


def _ring_allreduce_bytes(nbytes: float, p: int) -> float:
    """Bandwidth-optimal all-reduce: 2*(P-1)/P of the payload per worker."""
    return 2.0 * (p - 1) / p * nbytes


def _scatter(d: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(P, k) indices and values -> (P, d) dense rows, zeros elsewhere."""
    out = torch.zeros(idx.shape[:-1] + (d,), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_(-1, idx, vals.to(torch.float32))


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DenseAllReduce:
    """No compression — the classic synchronous data-parallel baseline."""

    name: str = "dense"

    def init(self, d: int, nworkers: int = 1, device="cpu") -> Any:
        return ()

    def comm_stats(self, d: int, nworkers: int) -> CommStats:
        return CommStats(_ring_allreduce_bytes(d * _F32, nworkers),
                         rounds=2 * (nworkers - 1), label=self.name)

    def step(self, state, g: torch.Tensor, *, nworkers: int):
        upd = ar.psum_allreduce(g.to(torch.float32))
        return upd, state, self.comm_stats(g.shape[-1], nworkers)


@dataclasses.dataclass(frozen=True)
class _SketchBased:
    k: int = 1024
    sketch: cs.SketchConfig = cs.SketchConfig()
    name: str = "sketch-base"

    def init(self, d: int, nworkers: int = 1, device="cpu") -> torch.Tensor:
        return ef.init(d, nworkers, device=device)

    def _encode(self, u: torch.Tensor) -> torch.Tensor:
        """One worker's (d,) vector -> its (R, W) f32 sketch."""
        return kops.encode(self.sketch, u)

    def _recover(self, sketch_sum: torch.Tensor, u: torch.Tensor, d: int, *,
                 include: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None):
        """HEAVYMIX + exact second round. Returns (upd_sum (P, d), idx (P, k)).

        Every worker recovers from its own copy of the summed sketch (the
        copies are identical, so every worker selects the same indices).
        include/scale: straggler-drop support, as in the reference.
        """
        idx = torch.stack([kops.heavymix_recover(self.sketch, sketch_sum[p],
                                                 self.k, d)[0]
                           for p in range(u.shape[0])])
        vals = torch.gather(u, -1, idx)
        if include is not None:
            vals = vals * include[:, None]
        vals = ar.psum_allreduce(vals)  # second round (Alg.2 line 4): k floats
        if scale is not None:
            vals = vals * scale[:, None]
        return _scatter(d, idx, vals), idx


@dataclasses.dataclass(frozen=True)
class GsSGD(_SketchBased):
    """THE PAPER: global-sketching SGD.

    Sketch locally, all-reduce the (linear, mergeable) sketches, recover
    Top-k via HEAVYMIX from the identical summed sketch on every worker,
    fetch exact values with a k-float second round.

    allreduce_mode: 'psum' | 'tree' (faithful Alg. 1).
    wire_dtype:     sketch dtype on the wire.
    """

    allreduce_mode: str = "psum"
    wire_dtype: torch.dtype = torch.float32
    name: str = "gs-sgd"

    def stage_encode(self, acc: torch.Tensor, g: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Stage 1 (compute): EF add + each worker's Count-Sketch encode."""
        u = ef.add(acc, g)
        sk = torch.stack([self._encode(u[p]) for p in range(u.shape[0])])
        return u, sk.to(self.wire_dtype)

    def stage_reduce(self, sk: torch.Tensor, *, nworkers: int,
                     include: torch.Tensor | None = None):
        """Stage 2 (communication): merge the sketches over workers.

        include: (P,) bool straggler mask; an excluded worker's sketch
        contributes zero and the P/live rescale is returned (None without
        a mask).
        """
        scale = None
        if include is not None:
            inc = include.to(torch.float32)
            live = ar.psum_allreduce(inc)
            scale = nworkers / torch.clamp(live, min=1.0)
            sk = sk * inc.to(sk.dtype).reshape(-1, 1, 1)
        sk_sum = ar.allreduce(sk, nworkers,
                              mode=self.allreduce_mode).to(torch.float32)
        return sk_sum, scale

    def stage_recover(self, u: torch.Tensor, sk_sum: torch.Tensor, scale, *,
                      nworkers: int, include: torch.Tensor | None = None):
        """Stage 3: HEAVYMIX + exact second round + EF residual update.

        Without a straggler mask the residual zeroes ``u`` in place (``u``
        is dead afterwards); with one, dropped workers keep all of ``u``.
        """
        d = u.shape[-1]
        inc = include.to(torch.float32) if include is not None else None
        upd, idx = self._recover(sk_sum, u, d, include=inc, scale=scale)
        if include is None:
            acc = ef.residual_global(u, idx, inplace=True)
        else:
            acc = torch.where(inc[:, None] > 0, ef.residual_global(u, idx), u)
        return upd, acc, self.comm_stats(d, nworkers)

    def comm_stats(self, d: int, nworkers: int) -> CommStats:
        """Static wire model of one step."""
        wire = torch.empty((), dtype=self.wire_dtype).element_size()
        if self.allreduce_mode == "tree":
            rounds = ar.tree_allreduce_rounds(nworkers)
            sk_bytes = rounds * self.sketch.size * wire
        else:
            rounds = 2 * (nworkers - 1)
            sk_bytes = _ring_allreduce_bytes(self.sketch.size * wire, nworkers)
        return CommStats(sk_bytes + self.k * _F32, rounds=rounds + 2,
                         label=self.name)

    def step(self, acc: torch.Tensor, g: torch.Tensor, *, nworkers: int,
             include: torch.Tensor | None = None):
        u, sk = self.stage_encode(acc, g)
        sk_sum, scale = self.stage_reduce(sk, nworkers=nworkers,
                                          include=include)
        return self.stage_recover(u, sk_sum, scale, nworkers=nworkers,
                                  include=include)


# ---------------------------------------------------------------------------
# Bucketed compression (comm/compute-overlap pipeline)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static contiguous partition of a flat d-vector."""

    sizes: tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.sizes)

    @property
    def total(self) -> int:
        return sum(self.sizes)

    @property
    def offsets(self) -> tuple[int, ...]:
        out, off = [], 0
        for s in self.sizes:
            out.append(off)
            off += s
        return tuple(out)

    def split(self, g: torch.Tensor) -> list[torch.Tensor]:
        """Views of the buckets along the last (coordinate) axis."""
        return [g[..., o:o + s] for o, s in zip(self.offsets, self.sizes)]

    def join(self, parts) -> torch.Tensor:
        return torch.cat(list(parts), dim=-1)


def even_bucket_sizes(d: int, n: int) -> tuple[int, ...]:
    """~Equal split for callers without FlatSpec boundaries."""
    n = max(1, min(int(n), int(d)))
    base, rem = divmod(int(d), n)
    return tuple(base + (1 if i < rem else 0) for i in range(n))


@dataclasses.dataclass(frozen=True)
class BucketedCommStats:
    """Per-bucket CommStats plus the aggregate view."""

    per_bucket: tuple[CommStats, ...]
    label: str = "bucketed"

    @property
    def bytes_out(self) -> float:
        return sum(s.bytes_out for s in self.per_bucket)

    @property
    def rounds(self) -> int:
        return sum(s.rounds for s in self.per_bucket)

    def time(self, alpha: float, beta: float) -> float:
        return sum(s.time(alpha, beta) for s in self.per_bucket)


_MIN_BUCKET_WIDTH = 256  # smallest usable sketch row (pow2)


def _scale_bucket(base, d_bucket: int, d_total: int, i: int):
    """Per-bucket compressor: k and sketch width scaled by the bucket's
    share of coordinates (k >= 1; width the power-of-two floor of its
    share, >= 256); per-bucket hash seed ``seed + i``."""
    frac = d_bucket / d_total
    out = base
    if hasattr(base, "k"):
        out = dataclasses.replace(
            out, k=max(1, min(d_bucket, round(base.k * frac))))
    if isinstance(base, _SketchBased):
        share = max(1.0, base.sketch.width * frac)
        width = 1 << int(math.floor(math.log2(share)))
        width = min(base.sketch.width, max(_MIN_BUCKET_WIDTH, width))
        sk = dataclasses.replace(base.sketch, width=width,
                                 seed=base.sketch.seed + i)
        out = dataclasses.replace(out, sketch=sk)
    return out


@dataclasses.dataclass(frozen=True)
class BucketedCompressor:
    """Base-compressor contract over a bucket partition (one EF state per
    bucket; ``step`` runs the buckets back-to-back)."""

    base: Any
    spec: BucketSpec
    parts: tuple[Any, ...]
    name: str = "bucketed"

    def _check(self, d: int) -> None:
        if d != self.spec.total:
            raise ValueError(
                f"gradient dimension {d} does not match the bucket "
                f"partition total {self.spec.total}")

    def init(self, d: int, nworkers: int = 1, device="cpu"):
        self._check(d)
        return tuple(c.init(s, nworkers, device)
                     for c, s in zip(self.parts, self.spec.sizes))

    def comm_stats(self, d: int, nworkers: int) -> BucketedCommStats:
        self._check(d)
        return BucketedCommStats(
            tuple(c.comm_stats(s, nworkers)
                  for c, s in zip(self.parts, self.spec.sizes)),
            label=self.name)

    def step(self, state, g: torch.Tensor, *, nworkers: int,
             include: torch.Tensor | None = None):
        kw = {}
        if include is not None and "include" in inspect.signature(
                type(self.base).step).parameters:
            kw["include"] = include  # dense ignores the straggler mask
        upds, news, stats = [], [], []
        for c, st, gb in zip(self.parts, state, self.spec.split(g)):
            u, s, nfo = c.step(st, gb, nworkers=nworkers, **kw)
            upds.append(u)
            news.append(s)
            stats.append(nfo)
        return (self.spec.join(upds), tuple(news),
                BucketedCommStats(tuple(stats), label=self.name))


def bucketize(base, sizes) -> BucketedCompressor:
    """Wrap ``base`` over contiguous buckets of the given sizes (a single
    bucket reuses ``base`` unchanged)."""
    spec = BucketSpec(tuple(int(s) for s in sizes))
    if spec.n == 1:
        parts: tuple[Any, ...] = (base,)
    else:
        parts = tuple(_scale_bucket(base, db, spec.total, i)
                      for i, db in enumerate(spec.sizes))
    return BucketedCompressor(base=base, spec=spec, parts=parts,
                              name=f"bucketed[{spec.n}]({base.name})")


def static_comm_stats(compressor, d: int, nworkers: int):
    """Wire model of one aggregation step without running it."""
    if compressor is None:
        return DenseAllReduce().comm_stats(d, nworkers)
    return compressor.comm_stats(d, nworkers)


REGISTRY = {
    "dense": DenseAllReduce,
    "gs-sgd": GsSGD,
}


def make(name: str, **kw) -> Any:
    """Build a compressor by name; sketch geometry via rows/width/seed kw."""
    if name not in REGISTRY:
        raise KeyError(f"compressor {name!r} is not ported yet; "
                       f"ported: {sorted(REGISTRY)}")
    cls = REGISTRY[name]
    if name == "gs-sgd":
        sk = cs.SketchConfig(rows=kw.pop("rows", 5),
                             width=kw.pop("width", 16384),
                             seed=kw.pop("seed", 0))
        return cls(sketch=sk, **kw)
    for geo in ("rows", "width", "seed", "k"):
        kw.pop(geo, None)
    return cls(**kw)
