"""Gradient compressors: gs-SGD (the paper) and every baseline it compares to.

Port of ``repro/core/compression.py``. One contract:

    state              = compressor.init(d, nworkers, device)
    upd_sum, state, nfo = compressor.step(state, g, nworkers=P)

The reference runs each worker under ``jax.vmap(..., axis_name=...)``;
here every per-worker tensor carries the worker axis first: ``g`` and the
error-feedback state are (P, d), sketch states (P, R, W), and ``upd_sum``
is (P, d), the SUM over workers of the applied update as each worker holds
it (caller divides by P). Collectives are the worker-axis reductions of
``core.allreduce``; ``jax.lax.top_k`` is ``heavymix.topk_lower_index``
(the same lower-index tie order), per worker.

Compressors: ``DenseAllReduce``, ``TopKCompressor``, ``GTopK``,
``SketchedSGD``, ``GsSGD`` (the paper), ``FetchSGDStyle``, ``SignSGD``,
``PowerSGD``.

Spans (cat ``detail``, ``obs/trace.py``): gs-SGD's error-feedback add
(``ef/add``) and residual (``ef/residual``), and the exact values' round
of every sketch-based compressor (``values/round``: the gather, the
k-float sum, the scale and the scatter to dense rows).

Recovery from an exact sketch goes through ``kernels.ops.heavymix_recover``
(the decode or scores kernel and a top-k with the reference's tie order)
where the reference calls the pure-jnp ``heavymix.heavymix``; the two
select the same indices in the same order, below and above the
reference's chunked threshold d > 2^22 (pinned in
tests/test_torch_compression.py and tests/test_torch_kernels.py).
``encoder="ts"`` sketches with ``kernels.ts_encode`` and recovers through
``kernels.ops.ts_heavymix_recover`` (the TS-map scores kernel and the same
select), which selects what the reference's ``heavymix(...,
estimates=ts.decode(...))`` selects.
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
from repro_torch.core import ts_sketch as ts
from repro_torch.core.heavymix import draw_filler, topk_lower_index
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ts_encode import ts_encode
from repro_torch.obs import trace as obtrace

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


def _topk_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each worker's ``jax.lax.top_k(|x_p|, k)`` indices: (P, d) -> (P, k)."""
    return torch.stack([topk_lower_index(x[p].abs(), k)[1]
                        for p in range(x.shape[0])])


def _sparsify(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep each worker's k largest-magnitude coordinates of (P, d) ``x``."""
    idx = _topk_rows(x, k)
    return _scatter(x.shape[-1], idx, torch.gather(x, -1, idx))


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
class TopKCompressor:
    """Local Top-k with centralized (PS-style) aggregation + error feedback.

    The PS inbox is a sum over workers of the k-sparse local selections;
    the wire model is the PS up/down link (k values + k indices a worker).
    """

    k: int
    name: str = "topk"

    def init(self, d: int, nworkers: int = 1, device="cpu") -> torch.Tensor:
        return ef.init(d, nworkers, device=device)

    def comm_stats(self, d: int, nworkers: int) -> CommStats:
        return CommStats(2 * self.k * (_F32 + _I32), rounds=2,
                         label=self.name)

    def step(self, acc: torch.Tensor, g: torch.Tensor, *, nworkers: int):
        u = ef.add(acc, g)
        local = _sparsify(u, self.k)
        upd = ar.psum_allreduce(local)
        return upd, ef.residual_dense(u, local), self.comm_stats(
            u.shape[-1], nworkers)


@dataclasses.dataclass(frozen=True)
class GTopK:
    """gTop-k [23]: tree merge keeping only k survivors a hop (Alg. 1's
    reduce schedule), then the survivors broadcast back down the tree."""

    k: int
    name: str = "gtopk"

    def init(self, d: int, nworkers: int = 1, device="cpu") -> torch.Tensor:
        return ef.init(d, nworkers, device=device)

    def comm_stats(self, d: int, nworkers: int) -> CommStats:
        rounds = ar.tree_allreduce_rounds(nworkers)
        return CommStats(rounds * self.k * (_F32 + _I32), rounds=rounds,
                         label=self.name)

    def step(self, acc: torch.Tensor, g: torch.Tensor, *, nworkers: int):
        u = ef.add(acc, g)
        s = _sparsify(u, self.k)
        sched = ar.reduce_schedule(nworkers)
        for pairs in sched:  # recursive halving; merged set re-sparsified
            received, mask = ar.masked_permute(s, pairs, nworkers)
            merged = s + torch.where(mask, received,
                                     torch.zeros_like(received))
            s = torch.where(mask, _sparsify(merged, self.k), s)
        for pairs in reversed(sched):  # broadcast the survivors back
            back = [(dst, src) for (src, dst) in pairs]
            received, mask = ar.masked_permute(s, back, nworkers)
            s = torch.where(mask, received, s)
        # EF: zero the globally surviving coordinates in u.
        acc = ef.residual_global(u, _topk_rows(s, self.k), inplace=True)
        return s, acc, self.comm_stats(u.shape[-1], nworkers)


@dataclasses.dataclass(frozen=True)
class _SketchBased:
    """faithful_heavymix: HEAVYMIX's random fill (Alg. 2) in place of the
    greedy one, its priorities drawn by ``heavymix.draw_filler`` (a
    generator seeded 0). The reference's train step passes no key, so
    every recovery draws the same filler for its d, as here."""

    k: int = 1024
    sketch: cs.SketchConfig = cs.SketchConfig()
    faithful_heavymix: bool = False
    encoder: str = "exact"  # 'exact' (multiply-shift) | 'ts' (TS-sketch)
    name: str = "sketch-base"

    def init(self, d: int, nworkers: int = 1, device="cpu") -> torch.Tensor:
        return ef.init(d, nworkers, device=device)

    def _ts_cfg(self, d: int) -> ts.TSketchConfig:
        return ts.TSketchConfig(d=d, rows=self.sketch.rows,
                                width=self.sketch.width,
                                seed=self.sketch.seed)

    def _encode(self, u: torch.Tensor) -> torch.Tensor:
        """One worker's (d,) vector -> its (R, W) f32 sketch."""
        if self.encoder == "ts":
            return ts_encode(self._ts_cfg(u.shape[-1]), u)
        return kops.encode(self.sketch, u)

    def _encode_workers(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's (d,) row of (P, d) ``x`` -> (P, R, W) sketches."""
        return torch.stack([self._encode(x[p]) for p in range(x.shape[0])])

    def _filler(self, d: int, device) -> torch.Tensor | None:
        """The faithful fill's priorities for d coordinates, else None."""
        return draw_filler(d, device) if self.faithful_heavymix else None

    def _select(self, sketch_sum: torch.Tensor, d: int,
                filler: torch.Tensor | None = None) -> torch.Tensor:
        """HEAVYMIX's k indices from one worker's copy of the summed
        sketch (the TS route recovers from the TS decode's estimates)."""
        if self.encoder == "ts":
            return kops.ts_heavymix_recover(self._ts_cfg(d), sketch_sum,
                                            self.k, d, filler=filler)[0]
        return kops.heavymix_recover(self.sketch, sketch_sum, self.k, d,
                                     filler=filler)[0]

    def _recover(self, sketch_sum: torch.Tensor, u: torch.Tensor, d: int, *,
                 include: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None):
        """HEAVYMIX + exact second round. Returns (upd_sum (P, d), idx (P, k)).

        Every worker recovers from its own copy of the summed sketch (the
        copies are identical, so every worker selects the same indices).
        include/scale: straggler-drop support, as in the reference.
        """
        filler = self._filler(d, u.device)
        idx = torch.stack([self._select(sketch_sum[p], d, filler)
                           for p in range(u.shape[0])])
        with obtrace.current().span("values/round", cat="detail"):
            vals = torch.gather(u, -1, idx)
            if include is not None:
                vals = vals * include[:, None]
            # second round (Alg.2 line 4): k floats
            vals = ar.psum_allreduce(vals)
            if scale is not None:
                vals = vals * scale[:, None]
            return _scatter(d, idx, vals), idx


@dataclasses.dataclass(frozen=True)
class SketchedSGD(_SketchBased):
    """Sketched-SGD [22]: PS aggregation of sketches — O(log d * P) comm.

    The PS inbox (every worker's sketch arriving at one place) is the
    reference's all_gather + sum: here a sum over the worker axis.
    """

    name: str = "sketched-sgd"

    def comm_stats(self, d: int, nworkers: int) -> CommStats:
        sk_bytes = self.sketch.size * _F32
        return CommStats(sk_bytes * nworkers + self.k * _F32,
                         rounds=nworkers, label=self.name)

    def step(self, acc: torch.Tensor, g: torch.Tensor, *, nworkers: int):
        u = ef.add(acc, g)
        d = u.shape[-1]
        upd, idx = self._recover(ar.psum_allreduce(self._encode_workers(u)),
                                 u, d)
        acc = ef.residual_global(u, idx, inplace=True)
        return upd, acc, self.comm_stats(d, nworkers)


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
        with obtrace.current().span("ef/add", cat="detail"):
            u = ef.add(acc, g)
        return u, self._encode_workers(u).to(self.wire_dtype)

    # The fused encode of the backward interleave: stage 1 split into
    # per-fragment partial encodes, so each backward chunk's gradient is
    # sketched the moment it is emitted. It rests on two linearities: the
    # EF add is elementwise (slicing commutes with it exactly), and with
    # offset hashing the partial sketches of a tiling sum to the whole
    # bucket's sketch. The partials stay exact (integer limb sums,
    # ``cs.ExactSketch``) until the merge converts once, so the fused
    # sketch is bit-equal to the whole-bucket encode of the same u.

    @property
    def can_fuse(self) -> bool:
        """Fragment-wise encode available? The TS encoder's map has no
        offset form: only the exact multiply-shift encoder fuses."""
        return self.encoder == "exact"

    def stage_encode_partial(self, acc_piece: torch.Tensor,
                             g_piece: torch.Tensor, offset: int
                             ) -> tuple[torch.Tensor, cs.ExactSketch]:
        """Stage 1, one fragment: EF add + each worker's partial encode of
        the bucket slice [offset, offset + n) of (P, n) ``g_piece``.
        Returns (u_piece (P, n), the exact partial sketches, P x (R, W)
        f32 sketches held as integer limb sums)."""
        with obtrace.current().span("ef/add", cat="detail"):
            u_piece = ef.add(acc_piece, g_piece)
        sk = cs.exact_zeros(self.sketch, (u_piece.shape[0],),
                            device=u_piece.device)
        for p in range(u_piece.shape[0]):
            kops.encode_into(self.sketch, u_piece[p], sk.worker(p),
                             offset=int(offset))
        return u_piece, sk

    def stage_encode_merge(self, pieces) -> tuple[torch.Tensor, torch.Tensor]:
        """Assemble fragments into the bucket's (u, wire sketch).

        ``pieces``: [(offset, u_piece, exact partial sketch)] tiling the
        bucket from 0 (any order). The partials are summed exactly and
        converted once (``kops.encode_finish``), then cast to
        ``wire_dtype``, as ``stage_encode`` encodes then casts: bit-equal
        to it. Raises on a gap or an overlap.
        """
        pieces = sorted(pieces, key=lambda p: p[0])
        off = 0
        for o, u_piece, _ in pieces:
            if int(o) != off:
                raise ValueError(
                    "fused encode fragments do not tile the bucket: "
                    f"expected offset {off}, got {int(o)}")
            off += u_piece.shape[-1]
        u = (pieces[0][1] if len(pieces) == 1
             else torch.cat([p[1] for p in pieces], dim=-1))
        sk = pieces[0][2]
        for _, _, part in pieces[1:]:
            sk = sk + part
        return u, kops.encode_finish(sk).to(self.wire_dtype)

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
        with obtrace.current().span("ef/residual", cat="detail"):
            if include is None:
                acc = ef.residual_global(u, idx, inplace=True)
            else:
                acc = torch.where(inc[:, None] > 0,
                                  ef.residual_global(u, idx), u)
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


@dataclasses.dataclass(frozen=True)
class FetchSGDStyle(_SketchBased):
    """Sketch-space EF + momentum (FetchSGD [36]).

    State is TWO (P, R, W) sketches (momentum + error), independent of d.
    No exact second round: applied values are the sketch estimates, and
    the error sketch subtracts the sketch of the applied update. Run it
    under an optimizer without its own momentum.
    """

    momentum: float = 0.9
    name: str = "fetchsgd"

    def init(self, d: int, nworkers: int = 1, device="cpu"):
        z = torch.zeros((nworkers, self.sketch.rows, self.sketch.width),
                        dtype=torch.float32, device=device)
        return (z, torch.zeros_like(z))  # (momentum sketch, error sketch)

    def comm_stats(self, d: int, nworkers: int) -> CommStats:
        return CommStats(
            _ring_allreduce_bytes(self.sketch.size * _F32, nworkers),
            rounds=2 * (nworkers - 1), label=self.name)

    def step(self, state, g: torch.Tensor, *, nworkers: int):
        s_m, s_e = state
        p_n, d = g.shape
        sk = ar.psum_allreduce(self._encode_workers(g))  # merged grad sketch
        s_m = self.momentum * s_m + sk                 # momentum in-sketch
        s_e = s_e + s_m                                # error accumulation
        rec = [kops.heavymix_recover(self.sketch, s_e[p], self.k, d)
               for p in range(p_n)]
        upd = _scatter(d, torch.stack([i for i, _ in rec]),
                       torch.stack([e for _, e in rec]))
        s_e = s_e - self._encode_workers(upd)          # subtract applied
        return upd, (s_m, s_e), self.comm_stats(d, nworkers)


@dataclasses.dataclass(frozen=True)
class SignSGD:
    """1-bit SGD with error feedback: sign(u) times one scale (mean |u|)
    a worker; EF keeps the quantization residual."""

    name: str = "signsgd"

    def init(self, d: int, nworkers: int = 1, device="cpu") -> torch.Tensor:
        return ef.init(d, nworkers, device=device)

    def comm_stats(self, d: int, nworkers: int) -> CommStats:
        return CommStats(
            _ring_allreduce_bytes(d / 8 + _F32, nworkers),
            rounds=2 * (nworkers - 1), label=self.name)

    def step(self, acc: torch.Tensor, g: torch.Tensor, *, nworkers: int):
        u = ef.add(acc, g)
        local = torch.sign(u) * u.abs().mean(dim=-1, keepdim=True)
        upd = ar.psum_allreduce(local)
        return upd, ef.residual_dense(u, local), self.comm_stats(
            g.shape[-1], nworkers)


def _powersgd_cols(d: int) -> int:
    """n of init's near-square (m0, n) split of a flat d-vector."""
    m0 = 1 << ((d - 1).bit_length() + 1) // 2
    return (d + m0 - 1) // m0


@dataclasses.dataclass(frozen=True)
class PowerSGD:
    """Rank-r low-rank compression with EF: the flat gradient as a
    near-square (m, n) matrix, one power iteration (P = M Q, orthonormalize
    after the sum, Q' = M^T P), two small all-reduces of r*(m+n) floats.

    ``q`` starts as standard normals from a ``torch.Generator`` seeded with
    ``seed`` (the reference draws it from ``jax.random``: other numbers).
    """

    rank: int = 4
    seed: int = 0
    name: str = "powersgd"

    def init(self, d: int, nworkers: int = 1, device="cpu"):
        n = _powersgd_cols(d)
        q = torch.randn((n, self.rank), dtype=torch.float32,
                        generator=torch.Generator().manual_seed(self.seed))
        q = q.to(device).expand(nworkers, n, self.rank).clone()
        return (ef.init(d, nworkers, device=device), q)

    def comm_stats(self, d: int, nworkers: int) -> CommStats:
        n = _powersgd_cols(d)
        m = (d + n - 1) // n                           # step's matricization
        return CommStats(
            _ring_allreduce_bytes(self.rank * (m + n) * _F32, nworkers),
            rounds=4 * (nworkers - 1), label=self.name)

    def step(self, state, g: torch.Tensor, *, nworkers: int):
        acc, q = state
        u = ef.add(acc, g)
        p_n, d = u.shape
        n = q.shape[-2]
        m = (d + n - 1) // n
        mat = torch.nn.functional.pad(u, (0, m * n - d)).reshape(p_n, m, n)
        mat_t = mat.transpose(-1, -2)
        p = ar.psum_allreduce(mat @ q)                 # (P, m, r)
        p, _ = torch.linalg.qr(p)                      # orthonormal basis
        q_new = ar.psum_allreduce(mat_t @ p)           # (P, n, r)
        approx = (p @ q_new.transpose(-1, -2)).reshape(p_n, -1)[:, :d]
        # each worker's applied share is ITS projection p p^T M_w
        local = (p @ (mat_t @ p).transpose(-1, -2)).reshape(p_n, -1)[:, :d]
        acc = ef.residual_dense(u, local)
        return approx, (acc, q_new), self.comm_stats(d, nworkers)


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


# Schedule pricers (pure Python): the bucket pipeline's recurrences, which
# ``sim/replay.py`` prices a step with.


def _pipeline_chains(t_compute, t_comm, ready) -> tuple[float, float]:
    """(encode-chain end, comm-chain end) of the bucket pipeline: bucket
    i's encode starts once its input is ready and the previous encode
    finished; its comm starts when both its encode and bucket i-1's comm
    have finished — the classic pipeline recurrence. The single source of
    the recurrence for ``overlap_schedule_time`` /
    ``interleaved_schedule_time`` / the sim replay."""
    done_enc = done_comm = 0.0
    for tc, tm, rd in zip(t_compute, t_comm, ready):
        done_enc = max(done_enc, float(rd)) + float(tc)
        done_comm = max(done_comm, done_enc) + float(tm)
    return done_enc, done_comm


def overlap_schedule_time(t_compute, t_comm,
                          ready=None) -> tuple[float, float]:
    """(serial, pipelined) totals for the encode->comm bucket pipeline.

    Serial = all stages back-to-back; pipelined = the comm chain's end
    under ``_pipeline_chains``. The saving is 0 for a single bucket.

    ready: optional per-bucket gradient-readiness times (monotone
    nondecreasing, e.g. (i+1)/N of backward) for modeling a
    backward-interleaved schedule; the serial baseline then waits for the
    last bucket (= full backward) before encoding. None = inputs ready at
    t=0 (the shipped post-accumulation schedule).
    """
    t_compute = [float(t) for t in t_compute]
    t_comm = [float(t) for t in t_comm]
    ready = [0.0] * len(t_compute) if ready is None else [
        float(r) for r in ready]
    serial = (ready[-1] if ready else 0.0) + sum(t_compute) + sum(t_comm)
    _, done_comm = _pipeline_chains(t_compute, t_comm, ready)
    return serial, done_comm


def interleaved_schedule_time(t_compute, t_comm, ready, *,
                              t_backward: float | None = None
                              ) -> tuple[float, float, float, float]:
    """3-stage backward/encode/comm recurrence of the readiness scheduler.

    Models the reference's ``core/gs_sgd.exchange_interleaved`` (and the
    port's): stage 0 is the backward
    scan, which emits bucket i's gradient at ``ready[i]`` (any order —
    buckets are re-sorted into readiness order here, exactly the order the
    real scheduler exchanges them); stage 1 is the per-bucket encode chain
    (one encode at a time, starting once the bucket is ready and the
    previous encode finished); stage 2 is the comm chain (a bucket's
    all-reduce starts when its encode and the previous bucket's comm are
    done).

    Returns ``(serial, pipelined, exposed, enc_done)``: serial is the
    post-accumulation baseline (full backward, then every stage
    back-to-back); pipelined is when the last comm finishes; exposed is
    the wall-clock the exchange adds past the end of backward
    (``t_backward``, default ``max(ready)``) — the quantity interleaving
    exists to shrink; enc_done is the encode chain's end (the sim replay
    splits exposed into encode/comm overhang with it). ``chunks=1`` (all
    ready at t_backward) reduces to ``overlap_schedule_time`` shifted by
    t_backward.
    """
    order = sorted(range(len(ready)), key=lambda i: (ready[i], i))
    tc = [float(t_compute[i]) for i in order]
    tm = [float(t_comm[i]) for i in order]
    rd = [float(ready[i]) for i in order]
    serial = (rd[-1] if rd else 0.0) + sum(tc) + sum(tm)
    enc_done, pipelined = _pipeline_chains(tc, tm, rd)
    t_b = (max(rd) if rd else 0.0) if t_backward is None else float(t_backward)
    return serial, pipelined, max(0.0, pipelined - t_b), enc_done


def fused_interleaved_schedule_time(piece_bucket, piece_compute, piece_ready,
                                    t_comm, *,
                                    t_backward: float | None = None
                                    ) -> tuple[float, float, float, float]:
    """Fused-encode variant of ``interleaved_schedule_time``.

    The encode chain's work items are bucket FRAGMENTS (one per VJP chunk
    overlapping the bucket), not whole buckets: fragment f of bucket
    ``piece_bucket[f]`` becomes ready at ``piece_ready[f]`` and costs
    ``piece_compute[f]`` to partial-encode; a bucket's wire sketch exists
    once its LAST fragment's encode finishes. The comm chain is unchanged
    (sketches still ship per bucket, in bucket-readiness order — the order
    ``exchange_interleaved`` fires all-reduces).

    Fragments encode in readiness order (ties broken toward the
    earlier-complete bucket, matching the scheduler's emission order).
    With exactly one fragment per bucket this reduces bit-for-bit to
    ``interleaved_schedule_time`` — same sort keys, same recurrences.

    Returns the same ``(serial, pipelined, exposed, enc_done)`` tuple.
    """
    n = len(t_comm)
    bucket_ready = [0.0] * n  # when the bucket's LAST fragment emits
    for b, rd in zip(piece_bucket, piece_ready):
        bucket_ready[b] = max(bucket_ready[b], float(rd))
    order = sorted(range(len(piece_ready)),
                   key=lambda f: (piece_ready[f],
                                  bucket_ready[piece_bucket[f]],
                                  piece_bucket[f], f))
    done_enc = 0.0
    enc_done_b = [0.0] * n
    for f in order:
        done_enc = max(done_enc, float(piece_ready[f])) + float(
            piece_compute[f])
        enc_done_b[piece_bucket[f]] = done_enc
    comm_order = sorted(range(n), key=lambda b: (bucket_ready[b], b))
    done_comm = 0.0
    for b in comm_order:
        done_comm = max(done_comm, enc_done_b[b]) + float(t_comm[b])
    rd_max = max((float(r) for r in piece_ready), default=0.0)
    serial = (rd_max + sum(float(t) for t in piece_compute)
              + sum(float(t) for t in t_comm))
    t_b = rd_max if t_backward is None else float(t_backward)
    return serial, done_comm, max(0.0, done_comm - t_b), done_enc


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
    "topk": TopKCompressor,
    "gtopk": GTopK,
    "sketched-sgd": SketchedSGD,
    "gs-sgd": GsSGD,
    "fetchsgd": FetchSGDStyle,
    "signsgd": SignSGD,
    "powersgd": PowerSGD,
}


def make(name: str, **kw) -> Any:
    """Build a compressor by name; sketch geometry via rows/width/seed kw.

    Non-sketch compressors drop the sketch-geometry kwargs they have no
    field for (and the k-free baselines drop ``k``), as the reference, so
    one kwarg dict can be threaded to any method."""
    if name not in REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; choose from "
                       f"{sorted(REGISTRY)}")
    cls = REGISTRY[name]
    if name in ("sketched-sgd", "gs-sgd", "fetchsgd"):
        sk = cs.SketchConfig(rows=kw.pop("rows", 5),
                             width=kw.pop("width", 16384),
                             seed=kw.pop("seed", 0))
        return cls(sketch=sk, **kw)
    fields = {f.name for f in dataclasses.fields(cls)}
    for geo in ("rows", "width", "seed"):
        if geo not in fields:
            kw.pop(geo, None)
    if name in ("dense", "signsgd", "powersgd"):
        kw.pop("k", None)
    return cls(**kw)
