"""Per-step exchange cost replay — priced from the REAL compressor objects.

Port of ``repro/sim/replay.py``: the same stage models, byte accounting
and recurrences, on the port's ``core.compression`` compressors and
``core.allreduce`` schedules. ``default_geometry`` lives in
``api/spec.py`` (the spec resolves its sketch through it) and is
re-exported here.

The simulator must not re-derive payload geometry or schedule structure:
``ExchangeReplay`` builds the very ``core.compression`` compressor the train
step runs (including ``bucketize``'s per-bucket k/width scaling for
the bucketed gs-SGD pipeline), walks the very ``allreduce.reduce_schedule``
rounds, and combines per-bucket encode/comm stage times with the very
``compression.overlap_schedule_time`` recurrence that models
``gs_sgd.exchange_bucketed``'s skewed schedule

    encode(0); for i: reduce(i); encode(i+1); recover(i)

so a change to any of those lands in simulated timelines automatically
(the shared-schedule invariant, DESIGN.md §6).

Byte accounting matches the analytical ``CommStats`` convention where the
two overlap, which the tier-1 cross-check test pins down:

* tree gs-SGD: every one of the 2⌈log2 P⌉ replayed rounds carries the
  sketch payload → critical bytes ``rounds * sketch_bytes``; the exact
  second round adds ``k * 4`` bytes over 2 rounds (k floats up, summed
  values back — received bytes are not ``bytes_out``).
* gTop-k: per replayed round 2k numbers — k values + k coordinates.
* dense: ring, 2(P-1) chunks of d/P floats → 2(P-1)/P · 4d bytes.
* Sketched-SGD: PS star — P-1 serialized inbound sketches + 1 broadcast.

Compute-side stage times are priced at memory-streaming cost (the
accelerator regime of ``benchmarks/time_breakdown.py``): encode streams
d·rows coordinates read+write; recovery streams the sketch estimate plus a
multi-pass top-k; gTop-k pays one re-sparsification per reduce round ON
the latency chain (the paper's key structural contrast).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.api.spec import default_geometry
from repro_torch.core import compression as comp
from repro_torch.sim import network as netm

_F32 = 4
_I32 = 4
# bytes/s memory streaming: the reference model's rate (a TPU HBM figure,
# benchmarks/time_breakdown.HBM_BW), kept so the port prices what the
# reference prices; it is not the H100's rate
ENCODE_BW = 819e9
TOPK_PASSES = 10    # multi-pass radix-select passes for a top-k over d


def bucket_readiness(offsets: Sequence[int], sizes: Sequence[int], d: int,
                     n_chunks: int) -> tuple[int, ...]:
    """Reverse-emission readiness index per bucket on an abstract flat d.

    The backward scan emits gradient coordinates from the top of the
    packed vector downward (reverse-layer order) in ``n_chunks`` equal
    spans: emission event e covers coords [d·(K-1-e)/K, d·(K-e)/K). A
    bucket is ready once its LOWEST coordinate is emitted. This is the
    sim/benchmark abstraction of the real ``flatten.bucket_plan`` (which
    additionally pins the embed+head top segments to the final event —
    an effect the abstract-d model folds into the last span).
    """
    k = max(1, int(n_chunks))
    out = []
    for o in offsets:
        e = k - 1 - min(k - 1, (int(o) * k) // max(1, int(d)))
        out.append(e)
    return tuple(out)


def event_times(t_backward: float, n_chunks: int) -> list[float]:
    """Completion time of each emission event: equal chunks finish at
    uniform fractions of the backward scan."""
    k = max(1, int(n_chunks))
    return [t_backward * (e + 1) / k for e in range(k)]


def fused_pieces(offsets: Sequence[int], sizes: Sequence[int], d: int,
                 n_chunks: int) -> list[tuple[int, float, int]]:
    """Bucket fragments of the fused-encode schedule: (bucket, frac, event).

    The reverse-emission span of event e covers coords
    [cuts[K-1-e], cuts[K-e]) with ``cuts[m] = ceil(m*d/K)`` — the same
    floor-span membership as ``bucket_readiness`` (coordinate c belongs to
    span floor(c*K/d)), so each bucket's LAST fragment lands exactly on
    its ``bucket_readiness`` event. ``frac`` is the fragment's share of
    its bucket's coordinates (its share of the bucket's encode time).
    One chunk => one whole fragment per bucket at event 0.
    """
    k = max(1, int(n_chunks))
    d = max(1, int(d))
    cuts = [(m * d + k - 1) // k for m in range(k + 1)]
    out: list[tuple[int, float, int]] = []
    for b, (o, s) in enumerate(zip(offsets, sizes)):
        o, s = int(o), int(s)
        for m in range(k):
            lo, hi = max(o, cuts[m]), min(o + s, cuts[m + 1])
            if lo < hi:
                out.append((b, (hi - lo) / s, k - 1 - m))
    return out


@dataclasses.dataclass(frozen=True)
class StageTimes:
    """Per-bucket (encode, comm, recover) stage times for one membership,
    plus the byte/round totals — the cacheable half of ``step_cost``."""

    t_enc: tuple[float, ...]
    t_comm: tuple[float, ...]
    t_rec: tuple[float, ...]
    bytes_wire: float
    bytes_critical: float
    rounds: int


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    """One simulated step's exchange, split the way the timeline reports it.

    encode / comm / recover are the *exposed* (wall-clock) phase times
    after the bucket pipeline's overlap; ``comm_serial`` is the
    un-overlapped sum (so ``encode + comm_serial - (encode + comm)`` is
    the modeled overlap saving). With a backward-interleaved schedule
    (``bwd_chunks > 1``), "exposed" additionally excludes whatever the
    readiness pipeline hid UNDER the backward scan — encode/comm are the
    overhang past the end of backward, the quantity DESIGN.md §7's
    3-stage recurrence minimizes. Bytes/rounds are per step, critical =
    the per-worker Eq. 1 payload term the complexity claims are about.
    """

    encode: float
    comm: float
    recover: float
    comm_serial: float
    bytes_wire: float
    bytes_critical: float
    rounds: int

    @property
    def total(self) -> float:
        return self.encode + self.comm + self.recover

    @property
    def overlap_saving(self) -> float:
        return max(0.0, self.encode + self.comm_serial - (self.encode + self.comm))


def _stream_time(nbytes: float) -> float:
    return nbytes / ENCODE_BW


class ExchangeReplay:
    """Prices one step's gradient exchange for a live worker-id list.

    Built once per simulation (geometry depends only on d/method/buckets);
    ``step_cost`` is re-evaluated per step because membership — and with it
    the real ``reduce_schedule`` — changes under elastic replans.
    """

    def __init__(self, method: str, d: int, *, buckets: int = 1,
                 k: int | None = None, rows: int | str = "log",
                 width: int | None = None, shape: str | None = None,
                 group_size: int = 8, wire_dtype_bytes: int = 4):
        self.method = method
        self.d = int(d)
        self.group_size = group_size
        k, rows_i, width = default_geometry(d, k=k, rows=rows, width=width)
        self.k, self.rows, self.width = k, rows_i, width
        self.shape = shape or {"dense": "ring", "sketched-sgd": "ps",
                               "gs-sgd": "tree", "gtopk": "tree"}[method]
        # gTop-k's per-hop merge and Sketched-SGD's PS inbox ARE their
        # algorithms — an override would silently mislabel the experiment
        if method == "gtopk" and self.shape != "tree":
            raise ValueError("gTop-k's merge is defined on the tree; "
                             f"shape={self.shape!r} is not replayable")
        if method == "sketched-sgd" and self.shape != "ps":
            raise ValueError("Sketched-SGD aggregates at a parameter "
                             f"server; shape={self.shape!r} is not "
                             "replayable")
        self.wire = wire_dtype_bytes
        if method in ("gs-sgd", "sketched-sgd"):
            base = comp.make(method, k=k, rows=rows_i, width=width)
        elif method == "gtopk":
            base = comp.make("gtopk", k=k)
        elif method == "dense":
            base = comp.make("dense")
        else:
            raise ValueError(f"unknown method {method!r}")
        self.bc = comp.bucketize(base, comp.even_bucket_sizes(d, buckets))

    # -- per-bucket stage models ------------------------------------------

    def _encode_time(self, d_b: int, c) -> float:
        if self.method in ("gs-sgd", "sketched-sgd"):
            return _stream_time(d_b * c.sketch.rows * 8)
        if self.method == "gtopk":
            return _stream_time(TOPK_PASSES * d_b * _F32)
        return 0.0

    def _recover_time(self, d_b: int, c) -> float:
        if self.method in ("gs-sgd", "sketched-sgd"):
            # HEAVYMIX: decode-estimate stream + one top-k over candidates
            return _stream_time(d_b * c.sketch.rows * 8
                                + TOPK_PASSES * d_b * _F32)
        return 0.0

    def _comm_rounds(self, net: netm.NetworkModel, ids: Sequence[int],
                     c, d_b: int) -> list[netm.RoundCost]:
        p = len(ids)
        if p <= 1:
            return []
        if self.method == "dense":
            # full payload per round on non-ring shapes (tree/hier trade
            # bandwidth for alpha-rounds — the contrast the sweep shows)
            return netm.allreduce_cost(net, ids, d_b * _F32,
                                       shape=self.shape,
                                       group_size=self.group_size)
        if self.method == "gtopk":
            per_round = c.k * (_F32 + _I32)
            rounds = netm.tree_allreduce_cost(net, ids, per_round)
            # per-reduce-round re-sparsification sits ON the latency chain
            resparse = _stream_time(TOPK_PASSES * d_b * _F32)
            half = len(rounds) // 2
            return [dataclasses.replace(r, duration=r.duration + resparse)
                    if i < half else r for i, r in enumerate(rounds)]
        sk_bytes = c.sketch.size * self.wire
        if self.method == "sketched-sgd":
            gather = netm.ps_gather_cost(net, ids, sk_bytes)
            arr = np.asarray(ids, dtype=np.int64)
            others = arr[arr != arr[0]]
            bcast = [netm.RoundCost(
                net.pair_times_max(np.full(others.size, arr[0]), others,
                                   sk_bytes),
                sk_bytes * (p - 1), sk_bytes)]
            return gather + bcast + self._second_round(net, ids, c.k)
        # gs-sgd: sketch all-reduce on the configured shape + second round
        rounds = netm.allreduce_cost(net, ids, sk_bytes, shape=self.shape,
                                     group_size=self.group_size)
        return rounds + self._second_round(net, ids, c.k)

    def _second_round(self, net: netm.NetworkModel, ids: Sequence[int],
                      k: int) -> list[netm.RoundCost]:
        """Exact-value second round (Alg. 2 line 4): k floats up, the
        summed values broadcast back — 2 rounds, k·4 injected bytes (the
        CommStats ``+ k*F32, rounds + 2`` convention)."""
        nbytes = k * _F32
        worst = net.worst_link(ids, nbytes).time(nbytes)
        return [netm.RoundCost(worst, nbytes * len(ids), nbytes),
                netm.RoundCost(worst, nbytes * len(ids), 0.0)]

    # -- one step ----------------------------------------------------------

    def stage_times(self, net: netm.NetworkModel,
                    ids: Sequence[int]) -> "StageTimes":
        """Per-bucket stage times + byte/round totals for one membership.

        This is the expensive part of pricing a step (it walks the real
        collective schedules over the topology); it depends only on the
        live-id list, so callers (``sim/cluster.py``) cache it per
        membership and re-run only the cheap ``step_cost`` recurrence when
        the backward duration varies step-to-step (compute jitter). The
        sim caches by ``plan.generation`` (1:1 with membership); under
        participation sampling the cohort changes per step, so it prices
        fresh — ids arrive as arrays and every collective walk is
        vectorized, keeping that path viable at P=100k."""
        ids = np.asarray(ids, dtype=np.int64)
        t_enc, t_comm, t_rec = [], [], []
        b_wire = b_crit = 0.0
        n_rounds = 0
        for c, d_b in zip(self.bc.parts, self.bc.spec.sizes):
            t_enc.append(self._encode_time(d_b, c))
            rounds = self._comm_rounds(net, ids, c, d_b)
            dur, wire, crit = netm.total(rounds)
            t_comm.append(dur)
            t_rec.append(self._recover_time(d_b, c))
            b_wire += wire
            b_crit += crit
            n_rounds += len(rounds)
        return StageTimes(t_enc=tuple(t_enc), t_comm=tuple(t_comm),
                          t_rec=tuple(t_rec), bytes_wire=b_wire,
                          bytes_critical=b_crit, rounds=n_rounds)

    def step_cost(self, net: netm.NetworkModel, ids: Sequence[int],
                  *, overlap: bool = True, t_backward: float = 0.0,
                  bwd_chunks: int = 1, fuse_encode: bool = False,
                  stages: "StageTimes | None" = None) -> PhaseCost:
        """Price one exchange. ``bwd_chunks > 1`` replays the readiness
        timeline: per-bucket ready times from the reverse-emission chunk
        schedule feed the 3-stage ``compression.interleaved_schedule_time``
        recurrence, and encode/comm report only the overhang past the end
        of backward (``t_backward`` seconds). ``bwd_chunks=1`` keeps the
        post-accumulation pipeline bit-for-bit. ``stages``: a cached
        ``stage_times(net, ids)`` result to skip the schedule walk.

        fuse_encode=True prices the fused schedule: the encode chain's
        work items are the ``fused_pieces`` bucket fragments (each a
        pro-rata share of its bucket's encode time, ready at its own
        emission event) instead of whole buckets ready at their last
        event — ``compression.fused_interleaved_schedule_time``."""
        st = stages if stages is not None else self.stage_times(net, ids)
        t_enc, t_comm = list(st.t_enc), list(st.t_comm)
        comm_serial = sum(t_comm)
        if bwd_chunks > 1 and overlap:
            d = self.bc.spec.total
            ev_t = event_times(t_backward, bwd_chunks)
            if fuse_encode:
                pb, pe, pr = [], [], []
                for b, frac, e in fused_pieces(self.bc.spec.offsets,
                                               self.bc.spec.sizes, d,
                                               bwd_chunks):
                    pb.append(b)
                    pe.append(t_enc[b] * frac)
                    pr.append(ev_t[e])
                _, pipelined, _, done_enc = \
                    comp.fused_interleaved_schedule_time(
                        pb, pe, pr, t_comm, t_backward=t_backward)
            else:
                ready_ev = bucket_readiness(self.bc.spec.offsets,
                                            self.bc.spec.sizes, d,
                                            bwd_chunks)
                ready = [ev_t[e] for e in ready_ev]
                _, pipelined, _, done_enc = comp.interleaved_schedule_time(
                    t_enc, t_comm, ready, t_backward=t_backward)
            encode = max(0.0, done_enc - t_backward)
            comm = pipelined - max(t_backward, done_enc)
        else:
            serial, pipelined = comp.overlap_schedule_time(t_enc, t_comm)
            encode = sum(t_enc)
            comm = (pipelined - encode) if (overlap and self.bc.spec.n > 1) \
                else comm_serial
        return PhaseCost(encode=encode, comm=comm, recover=sum(st.t_rec),
                         comm_serial=comm_serial, bytes_wire=st.bytes_wire,
                         bytes_critical=st.bytes_critical, rounds=st.rounds)


def predict_step(method: str, d: int, p: int, *, buckets: int = 1,
                 bwd_chunks: int = 1, k: int | None = None,
                 rows: int | str = "log", width: int | None = None,
                 shape: str | None = None, topology: str = "flat",
                 link: str = "1gbe", intra_link: str = "ici",
                 group_size: int = 8, overlap: bool = True,
                 fuse_encode: bool = False,
                 t_compute: float = 0.1, bwd_frac: float = 2 / 3,
                 wire_dtype_bytes: int = 4,
                 participation: float | None = None,
                 net: netm.NetworkModel | None = None,
                 replay: "ExchangeReplay | None" = None,
                 profile=None) -> dict:
    """One-call candidate pricing — the auto-tuner's replay entry point.

    Builds the real ``ExchangeReplay`` (real compressor geometry, real
    collective schedules on the modeled topology) for a full-membership
    cluster of ``p`` workers and prices one steady-state step: this is
    exactly what ``sim/cluster.simulate`` charges per step with zero
    compute jitter and no faults (barrier == ``t_compute``), so a
    ``tune`` prediction and a full event-loop run agree on the
    configs the tuner ranks. ``participation`` prices the steady-state
    cohort instead — a collective over ``max(1, round(f·p))`` workers, the
    per-step geometry of a partial-participation run (``p_eff`` in the
    output records what was priced). ``net``/``replay`` accept prebuilt
    objects so a sweep over many candidates reuses the network (and a
    sweep over backward depths reuses the schedule walk).

    Returns a plain dict: ``step_time`` (compute + exposed exchange),
    ``exposed_comm`` (encode + comm overhang the schedule could not hide),
    the per-phase splits, byte/round totals, and the RESOLVED geometry
    (post ``default_geometry`` defaults and ``bucketize`` scaling) for
    plan provenance.

    ``profile`` is a measured-reality correction (duck-typed
    ``tune.cost.CalibrationProfile``: a ``compute`` factor plus
    ``scale_stages(StageTimes)``): compute time and the per-bucket
    encode/comm/recover stage times are multiplied BEFORE the
    overlap/interleave recurrence, so a congested link stretches the
    schedule the way the fabric would, not just the reported totals.
    ``None`` (and the identity profile) leave the output bit-exact.
    """
    net = net or netm.make_network(topology, link=link,
                                   group_size=group_size, intra=intra_link)
    rep = replay if replay is not None else ExchangeReplay(
        method, d, buckets=buckets, k=k, rows=rows, width=width,
        shape=shape, group_size=group_size,
        wire_dtype_bytes=wire_dtype_bytes)
    p_eff = p if participation is None else max(1, int(round(participation * p)))
    ids = list(range(p_eff))
    t_comp = t_compute if profile is None else t_compute * profile.compute
    interleave = bwd_chunks > 1 and overlap
    t_bwd = t_comp * bwd_frac if interleave else 0.0
    stages = None if profile is None \
        else profile.scale_stages(rep.stage_times(net, ids))
    pc = rep.step_cost(net, ids, overlap=overlap, t_backward=t_bwd,
                       bwd_chunks=bwd_chunks, fuse_encode=fuse_encode,
                       stages=stages)
    return {
        "step_time": t_comp + pc.total,
        "compute": t_comp,
        "p_eff": p_eff,
        "exposed_comm": pc.encode + pc.comm,
        "encode": pc.encode, "comm": pc.comm, "recover": pc.recover,
        "comm_serial": pc.comm_serial,
        "bytes_critical": pc.bytes_critical, "bytes_wire": pc.bytes_wire,
        "rounds": pc.rounds,
        "geometry": {"k": rep.k, "rows": rep.rows, "width": rep.width,
                     "buckets": rep.bc.spec.n, "shape": rep.shape,
                     "bucket_sizes": list(rep.bc.spec.sizes)},
    }
