"""gs-SGD distributed train step with P simulated workers on one device.

Port of ``repro/core/gs_sgd.py``. The reference
builds a per-device step and runs P workers under ``jax.vmap(...,
axis_name='data')``; here the step itself carries the worker axis: every
per-worker tensor of the state (params, optimizer moments, error
feedback) has a leading P dimension, and each worker's loss and gradient
run in a Python loop over P. The exchange, the optimizer and the residual
bookkeeping then act on (P, ...) tensors with the worker-axis collectives
of ``core.allreduce``.

Order of one step (gs_sgd.py:553 onward in the reference):
loss+grad per worker -> pack_segs -> exchange (monolithic, or bucketed
with the skewed schedule encode(0); reduce(i); encode(i+1); recover(i))
-> g_mean = upd / P -> optimizer. The error feedback may be stored in
another dtype (``make_state(..., ef_dtype=)``, bf16 for qwen3-moe's
override row): the step casts it to f32 before the exchange and the new
residual back to its own dtype after it, as the reference's does.

With ``bwd_chunks=K`` the backward is cut into K chunks
(``model.chunked_loss_vjp``) on every layout: the forward runs for every
worker, then ``exchange_interleaved`` drives the backward itself, chunk
by chunk, and starts each bucket's encode and sketch all-reduce at the
event that completes its gradient, recovering one bucket behind. Without
a staged bucketed compressor or the pipelined schedule (``overlap``)
the chunked backward runs all the same and the exchange takes its
gradient after it (``flat_of_chunks``, span ``backward``); the
``TrainStep`` says which (``bwd_chunks``, ``interleave``). With
``fuse_encode`` each emitted gradient slice is EF-added and partially
encoded at once (Count-Sketch linearity) and the bucket's exact partial
sketches are summed at its event (as integers: the fused sketch is
bit-equal to the whole-bucket encode). On one device every stage runs in program order
on one stream; nothing overlaps yet.

Spans: each phase of the step runs under a span of the ambient tracer
(``obs.trace.current()``) with the reference's names and categories
(``loss_and_grad`` cat backward, or ``forward`` and ``backward/chunk{j}``,
``backward/top`` for a chunked backward; ``encode/b{i}``,
``allreduce/b{i}`` cat comm, ``recover/b{i}``, ``exchange`` cat comm for
the monolithic exchange, ``optimizer``; ``ready/b{i}`` instants in the
interleave), each ending in ``sp.sync`` of its result where the
reference's does. A fused partial encode runs under its bucket's
``encode/b{i}`` (the reference gives it no span of its own). Inside the
monolithic ``loss_and_grad`` each worker's ``model/forward/w{w}`` and
``model/backward/w{w}``, then ``model/pack`` (the gradients scattered and
packed into the flat rows), cat ``detail``, as the model's
``params/views`` and ``remat/recompute`` and the compressor's ``ef/*``
and ``values/round`` (``obs/trace.py``). With tracing off (``NULL``) a
span is a ``torch.profiler.record_function`` range while a profiler
records and nothing otherwise, and ``sync`` does nothing, so the step's
device work is the same and it never waits on the card; under
``torch.profiler.profile`` each range's device time is the sum of the
kernels launched inside it (``chip_smoke.py`` and the benchmark read
them). With a tracer active each span syncs the card at its end, so its
host duration covers its kernels; the ``detail`` spans do not sync.

``microbatch=mb`` cuts each worker's batch into slices of mb rows and
sums their losses and gradients in f32, then divides by the slice count
(``jax.lax.scan`` in the reference, a Python loop here). ``clip_norm``
scales the aggregated gradient to at most that global norm.
``make_serve_fns`` binds the serving targets (prefill, decode) to the
same layout.

Sharded layouts (tp > 1, or ``dp_mode="fsdp"``; the reference under
nested ``jax.vmap``, ``model`` outside the data-parallel axes). State
tensors are (tp, P, *local) (P workers pod-major, the reference's
order; (P, *local) at tp = 1), each segment's last dim divided as
``seg_divisors`` says: in 'dp' a model rank stores its sharded segments
whole and 1/tp of the replicated ones, in 'fsdp' each worker also 1/data
of all of them. ``_gather_closures`` maps a group's storage to the
*use* layout the model reads (``models/model.py``) and the group's
summed gradient back (the gathers' transpose, psum_scatter). A group is
one worker in 'dp' and the ``data`` workers of one pod in 'fsdp': the
pod's shards are gathered once a step, every worker of the pod runs its
rows on them, and their gradients accumulate in one buffer, which each
worker's slice is then cut from. The whole model replica (every rank) is
one autograd graph (``common.ShardCtx``), whose loss is seeded with 1/tp:
psum's transpose makes the summed objective's gradient tp times the
loss's, as in the reference. The exchange then runs once per model rank
over the dp workers ('dp': every worker; 'fsdp' with a pod axis: the
pods, once per data index, each exchanging its own shard's
coordinates); a single-pod fsdp step is dense and EF-free (the data sum
is the gradient's). The EF is a tuple with one compressor state per such
group. The global norm sums over the ranks (and the pod's data shards
in fsdp); the reported loss is the mean over the workers.

A chunked backward on the sharded layouts runs one
``model.chunked_loss_vjp`` a gather group, on the group's storage with
the gathers: the top segments gathered once, each chunk's cycle rows
in their chunk, every worker of the group on the same leaves; a chunk's
backward step scatters its rows' gradient at once, so the emitted
slices are (tp, P, ...) in the storage layout, and the top segments'
scatter runs once, last (``group_backward``). The gradients are the
monolithic backward's bit for bit. All ranks (and the groups) are one
backward, so the interleave serves every exchange group from it: at
each emission event the slices are emitted once, then each group's
ready buckets are encoded (fused: each group's own partial sketches),
all-reduced and recovered one bucket behind, each group with its own
EF, include mask and compressor state. A single-pod fsdp step (no
exchange axis) and a compressor that cannot stage take the
post-accumulation path. On a process mesh every process runs the same
schedule, so the chunks' model-axis collectives (gathers in the
forward, a reduce-scatter a chunk and one for the top in the backward)
and the exchange's collectives over the dp axes are issued in the same
order everywhere (tests/test_torch_mesh.py pins it); they are
synchronous calls, issued in program order, so nothing of the exchange
overlaps the backward yet.

The tp = 1 'dp' step is the same step with one rank, one worker a
group (its leaves views of the worker's params) and one exchange over
all workers, whose EF is the compressor state itself.

On a process mesh (``MeshAxes.mesh``, a ``core.pgroup.ProcessMesh``
built by ``launch/mesh.py``) the same step runs with one model rank and
one worker a process: every leading rank and worker dimension is 1 long
and ``ma.tp``, ``ma.data``, ``ma.pod`` stay the global sizes. The
collectives cross processes (``_mesh_gather_closures``: the gathers are
all-gathers, their transpose a reduce-scatter, over ``model`` for the
replicated segments in 'dp', over ``data`` (and ``model``) in 'fsdp');
the exchange runs its compressor's collectives over the exchange axes
(``('pod', 'data')`` in 'dp', ``'pod'`` in 'fsdp'; ``allreduce.over``);
the global norm and the reported loss are all-reduces. The compressor
still sees the global worker count. An elastic re-plan (another P) needs
a new mesh: a step whose sizes differ from its mesh's raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.api.spec import check_exchange_config
from repro_torch.core import allreduce as ar
from repro_torch.core import compression as comp
from repro_torch.core import pgroup
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import model as mdl
from repro_torch.models.common import ArchConfig, ShardCtx, init_params
from repro_torch.models.flatten import (SEG_NAMES, BucketPlan, FlatSpec,
                                        bucket_plan, init_flat_params,
                                        make_flat_spec, pack_segs,
                                        shard_segs, unpack_segs)
from repro_torch.obs import trace as obtrace
from repro_torch.optim.optimizers import Optimizer


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Static description of the mesh the step runs in: simulated on one
    process, or with ``mesh`` (a ``core.pgroup.ProcessMesh``,
    ``launch.mesh.mesh_axes_of``) one rank and one worker a process."""

    tp: int
    data: int
    pod: int = 1
    tp_axis: str | None = "model"
    data_axis: str | None = "data"  # None -> single-worker path
    pod_axis: str | None = None
    mesh: Any = dataclasses.field(default=None, compare=False)

    @property
    def dp_axes(self) -> tuple[str, ...]:
        axes = (self.pod_axis,) if self.pod_axis else ()
        return axes + ((self.data_axis,) if self.data_axis else ())

    @property
    def dp_size(self) -> int:
        return self.pod * self.data

    def ctx(self, dtype=torch.bfloat16, comm_dtype=None) -> ShardCtx:
        model = (self.mesh.axis("model")
                 if self.mesh is not None and self.tp > 1 else None)
        return ShardCtx(tp=self.tp, tp_axis=self.tp_axis,
                        dp_axes=self.dp_axes, dtype=dtype,
                        comm_dtype=comm_dtype, model=model)

    def check_mesh(self) -> None:
        """On a process mesh: the sizes must be the mesh's (an elastic
        re-plan's other worker count needs a mesh of its own)."""
        if self.mesh is None:
            return
        want = {"model": self.tp, "data": self.data, "pod": self.pod}
        got = {a: self.mesh.size(a) for a in want}
        if want != got:
            raise ValueError(
                f"MeshAxes sizes {want} differ from the process mesh's "
                f"{got}: an elastic re-plan (another worker count) on a "
                "process mesh is not supported; build a new mesh")


def _gather_closures(ma: MeshAxes, dp_mode: str):
    """(gather, scatter) between a group's storage and the use layout.

    A group's storage: every segment (tp, n, *local), the model ranks,
    then the group's n workers (one in 'dp', a pod's ``data`` workers in
    'fsdp'). ``gather`` returns the use layout: each ``*_s`` segment the
    n shards concatenated (the reference's ``gdata``), rank-stacked
    (unranked at tp = 1); each ``*_r`` one unranked tensor, every
    worker's and rank's slice concatenated data-major (``gdata(gmodel(
    v))``). ``scatter(use, n)`` is the transpose of both: given the use
    layout's gradient, summed over the group's workers (the pod's data
    sum), it cuts each worker's and rank's slice, (tp, n, *local) -- the
    reference's psum_scatter. Casting to the compute dtype is left to the
    model (``FlatSpec`` casts each leaf).
    """
    if dp_mode not in ("dp", "fsdp"):
        raise ValueError(f"unknown dp_mode {dp_mode!r}")
    tp = ma.tp

    def gather(store: dict) -> dict:
        out = {}
        for k, v in store.items():
            n = v.shape[1]
            rep = k.endswith("_r")
            parts = ([v[r, j] for j in range(n) for r in range(tp)] if rep
                     else [v[:, j] for j in range(n)])
            u = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            out[k] = u if rep or tp > 1 else u[0]
        return out

    def scatter(use: dict, n: int) -> dict:
        out = {}
        for k, u in use.items():
            if k.endswith("_r"):
                m = u.shape[-1] // (n * tp)
                out[k] = u.reshape(u.shape[:-1] + (n, tp, m)).movedim(
                    (-2, -3), (0, 1))
            else:
                u = u if tp > 1 else u[None]
                m = u.shape[-1] // n
                out[k] = u.reshape(u.shape[:-1] + (n, m)).movedim(-2, 1)
        return out

    return gather, scatter


def _mesh_gather_closures(ma: MeshAxes, dp_mode: str):
    """``_gather_closures`` on a process mesh: the storage is this
    process's (1, 1, *local); ``gather`` all-gathers each ``*_r`` segment
    over ``model`` ('dp') or ``('data', 'model')`` ('fsdp', ``model``
    innermost) and each ``*_s`` segment over ``data`` ('fsdp'), in the
    simulation's concatenation orders; ``scatter`` reduce-scatters the
    use layout's gradient over the same groups, which sums the ranks'
    shares of a replicated leaf's gradient and, in 'fsdp', the pod's
    workers' gradients (the simulation's one buffer)."""
    pm = ma.mesh
    fsdp = dp_mode == "fsdp"
    rep = pm.axis(("data", "model") if fsdp else ("model",))
    shard = pm.axis("data") if fsdp else pm.axis(())
    ranked = ma.tp > 1

    def gather(store: dict) -> dict:
        out = {}
        for k, v in store.items():
            if k.endswith("_r"):
                out[k] = pgroup.all_gather_cat(v[0, 0], rep)
            else:
                u = pgroup.all_gather_cat(v[0, 0], shard)
                out[k] = u[None] if ranked else u
        return out

    def scatter(use: dict, n: int) -> dict:
        out = {}
        for k, u in use.items():
            if k.endswith("_r"):
                s = pgroup.reduce_scatter(u, rep)
            else:
                s = pgroup.reduce_scatter(u[0] if ranked else u, shard)
            out[k] = s[None, None]
        return out

    return gather, scatter


def seg_divisors(ma: MeshAxes, dp_mode: str) -> dict[str, int]:
    """By how much each stored segment's last dim is divided on-device."""
    d = 1 if dp_mode == "dp" else ma.data
    return {"top_s": d, "top_r": d * ma.tp,
            "cycles_s": d, "cycles_r": d * ma.tp}


def local_seg_shapes(fs: FlatSpec, ma: MeshAxes,
                     dp_mode: str) -> dict[str, tuple[int, ...]]:
    div = seg_divisors(ma, dp_mode)
    out = {}
    for k, shape in fs.seg_shapes().items():
        if shape[-1] % div[k] != 0:
            raise ValueError(
                f"segment {k!r} last dim {shape[-1]} is not divisible by "
                f"its on-device divisor {div[k]} (shape {shape})")
        out[k] = shape[:-1] + (shape[-1] // div[k],)
    return out


# ---------------------------------------------------------------------------
# Bucket scheduler
# ---------------------------------------------------------------------------


def exchange_bucketed(bc: comp.BucketedCompressor, ef_state, g_flat, *,
                      nworkers: int, overlap: bool = True, include=None):
    """Run a bucketed gradient exchange, optionally in the skewed order

        encode(0); for i: reduce(i); encode(i+1); recover(i)

    Buckets cover disjoint coordinate ranges, so both orders give the same
    numbers. On one device the stages run in program order; the skew
    frees bucket i's sketches before bucket i+1's recovery.
    """
    n = bc.spec.n
    staged = all(hasattr(c, "stage_encode") for c in bc.parts)
    tr = obtrace.current()
    if not overlap or n == 1 or not staged:
        with tr.span("exchange", cat="comm") as sp:
            out = bc.step(ef_state, g_flat, nworkers=nworkers,
                          include=include)
            sp.sync(out[0])
        return out
    parts = bc.spec.split(g_flat)
    us: list = [None] * n
    sks: list = [None] * n
    outs: list = [None] * n
    with tr.span("encode/b0", cat="encode") as sp:
        us[0], sks[0] = bc.parts[0].stage_encode(ef_state[0], parts[0])
        sp.sync(sks[0])
    for i in range(n):
        with tr.span(f"allreduce/b{i}", cat="comm") as sp:
            sk_sum, scale = bc.parts[i].stage_reduce(
                sks[i], nworkers=nworkers, include=include)
            sp.sync(sk_sum)
        sks[i] = None
        if i + 1 < n:  # next bucket's encode — independent of the reduce
            with tr.span(f"encode/b{i + 1}", cat="encode") as sp:
                us[i + 1], sks[i + 1] = bc.parts[i + 1].stage_encode(
                    ef_state[i + 1], parts[i + 1])
                sp.sync(sks[i + 1])
        with tr.span(f"recover/b{i}", cat="recover") as sp:
            outs[i] = bc.parts[i].stage_recover(
                us[i], sk_sum, scale, nworkers=nworkers, include=include)
            sp.sync(outs[i][0])
        us[i] = None
    upd = bc.spec.join([o[0] for o in outs])
    ef_new = tuple(o[1] for o in outs)
    stats = comp.BucketedCommStats(tuple(o[2] for o in outs),
                                   label=bc.name + "|overlap")
    return upd, ef_new, stats


def exchange_interleaved(bc: comp.BucketedCompressor, plan: BucketPlan,
                         bwd_steps, top_grads, groups, *, nworkers: int,
                         fuse_encode: bool = False):
    """Readiness-driven bucketed exchange interleaved with backward chunks.

    Port of ``repro/core/gs_sgd.py:exchange_interleaved``, on the worker
    axis: ``bwd_steps`` / ``top_grads`` are every worker's chunked backward
    (``group_backward``) and emit (tp, P, ...) gradient slices in the
    storage layout, chunk K-1 first, the top segments last, at the packed
    offsets of ``plan.emits``. After each emission event every bucket
    whose packed range is complete (``plan.readiness``) is encoded and its
    sketch all-reduced, and the recovery runs one bucket behind:

        bwd(K-1); enc(b); red(b); bwd(K-2); enc(b'); red(b'); rec(b); ...

    Each bucket's chain is the same ops as ``exchange_bucketed``'s, so the
    numbers are the bucketed exchange's for any chunk count (bit-exact at
    one chunk). The reference also folds a PRNG key per bucket for the
    faithful fill; its train step passes no key, so every bucket draws
    ``PRNGKey(0)``'s filler, and the port's faithful fill, which takes no
    key here, draws its own the same way for each bucket's d.

    fuse_encode: each emitted slice is EF-added and partially encoded the
    moment it is emitted (``stage_encode_partial`` at its offset inside the
    bucket); at the bucket's event the exact partial sketches are summed
    and converted once (``stage_encode_merge``). A bucket whose compressor
    cannot fuse (the TS encoder, a dense baseline) assembles its slices
    and encodes them at its event.

    ``groups``: the exchanges the one backward feeds, each ``((rank,
    worker slice), ef_state, include)``: all workers' at tp = 1 in 'dp';
    on the sharded layouts one a model rank (and in 'fsdp' a data
    index), over the workers of the slice. A group's rows of an emitted
    slice are ``slice[rank, workers]``. Each event's slices are emitted
    once; then every ready bucket is encoded and all-reduced for each
    group in group order, and each group recovers one bucket behind, with
    its own EF, include mask and compressor state. Returns one (upd_sum
    (n, d), ef_new, BucketedCommStats) a group.
    """
    parts, spec = bc.parts, bc.spec
    n = spec.n
    G = len(groups)
    by_event: dict[int, list[int]] = {}
    for i in plan.order:
        by_event.setdefault(plan.readiness[i], []).append(i)
    emits: dict[int, list[tuple[int, int]]] = {}  # event -> (offset, length)
    for off, m, ev in plan.emits:
        emits.setdefault(ev, []).append((off, m))

    tr = obtrace.current()
    fusable = [bool(fuse_encode and getattr(p, "can_fuse", False))
               for p in parts]
    # per group and bucket: (off-in-bucket, u, sketch)
    frags: list[list[list]] = [[[] for _ in range(n)] for _ in range(G)]
    # (packed offset, length, emitted slice); kept only for buckets that
    # assemble
    pieces: list[tuple[int, int, torch.Tensor]] = []
    keep_pieces = not all(fusable)

    def rows(g: int, t: torch.Tensor, m: int) -> torch.Tensor:
        """Group g's (n, m) rows of an emitted slice."""
        r, sl = groups[g][0]
        return t[r, sl].reshape(-1, m)

    def fuse_piece(g: int, off: int, arr: torch.Tensor) -> None:
        """Partial-encode the overlap of one emitted slice with every
        fusable bucket, at its offset inside that bucket."""
        ef_g = groups[g][1]
        for i, lo, hi in plan.overlaps(off, arr.shape[-1]):
            if not fusable[i]:
                continue
            o = spec.offsets[i]
            with tr.span(f"encode/b{i}", cat="encode") as sp:
                u_piece, sk = parts[i].stage_encode_partial(
                    ef_g[i][:, lo - o:hi - o], arr[:, lo - off:hi - off],
                    lo - o)
                sp.sync(sk.limbs)
            frags[g][i].append((lo - o, u_piece, sk))

    def emit(ev: int, grads) -> None:
        """Emit event ``ev``'s (tp, P, ...) gradient slices at the plan's
        packed offsets."""
        for (off, m), t in zip(emits[ev], grads):
            if m and t[0, 0].numel() != m:
                raise ValueError(f"event {ev} emitted {tuple(t.shape)} at "
                                 f"offset {off}; the plan has {m} a worker")
            if not m:
                continue
            if keep_pieces:
                pieces.append((off, m, t))
            for g in range(G):
                fuse_piece(g, off, rows(g, t, m))

    def assemble(g: int, i: int) -> torch.Tensor:
        o, sz = spec.offsets[i], spec.sizes[i]
        got = []
        for off, m, t in pieces:
            lo, hi = max(o, off), min(o + sz, off + m)
            if lo < hi:
                got.append((lo, rows(g, t, m)[:, lo - off:hi - off]))
        got.sort(key=lambda t: t[0])
        if sum(a.shape[-1] for _, a in got) != sz:
            raise ValueError(
                f"bucket {i} (offset {o}, size {sz}) is not covered by the "
                "emitted gradient slices at its readiness event")
        return got[0][1] if len(got) == 1 else torch.cat(
            [a for _, a in got], dim=-1)

    us = [[None] * n for _ in range(G)]
    sk_sum = [[None] * n for _ in range(G)]
    scale = [[None] * n for _ in range(G)]
    outs = [[None] * n for _ in range(G)]
    launched: list[list[int]] = [[] for _ in range(G)]

    def recover(g: int, i: int) -> None:
        with tr.span(f"recover/b{i}", cat="recover") as sp:
            outs[g][i] = parts[i].stage_recover(
                us[g][i], sk_sum[g][i], scale[g][i], nworkers=nworkers,
                include=groups[g][2])
            sp.sync(outs[g][i][0])
        us[g][i] = sk_sum[g][i] = None

    n_chunks = len(bwd_steps)
    for ev in range(plan.n_events):
        if ev < n_chunks:
            with tr.span(f"backward/chunk{ev}", cat="backward") as sp:
                _, d_cs, d_cr = bwd_steps[ev]()
                sp.sync((d_cs, d_cr))
            emit(ev, (d_cs, d_cr))
            del d_cs, d_cr
        if ev == n_chunks - 1:  # top segments finalize with the last chunk
            with tr.span("backward/top", cat="backward") as sp:
                d_ts, d_tr = top_grads()
                sp.sync((d_ts, d_tr))
            emit(n_chunks, (d_ts, d_tr))
            del d_ts, d_tr
        for i in by_event.get(ev, []):
            tr.instant(f"ready/b{i}", cat="encode",
                       args={"bucket": i, "event": ev})
            for g in range(G):
                with tr.span(f"encode/b{i}", cat="encode") as sp:
                    if fusable[i]:
                        us[g][i], sk = parts[i].stage_encode_merge(
                            frags[g][i])
                        frags[g][i] = []
                    else:
                        us[g][i], sk = parts[i].stage_encode(
                            groups[g][1][i], assemble(g, i))
                    sp.sync(sk)
                with tr.span(f"allreduce/b{i}", cat="comm") as sp:
                    sk_sum[g][i], scale[g][i] = parts[i].stage_reduce(
                        sk, nworkers=nworkers, include=groups[g][2])
                    sp.sync(sk_sum[g][i])
                del sk
                launched[g].append(i)
                while len(launched[g]) > 1:  # recover, one bucket behind
                    recover(g, launched[g].pop(0))
    for g in range(G):
        for i in launched[g]:
            recover(g, i)
    res = []
    for g in range(G):
        upd = spec.join([outs[g][i][0] for i in range(n)])
        ef_new = tuple(outs[g][i][1] for i in range(n))
        stats = comp.BucketedCommStats(tuple(outs[g][i][2] for i in range(n)),
                                       label=bc.name + "|interleaved")
        res.append((upd, ef_new, stats))
    return res


def group_backward(vjps):
    """Every gather group's chunked backward as one: ``vjps`` holds each
    group's ``(bwd_steps, top_grads)`` from ``model.chunked_loss_vjp``
    with the gathers, which emit (tp, n, ...) in the storage layout (tp =
    1 included). Step j runs step j of every group in group order and
    joins them along the worker dim: ``((a, b), d_cs (tp, P, b-a, f_cs),
    d_cr (tp, P, b-a, f_cr))``; ``top_grads()`` returns ``(d_top_s (tp, P,
    f), d_top_r (tp, P, f))``."""
    def join(ts):
        return ts[0] if len(ts) == 1 else torch.cat(ts, dim=1)

    def make_step(j: int):
        def run():
            outs = [steps[j]() for steps, _ in vjps]
            return (outs[0][0], join([o[1] for o in outs]),
                    join([o[2] for o in outs]))
        return run

    def top_grads():
        tops = [top() for _, top in vjps]
        return join([t[0] for t in tops]), join([t[1] for t in tops])

    return [make_step(j) for j in range(len(vjps[0][0]))], top_grads


def flat_of_chunks(bwd_steps, top_grads, d_local: int) -> torch.Tensor:
    """The post-accumulation path of a chunked backward: drain the steps
    and reassemble ``pack_segs`` order (top_s, top_r, cycle rows ascending
    per segment) as (tp, P, d_local) from ``group_backward``'s (tp, P,
    ...) slices."""
    cs_parts, cr_parts = [], []
    for step in bwd_steps:
        (a, _), d_cs, d_cr = step()
        cs_parts.append((a, d_cs))
        cr_parts.append((a, d_cr))
    d_ts, d_tr = top_grads()
    lead = tuple(d_ts.shape[:-1])

    def rows(ps):
        return [p.reshape(lead + (-1,))
                for _, p in sorted(ps, key=lambda t: t[0])]

    g = torch.cat([d_ts, d_tr.reshape(lead + (-1,))]
                  + rows(cs_parts) + rows(cr_parts), dim=-1)
    if g.shape[-1] != d_local:
        raise ValueError(f"chunked gradients cover {g.shape[-1]} of "
                         f"{d_local} coordinates")
    return g


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainStep:
    """Bound train step + its static metadata."""

    fn: Callable[..., tuple[dict, dict]]
    fs: FlatSpec
    ma: MeshAxes
    dp_mode: str
    compressor: Any | None
    d_local: int                  # flat coords per worker (compressor input)
    nworkers: int                 # size of the leading worker axis
    device: torch.device
    n_buckets: int = 1
    overlap: bool = True
    bwd_chunks: int = 0           # backward chunks (0 = monolithic backward)
    plan: BucketPlan | None = None  # readiness plan (bucketed exchange)
    fuse_encode: bool = False     # fragment-wise encode in the interleave
    # the exchange runs inside the chunked backward, at each bucket's
    # readiness event (else after it: the post-accumulation exchange)
    interleave: bool = False
    # sharded layouts: each exchange's model rank and worker slice
    comp_groups: tuple[tuple[int, slice], ...] = ()

    @property
    def sharded(self) -> bool:
        """tp > 1 or fsdp: state (tp, P, *local), module docstring."""
        return self.ma.tp > 1 or self.dp_mode == "fsdp"

    def shard(self, gb: dict) -> dict:
        """The global batch (B, ...) as the step takes it: (P, B/P, ...),
        every worker's rows; on a process mesh (1, B/P, ...), this
        process's worker's rows (the reference's batch sharding over the
        dp axes; every model rank of a worker reads the same rows)."""
        pm = self.ma.mesh
        n = self.nworkers if pm is None else self.ma.dp_size
        out = {}
        for k, v in gb.items():
            if v.shape[0] % n:
                raise ValueError(f"global batch {v.shape[0]} is not "
                                 f"divisible by {n} workers")
            v = v.reshape((n, v.shape[0] // n) + v.shape[1:])
            out[k] = v if pm is None else v[pm.worker():pm.worker() + 1]
        return out

    def init_state(self, opt: Optimizer, generator: torch.Generator) -> dict:
        """Fresh state: params drawn from ``generator`` (the global model,
        cut into rank-stacked segments at tp > 1), as ``state_from``."""
        if self.ma.tp > 1:
            params = shard_segs(self.fs.cfg, init_params(
                self.fs.cfg, generator, self.ma.tp, device=self.device),
                self.ma.tp, self.fs)[1]
        else:
            params = init_flat_params(self.fs.cfg, generator, 1, self.fs,
                                      device=self.device)
        return self.state_from(params, opt)

    def state_from(self, params: dict, opt: Optimizer,
                   ef_dtype: torch.dtype = torch.float32) -> dict:
        """The step's state from one model replica's parameters: the flat
        segments at tp = 1, the rank-stacked segments of
        ``flatten.shard_segs`` at tp > 1. 'dp' replicates them to every
        worker, 'fsdp' gives each worker of each pod its shard; zero
        optimizer and EF state (``ef_dtype`` its storage dtype)."""
        pm = self.ma.mesh
        if not self.sharded:
            return make_state(params, opt, self.compressor, self.d_local,
                              self.nworkers, ef_dtype)
        tp, P = self.ma.tp, self.nworkers
        gather, scatter = _gather_closures(
            dataclasses.replace(self.ma, mesh=None), self.dp_mode)
        one = {k: (v if tp > 1 else v[None])[:, None]
               for k, v in params.items()}
        if pm is not None:   # this process's rank and data shard only
            r, j = pm.coord("model"), pm.coord("data")
            if self.dp_mode == "fsdp":
                one = scatter(gather(one), self.ma.data)
            else:
                j = 0
            store = {k: v[r:r + 1, j:j + 1].clone() for k, v in one.items()}
        elif self.dp_mode == "fsdp":
            shards = scatter(gather(one), self.ma.data)
            store = {k: torch.cat([v] * (P // self.ma.data), dim=1)
                     for k, v in shards.items()}
        else:
            store = {k: v.expand((tp, P) + v.shape[2:]).clone()
                     for k, v in one.items()}
        store = {k: v if tp > 1 else v[0] for k, v in store.items()}
        dev = store["top_s"].device
        ef = None if self.compressor is None else tuple(
            self.compressor.init(self.d_local, len(range(*sl.indices(P))),
                                 dev) for _, sl in self.comp_groups)
        return _fresh_state(store, opt, ef, ef_dtype)


def _fresh_state(store: dict, opt: Optimizer, ef, ef_dtype: torch.dtype
                 ) -> dict:
    """A step-0 state on the stored params: zero optimizer state, the
    compressor's zero EF ``ef`` (f32) cast to ``ef_dtype``, or without a
    compressor (``ef`` None) an empty (..., P, 0) EF."""
    dev = store["top_s"].device
    opt_state = {k: opt.init(v.shape, dev) for k, v in store.items()}
    if ef is None:
        ef = torch.zeros(store["top_s"].shape[:-1] + (0,), device=dev)
    elif ef_dtype != torch.float32:
        ef = _cast_tree(ef, ef_dtype)
    return {"params": store, "opt": opt_state, "ef": ef, "step": 0}


def _cast_tree(tree, dtype: torch.dtype):
    """Every tensor of an EF state (a tensor or nested tuples of them) cast
    to ``dtype``."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_tree(t, dtype) for t in tree)
    return tree.to(dtype)


def _stored_dtype(tree) -> torch.dtype:
    """The EF state's storage dtype (``make_state`` gives every tensor
    one); f32 for a state that holds none."""
    while isinstance(tree, (tuple, list)):
        if not tree:
            return torch.float32
        tree = tree[0]
    return tree.dtype


def make_state(params: dict, opt: Optimizer, compressor, d_local: int,
               nworkers: int, ef_dtype: torch.dtype = torch.float32) -> dict:
    """Replicate single-copy flat params to P workers; zero opt/EF state.
    ``ef_dtype``: the error-feedback state's storage dtype (the step adds
    and encodes in f32 and stores the new residual back in this dtype)."""
    dev = params["top_s"].device
    rep = {k: v.unsqueeze(0).expand((nworkers,) + tuple(v.shape)).clone()
           for k, v in params.items()}
    ef = (compressor.init(d_local, nworkers, dev) if compressor is not None
          else None)
    return _fresh_state(rep, opt, ef, ef_dtype)


def make_train_step(cfg: ArchConfig, ma: MeshAxes, opt: Optimizer, *,
                    dp_mode: str = "dp",
                    spec: Any | None = None,
                    compressor_name: str | None = "gs-sgd",
                    compressor_kw: dict | None = None,
                    remat: bool = True, dtype=torch.float32,
                    microbatch: int | None = None,
                    clip_norm: float | None = None,
                    fs: FlatSpec | None = None,
                    buckets: int | None = None,
                    overlap: bool = True,
                    bwd_chunks: int | None = None,
                    fuse_encode: bool = False,
                    device: str | torch.device | None = None) -> TrainStep:
    """Build the train step over P simulated workers.

    spec: a ``repro_torch.api.ExchangeSpec`` (compressor, resolved sketch
    geometry at this step's ``d_local``, buckets, overlap); the legacy
    kwargs must stay at their defaults when it is passed. ``remat``: the
    model's cycle remat (``models.model``: each cycle checkpointed, in
    the reference's sqrt-n groups), which trades memory for recompute
    and changes no value. ``device``:
    None means the card (and raises without one); pass "cpu" for the
    plain path. At tp > 1 or in 'fsdp' the step runs the sharded layout
    (module docstring); ``fs`` then is the FlatSpec at ``ma.tp``.
    """
    device = resolve_device(device)
    if dp_mode not in ("dp", "fsdp"):
        raise ValueError(f"unknown dp_mode {dp_mode!r}")
    ma.check_mesh()
    pm = ma.mesh
    fs = fs or make_flat_spec(cfg, ma.tp)
    shapes = local_seg_shapes(fs, ma, dp_mode)
    d_local = sum(math.prod(s) for s in shapes.values())
    if spec is not None:
        if (compressor_name != "gs-sgd" or compressor_kw is not None
                or microbatch is not None or buckets is not None
                or overlap is not True or bwd_chunks is not None
                or fuse_encode is not False):
            raise ValueError("make_train_step: pass either spec= or the "
                             "legacy exchange kwargs, not both")
        spec.validate()
        if spec.shape is not None:
            raise ValueError(
                f"collective shape {spec.shape!r} is a simulator-only knob "
                "— the training step cannot apply it")
        compressor_name = (None if spec.compressor == "none"
                           else spec.compressor)
        compressor_kw = spec.compressor_kw(d_local) or None
        microbatch, buckets = spec.microbatch, spec.buckets
        overlap, bwd_chunks = spec.overlap, spec.bwd_chunks
        fuse_encode = spec.fuse_encode
    check_exchange_config(
        microbatch=microbatch, bwd_chunks=bwd_chunks,
        fuse_encode=fuse_encode,
        compressor=compressor_name if compressor_name else "dense",
        buckets=buckets, overlap=overlap)
    # In 'dp' the exchange sums the raw per-worker gradients over all dp
    # axes; in 'fsdp' the pod's data sum is already in the gradient, so
    # only the pod axis remains. Either way the update is the sum over all
    # dp_size workers and is divided once.
    sharded = ma.tp > 1 or dp_mode == "fsdp"
    if dp_mode == "dp":
        comp_axes, comp_n = ma.dp_axes, ma.dp_size
    else:
        comp_axes = (ma.pod_axis,) if ma.pod_axis else ()
        comp_n = ma.pod
    nworkers = ma.dp_size if (comp_axes or sharded) else 1
    if pm is not None:   # one rank and one worker a process
        nworkers = 1
    # the process group the exchange's collectives run over (a mesh's)
    ex_axis = pm.axis(comp_axes) if pm is not None else None
    comp_groups: tuple = ()
    if sharded and comp_axes:
        comp_groups = (((0, slice(0, 1)),) if pm is not None else
                       tuple((r, slice(0, nworkers)) for r in range(ma.tp))
                       if dp_mode == "dp" else
                       tuple((r, slice(j, nworkers, ma.data))
                             for r in range(ma.tp) for j in range(ma.data)))
    compressor = None
    plan = None
    bucketed = bool(buckets is not None and comp_axes)
    if comp_axes and (compressor_name not in (None, "dense") or bucketed):
        if compressor_name in (None, "dense"):
            compressor = comp.make("dense")
        else:
            compressor = comp.make(compressor_name, **(compressor_kw or {}))
        if bucketed:
            plan = bucket_plan(shapes, buckets, bwd_chunks or 1)
            compressor = comp.bucketize(compressor, plan.sizes)

    # The readiness interleave needs a staged bucketed compressor and the
    # pipelined schedule; otherwise a chunked backward still runs, but the
    # exchange sees the gradient only after the whole backward.
    chunked = bwd_chunks is not None
    interleave = (chunked and plan is not None and overlap
                  and all(hasattr(c, "stage_encode")
                          for c in compressor.parts))

    gather, scatter = (_gather_closures(ma, dp_mode) if pm is None
                       else _mesh_gather_closures(ma, dp_mode))
    ctx = ma.ctx(dtype)
    # workers a gather group in this process (a mesh gathers across them)
    n_group = ma.data if dp_mode == "fsdp" and pm is None else 1
    tp_lead = ma.tp if pm is None else 1            # the rank dim's length
    inv_tp = 1.0 / ma.tp

    def loss_and_grad(params: dict, batch: dict
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-worker loss (P,) and packed gradients (tp, P, d_local) in
        the storage layout (tp = 1 included). Each gather group's storage
        is gathered once into leaves (at tp = 1 in 'dp': views of the
        worker's params); every worker of the group (and each of its
        microbatch slices) runs its rows on them, its (tp,)-loss seeded
        with 1/tp, the gradients accumulating on the leaves in f32 in
        slice order, as the reference's scan; the sum is then scattered
        to the group's workers and divided by the slice count."""
        tp, P = ma.tp, nworkers
        g_flat = torch.empty((tp_lead, P, d_local), dtype=torch.float32,
                             device=device)
        losses = torch.empty((P,), dtype=torch.float32, device=device)
        b_loc = batch["tokens"].shape[1]
        mb = microbatch or b_loc
        if mb < b_loc and b_loc % mb != 0:
            raise ValueError(f"local batch {b_loc} is not divisible by "
                             f"microbatch {mb}")
        n_mb = max(1, b_loc // mb)
        tr = obtrace.current()
        for a in range(0, P, n_group):
            store = {k: (params[k] if tp > 1 else params[k][None])
                     [:, a:a + n_group] for k in SEG_NAMES}
            use = {k: v.detach().requires_grad_()
                   for k, v in gather(store).items()}
            del store
            for w in range(a, a + n_group):
                loss_w = None
                for i in range(n_mb):
                    rows = slice(i * mb, (i + 1) * mb) if n_mb > 1 else \
                        slice(None)
                    wb = {k: v[w, rows] for k, v in batch.items()}
                    with torch.enable_grad():
                        with tr.span(f"model/forward/w{w}", cat="detail"):
                            loss = inv_tp * mdl.loss_fn(
                                cfg, fs, use, wb, dtype=dtype, remat=remat,
                                ctx=ctx)
                        with tr.span(f"model/backward/w{w}", cat="detail"):
                            loss.sum().backward()
                    loss = loss.detach()
                    loss = loss[0] if loss.ndim else loss
                    loss_w = loss if loss_w is None else loss_w + loss
                losses[w] = (loss_w / n_mb if n_mb > 1 else loss_w) * ma.tp
            with tr.span("model/pack", cat="detail"):
                grads = scatter({k: (v.grad if v.grad is not None
                                     else torch.zeros_like(v))
                                 for k, v in use.items()}, n_group)
                del use
                for j in range(n_group):
                    g_flat[:, a + j] = pack_segs({k: grads[k][:, j]
                                                  for k in SEG_NAMES}, lead=1)
                del grads
        if n_mb > 1:
            g_flat /= n_mb
        return losses, g_flat

    def forward(params: dict, batch: dict):
        """Every worker's chunked forward: per-worker loss (P,) and the
        workers' backward as one (``group_backward``: (tp, P, ...) slices
        in the storage layout, tp = 1 included). One chunked graph a
        gather group, as ``loss_and_grad`` loops: the group's storage
        gathered by the chunked forward itself (the top segments once,
        each chunk's cycle rows in their chunk; at tp = 1 in 'dp' views
        of the worker's params), every worker of the group on those
        leaves, the 1/tp seed. All graphs stay alive until the backward
        has run."""
        losses = torch.empty((nworkers,), dtype=torch.float32, device=device)
        vjps = []
        for a in range(0, nworkers, n_group):
            store = {k: (params[k] if ma.tp > 1 else params[k][None])
                     [:, a:a + n_group] for k in SEG_NAMES}
            wbs = [{k: v[w] for k, v in batch.items()}
                   for w in range(a, a + n_group)]
            loss, steps, top = mdl.chunked_loss_vjp(
                cfg, fs, store, wbs, chunks=bwd_chunks, dtype=dtype,
                remat=remat, ctx=ctx, gathers=(gather, scatter),
                grad_seed=inv_tp)
            for j, l in enumerate(loss):   # as loss_and_grad reports it
                l = l[0] if l.ndim else l
                losses[a + j] = (inv_tp * l) * ma.tp
            vjps.append((steps, top))
        return losses, group_backward(vjps)

    def exchange(ef, g, include):
        """The post-accumulation exchange of (n, d) gradients over comp_n
        workers: (upd_sum, ef_new). Without a compressor the dense psum
        (or, with no dp axis to exchange over, the gradient itself)."""
        kw = {} if include is None else {"include": include}
        if isinstance(compressor, comp.BucketedCompressor):
            with ar.over(ex_axis):
                upd, ef_new, _ = exchange_bucketed(compressor, ef, g,
                                                   nworkers=comp_n,
                                                   overlap=overlap, **kw)
            return upd, ef_new
        with obtrace.current().span("exchange", cat="comm") as sp, \
                ar.over(ex_axis):
            if compressor is not None:
                upd, ef_new, _ = compressor.step(ef, g, nworkers=comp_n,
                                                 **kw)
            else:
                upd = ar.psum_allreduce(g) if comp_axes else g
                ef_new = ef
            sp.sync(upd)
        return upd, ef_new

    def update(params: dict, opt_state: dict, step: int,
               g_mean: torch.Tensor):
        """The optimizer on the mean gradient g_mean (tp, P, d_local): its
        global norm (P,) (coordinates are disjoint over the ranks and, in
        fsdp, over the pod's data shards: the norm sums over both), the
        clip (in place), ``opt.apply``."""
        # each (rank, worker) row's squares summed by the call a mesh's
        # process makes on its own (1, 1, d_local) row, then the ranks
        # (and the pod's data shards) added in the mesh's order
        tp_n, p_n = g_mean.shape[:2]
        gsq = torch.cat([torch.sum(g_mean[r:r + 1, w:w + 1]
                                   * g_mean[r:r + 1, w:w + 1], dim=-1)
                         for r in range(tp_n) for w in range(p_n)]
                        ).reshape(tp_n, p_n)
        gsq = pgroup.fold_sum(gsq)                                 # (P,)
        if pm is not None:   # the other ranks' (and data shards') squares
            gsq = pgroup.all_reduce(gsq, pm.axis("model"))
            if dp_mode == "fsdp":
                gsq = pgroup.all_reduce(gsq, pm.axis("data"))
        elif dp_mode == "fsdp":
            gsq = pgroup.fold_sum(gsq.reshape(-1, ma.data), dim=-1,
                                  keepdim=True).expand(
                -1, ma.data).reshape(nworkers)
        gnorm = torch.sqrt(gsq)
        if clip_norm is not None:  # global-norm clip, aggregated grad
            g_mean *= torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12),
                                  max=1.0)[None, :, None]
        g_segs = unpack_segs(g_mean if ma.tp > 1 else g_mean[0], params,
                             lead=2 if ma.tp > 1 else 1)
        new_params, new_opt = {}, {}
        for k in SEG_NAMES:
            new_params[k], new_opt[k] = opt.apply(params[k], g_segs[k],
                                                  opt_state[k], step)
        return new_params, new_opt, gnorm

    def train_step(state: dict, batch: dict,
                   include: torch.Tensor | None = None) -> tuple[dict, dict]:
        params, opt_state, ef_stored, step = (
            state["params"], state["opt"], state["ef"], state["step"])
        tr = obtrace.current()
        if chunked:
            with tr.span("forward", cat="forward") as sp:
                losses, (bwd_steps, top_grads) = forward(params, batch)
                sp.sync(losses)
            if not interleave:
                with tr.span("backward", cat="backward") as sp:
                    g = flat_of_chunks(bwd_steps, top_grads, d_local)
                    sp.sync(g)
                del bwd_steps, top_grads
        else:
            # monolithic autodiff: forward and backward are one call, so
            # the span carries both under cat='backward'
            with tr.span("loss_and_grad", cat="backward") as sp:
                losses, g = loss_and_grad(params, batch)
                sp.sync(g)
        # one exchange a model rank (and, in fsdp, a data shard); the EF
        # is stored in its own dtype and added/encoded in f32
        groups = comp_groups or ((0, slice(None)),)
        efs = ef_stored if comp_groups else (ef_stored,)
        dtypes = [_stored_dtype(e) for e in efs]
        if compressor is not None:
            efs = [_cast_tree(e, torch.float32) for e in efs]
        incs = [None if include is None else include[sl]
                for _, sl in groups]
        if interleave:
            # one backward, every group's exchange at its events
            with ar.over(ex_axis):
                res = exchange_interleaved(
                    compressor, plan, bwd_steps, top_grads,
                    tuple(zip(groups, efs, incs)), nworkers=comp_n,
                    fuse_encode=fuse_encode)
            del bwd_steps, top_grads
            if sharded:
                g = torch.empty((tp_lead, nworkers, d_local),
                                dtype=torch.float32, device=device)
        else:
            res = [None] * len(groups)
        ef_new = []
        for gi, ((r, sl), ef_g, inc, ef_dtype) in enumerate(
                zip(groups, efs, incs, dtypes)):
            if res[gi] is None:
                upd, ef_g = exchange(ef_g, g[r, sl], inc)
            else:
                (upd, ef_g, _), res[gi] = res[gi], None
            if sharded:
                g[r, sl] = upd
            else:
                g = upd[None]
            del upd
            ef_new.append(_cast_tree(ef_g, ef_dtype)
                          if compressor is not None else ef_g)
        ef_new = tuple(ef_new) if comp_groups else ef_new[0]
        with tr.span("optimizer", cat="optimizer") as sp:
            # the sharded step divides its own g buffer in place; at tp = 1
            # in 'dp' g may be the exchange's broadcast sum
            g_mean = g.div_(ma.dp_size) if sharded else g / ma.dp_size
            del g
            new_params, new_opt, gnorm = update(params, opt_state, step,
                                                g_mean)
            sp.sync(new_params["top_s"])
        new_state = {"params": new_params, "opt": new_opt, "ef": ef_new,
                     "step": step + 1}
        # the mean over every worker: on a mesh the dp group's losses,
        # gathered in worker order
        every = (losses if pm is None
                 else pgroup.all_gather(losses, pm.axis(ma.dp_axes))
                 .reshape(-1))
        return new_state, {"loss": every.mean(), "grad_norm": gnorm,
                           "worker_loss": losses}

    return TrainStep(fn=train_step, fs=fs, ma=ma, dp_mode=dp_mode,
                     compressor=compressor, d_local=d_local,
                     nworkers=nworkers, device=device,
                     n_buckets=(compressor.spec.n
                                if isinstance(compressor,
                                              comp.BucketedCompressor) else 1),
                     overlap=overlap, bwd_chunks=(bwd_chunks or 0),
                     plan=plan, fuse_encode=fuse_encode,
                     comp_groups=comp_groups, interleave=bool(interleave))


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def make_serve_fns(cfg: ArchConfig, ma: MeshAxes, *, dp_mode: str = "dp",
                   dtype=torch.bfloat16, comm_dtype=None,
                   fs: FlatSpec | None = None):
    """(prefill, decode) bound to the storage layout: params segments only,
    no optimizer or EF state at serving time. Each runs where the params
    it is given lie.

    ``params``: one model replica's storage. In 'dp' at tp = 1 the flat
    segments; at tp > 1 the rank-stacked (tp, *local) segments
    (``flatten.shard_segs``). In 'fsdp' one pod's data workers' shards,
    (data, *local), or (tp, data, *local) at tp > 1. Each call gathers
    them into the use layout (``_gather_closures``) and runs the model
    with every rank; its results and the cache are as ``models.model``
    describes for ``ctx``. ``comm_dtype=torch.float8_e4m3fn`` puts the
    activation reductions on the wire in fp8 (tp > 1 and a non-f32
    ``dtype``; the identity otherwise, as in the reference). On a process
    mesh ``params`` is this process's storage (its rank's, and in 'fsdp'
    its data shard's: leading dims of 1), gathered over the mesh, and the
    results are this rank's (the logits its vocab shard)."""
    ma.check_mesh()
    fs = fs or make_flat_spec(cfg, ma.tp)
    ctx = ma.ctx(dtype, comm_dtype)
    gather, _ = (_gather_closures(ma, dp_mode) if ma.mesh is None
                 else _mesh_gather_closures(ma, dp_mode))
    tp = ma.tp

    def use(params: dict) -> dict:
        if tp == 1 and dp_mode == "dp":
            return params
        grouped = {k: v if tp > 1 else v[None] for k, v in params.items()}
        if dp_mode == "dp":
            grouped = {k: v[:, None] for k, v in grouped.items()}
        return gather(grouped)

    def prefill(params: dict, batch: dict, cache: Any):
        return mdl.prefill_fn(cfg, fs, use(params), batch, cache,
                              dtype=dtype, ctx=ctx)

    def decode(params: dict, tokens: torch.Tensor, kv_len, cache: Any,
               cross_kv: torch.Tensor | None = None):
        return mdl.decode_fn(cfg, fs, use(params), tokens, kv_len, cache,
                             cross_kv=cross_kv, dtype=dtype, ctx=ctx)

    return prefill, decode
