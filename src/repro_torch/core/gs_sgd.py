"""gs-SGD distributed train step with P simulated workers on one device.

Port of ``repro/core/gs_sgd.py`` for 'dp' mode at tp=1. The reference
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
-> g_mean = upd / P -> optimizer.

With ``bwd_chunks=K`` the backward is cut into K chunks
(``model.chunked_loss_vjp``): the forward runs for every worker, then
``exchange_interleaved`` drives the backward itself, chunk by chunk, and
starts each bucket's encode and sketch all-reduce at the event that
completes its gradient, recovering one bucket behind. With
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
``encode/b{i}`` (the reference gives it no span of its own). With tracing
off (``NULL``) a span is only a ``torch.profiler.record_function`` range
and ``sync`` does nothing, so the step's device work is the same and it
never waits on the card; under ``torch.profiler.profile`` each range's
device time is the sum of the kernels launched inside it
(``chip_smoke.py`` reads them). With a tracer active each span syncs the
card at its end, so its host duration covers its kernels.

``microbatch=mb`` cuts each worker's batch into slices of mb rows and
sums their losses and gradients in f32, then divides by the slice count
(``jax.lax.scan`` in the reference, a Python loop here). ``clip_norm``
scales the aggregated gradient to at most that global norm. Left to later
slices: tp > 1 and fsdp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.api.spec import check_exchange_config
from repro_torch.core import allreduce as ar
from repro_torch.core import compression as comp
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import model as mdl
from repro_torch.models.common import ArchConfig
from repro_torch.models.flatten import (SEG_NAMES, BucketPlan, FlatSpec,
                                        bucket_plan, init_flat_params,
                                        make_flat_spec, pack_segs,
                                        unpack_segs)
from repro_torch.obs import trace as obtrace
from repro_torch.optim.optimizers import Optimizer


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Static description of the (simulated) mesh the step runs in."""

    tp: int
    data: int
    pod: int = 1
    tp_axis: str | None = "model"
    data_axis: str | None = "data"  # None -> single-worker path
    pod_axis: str | None = None

    @property
    def dp_axes(self) -> tuple[str, ...]:
        axes = (self.pod_axis,) if self.pod_axis else ()
        return axes + ((self.data_axis,) if self.data_axis else ())

    @property
    def dp_size(self) -> int:
        return self.pod * self.data


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
                         ef_state, bwd_steps, top_grads, *,
                         nworkers: int, include=None,
                         fuse_encode: bool = False):
    """Readiness-driven bucketed exchange interleaved with backward chunks.

    Port of ``repro/core/gs_sgd.py:exchange_interleaved``, on the worker
    axis: ``bwd_steps`` / ``top_grads`` are every worker's chunked backward
    (``worker_backward``) and emit (P, ...) gradient slices, chunk K-1
    first, the top segments last, at the packed offsets of ``plan.emits``.
    After each emission event every bucket whose packed range is complete
    (``plan.readiness``) is encoded and its sketch all-reduced, and the
    recovery runs one bucket behind:

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
    and converted once (``stage_encode_merge``). A bucket whose compressor cannot fuse (the TS
    encoder, a dense baseline) assembles its slices and encodes them at its
    event. Returns (upd_sum (P, d), ef_new, BucketedCommStats).
    """
    parts, spec = bc.parts, bc.spec
    n = spec.n
    by_event: dict[int, list[int]] = {}
    for i in plan.order:
        by_event.setdefault(plan.readiness[i], []).append(i)
    emits: dict[int, list[tuple[int, int]]] = {}  # event -> (offset, length)
    for off, m, ev in plan.emits:
        emits.setdefault(ev, []).append((off, m))

    tr = obtrace.current()
    fusable = [bool(fuse_encode and getattr(p, "can_fuse", False))
               for p in parts]
    frags: list[list] = [[] for _ in range(n)]  # (off-in-bucket, u, sketch)
    # (packed offset, (P, m) slice); kept only for buckets that assemble
    pieces: list[tuple[int, torch.Tensor]] = []
    keep_pieces = not all(fusable)

    def fuse_piece(off: int, arr: torch.Tensor) -> None:
        """Partial-encode the overlap of one emitted slice with every
        fusable bucket, at its offset inside that bucket."""
        for i, lo, hi in plan.overlaps(off, arr.shape[-1]):
            if not fusable[i]:
                continue
            o = spec.offsets[i]
            with tr.span(f"encode/b{i}", cat="encode") as sp:
                u_piece, sk = parts[i].stage_encode_partial(
                    ef_state[i][:, lo - o:hi - o], arr[:, lo - off:hi - off],
                    lo - o)
                sp.sync(sk.limbs)
            frags[i].append((lo - o, u_piece, sk))

    def emit(ev: int, grads) -> None:
        """Emit event ``ev``'s gradient slices, (P, ...) each, at the
        plan's packed offsets."""
        for (off, m), g in zip(emits[ev], grads):
            if g.numel() != nworkers * m:
                raise ValueError(f"event {ev} emitted {tuple(g.shape)} at "
                                 f"offset {off}; the plan has {m} a worker")
            if not m:
                continue
            arr = g.reshape(nworkers, m)
            if keep_pieces:
                pieces.append((off, arr))
            fuse_piece(off, arr)

    def assemble(i: int) -> torch.Tensor:
        o, sz = spec.offsets[i], spec.sizes[i]
        got = []
        for off, arr in pieces:
            lo, hi = max(o, off), min(o + sz, off + arr.shape[-1])
            if lo < hi:
                got.append((lo, arr[:, lo - off:hi - off]))
        got.sort(key=lambda t: t[0])
        if sum(a.shape[-1] for _, a in got) != sz:
            raise ValueError(
                f"bucket {i} (offset {o}, size {sz}) is not covered by the "
                "emitted gradient slices at its readiness event")
        return got[0][1] if len(got) == 1 else torch.cat(
            [a for _, a in got], dim=-1)

    us: list = [None] * n
    sk_sum: list = [None] * n
    scale: list = [None] * n
    outs: list = [None] * n
    launched: list[int] = []

    def recover(i: int) -> None:
        with tr.span(f"recover/b{i}", cat="recover") as sp:
            outs[i] = parts[i].stage_recover(
                us[i], sk_sum[i], scale[i], nworkers=nworkers,
                include=include)
            sp.sync(outs[i][0])
        us[i] = sk_sum[i] = None

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
            with tr.span(f"encode/b{i}", cat="encode") as sp:
                if fusable[i]:
                    us[i], sk = parts[i].stage_encode_merge(frags[i])
                    frags[i] = []
                else:
                    us[i], sk = parts[i].stage_encode(ef_state[i],
                                                      assemble(i))
                sp.sync(sk)
            with tr.span(f"allreduce/b{i}", cat="comm") as sp:
                sk_sum[i], scale[i] = parts[i].stage_reduce(
                    sk, nworkers=nworkers, include=include)
                sp.sync(sk_sum[i])
            del sk
            launched.append(i)
            while len(launched) > 1:  # recover, one bucket behind
                recover(launched.pop(0))
    for i in launched:
        recover(i)
    upd = spec.join([outs[i][0] for i in range(n)])
    ef_new = tuple(outs[i][1] for i in range(n))
    stats = comp.BucketedCommStats(tuple(outs[i][2] for i in range(n)),
                                   label=bc.name + "|interleaved")
    return upd, ef_new, stats


def worker_backward(vjps):
    """Every worker's chunked backward as one: ``vjps`` holds each
    worker's ``(bwd_steps, top_grads)`` from ``model.chunked_loss_vjp``.
    Returns the same contract on the worker axis: step j runs step j of
    every worker and returns ``((a, b), d_cs (P, b-a, f_cs), d_cr (P,
    b-a, f_cr))``; ``top_grads()`` returns ``(d_top_s (P, f), d_top_r (P,
    f))``."""
    def make_step(j: int):
        def run():
            outs = [steps[j]() for steps, _ in vjps]
            return (outs[0][0], torch.stack([o[1] for o in outs]),
                    torch.stack([o[2] for o in outs]))
        return run

    def top_grads():
        tops = [top() for _, top in vjps]
        return (torch.stack([t[0] for t in tops]),
                torch.stack([t[1] for t in tops]))

    return [make_step(j) for j in range(len(vjps[0][0]))], top_grads


def flat_of_chunks(bwd_steps, top_grads, d_local: int) -> torch.Tensor:
    """The post-accumulation fallback of a chunked backward: drain the
    steps and reassemble ``pack_segs`` order (top_s, top_r, cycle rows
    ascending per segment) as (P, d_local)."""
    cs_parts, cr_parts = [], []
    for step in bwd_steps:
        (a, _), d_cs, d_cr = step()
        cs_parts.append((a, d_cs))
        cr_parts.append((a, d_cr))
    d_ts, d_tr = top_grads()
    nw = d_ts.shape[0]

    def rows(ps):
        return [p.reshape(nw, -1) for _, p in sorted(ps, key=lambda t: t[0])]

    g = torch.cat([d_ts.reshape(nw, -1), d_tr.reshape(nw, -1)]
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

    def init_state(self, opt: Optimizer, generator: torch.Generator) -> dict:
        """Fresh state: params drawn from ``generator``, replicated to P."""
        params = init_flat_params(self.fs.cfg, generator, 1, self.fs,
                                  device=self.device)
        return make_state(params, opt, self.compressor, self.d_local,
                          self.nworkers)


def make_state(params: dict, opt: Optimizer, compressor, d_local: int,
               nworkers: int) -> dict:
    """Replicate single-copy flat params to P workers; zero opt/EF state."""
    dev = params["top_s"].device
    rep = {k: v.unsqueeze(0).expand((nworkers,) + tuple(v.shape)).clone()
           for k, v in params.items()}
    opt_state = {k: opt.init(v.shape, dev) for k, v in rep.items()}
    ef = (compressor.init(d_local, nworkers, dev) if compressor is not None
          else torch.zeros((nworkers, 0), device=dev))
    return {"params": rep, "opt": opt_state, "ef": ef, "step": 0}


def _unsupported(name: str) -> NotImplementedError:
    return NotImplementedError(f"{name} is not ported yet (left to a later "
                               "slice of the PyTorch port)")


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
    kwargs must stay at their defaults when it is passed. ``device``:
    None means the card (and raises without one); pass "cpu" for the
    plain path.
    """
    device = resolve_device(device)
    if dp_mode != "dp" or ma.tp != 1:
        raise _unsupported(f"dp_mode={dp_mode!r} with tp={ma.tp}")
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
    comp_axes = ma.dp_axes
    nworkers = ma.dp_size if comp_axes else 1
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
    interleave = (bwd_chunks is not None and plan is not None and overlap
                  and all(hasattr(c, "stage_encode")
                          for c in compressor.parts))

    def worker_loss_and_grad(params: dict, wb: dict, p: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Worker p's loss and packed flat gradient on the rows ``wb``."""
        segs = {k: params[k][p].detach().requires_grad_()
                for k in SEG_NAMES}
        with torch.enable_grad():
            loss = mdl.loss_fn(cfg, fs, segs, wb, dtype=dtype, remat=remat)
            loss.backward()
        return loss.detach(), pack_segs({k: segs[k].grad for k in SEG_NAMES})

    def loss_and_grad(params: dict, batch: dict
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-worker loss (P,) and packed flat gradients (P, d_local).
        With ``microbatch`` below the local batch: the sum of the slices'
        losses and gradients (f32, from zeros, in slice order), divided by
        the slice count, as the reference's scan."""
        losses = []
        g_flat = torch.empty((nworkers, d_local), dtype=torch.float32,
                             device=device)
        b_loc = batch["tokens"].shape[1]
        mb = microbatch or b_loc
        if mb < b_loc and b_loc % mb != 0:
            raise ValueError(f"local batch {b_loc} is not divisible by "
                             f"microbatch {mb}")
        for p in range(nworkers):
            wb = {k: batch[k][p] for k in ("tokens", "labels")}
            if mb >= b_loc:
                loss, g_flat[p] = worker_loss_and_grad(params, wb, p)
            else:
                loss = torch.zeros((), dtype=torch.float32, device=device)
                g_flat[p] = 0.0
                for i in range(b_loc // mb):
                    sl = {k: v[i * mb:(i + 1) * mb] for k, v in wb.items()}
                    l_i, g_i = worker_loss_and_grad(params, sl, p)
                    loss = loss + l_i
                    g_flat[p] += g_i
                    del g_i
                loss = loss / (b_loc // mb)
                g_flat[p] /= b_loc // mb
            losses.append(loss)
        return torch.stack(losses), g_flat

    def forward(params: dict, batch: dict):
        """Every worker's chunked forward: per-worker loss (P,) and the
        workers' backward as one (``worker_backward``). All P graphs stay
        alive until the backward has run."""
        losses, vjps = [], []
        for p in range(nworkers):
            segs = {k: params[k][p] for k in SEG_NAMES}
            wb = {k: batch[k][p] for k in ("tokens", "labels")}
            loss, steps, top = mdl.chunked_loss_vjp(
                cfg, fs, segs, wb, chunks=bwd_chunks, dtype=dtype,
                remat=remat)
            losses.append(loss)
            vjps.append((steps, top))
        return torch.stack(losses), worker_backward(vjps)

    def train_step(state: dict, batch: dict,
                   include: torch.Tensor | None = None) -> tuple[dict, dict]:
        params, opt_state, ef, step = (state["params"], state["opt"],
                                       state["ef"], state["step"])
        tr = obtrace.current()
        g_flat = None
        if bwd_chunks is not None:
            with tr.span("forward", cat="forward") as sp:
                losses, (bwd_steps, top_grads) = forward(params, batch)
                sp.sync(losses)
            if not interleave:
                with tr.span("backward", cat="backward") as sp:
                    g_flat = flat_of_chunks(bwd_steps, top_grads, d_local)
                    sp.sync(g_flat)
        else:
            # monolithic autodiff: forward and backward are one call, so
            # the span carries both under cat='backward'
            with tr.span("loss_and_grad", cat="backward") as sp:
                losses, g_flat = loss_and_grad(params, batch)
                sp.sync(g_flat)
        if interleave:
            kw = {} if include is None else {"include": include}
            upd, ef_new, _ = exchange_interleaved(
                compressor, plan, ef, bwd_steps, top_grads,
                nworkers=nworkers, fuse_encode=fuse_encode, **kw)
            del bwd_steps, top_grads
        elif isinstance(compressor, comp.BucketedCompressor):
            kw = {} if include is None else {"include": include}
            upd, ef_new, _ = exchange_bucketed(
                compressor, ef, g_flat, nworkers=nworkers, overlap=overlap,
                **kw)
        else:
            with tr.span("exchange", cat="comm") as sp:
                if compressor is not None:
                    kw = {} if include is None else {"include": include}
                    upd, ef_new, _ = compressor.step(
                        ef, g_flat, nworkers=nworkers, **kw)
                else:
                    upd = ar.psum_allreduce(g_flat) if comp_axes else g_flat
                    ef_new = ef
                sp.sync(upd)
        del g_flat
        with tr.span("optimizer", cat="optimizer") as sp:
            g_mean = upd / ma.dp_size
            del upd
            gnorm = torch.sqrt(torch.sum(g_mean * g_mean, dim=-1))
            if clip_norm is not None:  # global-norm clip, aggregated grad
                g_mean *= torch.clamp(
                    clip_norm / torch.clamp(gnorm, min=1e-12),
                    max=1.0)[:, None]
            g_segs = unpack_segs(g_mean, params, lead=1)
            new_params, new_opt = {}, {}
            for k in SEG_NAMES:
                new_params[k], new_opt[k] = opt.apply(
                    params[k], g_segs[k], opt_state[k], step)
            sp.sync(new_params["top_s"])
        new_state = {"params": new_params, "opt": new_opt, "ef": ef_new,
                     "step": step + 1}
        return new_state, {"loss": losses.mean(), "grad_norm": gnorm,
                           "worker_loss": losses}

    return TrainStep(fn=train_step, fs=fs, ma=ma, dp_mode=dp_mode,
                     compressor=compressor, d_local=d_local,
                     nworkers=nworkers, device=device,
                     n_buckets=(compressor.spec.n
                                if isinstance(compressor,
                                              comp.BucketedCompressor) else 1),
                     overlap=overlap, bwd_chunks=(bwd_chunks or 0),
                     plan=plan, fuse_encode=fuse_encode)
