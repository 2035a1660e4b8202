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

Spans: each phase of the step runs under ``torch.profiler.record_function``
(``loss_and_grad``, ``encode/b{i}``, ``allreduce/b{i}``, ``recover/b{i}``,
``exchange`` for the monolithic exchange, ``optimizer``) — the reference's
span names. Outside a profiler they cost one small host object each; under
``torch.profiler.profile`` each span's device time is the sum of the
kernels launched inside it (``chip_smoke.py`` reads them).

Left to later slices: microbatch accumulation, gradient clipping, the
chunked backward and readiness interleave (``bwd_chunks``,
``fuse_encode``), tp > 1 and fsdp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch.profiler import record_function as span

from repro_torch.core import allreduce as ar
from repro_torch.core import compression as comp
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import model as mdl
from repro_torch.models.common import ArchConfig
from repro_torch.models.flatten import (SEG_NAMES, FlatSpec, bucket_sizes,
                                        init_flat_params, make_flat_spec,
                                        pack_segs, unpack_segs)
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
    if not overlap or n == 1 or not staged:
        with span("exchange"):
            return bc.step(ef_state, g_flat, nworkers=nworkers,
                           include=include)
    parts = bc.spec.split(g_flat)
    us: list = [None] * n
    sks: list = [None] * n
    outs: list = [None] * n
    with span("encode/b0"):
        us[0], sks[0] = bc.parts[0].stage_encode(ef_state[0], parts[0])
    for i in range(n):
        with span(f"allreduce/b{i}"):
            sk_sum, scale = bc.parts[i].stage_reduce(
                sks[i], nworkers=nworkers, include=include)
        sks[i] = None
        if i + 1 < n:  # next bucket's encode — independent of the reduce
            with span(f"encode/b{i + 1}"):
                us[i + 1], sks[i + 1] = bc.parts[i + 1].stage_encode(
                    ef_state[i + 1], parts[i + 1])
        with span(f"recover/b{i}"):
            outs[i] = bc.parts[i].stage_recover(
                us[i], sk_sum, scale, nworkers=nworkers, include=include)
        us[i] = None
    upd = bc.spec.join([o[0] for o in outs])
    ef_new = tuple(o[1] for o in outs)
    stats = comp.BucketedCommStats(tuple(o[2] for o in outs),
                                   label=bc.name + "|overlap")
    return upd, ef_new, stats


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
    if microbatch is not None:
        raise _unsupported("microbatch accumulation")
    if clip_norm is not None:
        raise _unsupported("gradient clipping")
    if bwd_chunks is not None or fuse_encode:
        raise _unsupported("the chunked backward (bwd_chunks/fuse_encode)")

    comp_axes = ma.dp_axes
    nworkers = ma.dp_size if comp_axes else 1
    compressor = None
    bucketed = bool(buckets is not None and comp_axes)
    if comp_axes and (compressor_name not in (None, "dense") or bucketed):
        if compressor_name in (None, "dense"):
            compressor = comp.make("dense")
        else:
            compressor = comp.make(compressor_name, **(compressor_kw or {}))
        if bucketed:
            compressor = comp.bucketize(compressor,
                                        bucket_sizes(shapes, buckets))

    def loss_and_grad(params: dict, batch: dict
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-worker loss (P,) and packed flat gradients (P, d_local)."""
        losses = []
        g_flat = torch.empty((nworkers, d_local), dtype=torch.float32,
                             device=device)
        for p in range(nworkers):
            segs = {k: params[k][p].detach().requires_grad_()
                    for k in SEG_NAMES}
            wb = {k: batch[k][p] for k in ("tokens", "labels")}
            with torch.enable_grad():
                loss = mdl.loss_fn(cfg, fs, segs, wb, dtype=dtype,
                                   remat=remat)
                loss.backward()
            g_flat[p] = pack_segs({k: segs[k].grad for k in SEG_NAMES})
            losses.append(loss.detach())
            del segs, loss
        return torch.stack(losses), g_flat

    def train_step(state: dict, batch: dict,
                   include: torch.Tensor | None = None) -> tuple[dict, dict]:
        params, opt_state, ef, step = (state["params"], state["opt"],
                                       state["ef"], state["step"])
        with span("loss_and_grad"):
            losses, g_flat = loss_and_grad(params, batch)
        if isinstance(compressor, comp.BucketedCompressor):
            kw = {} if include is None else {"include": include}
            upd, ef_new, _ = exchange_bucketed(
                compressor, ef, g_flat, nworkers=nworkers, overlap=overlap,
                **kw)
        else:
            with span("exchange"):
                if compressor is not None:
                    kw = {} if include is None else {"include": include}
                    upd, ef_new, _ = compressor.step(
                        ef, g_flat, nworkers=nworkers, **kw)
                else:
                    upd = ar.psum_allreduce(g_flat) if comp_axes else g_flat
                    ef_new = ef
        del g_flat
        with span("optimizer"):
            g_mean = upd / ma.dp_size
            del upd
            gnorm = torch.sqrt(torch.sum(g_mean * g_mean, dim=-1))
            g_segs = unpack_segs(g_mean, params, lead=1)
            new_params, new_opt = {}, {}
            for k in SEG_NAMES:
                new_params[k], new_opt[k] = opt.apply(
                    params[k], g_segs[k], opt_state[k], step)
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
                     overlap=overlap)
