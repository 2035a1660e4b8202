"""The dry-run: one production rank's step at its local shapes, on the card
or on the meta device, for every (arch x shape x mesh) cell.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell's ``shard_map`` step for 256 or 512 placeholder devices and reads
XLA's memory and cost analyses and the collectives of the optimized HLO.
Here one process joins a *fake* world of the production mesh's size
(``make_production_mesh``: (16, 16) ('data', 'model'), 256 ranks, or
(2, 16, 16) ('pod', 'data', 'model'), 512) as rank 0 and runs that
rank's step: the train step of ``core.gs_sgd.make_train_step`` or the
serve step of ``make_serve_fns``, on the state, batch and cache that rank
holds (the reference's global specs of ``launch/specs.py`` cut to one
rank). On a fake world the collectives of ``core.pgroup`` move nothing
and return tensors of their results' shapes (``core.pgroup``'s
docstring), so the step runs alone:

* ``--device cuda`` (the default; raises without a card): a warm-up
  step, then one measured step. ``peak_bytes`` is
  ``torch.cuda.max_memory_allocated`` over the measured step (the
  arguments included), ``step_seconds`` its host time ending in a sync,
  ``launches`` the kernels it launched (``kernels.dispatch.LAUNCHES``),
  ``outputs_finite`` whether its float outputs (a train step's metrics, a
  prefill's logits) are finite and ``loss`` a train step's loss.
* ``--device meta``: the same step on meta tensors (the kernel wrappers'
  shape functions, ``kernels.dispatch``), one call: every field but the
  peak, ``outputs_finite`` and ``loss`` (null). This covers the cells no
  single card holds.

Fields (the reference's schema): ``memory.argument_bytes`` the bytes of
the rank's arguments as the reference passes them (its global specs cut
to one rank: f32 params and optimizer slots, the EF in its dtype, the
int32 step, int32 tokens and labels; serving: the params, the batch or
the token and ``kv_len``, the cache, the vlm's ``cross_kv``);
``output_bytes`` the step's outputs; ``temp_bytes`` the peak less both
(null on meta); ``cost.flops`` from ``torch.utils.flop_counter.
FlopCounterMode`` over the warm-up step (matmuls, convolutions and
attention, recompute included); ``collectives`` the wire bytes by kind
(``per_kind``: count, result bytes, wire bytes = result bytes x the
reference's ``_WIRE_FACTOR``, pod-crossing wire bytes, group sizes) and
by group (``per_axis``), with ``total_wire_bytes`` and
``pod_crossing_wire_bytes``. ``alias_bytes`` and ``bytes_accessed`` have
no counterpart here (null); ``compile_seconds`` is ``build_seconds``,
the time to build the step and its state.

``counted: "executed"``: the port tallies each collective every time it
runs, so one inside a layer, a microbatch slice or a recomputed
(checkpointed) cycle counts once a run. The reference's
``parse_collectives`` reads the HLO text and counts each site once, a
loop body's included, whatever the trip count; XLA's ``cost_analysis``
counts a loop body's FLOPs once too. The ordered all-reduce of a sum
over more than two ranks is tallied as the one all-reduce it stands for
(it moves a ring all-reduce's bytes).

The rank's params are N(0, 0.02^2) draws from a generator seeded 0, its
tokens ids of its own vocab shard (``_tokens``), its optimizer state and
EF zero. Files: ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device meta
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, DP_MODE, TRAIN_OVERRIDES
from repro_torch.configs.shapes import SHAPES, applicable, skip_reason
from repro_torch.core import pgroup
from repro_torch.core.gs_sgd import (local_seg_shapes, make_serve_fns,
                                     make_state, make_train_step)
from repro_torch.kernels.dispatch import LAUNCHES, meta_shapes
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (PRODUCTION, init_process, make_mesh,
                                     mesh_axes_of)
from repro_torch.models import model as mdl
from repro_torch.models.common import padded_vocab
from repro_torch.models.flatten import make_flat_spec
from repro_torch.optim import make as make_opt

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# wire bytes per device as a multiple of the RESULT buffer size (the
# reference's table)
_WIRE_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
    "collective-broadcast": lambda g: 1.0,
}

COMPUTE_DTYPE = torch.bfloat16
PARAM_SCALE = 0.02


def collectives_of(records: list[dict]) -> dict:
    """The reference's ``parse_collectives`` summary of a ``pgroup.tally``
    record list, plus ``per_axis``: the same sums by group (its axis
    names joined by '+'). A group that holds the 'pod' axis crosses
    pods."""
    per_kind: dict[str, dict] = {}
    per_axis: dict[str, dict] = {}
    for r in records:
        g = r["group"]
        wire = r["result_bytes"] * _WIRE_FACTOR[r["kind"]](max(g, 1))
        crosses = "pod" in r["axes"]
        slot = per_kind.setdefault(r["kind"], {
            "count": 0, "result_bytes": 0.0, "wire_bytes": 0.0,
            "pod_crossing_wire_bytes": 0.0, "group_sizes": {}})
        slot["count"] += 1
        slot["result_bytes"] += r["result_bytes"]
        slot["wire_bytes"] += wire
        if crosses:
            slot["pod_crossing_wire_bytes"] += wire
        slot["group_sizes"][str(g)] = slot["group_sizes"].get(str(g), 0) + 1
        ax = per_axis.setdefault("+".join(r["axes"]), {})
        k = ax.setdefault(r["kind"], {"count": 0, "result_bytes": 0.0,
                                      "wire_bytes": 0.0})
        k["count"] += 1
        k["result_bytes"] += r["result_bytes"]
        k["wire_bytes"] += wire
    total = sum(k["wire_bytes"] for k in per_kind.values())
    cross = sum(k["pod_crossing_wire_bytes"] for k in per_kind.values())
    return {"per_kind": per_kind, "per_axis": per_axis,
            "total_wire_bytes": total, "pod_crossing_wire_bytes": cross}


# ---------------------------------------------------------------------------
# The fake world and the rank's tensors
# ---------------------------------------------------------------------------


def join_fake_world(world: int) -> None:
    """This process as rank 0 of a fake world of ``world`` ranks (a world
    of another size is left first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world):
            return
        dist.destroy_process_group()
    init_process(0, world, local_world=world, store=FakeStore(),
                 backend="fake", device_type="cpu")


def cell_mesh(mesh_kind: str, mesh_shape=None):
    """The cell's ``ProcessMesh`` on a fake world: the production mesh of
    ``mesh_kind`` ('single' or 'multi'), or ``mesh_shape`` (shape, axes)
    in its place (the tests' small meshes)."""
    shape, axes = mesh_shape or PRODUCTION[mesh_kind == "multi"]
    join_fake_world(math.prod(shape))
    return make_mesh(shape, axes)


def _generator(device: torch.device):
    """The cell's seeded generator (seed 0); none on meta."""
    return (None if device.type == "meta"
            else torch.Generator(device).manual_seed(0))


def _draw(shape, dtype, device, gen) -> torch.Tensor:
    """A tensor of ``shape``: N(0, PARAM_SCALE^2) draws from ``gen`` on
    the card, an empty meta tensor on meta."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(PARAM_SCALE).to(dtype)


def _tokens(shape, cfg, ma, device, gen) -> torch.Tensor:
    """Token ids drawn from this rank's (rank 0's) vocab shard: on a fake
    world the vocab-sharded embedding's psum returns this rank's rows
    alone, so an id outside its shard would embed as a zero row, whose
    RMSNorm gradient (rsqrt(eps)) grows without bound over the depth."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.int64, device=device)
    vocab = min(cfg.vocab_size, padded_vocab(cfg, ma.tp) // ma.tp)
    return torch.randint(0, vocab, shape, generator=gen, device=device)


def rank_state(ts, opt, *, ef_dtype: torch.dtype, device: torch.device,
               gen) -> dict:
    """This rank's train state at its local shapes, as ``TrainStep.
    state_from`` lays it out on a process mesh: seeded params (every
    segment N(0, 0.02^2)), zero optimizer slots and EF (``make_state``,
    the EF stored in ``ef_dtype``)."""
    lead = (1,) if ts.ma.tp > 1 else ()        # the rank dimension
    params = {k: _draw(lead + tuple(s), torch.float32, device, gen)
              for k, s in local_seg_shapes(ts.fs, ts.ma,
                                           ts.dp_mode).items()}
    state = make_state(params, opt, ts.compressor, ts.d_local, 1, ef_dtype)
    if ts.comp_groups:          # one exchange group: this rank's
        state["ef"] = (state["ef"],)
    return state


def local_bytes(tree, ma) -> int:
    """The bytes one rank holds of a tree of ``specs.GlobalSpec`` (each
    sharded dim divided by its axes' sizes)."""
    sizes = sp.axis_sizes(ma)
    total = 0

    def add(spec):
        nonlocal total
        n = 1
        for dim, axes in zip(spec.shape, spec.dims()):
            n *= dim // math.prod(sizes.get(a, 1) for a in axes)
        total += n * spec.dtype.itemsize
        return spec

    sp._tree_map(add, tree)
    return total


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a tree (dicts, tuples, lists)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


# ---------------------------------------------------------------------------
# Cell builders
# ---------------------------------------------------------------------------


def build_train_cell(cfg, ma, dp_mode: str, *, device: torch.device,
                     case=None, overrides: dict | None = None):
    """(fn, args, argument_bytes) of the rank's train step, as the
    reference's ``build_train_cell``: the ``TRAIN_OVERRIDES`` row's
    optimizer, compressor, ``compressor_kw`` (default k 65,536, rows 5,
    width 2^17), ``microbatch`` (default ~16k tokens a slice) and
    ``ef_dtype``; remat on; bf16 compute. ``fn(state, batch)`` returns the
    step's (state, metrics)."""
    case = case or SHAPES["train_4k"]
    ov = TRAIN_OVERRIDES.get(cfg.name, {}) if overrides is None else overrides
    opt = make_opt(ov.get("optimizer", "adamw"))
    fs = make_flat_spec(cfg, ma.tp)
    b_loc = case.global_batch // ma.dp_size
    mb = ov.get("microbatch", None)
    if mb is None:  # ~16k tokens per accumulation slice per device
        mb = max(1, min(b_loc, 16384 // case.seq_len))
    ts = make_train_step(
        cfg, ma, opt, dp_mode=dp_mode,
        compressor_name=ov.get("compressor", "gs-sgd"),
        compressor_kw=ov.get("compressor_kw",
                             dict(k=65536, rows=5, width=2 ** 17)),
        remat=True, microbatch=mb, fs=fs, dtype=COMPUTE_DTYPE,
        device=device)
    ef_dtype = getattr(torch, ov.get("ef_dtype", "float32"))
    gen = _generator(device)
    state = rank_state(ts, opt, ef_dtype=ef_dtype, device=device, gen=gen)
    toks = _tokens((1, b_loc, case.seq_len), cfg, ma, device, gen)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["cross_kv"] = _draw((1, b_loc, cfg.n_cross_tokens,
                                   cfg.d_model), torch.bfloat16, device, gen)
    args_spec = (
        sp.state_specs_global(fs, ma, dp_mode, opt, ts.d_local,
                              with_ef=ts.compressor is not None,
                              ef_dtype=ef_dtype),
        sp.batch_specs_global(cfg, ma, global_batch=case.global_batch,
                              seq_len=case.seq_len, with_labels=True))
    return ts.fn, [state, batch], local_bytes(args_spec, ma)


def build_serve_cell(cfg, ma, dp_mode: str, case, *, device: torch.device):
    """(fn, args, argument_bytes) of the rank's prefill or decode step, as
    the reference's ``build_serve_cell``: f32 params, a bf16 cache of
    ``case.seq_len`` positions, bf16 compute; decode is one token against
    a full cache (``kv_len`` = seq_len - 1), with the vlm's ``cross_kv``."""
    fs = make_flat_spec(cfg, ma.tp)
    prefill, decode = make_serve_fns(cfg, ma, dp_mode=dp_mode, fs=fs,
                                     dtype=COMPUTE_DTYPE)
    gen = _generator(device)
    lead = ((1,) if ma.tp > 1 else ()) + ((1,) if dp_mode == "fsdp" else ())
    params = {k: _draw(lead + tuple(s), torch.float32, device, gen)
              for k, s in local_seg_shapes(fs, ma, dp_mode).items()}
    gb = case.global_batch
    b_loc = gb // ma.dp_size if gb % ma.dp_size == 0 else gb
    cache = mdl.init_cache(cfg, b_loc, case.seq_len, COMPUTE_DTYPE, device,
                           ctx=ma.ctx(COMPUTE_DTYPE))
    specs = [sp.param_specs_global(fs, ma, dp_mode, dtype=torch.float32),
             sp.cache_specs_global(cfg, ma, global_batch=gb,
                                   t_cache=case.seq_len)]
    ck = None
    if cfg.family == "vlm":
        ck = _draw((b_loc, cfg.n_cross_tokens, cfg.d_model), torch.bfloat16,
                   device, gen)
        specs.append(sp._sds((gb, cfg.n_cross_tokens, cfg.d_model),
                             torch.bfloat16, sp._batch_pspec(ma, gb, 2)))
    if case.kind == "prefill":
        batch = {"tokens": _tokens((b_loc, case.seq_len), cfg, ma, device,
                                   gen)}
        if ck is not None:
            batch["cross_kv"] = ck
        specs.append(sp.batch_specs_global(cfg, ma, global_batch=gb,
                                           seq_len=case.seq_len,
                                           with_labels=False)["tokens"])

        def fn(params, batch, cache):
            return prefill(params, batch, cache)

        return fn, [params, batch, cache], local_bytes(specs, ma)

    toks = _tokens((b_loc, 1), cfg, ma, device, gen)
    specs += [sp._sds((gb, 1), torch.int32, sp._batch_pspec(ma, gb, 1)),
              sp._sds((), torch.int32, ())]

    def fn(params, toks, cache):
        return decode(params, toks, case.seq_len - 1, cache, cross_kv=ck)

    return fn, [params, toks, cache], local_bytes(specs, ma)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _grad_mode(case):
    """Autograd records a train step only; a serve step runs without."""
    return contextlib.nullcontext() if case.kind == "train" \
        else torch.no_grad()


def _call(fn, args: list, kind: str):
    """One step; the train step's new state replaces its argument (the
    reference donates it), the serve steps' cache is written in place."""
    out = fn(*args)
    if kind == "train":
        args[0] = out[0]
    return out


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             device: str | torch.device = "cuda", save: bool = True,
             out_dir: str | None = None, cfg=None, case=None,
             mesh_shape=None, overrides: dict | None = None) -> dict:
    """Run one cell (module docstring) and return its record; written to
    ``out_dir`` (default ``OUT_DIR``) when ``save``. ``cfg``, ``case``,
    ``mesh_shape`` and ``overrides`` replace the arch's config, the
    shape's case, the production mesh and the ``TRAIN_OVERRIDES`` row
    (the tests' small cells)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry-run on the card needs a CUDA device; "
                           "pass --device meta for the meta device")
    cfg = cfg or ARCHS[arch]
    case = case or SHAPES[shape]
    if not applicable(cfg, shape):
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "skipped", "reason": skip_reason(cfg, shape)}
    pm = cell_mesh(mesh_kind, mesh_shape)
    ma = mesh_axes_of(pm)
    dp_mode = DP_MODE[arch]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    if case.kind == "train":
        fn, args, arg_bytes = build_train_cell(cfg, ma, dp_mode,
                                               device=device, case=case,
                                               overrides=overrides)
    else:
        fn, args, arg_bytes = build_serve_cell(cfg, ma, dp_mode, case,
                                               device=device)
    _sync(device)
    t1 = time.time()

    from torch.utils.flop_counter import FlopCounterMode
    shapes = (meta_shapes() if device.type == "meta"
              else contextlib.nullcontext())
    with pgroup.tally() as records, FlopCounterMode(display=False) as fc, \
            shapes:
        with _grad_mode(case):
            out = _call(fn, args, case.kind)
        _sync(device)
    flops = fc.get_total_flops()
    out_bytes = tensor_bytes(out)
    del out
    peak = temp = finite = loss = None
    seconds = time.time() - t1
    LAUNCHES.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        t2 = time.time()
        with _grad_mode(case):
            out = _call(fn, args, case.kind)
        _sync(device)
        seconds = time.time() - t2
        peak = torch.cuda.max_memory_allocated(device)
        temp = max(0, peak - arg_bytes - out_bytes)
        res = out[1] if case.kind == "train" else {"out": out[0]}
        finite = all(bool(torch.isfinite(t).all()) for t in res.values()
                     if t.is_floating_point())
        if case.kind == "train":
            loss = float(res["loss"])
        del out, res
    launches = {k: v for k, v in LAUNCHES.items() if v}
    del fn, args
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "status": "ok",
        "dp_mode": dp_mode, "n_devices": math.prod(pm.shape),
        "device": device.type,
        "build_seconds": round(t1 - t0, 1),
        "step_seconds": seconds,
        "loss": loss,
        "outputs_finite": finite,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "peak_bytes": peak,
            "alias_bytes": None,
        },
        "cost": {"flops": float(flops), "bytes_accessed": None},
        "counted": "executed",
        "collectives": collectives_of(records),
        "launches": launches,
    }
    if save:
        out_dir = out_dir or OUT_DIR
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCHS),
                    help="arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="shape case (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"],
                    help="run the rank's step on the card (default) or on "
                         "meta tensors (no peak)")
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default without "
                         "--arch / --shape)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch} x {shape} x {mesh_kind}"
                try:
                    r = run_cell(arch, shape, mesh_kind, device=args.device)
                except Exception:
                    failures.append(tag)
                    print(f"[FAIL] {tag}\n{traceback.format_exc()}",
                          flush=True)
                    continue
                if r["status"] == "skipped":
                    print(f"[SKIP] {tag}: {r['reason']}", flush=True)
                    continue
                mem = r["memory"]
                peak = ("n/a" if mem["peak_bytes"] is None
                        else f"{mem['peak_bytes'] / 2**30:.2f} GiB")
                print(f"[ OK ] {tag}: build {r['build_seconds']}s, step "
                      f"{r['step_seconds']:.3f}s, flops "
                      f"{r['cost']['flops']:.3e}, peak {peak} (args "
                      f"{mem['argument_bytes'] / 2**30:.2f} GiB), coll "
                      f"{r['collectives']['total_wire_bytes'] / 2**20:.1f} "
                      f"MiB", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")


if __name__ == "__main__":
    main()
