"""Global array specs for the process mesh: how each process's LOCAL
state, batch and cache correspond to GLOBAL arrays.

Port of ``repro/launch/specs.py``. The reference's ``ShapeDtypeStruct``
with a ``NamedSharding`` is a ``GlobalSpec`` here: the global shape, the
dtype and the mesh axes of each dim (``pspec``: one entry a dim, None for
a replicated dim, an axis name, or a tuple of names, major first).

  storage segs ('dp'):   top_s (tp*f_ts,) ('model',);  top_r (f_tr,) ('model',)
  storage segs ('fsdp'): top_s (tp*f_ts,) (('model','data'),);
                         top_r (f_tr,)   (('data','model'),)
  (cycles segs identical with a leading replicated n_cycles axis)

The orders match the gather closures in core/gs_sgd.py: ``*_s`` gathers
over 'data' inside each model rank's contiguous block (model-major);
``*_r`` has 'model' innermost (data-major). EF and compressor state are
private to each process. Batch and cache batch dims shard over the dp
axes when the global batch divides, else replicate (``_batch_pspec``).

``local_of`` cuts the process at ``coords`` its slice of global arrays,
exactly where the reference's sharding places it on that device;
``global_of`` assembles the global arrays from every process's slice.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable

import torch

from repro_torch.core.gs_sgd import MeshAxes
from repro_torch.models import mamba as mb
from repro_torch.models import rwkv as rk
from repro_torch.models.common import ArchConfig, head_geometry
from repro_torch.models.flatten import FlatSpec
from repro_torch.models.model import _kind_counts
from repro_torch.optim.optimizers import Optimizer


@dataclasses.dataclass(frozen=True)
class GlobalSpec:
    """A global array: shape, dtype and the mesh axes of each dim."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    pspec: tuple = ()

    def dims(self) -> tuple[tuple[str, ...], ...]:
        """The axes of every dim (a tuple each, empty: replicated)."""
        out = []
        for e in tuple(self.pspec) + (None,) * (len(self.shape)
                                                - len(self.pspec)):
            out.append(() if e is None else (e,) if isinstance(e, str)
                       else tuple(e))
        return tuple(out)


def _sds(shape, dtype, pspec) -> GlobalSpec:
    return GlobalSpec(tuple(int(s) for s in shape), dtype, tuple(pspec))


def axis_sizes(ma: MeshAxes) -> dict[str, int]:
    """Each mesh axis name's size (the axes ``ma`` names)."""
    out = {}
    for name, size in ((ma.pod_axis, ma.pod), (ma.data_axis, ma.data),
                       (ma.tp_axis, ma.tp)):
        if name:
            out[name] = size
    return out


def seg_pspecs(ma: MeshAxes, dp_mode: str) -> dict[str, tuple]:
    if dp_mode == "dp":
        m = ("model",)
        return {"top_s": m, "top_r": m,
                "cycles_s": (None, "model"), "cycles_r": (None, "model")}
    return {"top_s": (("model", "data"),), "top_r": (("data", "model"),),
            "cycles_s": (None, ("model", "data")),
            "cycles_r": (None, ("data", "model"))}


def seg_global_shapes(fs: FlatSpec, ma: MeshAxes) -> dict[str, tuple]:
    """Global segment shapes: the *_s segs concatenate tp local shards."""
    return {"top_s": (ma.tp * fs.f_top_s,), "top_r": (fs.f_top_r,),
            "cycles_s": (fs.n_cycles, ma.tp * fs.f_cyc_s),
            "cycles_r": (fs.n_cycles, fs.f_cyc_r)}


def param_specs_global(fs: FlatSpec, ma: MeshAxes, dp_mode: str,
                       dtype=torch.float32) -> dict[str, GlobalSpec]:
    ps = seg_pspecs(ma, dp_mode)
    gs = seg_global_shapes(fs, ma)
    return {k: _sds(gs[k], dtype, ps[k]) for k in gs}


def state_specs_global(fs: FlatSpec, ma: MeshAxes, dp_mode: str,
                       opt: Optimizer, d_local: int, *, with_ef: bool,
                       ef_dtype=torch.float32) -> dict[str, Any]:
    params = param_specs_global(fs, ma, dp_mode)
    opt_state = {}
    for k, sd in params.items():
        slot = _sds(sd.shape, torch.float32, sd.pspec)
        opt_state[k] = slot if opt.slots == 1 else tuple(
            _sds(sd.shape, torch.float32, sd.pspec)
            for _ in range(opt.slots))
    n_dev = ma.tp * ma.data * ma.pod
    all_axes = tuple(a for a in (ma.pod_axis, ma.data_axis, ma.tp_axis) if a)
    ef = (_sds((n_dev * d_local,), ef_dtype, (all_axes,)) if with_ef
          else _sds((0,), torch.float32, (None,)))
    step = _sds((), torch.int32, ())
    return {"params": params, "opt": opt_state, "ef": ef, "step": step}


def _batch_pspec(ma: MeshAxes, global_batch: int, extra_dims: int) -> tuple:
    dp = ma.dp_axes
    if dp and global_batch % ma.dp_size == 0:
        return (dp,) + (None,) * extra_dims
    return (None,) + (None,) * extra_dims


def batch_specs_global(cfg: ArchConfig, ma: MeshAxes, *, global_batch: int,
                       seq_len: int, with_labels: bool) -> dict[str, Any]:
    toks = _sds((global_batch, seq_len), torch.int32,
                _batch_pspec(ma, global_batch, 1))
    out = {"tokens": toks}
    if with_labels:
        out["labels"] = toks
    if cfg.family == "vlm":
        out["cross_kv"] = _sds(
            (global_batch, cfg.n_cross_tokens, cfg.d_model),
            torch.bfloat16, _batch_pspec(ma, global_batch, 2))
    return out


def cache_specs_global(cfg: ArchConfig, ma: MeshAxes, *, global_batch: int,
                       t_cache: int, dtype=torch.bfloat16) -> Any:
    """Global cache tree mirroring ``model.init_cache``'s local layout."""
    n = cfg.n_cycles
    g = head_geometry(cfg, ma.tp)
    nkv_store = ma.tp if g.kv_replicated else g.nkv  # tp ranks x 1, or nkv
    b_axes = _batch_pspec(ma, global_batch, 0)[0]

    def kv(cnt):
        shape = (n, cnt, global_batch, t_cache, nkv_store, cfg.hd)
        pspec = (None, None, b_axes, None, "model", None)
        return {"k": _sds(shape, dtype, pspec), "v": _sds(shape, dtype, pspec)}

    cache: dict[str, Any] = {}
    for kind, cnt in _kind_counts(cfg).items():
        if kind in ("attn", "moe"):
            cache[kind] = kv(cnt)
        elif kind == "rwkv":
            nh, hd = rk.rwkv_geometry(cfg, ma.tp)
            cache[kind] = {
                "s": _sds((n, cnt, global_batch, nh, hd, hd), torch.float32,
                          (None, None, b_axes, "model", None, None)),
                "tm_prev": _sds((n, cnt, global_batch, cfg.d_model),
                                torch.float32, (None, None, b_axes, None)),
                "cm_prev": _sds((n, cnt, global_batch, cfg.d_model),
                                torch.float32, (None, None, b_axes, None)),
            }
        elif kind == "mamba":
            nh, hd, ns = mb.mamba_geometry(cfg, ma.tp)
            cache[kind] = {
                "h": _sds((n, cnt, global_batch, nh, ns, hd), torch.float32,
                          (None, None, b_axes, "model", None, None)),
                "conv": _sds((n, cnt, global_batch, mb._CONV_W - 1,
                              nh * hd), dtype,
                             (None, None, b_axes, None, "model")),
            }
    if "shared_attn" in cfg.cycle:
        shape = (n, 1, global_batch, t_cache, nkv_store, cfg.hd)
        pspec = (None, None, b_axes, None, "model", None)
        cache["shared_attn"] = {"k": _sds(shape, dtype, pspec),
                                "v": _sds(shape, dtype, pspec)}
    return cache


def _tree_map(fn: Callable, tree: Any, *rest) -> Any:
    """``fn`` over the ``GlobalSpec`` leaves of ``tree`` (dicts, tuples and
    lists), with the same-shaped trees ``rest`` alongside."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def shard_map_specs(specs_tree: Any) -> Any:
    """The pspec tree (the reference's shard_map in_specs) of a spec tree."""
    return _tree_map(lambda s: s.pspec, specs_tree)


def _chunk(dim_axes: tuple[str, ...], coords: dict, sizes: dict
           ) -> tuple[int, int]:
    """(index, count) of the chunk the device at ``coords`` holds along a
    dim sharded over ``dim_axes`` (major first; absent axes are 1)."""
    idx, count = 0, 1
    for a in dim_axes:
        s = sizes.get(a, 1)
        idx = idx * s + coords.get(a, 0)
        count *= s
    return idx, count


def local_of(global_tree: Any, specs: Any, ma: MeshAxes, coords: dict
             ) -> Any:
    """The slice of each global tensor of ``global_tree`` (the structure of
    ``specs``) that the process at mesh ``coords`` ({axis: index}) holds,
    as the reference's ``NamedSharding`` places it on that device."""
    sizes = axis_sizes(ma)

    def cut(spec: GlobalSpec, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != spec.shape:
            raise ValueError(f"global tensor {tuple(x.shape)} is not its "
                             f"spec's {spec.shape}")
        for d, axes in enumerate(spec.dims()):
            if axes:
                i, n = _chunk(axes, coords, sizes)
                m = spec.shape[d] // n
                x = x.narrow(d, i * m, m)
        return x

    return _tree_map(cut, specs, global_tree)


def all_coords(ma: MeshAxes) -> list[dict]:
    """Every process's coordinates, row-major in mesh order."""
    sizes = axis_sizes(ma)
    names = list(sizes)
    return [dict(zip(names, c))
            for c in itertools.product(*(range(sizes[n]) for n in names))]


def global_of(local_at: Callable[[dict], Any], specs: Any, ma: MeshAxes
              ) -> Any:
    """The inverse of ``local_of``: the global tensors assembled from
    ``local_at(coords)``, every process's local tree (a replicated dim is
    read from the first process that holds each chunk)."""
    sizes = axis_sizes(ma)
    parts = [(c, local_at(c)) for c in all_coords(ma)]

    def build(spec: GlobalSpec, *locals_):
        first = locals_[0]
        out = torch.empty(spec.shape, dtype=first.dtype, device=first.device)
        for (c, _), x in zip(parts, locals_):
            view = out
            for d, axes in enumerate(spec.dims()):
                if axes:
                    i, n = _chunk(axes, c, sizes)
                    m = spec.shape[d] // n
                    view = view.narrow(d, i * m, m)
            view.copy_(x)
        return out

    return _tree_map(build, specs, *(p for _, p in parts))

