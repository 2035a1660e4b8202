"""The process-group collective layer: one model rank and one worker a
process, over ``torch.distributed``.

The simulated layouts keep every worker and every model rank as a leading
dimension of one process; on a real mesh those dimensions hold only this
process's rank and worker (size 1 each) and the collectives cross
processes. ``ProcessMesh`` wraps a ``DeviceMesh`` with the reference's
axis names (``('pod', 'data', 'model')`` or a subset, in that order) and
takes from it, once and collectively, a process group for every
non-empty set of its axes; ``Axis`` is one such group as this process
sees it.

Group order: the ranks of a group are ordered by their coordinates on the
group's axes, row-major in mesh order. So ``('pod', 'data')`` is
pod-major (the reference's worker order) and ``('data', 'model')`` has
``model`` innermost, the order of the replicated segments' shards
(``launch/specs.py``).

Transport (``launch/mesh.py`` picks it): NCCL when every rank has a card
of its own, gloo when ranks share one (NCCL refuses two ranks on one
device) or run on the CPU. On gloo a CUDA tensor is copied explicitly
through pinned host memory around each collective (``stage/d2h`` and
``stage/h2d`` spans of the ambient tracer, inside the collective's own
span; ``STAGING`` sums their seconds and bytes). Nothing falls back
silently: a collective that fails raises.

Sum order: a sum over more than two processes is an *ordered all-reduce*
(``all_reduce``): every process sends the i-th of ``size`` equal chunks
of ``x`` to group index i (one ``all_to_all_single``), adds the pieces
it receives as a left fold in group order, ``((x0 + x1) + x2) + ...``
(``fold_sum``), and the summed chunks are all-gathered. It moves a ring
all-reduce's bytes ((size - 1) / size of ``x`` out and back) and gives
every transport the same bits, those of the simulated layouts, whose
sums over a rank or worker dimension are the same ``fold_sum``. A sum
over two processes stays one all-reduce (two terms add alike in either
order), and so does a max.

On a ``fake`` world (``launch/dryrun.py``: one rank of a production mesh
in one process) nothing crosses a wire: each collective returns a
tensor of its result's shape made from this process's own input (a sum
is ``x``, a gather ``size`` copies of ``x``, a scatter this index's
chunk), so a step runs on the card or the meta device alike. Inside
``tally()`` every collective, on any transport, records its kind, group
and result bytes (the ordered all-reduce as the one all-reduce it
stands for).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.obs import trace as obtrace

AXIS_ORDER = ("pod", "data", "model")

# Host staging of CUDA tensors on the gloo transport, summed since the
# last ``reset_staging``: seconds of device-to-host and host-to-device
# copies (each ended by a sync) and the bytes they moved.
STAGING = {"d2h_s": 0.0, "h2d_s": 0.0, "bytes": 0, "copies": 0}


def reset_staging() -> dict:
    """Zero ``STAGING``; returns what it held."""
    old = dict(STAGING)
    STAGING.update(d2h_s=0.0, h2d_s=0.0, bytes=0, copies=0)
    return old


# The non-deprecated names where this torch has them.
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One process group of a mesh as this process sees it: the processes
    that share every coordinate but ``names``'. ``ranks`` are global
    ranks in group order, ``index`` is this process's position in it.
    ``stage``: the transport takes host tensors only (gloo), so CUDA
    tensors are staged through pinned host memory. ``fake``: a fake
    world's group, whose collectives move nothing (module docstring)."""

    names: tuple[str, ...]
    group: Any
    ranks: tuple[int, ...]
    index: int
    stage: bool = False
    fake: bool = False

    @property
    def size(self) -> int:
        return len(self.ranks)


def fold_sum(x: torch.Tensor, dim: int = 0,
             keepdim: bool = False) -> torch.Tensor:
    """The sum of ``x`` over ``dim`` as a left fold in index order,
    ``((x[0] + x[1]) + x[2]) + ...``: the order of every sum over more
    than two processes (``all_reduce``), which the simulated layouts'
    sums over a worker or rank dimension follow, so that a mesh's sums
    are bit for bit its simulation's. A new tensor."""
    n = x.shape[dim]
    acc = (x.select(dim, 0).clone() if n == 1
           else x.select(dim, 0) + x.select(dim, 1))
    for i in range(2, n):
        acc = acc + x.select(dim, i)
    return acc.unsqueeze(dim) if keepdim else acc


# The collectives recorded inside ``tally()`` (None outside it).
_TALLY: list | None = None


@contextlib.contextmanager
def tally():
    """Record every collective run inside: yields a list that gets one
    dict a call, ``kind`` (the reference's HLO name: all-reduce,
    all-gather, reduce-scatter, collective-permute), ``axes`` (the
    group's axis names), ``group`` (its size), ``result_bytes`` (the
    bytes of this process's result buffer, as the reference's
    ``parse_collectives`` counts them), ``shape`` and ``dtype``."""
    global _TALLY
    outer, _TALLY = _TALLY, []
    try:
        yield _TALLY
    finally:
        _TALLY = outer


def _record(kind: str, axis: Axis, result_shape, dtype) -> None:
    if _TALLY is None:
        return
    _TALLY.append({"kind": kind, "axes": axis.names, "group": axis.size,
                   "result_bytes": math.prod(result_shape) * dtype.itemsize,
                   "shape": tuple(int(s) for s in result_shape),
                   "dtype": str(dtype).replace("torch.", "")})


def _staged(x: torch.Tensor, axis: Axis) -> bool:
    return axis.stage and x.is_cuda


def _to_wire(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` where the transport reads it: itself, or on gloo a pinned
    host copy of a CUDA tensor (``stage/d2h``, timed after a sync of the
    work that made ``x``)."""
    if not _staged(x, axis):
        return x
    nbytes = x.numel() * x.element_size()
    # the work that made x ends first, so the span and STAGING time the
    # copy alone
    torch.cuda.current_stream(x.device).synchronize()
    with obtrace.current().span("stage/d2h", cat="comm",
                                args={"bytes": nbytes}):
        t0 = time.perf_counter()
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        STAGING["d2h_s"] += time.perf_counter() - t0
    STAGING["bytes"] += nbytes
    STAGING["copies"] += 1
    return h


def _from_wire(h: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A wire tensor back on ``device`` (``stage/h2d``, timed to the end
    of the copy)."""
    if h.device == device:
        return h
    nbytes = h.numel() * h.element_size()
    with obtrace.current().span("stage/h2d", cat="comm",
                                args={"bytes": nbytes}):
        t0 = time.perf_counter()
        out = h.to(device)
        torch.cuda.current_stream(device).synchronize()
        STAGING["h2d_s"] += time.perf_counter() - t0
    STAGING["bytes"] += nbytes
    STAGING["copies"] += 1
    return out


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced over the group (``op`` sum or max),
    every process receiving the result; a sum over more than two
    processes in group order (``_ordered_sum``). ``x`` itself for a
    group of one."""
    if axis.size == 1:
        return x
    _record("all-reduce", axis, x.shape, x.dtype)
    if axis.fake:
        return x.detach().clone()
    if op == "sum" and axis.size > 2:
        return _ordered_sum(x, axis)
    w = x.detach().contiguous()
    w = _to_wire(w, axis) if _staged(w, axis) else w.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(w, op=red, group=axis.group)
    return _from_wire(w, x.device)


def _ordered_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The ordered all-reduce (module docstring): ``x`` flattened and
    padded to ``size`` equal chunks, chunk i sent to group index i, the
    received pieces folded left in group order (``fold_sum``), the
    summed chunks all-gathered."""
    size, n = axis.size, x.numel()
    m = -(-n // size)
    flat = x.detach().reshape(-1)
    if m * size != n:
        flat = torch.cat([flat, flat.new_zeros(m * size - n)])
    w = _to_wire(flat.contiguous(), axis)
    recv = torch.empty_like(w)
    dist.all_to_all_single(recv, w, group=axis.group)
    part = fold_sum(recv.view(size, m))
    out = torch.empty_like(w)
    _all_gather(out, part, group=axis.group)
    return _from_wire(out[:n].reshape(x.shape), x.device)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(size, *x.shape): every process's ``x`` in group order. A float8
    tensor travels as its bytes (``uint8``), which every transport
    takes."""
    if axis.size == 1:
        return x[None]
    _record("all-gather", axis, (axis.size,) + tuple(x.shape), x.dtype)
    if axis.fake:
        return x.detach()[None].expand((axis.size,) + x.shape).clone()
    src = x.detach().contiguous()
    wire = src.view(torch.uint8) if src.dtype in _FP8 else src
    w = _to_wire(wire, axis).reshape(-1)
    out = torch.empty((axis.size * w.numel(),), dtype=w.dtype,
                      device=w.device)
    _all_gather(out, w, group=axis.group)
    out = _from_wire(out, x.device).reshape((axis.size,) + tuple(x.shape))
    return out.view(src.dtype) if wire is not src else out


def all_gather_cat(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every process's ``x`` concatenated along the last dim, group
    order (the simulation's ``torch.cat(parts, dim=-1)``)."""
    if axis.size == 1:
        return x
    g = all_gather(x, axis)                      # (size, ..., m)
    return g.movedim(0, -2).reshape(x.shape[:-1] + (-1,))


def reduce_scatter(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``x`` over the group and keep this process's chunk of its last
    dim (the ``index``-th of ``size`` equal chunks)."""
    if axis.size == 1:
        return x
    m = x.shape[-1] // axis.size
    _record("reduce-scatter", axis, x.shape[:-1] + (m,), x.dtype)
    if axis.fake:
        return x.detach()[..., axis.index * m:(axis.index + 1) * m].clone()
    src = x.detach().reshape(x.shape[:-1] + (axis.size, m)).movedim(
        -2, 0).contiguous()
    w = _to_wire(src, axis).reshape(-1)
    out = torch.empty((w.numel() // axis.size,), dtype=w.dtype,
                      device=w.device)
    _reduce_scatter(out, w, group=axis.group)
    return _from_wire(out, x.device).reshape(src.shape[1:])


def permute(x: torch.Tensor, pairs, axis: Axis
            ) -> tuple[torch.Tensor, bool]:
    """One round of point-to-point messages along (src, dst) pairs of
    group indices (one ``batch_isend_irecv``): returns (what this process
    received, or ``x`` if it receives nothing; whether it received)."""
    me = axis.index
    dst = [d for s, d in pairs if s == me]
    src = [s for s, d in pairs if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"group index {me} sends to {dst} and receives "
                         f"from {src} in one round; at most one each")
    _record("collective-permute", axis, x.shape, x.dtype)
    if not dst and not src:
        return x, False
    if axis.fake:
        return (x.detach().clone(), True) if src else (x, False)
    x = x.contiguous()
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, _to_wire(x, axis),
                              axis.ranks[dst[0]], group=axis.group))
    if src:
        recv = (torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                if _staged(x, axis) else torch.empty_like(x))
        ops.append(dist.P2POp(dist.irecv, recv, axis.ranks[src[0]],
                              group=axis.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if not src:
        return x, False
    return _from_wire(recv, x.device), True


_FP8 = tuple(getattr(torch, n) for n in ("float8_e4m3fn", "float8_e5m2")
             if hasattr(torch, n))


class ProcessMesh:
    """A ``DeviceMesh`` with the reference's axis names and a process
    group for every non-empty set of its axes: the mesh's own group of
    each dim, and for several dims the group of the sub-mesh flattened
    (built here, collectively: every process of the world must construct
    it with the same mesh).

    ``backend``: the transport of the default group (``nccl``, ``gloo``
    or ``fake``); on ``gloo`` every ``Axis`` stages CUDA tensors. Every
    group of this process is checked by one all-reduce of a scalar on
    ``device`` (skipped on a fake world), so a rank that cannot reach its
    peers or its device fails here."""

    def __init__(self, device_mesh, *, backend: str,
                 device: torch.device | str):
        names = tuple(device_mesh.mesh_dim_names)
        if tuple(n for n in AXIS_ORDER if n in names) != names:
            raise ValueError(f"mesh axes {names} must be a subset of "
                             f"{AXIS_ORDER}, in that order")
        self.device_mesh = device_mesh
        self.names = names
        self.shape = tuple(int(s) for s in device_mesh.mesh.shape)
        self.backend = backend
        self.device = torch.device(device)
        me = dist.get_rank()
        self.rank = me
        coords = device_mesh.get_coordinate()
        if coords is None:
            raise RuntimeError(f"rank {me} is not in the mesh {self.shape}")
        self.coords = dict(zip(names, (int(c) for c in coords)))
        self._axes: dict[tuple[str, ...], Axis] = {}
        for n_ax in range(1, len(names) + 1):
            for sub in itertools.combinations(names, n_ax):
                self._axes[sub] = self._axis_of(sub, me, backend == "gloo")
        if backend != "fake":
            for ax in self._axes.values():
                one = torch.ones((), device=self.device)
                got = all_reduce(one, ax)
                if float(got) != ax.size:
                    raise RuntimeError(f"group {ax.names}: all-reduce of "
                                       f"ones gave {float(got)}, not "
                                       f"{ax.size}")

    def _axis_of(self, sub, me, stage) -> Axis:
        """This process's group over the dims ``sub``. Its ranks come in
        increasing order, which is row-major over ``sub`` (the other
        coordinates fixed)."""
        dm = self.device_mesh
        group = (dm.get_group(sub[0]) if len(sub) == 1
                 else dm[sub]._flatten().get_group())
        ranks = tuple(dist.get_process_group_ranks(group))
        return Axis(sub, group, ranks, ranks.index(me), stage,
                    self.backend == "fake")

    def axis(self, names) -> Axis:
        """The group over ``names`` (a name or a tuple, any order; names
        the mesh lacks are size 1): this process alone for none."""
        if isinstance(names, str):
            names = (names,)
        key = tuple(n for n in self.names if n in names)
        if not key:
            return Axis((), None, (self.rank,), 0)
        return self._axes[key]

    def size(self, name: str) -> int:
        return self.shape[self.names.index(name)] if name in self.names \
            else 1

    def coord(self, name: str) -> int:
        return self.coords.get(name, 0)

    def worker(self) -> int:
        """This process's data-parallel worker index, pod-major (the
        simulation's worker order)."""
        return self.coord("pod") * self.size("data") + self.coord("data")
