"""Process meshes: one model rank and one data-parallel worker a process.

Port of ``repro/launch/mesh.py``. Single pod: (16, 16) = 256 ranks, axes
('data', 'model'), TP = 16 inside a fast slice, DP = 16 across it.
Multi-pod: (2, 16, 16) = 512 ranks, axes ('pod', 'data', 'model'), the
'pod' axis the slow inter-pod link gs-SGD's compressed exchange is aimed
at. These are functions, so importing touches no process group.

A process joins the world with ``init_process`` (its rank, the world
size, how many of the world's ranks run on its host, and a rendezvous: a
``torch.distributed`` store or an init method; nothing here reads a
cluster's environment). Ranks are numbered host by host, so rank r is
local rank r mod ``local_world`` on its host. The transport follows from
the ranks on each host against that host's cards:

* NCCL when every rank of the host has a card of its own (local rank l
  drives ``cuda:l``);
* gloo when the whole world runs on one host and its ranks share the
  cards (NCCL refuses two ranks on one device): rank r drives
  ``cuda:(r mod cards)``, and every collective copies its CUDA tensors
  through pinned host memory explicitly (``core.pgroup``);
* gloo on the CPU (``device_type="cpu"``, the tests).

A world over several hosts with more ranks on a host than cards raises,
and so does a rank that asks for a card where none is visible.
``make_mesh`` then builds the ``DeviceMesh`` and takes every process
group of its axes from it (``core.pgroup.ProcessMesh``), and
``mesh_axes_of`` the ``MeshAxes`` the train and serve steps take.
``spawn`` starts a world on one host (one process a rank, a ``FileStore``
in a temporary directory, no port) and returns what each rank's body
returned.

``per_rank_kernels`` is a simulated step's witness for a mesh at tp > 1:
while it is open, the model's calls whose kernels see the rank
dimension (the rank-stacked GEMMs, the attention, the norm gains'
product) run one rank at a time in a process's layout, so the simulated
step rounds as the mesh's processes do and their runs can be held to it
bit for bit.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.core.gs_sgd import MeshAxes
from repro_torch.core.pgroup import ProcessMesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

_DEVICE: list[torch.device] = []   # the device init_process chose


def transport(world: int, local_world: int,
              device_type: str = "cuda") -> str:
    """The backend for ``world`` ranks, ``local_world`` of them on this
    host, on ``device_type``: ``nccl`` when each of this host's ranks has
    a card of its own, ``gloo`` when a one-host world's ranks share its
    cards. Raises when a card is asked for and none is visible, and when
    a world over several hosts puts more ranks on this host than it has
    cards."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"unknown device type {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a rank asked for a CUDA device and none is "
                           "visible")
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl"
    if local_world == world:
        return "gloo"
    raise RuntimeError(f"{local_world} ranks on a host of {cards} card(s) "
                       f"in a world of {world} over several hosts: give "
                       "every rank a card of its own")


def rank_device(rank: int, local_world: int,
                device_type: str = "cuda") -> torch.device:
    """The device rank ``rank`` drives: its local rank's card (cards
    shared round-robin when a one-host world has more ranks than cards),
    or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(f"rank {rank} cannot reach a CUDA device: none "
                           "is visible")
    return torch.device("cuda", (rank % local_world) % n)


def init_process(rank: int, world: int, *, local_world: int, store=None,
                 init_method: str | None = None,
                 device_type: str = "cuda",
                 backend: str | None = None,
                 timeout_s: float = 600.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` over
    ``store`` (or ``init_method``, e.g. ``tcp://localhost:PORT``) with the
    transport ``transport`` picks for ``local_world`` ranks on this host
    (``backend`` overrides it: ``fake`` for a world of stand-in ranks). A
    collective that waits longer than ``timeout_s`` fails. Returns this
    rank's device, made current."""
    backend = backend or transport(world, local_world, device_type)
    dev = (torch.device("cpu") if backend == "fake"
           else rank_device(rank, local_world, device_type))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"store": store} if store is not None else {
        "init_method": init_method}
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    _DEVICE[:] = [dev]
    return dev


def make_mesh(shape, axes) -> ProcessMesh:
    """A ``ProcessMesh`` of ``shape`` with axis names ``axes`` (a subset
    of ('pod', 'data', 'model'), in that order) over the default group,
    whose world must be ``prod(shape)``; built collectively, its groups
    checked on the device ``init_process`` chose."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not _DEVICE:
        raise RuntimeError("make_mesh needs a process that joined its "
                           "world with init_process")
    backend = dist.get_backend()
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} ranks; the world has "
                         f"{world}")
    # NCCL's mesh is a CUDA one; gloo's collectives run on host memory
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=axes)
    return ProcessMesh(dm, backend=backend, device=_DEVICE[0])


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """The reference's production mesh: (16, 16) ('data', 'model'), or
    (2, 16, 16) ('pod', 'data', 'model'); a world of 256 or 512 ranks."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return make_mesh(shape, axes)


def mesh_axes_of(mesh: ProcessMesh) -> MeshAxes:
    """The ``MeshAxes`` of a process mesh (the reference's fields), which
    carries the mesh: steps built on it run one rank a process."""
    sizes = dict(zip(mesh.names, mesh.shape))
    return MeshAxes(
        tp=sizes.get("model", 1),
        data=sizes.get("data", 1),
        pod=sizes.get("pod", 1),
        tp_axis="model" if "model" in sizes else None,
        data_axis="data" if "data" in sizes else None,
        pod_axis="pod" if "pod" in sizes else None,
        mesh=mesh,
    )


def _rank_main(rank: int, body, world: int, workdir: str, device_type: str,
               timeout_s: float, args: tuple) -> None:
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    init_process(rank, world, local_world=world, store=store,
                 device_type=device_type, timeout_s=timeout_s)
    try:
        out = body(rank, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(body, world: int, *args, device_type: str = "cuda",
          timeout_s: float = 600.0) -> list:
    """Run ``body(rank, *args)`` in ``world`` new processes on this host,
    each joined to one world (``init_process``) before it starts; returns
    their return values (host tensors and plain data, saved with
    ``torch.save``) in rank order. ``body`` must be importable by name (a
    module-level function). A rank that raises fails the call (the others
    are stopped)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank_main, args=(body, world, d, device_type,
                                             timeout_s, tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# A simulated step rounded as a mesh's processes round it
# ---------------------------------------------------------------------------


def _rank_grads(fn, ins, g) -> list:
    """The gradients of ``fn(*ins)`` at ``g`` by autograd, each input a
    fresh leaf of its layout: what a mesh process's backward of the same
    call on the same inputs computes."""
    ins = [t.detach().requires_grad_() for t in ins]
    with torch.enable_grad():
        y = fn(*ins)
    return list(torch.autograd.grad(y, ins, g))


def _per_rank_fn():
    """An autograd Function that runs ``fn`` on each model rank's slice
    of its inputs (``split(r, *xs)``) and joins the ranks' outputs
    (``join``); its backward recomputes each rank's call under autograd
    (``_rank_grads``) and joins each input's rank gradients
    (``join_grads``). One node, as the call it replaces, so the
    gradients outside it accumulate in the same order."""
    class PerRank(torch.autograd.Function):
        @staticmethod
        def forward(ctx, spec, *xs):
            fn, split, join, split_g, join_grads, tp = spec
            ctx.spec, ctx.tp = spec, tp
            ctx.save_for_backward(*xs)
            return join([fn(*split(r, *xs)) for r in range(tp)])

        @staticmethod
        def backward(ctx, g):
            fn, split, join, split_g, join_grads, tp = ctx.spec
            xs = ctx.saved_tensors
            per = [_rank_grads(fn, split(r, *xs), split_g(r, g))
                   for r in range(tp)]
            return (None,) + tuple(join_grads(i, [p[i] for p in per])
                                   for i in range(len(xs)))

    return PerRank


class per_rank_kernels:
    """While open, the calls of the model whose kernels see a simulated
    step's rank dimension run one model rank at a time, each on its
    rank's slice in a mesh process's layout, and so does their backward
    (``_per_rank_fn``): ``lin`` of a rank-stacked weight (one batched
    GEMM over the ranks), the attention over the ranks' folded heads,
    and in ``rmsnorm`` the gain's product with the rank-stacked
    activations (its gradient one reduction over every rank's rows; per
    rank, the ranks' sums added, as the mesh's reduce-scatter adds
    them). The arithmetic is the simulated step's, rounded as each
    process rounds it."""

    def __init__(self, tp: int):
        self.tp = tp

    def __enter__(self):
        from repro_torch.models import layers, model as mdl
        tp, PerRank = self.tp, _per_rank_fn()
        lin, attn = layers.lin, layers.blockwise_attention

        def cat(parts):
            return torch.cat(parts)

        def rows(r, *xs):
            return tuple(x[r:r + 1] for x in xs)

        def per_lin(x, w):
            if w.ndim == 2:
                return lin(x, w)
            return PerRank.apply(
                (lin, rows, cat, lambda r, g: g[r:r + 1],
                 lambda i, gs: torch.cat(gs), tp), x, w)

        def heads(t):    # (B, S, tp * H, hd) -> the ranks' (B, S, H, hd)
            return t.reshape(t.shape[:2] + (tp, -1, t.shape[-1]))

        def per_attn(q, k, v, **kw):
            def split(r, *xs):
                return tuple(heads(x)[:, :, r].contiguous() for x in xs)

            def join(outs):   # the head-major layout attention returns
                return torch.cat([o.permute(0, 2, 1, 3) for o in outs],
                                 dim=1).permute(0, 2, 1, 3)
            return PerRank.apply(
                (lambda a, b, c: attn(a, b, c, **kw), split, join,
                 lambda r, g: heads(g)[:, :, r], lambda i, gs: join(gs),
                 tp), q, k, v)

        def gain_mul(a, x):   # (1 + delta) * xf, x rank-stacked
            if x.ndim < 4 or x.shape[0] != tp:
                return a * x
            return PerRank.apply(
                (torch.mul, lambda r, a, x: (a, x[r:r + 1]), cat,
                 lambda r, g: g[r:r + 1],
                 lambda i, gs: gs[0] + gs[1] if i == 0 else torch.cat(gs),
                 tp), a, x)

        def per_norm(x, delta, eps):
            xf = x.to(torch.float32)
            rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
            return (gain_mul(1.0 + delta.to(torch.float32), xf)
                    * rms).to(x.dtype)

        if tp != 2:
            raise ValueError("per_rank_kernels adds the ranks' gain "
                             "gradients pairwise: tp = 2 only")
        self.saved = [(layers, "lin", lin), (layers, "rmsnorm",
                                             layers.rmsnorm),
                      (mdl, "rmsnorm", mdl.rmsnorm),
                      (layers, "blockwise_attention", attn)]
        layers.lin, layers.rmsnorm, mdl.rmsnorm = per_lin, per_norm, per_norm
        layers.blockwise_attention = per_attn
        return self

    def __exit__(self, *exc):
        for mod, name, f in self.saved:
            setattr(mod, name, f)
