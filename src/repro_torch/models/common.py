"""Shared model machinery: configs, padded geometry, param specs, and the
tensor-parallel context ``ShardCtx``.

Port of ``repro/models/common.py`` for every block kind (attention, the
cross-attention layer, MoE, RWKV6, Mamba2 and the hybrid's weight-tied
shared attention block) at any TP degree. A ``Spec``'s ``pspec`` is a
plain tuple of ``"model"``/``None`` entries, the PartitionSpec's contents.

The ``model`` axis is simulated on one device, inside one autograd graph:
at tp > 1 every activation and every model-sharded parameter leaf is
stacked on a leading rank dimension of size tp ("ranked"), and the
replicated leaves (norm gains, the router, replicated KV storage, token
-shift mixes) are one unranked tensor that every rank reads, so autograd
sums their gradients over the ranks, as the reference's gather transpose
does. ``ShardCtx.psum_tp`` is a sum over the rank dimension broadcast
back to every rank; its autograd transpose is the same operation, as
``jax.lax.psum``'s is. At tp = 1 nothing carries a rank dimension and
every collective is the identity (the single-device path).

On a process mesh (``ShardCtx.model``, the ``model`` group of a
``core.pgroup.ProcessMesh``) each process holds one rank: the rank
dimension is 1 long (``ShardCtx.lead``), the sharded leaves are this
rank's, and the collectives cross processes. ``psum_tp`` is an
all-reduce whose backward all-reduces the cotangent (the simulation's
transpose), ``pmax_tp`` an all-reduce MAX with no gradient, and
``rank_offsets`` this process's model coordinate times the step. A
replicated leaf's gradient then holds this rank's share only; the train
step sums the ranks' shares when it scatters the gradient
(``core/gs_sgd.py``). ``tp`` stays the global degree that fixes the
geometry.

Leaf order: ``jax.tree_util.tree_flatten`` visits dict keys SORTED, and
every ``FlatSpec`` offset follows that order. ``tree_leaves`` below walks
nested dicts in the same sorted order, so both packages lay the flat
parameter vector out identically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.core import pgroup


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Exact published architecture hyper-parameters (see configs/<id>.py)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    shared_attn_every: int = 0
    # --- VLM ---
    cross_attn_every: int = 0
    n_cross_tokens: int = 0
    # --- misc ---
    block: str = "attn"              # attn | moe | rwkv | mamba
    parallel_block: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def cycle(self) -> tuple[str, ...]:
        if self.family == "vlm" and self.cross_attn_every:
            return ("attn",) * (self.cross_attn_every - 1) + ("cross",)
        if self.family == "hybrid" and self.shared_attn_every:
            return ("mamba",) * self.shared_attn_every + ("shared_attn",)
        return (self.block,)

    @property
    def n_cycles(self) -> int:
        per = len([b for b in self.cycle if b not in ("shared_attn",)])
        if self.family == "hybrid" and self.shared_attn_every:
            per = self.shared_attn_every
        n, r = divmod(self.n_layers, per)
        if r:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not a "
                             f"multiple of cycle length {per}")
        return n

    def params_count(self, tp: int = 1) -> int:
        """Exact parameter count of the *padded* model (python int)."""
        return sum(math.prod(s.shape)
                   for _, s in tree_leaves(param_specs(self, tp=tp)))

    def active_params_count(self, tp: int = 1) -> int:
        """Active-per-token params (MoE: only experts_per_tok experts)."""
        total = self.params_count(tp)
        if self.n_experts:
            ex_total = sum(
                math.prod(s.shape)
                for path, s in tree_leaves(param_specs(self, tp)["layers"])
                if "experts" in path)
            n_exp = pad_to(self.n_experts, max(1, tp))
            total = (total - ex_total
                     + int(ex_total * self.experts_per_tok / n_exp))
        return total


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """How the computation is sharded over the tensor-parallel axis.

    ``ranked`` (tp > 1): activations and model-sharded leaves carry a
    leading rank dimension of size tp (module docstring). ``comm_dtype``
    (None = the compute dtype) is the wire dtype of the activation
    reductions: ``torch.float8_e4m3fn`` puts them on the wire in fp8, as
    the reference's serving option does. ``model``: the ``model``
    group on a process mesh (None: the ranks are simulated).
    """

    tp: int = 1
    tp_axis: str | None = None       # None => single-device (no collectives)
    dp_axes: tuple[str, ...] = ()    # data-parallel axes ('data'[, 'pod'])
    dtype: torch.dtype = torch.bfloat16
    comm_dtype: torch.dtype | None = None
    model: pgroup.Axis | None = None

    @property
    def ranked(self) -> bool:
        return self.tp > 1

    @property
    def lead(self) -> int:
        """Length of the rank dimension: tp when the ranks are simulated,
        1 on a process mesh (and at tp = 1, where there is none)."""
        return self.tp if self.ranked and self.model is None else 1

    def ranks(self) -> range:
        """The model ranks this process holds, in rank-dimension order."""
        if self.model is None:
            return range(self.tp)
        return range(self.model.index, self.model.index + 1)

    def held(self, n: int) -> int:
        """The part of ``n`` globally sharded items (heads, channels) the
        held ranks cover: all of them when simulated, 1/tp on a mesh."""
        return n * self.lead // self.tp if self.ranked else n

    def psum_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, every rank receiving the sum. With an fp8
        ``comm_dtype`` and a non-f32 ``x``: each rank's shard scaled by
        448 / its amax, cast to fp8 (the wire), then every rank's payload
        dequantized and summed in f32, as the reference's all-gather of
        the fp8 payload does."""
        if not self.ranked:
            return x
        if self.comm_dtype is not None and x.dtype != torch.float32:
            xf = x.to(torch.float32)
            dims = tuple(range(1, x.ndim))
            amax = torch.clamp(xf.abs().amax(dim=dims, keepdim=True)
                               .detach(), min=1e-12)
            scale = 448.0 / amax
            y8 = (xf * scale).to(self.comm_dtype)
            if self.model is not None:   # every rank's payload and scale
                y8 = pgroup.all_gather(y8, self.model)[:, 0]
                scale = pgroup.all_gather(scale, self.model)[:, 0]
            y = torch.sum(y8.to(torch.float32) / scale, dim=0, keepdim=True)
            return y.to(x.dtype).expand_as(x)
        if self.model is not None:
            return _PsumTP.apply(x, self.model)
        return _FoldSumTP.apply(x)

    def pmax_tp(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the ranks, every rank receiving it (no gradient:
        the reference's pmax has no differentiation rule)."""
        if not self.ranked:
            return x
        if self.model is not None:
            return pgroup.all_reduce(x.detach(), self.model, "max")
        return x.amax(0, keepdim=True).expand_as(x)

    def rank_offsets(self, step: int, ndim: int,
                     device) -> torch.Tensor | int:
        """``tp_rank() * step`` as a (tp, 1, ..., 1) tensor of ``ndim``
        dims (0 at tp = 1): each rank's offset into a sharded axis."""
        if not self.ranked:
            return 0
        if self.model is not None:
            return torch.full((1,) * ndim, self.model.index * step,
                              dtype=torch.int64, device=device)
        return (torch.arange(self.tp, device=device) * step).reshape(
            (self.tp,) + (1,) * (ndim - 1))

    def fold_heads(self, t: torch.Tensor) -> torch.Tensor:
        """(tp, B, S, H, ...) -> (B, S, tp*H, ...): the ranks' local heads
        side by side, rank-major, which is the global head order (the
        identity at tp = 1)."""
        if not self.ranked:
            return t
        return t.movedim(0, 2).reshape(t.shape[1:3] + (-1,) + t.shape[4:])

    def unfold_heads(self, t: torch.Tensor) -> torch.Tensor:
        """Inverse of ``fold_heads``."""
        if not self.ranked:
            return t
        B, S, H = t.shape[:3]
        return t.reshape((B, S, self.lead, H // self.lead)
                         + t.shape[3:]).movedim(2, 0)


class _FoldSumTP(torch.autograd.Function):
    """The simulated ``psum`` over the rank dimension: its left fold in
    rank order (``pgroup.fold_sum``), broadcast back; its transpose the
    same fold of the cotangent, as a mesh's ``_PsumTP`` all-reduces it
    (in that order beyond two ranks)."""

    @staticmethod
    def forward(ctx, x):
        return pgroup.fold_sum(x, keepdim=True).expand_as(x)

    @staticmethod
    def backward(ctx, g):
        return pgroup.fold_sum(g, keepdim=True).expand_as(g)


class _PsumTP(torch.autograd.Function):
    """``psum`` over the ``model`` group of a process mesh; its transpose
    all-reduces the cotangent, as the simulated sum's does."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return pgroup.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return pgroup.all_reduce(g, ctx.axis), None


# ---------------------------------------------------------------------------
# Sorted-key pytree helpers (the jax.tree_util order for nested dicts)
# ---------------------------------------------------------------------------


def tree_leaves(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs of a nested dict, keys visited sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_from_paths(pairs) -> dict:
    """Inverse of ``tree_leaves``: nested dict from ``(path, leaf)`` pairs."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Padded/sharded geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadGeom:
    nq: int          # padded global q heads (multiple of tp)
    nkv: int         # kv heads as stored
    nq_loc: int      # q heads per shard
    nkv_loc: int     # kv heads per shard
    kv_replicated: bool

    @property
    def q_per_kv(self) -> int:
        return self.nq // max(self.nkv, 1)


def head_geometry(cfg: ArchConfig, tp: int) -> HeadGeom:
    nq = pad_to(cfg.n_heads, tp)
    nkv = cfg.n_kv_heads
    if nkv >= tp:
        if nkv % tp:
            nkv = pad_to(nkv, tp)
        return HeadGeom(max(nq, nkv), nkv, max(nq, nkv) // tp, nkv // tp, False)
    return HeadGeom(nq, nkv, nq // tp, 1, True)


def padded_vocab(cfg: ArchConfig, tp: int) -> int:
    return pad_to(cfg.vocab_size, max(128, tp))


def padded_experts(cfg: ArchConfig, tp: int) -> int:
    return pad_to(cfg.n_experts, tp) if cfg.n_experts else 0


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Spec:
    """One parameter leaf: GLOBAL (padded) shape + partition + init scale."""

    shape: tuple[int, ...]
    pspec: tuple
    scale: float = 0.02
    dtype: torch.dtype = torch.float32

    def local_shape(self, tp: int) -> tuple[int, ...]:
        out = []
        for dim, ax in zip(self.shape, tuple(self.pspec) + (None,) * 8):
            out.append(dim // tp if ax == "model" else dim)
        return tuple(out)


def _attn_specs(cfg: ArchConfig, tp: int, cross: bool = False) -> dict:
    g = head_geometry(cfg, tp)
    d, hd = cfg.d_model, cfg.hd
    kv_pspec = (None, None) if g.kv_replicated else (None, "model")
    kv_cols = g.nkv * hd
    s = {
        "wq": Spec((d, g.nq * hd), (None, "model")),
        "wk": Spec((d, kv_cols), kv_pspec),
        "wv": Spec((d, kv_cols), kv_pspec),
        "wo": Spec((g.nq * hd, d), ("model", None)),
        "norm": Spec((d,), (None,), scale=0.0),  # RMSNorm gain (1 + x)
    }
    if cfg.qk_norm:
        s["q_norm"] = Spec((hd,), (None,), scale=0.0)
        s["k_norm"] = Spec((hd,), (None,), scale=0.0)
    if cross:
        s["kv_norm"] = Spec((d,), (None,), scale=0.0)
    return s


def _mlp_specs(cfg: ArchConfig, tp: int) -> dict:
    d, ff = cfg.d_model, pad_to(cfg.d_ff, tp)
    return {
        "wg": Spec((d, ff), (None, "model")),
        "wu": Spec((d, ff), (None, "model")),
        "wo": Spec((ff, d), ("model", None)),
        "norm": Spec((d,), (None,), scale=0.0),
    }


def _moe_specs(cfg: ArchConfig, tp: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff  # cfg.d_ff is the per-expert ff dim
    ne = padded_experts(cfg, tp)
    return {
        "router": Spec((d, ne), (None, None)),
        "experts": {
            "wi": Spec((ne, d, 2 * ff), ("model", None, None)),
            "wo": Spec((ne, ff, d), ("model", None, None)),
        },
        "norm": Spec((d,), (None,), scale=0.0),
    }


def _rwkv_specs(cfg: ArchConfig, tp: int) -> dict:
    d = cfg.d_model
    nh = pad_to(d // cfg.ssm_head_dim, tp)  # wkv heads
    dh = nh * cfg.ssm_head_dim              # padded inner width
    ff = pad_to(cfg.d_ff, tp)
    return {
        "wr": Spec((d, dh), (None, "model")),
        "wk": Spec((d, dh), (None, "model")),
        "wv": Spec((d, dh), (None, "model")),
        "wg": Spec((d, dh), (None, "model")),
        "ww": Spec((d, dh), (None, "model"), scale=0.002),  # decay lora
        "w_bias": Spec((dh,), ("model",), scale=0.0),
        "bonus": Spec((dh,), ("model",), scale=0.02),        # 'u' term
        "wo": Spec((dh, d), ("model", None)),
        "mu": Spec((4, d), (None, None), scale=0.0),         # token-shift mix
        "norm": Spec((d,), (None,), scale=0.0),
        "ck": Spec((d, ff), (None, "model")),                # channel mix
        "cv": Spec((ff, d), ("model", None)),
        "cmu": Spec((1, d), (None, None), scale=0.0),
        "cnorm": Spec((d,), (None,), scale=0.0),
    }


def _mamba_specs(cfg: ArchConfig, tp: int) -> dict:
    d = cfg.d_model
    nh = pad_to(max(1, d // cfg.ssm_head_dim), tp)
    dh = nh * cfg.ssm_head_dim
    ns = cfg.ssm_state
    return {
        "wx": Spec((d, dh), (None, "model")),
        "wz": Spec((d, dh), (None, "model")),
        "wB": Spec((d, nh * ns), (None, "model")),
        "wC": Spec((d, nh * ns), (None, "model")),
        "wdt": Spec((d, nh), (None, "model")),
        "dt_bias": Spec((nh,), ("model",), scale=0.0),
        "A_log": Spec((nh,), ("model",), scale=0.0),
        "D": Spec((nh,), ("model",), scale=0.0),
        "conv": Spec((4, dh), (None, "model"), scale=0.1),  # depthwise conv
        "wo": Spec((dh, d), ("model", None)),
        "norm": Spec((d,), (None,), scale=0.0),
        "gnorm": Spec((dh,), ("model",), scale=0.0),  # gated RMSNorm
    }


_BLOCK_SPECS = {
    "attn": lambda c, t: {**_attn_specs(c, t), "mlp": _mlp_specs(c, t)},
    "cross": lambda c, t: {**_attn_specs(c, t, cross=True),
                           "mlp": _mlp_specs(c, t)},
    "moe": lambda c, t: {**_attn_specs(c, t), "moe": _moe_specs(c, t)},
    "rwkv": _rwkv_specs,
    "mamba": _mamba_specs,
}


def _stack(tree: Any, n: int) -> Any:
    """Prefix every Spec's shape with the scan (cycle) axis."""
    return tree_map(lambda s: Spec((n,) + s.shape, (None,) + tuple(s.pspec),
                                   s.scale, s.dtype), tree)


def param_specs(cfg: ArchConfig, tp: int = 1) -> dict:
    """Full tree of Spec for the padded model at the given TP degree."""
    vp = padded_vocab(cfg, tp)
    d = cfg.d_model
    specs: dict = {
        "embed": Spec((vp, d), ("model", None), scale=0.02),
        "final_norm": Spec((d,), (None,), scale=0.0),
    }
    if not cfg.tie_embeddings:
        specs["head"] = Spec((d, vp), (None, "model"))
    # One sub-tree per block kind of the cycle, stacked over its
    # occurrences and then over n_cycles; the weight-tied shared block is
    # not per cycle and sits at the top of the tree.
    layer: dict = {}
    counts: dict[str, int] = {}
    for kind in cfg.cycle:
        if kind != "shared_attn":
            counts[kind] = counts.get(kind, 0) + 1
    for kind, cnt in counts.items():
        layer[kind] = _stack(_BLOCK_SPECS[kind](cfg, tp), cnt)
    specs["layers"] = _stack(layer, cfg.n_cycles)
    if "shared_attn" in cfg.cycle:
        specs["shared_attn"] = {**_attn_specs(cfg, tp),
                                "mlp": _mlp_specs(cfg, tp)}
    return specs


def init_params(cfg: ArchConfig, generator: torch.Generator, tp: int = 1,
                device: str | torch.device = "cpu") -> dict:
    """Concrete (global-shape) parameter init drawn from ``generator``.

    Same recipe as the reference (zeros for scale 0, else scale * N(0, 1)),
    drawn leaf by leaf in sorted-key order; the numbers differ from
    ``jax.random`` — tests carry the reference's init over with
    ``flatten.params_from_numpy``.
    """
    vals = []
    for path, s in tree_leaves(param_specs(cfg, tp)):
        if s.scale == 0.0:
            v = torch.zeros(s.shape, dtype=s.dtype, device=device)
        else:
            v = torch.randn(s.shape, generator=generator, dtype=s.dtype,
                            device=device).mul_(s.scale)
        vals.append((path, v))
    return tree_from_paths(vals)


def abstract_params(cfg: ArchConfig, mesh=None, tp: int = 1) -> dict:
    """Stand-ins for one process's parameters: a ``meta`` tensor of each
    leaf's LOCAL shape at ``tp`` (no allocation), the reference's
    ``ShapeDtypeStruct`` tree. ``mesh`` (a ``core.pgroup.ProcessMesh`` or
    None) must then have ``tp`` ranks on its ``model`` axis."""
    if mesh is not None and mesh.size("model") != tp:
        raise ValueError(f"tp {tp} is not the mesh's model axis "
                         f"{mesh.size('model')}")
    return tree_map(lambda s: torch.empty(s.local_shape(tp), dtype=s.dtype,
                                          device="meta"),
                    param_specs(cfg, tp))


def pspec_tree(cfg: ArchConfig, tp: int = 1) -> dict:
    """Each leaf's partition (its ``Spec.pspec``, the reference's
    PartitionSpec contents)."""
    return tree_map(lambda s: tuple(s.pspec), param_specs(cfg, tp))
