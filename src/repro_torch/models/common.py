"""Shared model machinery: configs, padded geometry, param specs.

Port of ``repro/models/common.py`` for the dense ``attn`` block at any TP
degree's *geometry* (the port itself runs tp=1). A ``Spec``'s ``pspec`` is
a plain tuple of ``"model"``/``None`` entries, the PartitionSpec's
contents.

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


def _attn_specs(cfg: ArchConfig, tp: int) -> dict:
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
    return s


def _mlp_specs(cfg: ArchConfig, tp: int) -> dict:
    d, ff = cfg.d_model, pad_to(cfg.d_ff, tp)
    return {
        "wg": Spec((d, ff), (None, "model")),
        "wu": Spec((d, ff), (None, "model")),
        "wo": Spec((ff, d), ("model", None)),
        "norm": Spec((d,), (None,), scale=0.0),
    }


_BLOCK_SPECS = {
    "attn": lambda c, t: {**_attn_specs(c, t), "mlp": _mlp_specs(c, t)},
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
    layer: dict = {}
    counts: dict[str, int] = {}
    for kind in cfg.cycle:
        counts[kind] = counts.get(kind, 0) + 1
    for kind, cnt in counts.items():
        if kind not in _BLOCK_SPECS:
            raise NotImplementedError(
                f"block kind {kind!r} ({cfg.family} family) is not ported "
                "yet; the port runs the dense family")
        layer[kind] = _stack(_BLOCK_SPECS[kind](cfg, tp), cnt)
    specs["layers"] = _stack(layer, cfg.n_cycles)
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
