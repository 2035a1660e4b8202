"""Flat (raveled) parameter storage — the layout the train step runs on.

Port of ``repro/models/flatten.py``. Segments (f32, zero-padded to
``pad_multiple``):

    top_s    (f_top_s,)             embed / head sharded leaves
    top_r    (f_top_r,)             top-level replicated leaves
    cycles_s (n_cycles, f_cyc_s)    per-cycle sharded leaves
    cycles_r (n_cycles, f_cyc_r)    per-cycle replicated leaves

Leaves are laid out in sorted-key order (``common.tree_leaves``), the order
``jax.tree_util.tree_flatten`` uses, so every offset equals the
reference's. Per-worker copies carry a leading P dimension; the helpers
that see them take ``lead`` (the number of leading dims).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.common import (ArchConfig, init_params, pad_to,
                                       param_specs, tree_from_paths,
                                       tree_leaves)

SEG_NAMES = ("top_s", "top_r", "cycles_s", "cycles_r")


@dataclasses.dataclass(frozen=True)
class _Leaf:
    path: tuple              # key path inside its tree
    shape: tuple[int, ...]   # local shape (cycle axis stripped for cycles)
    offset: int              # offset within its sub-segment
    size: int
    rep: bool                # True -> lives in the *_r sub-segment


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static description of the flat layout for one (arch, tp) pair."""

    cfg: ArchConfig
    tp: int
    n_cycles: int
    top_leaves: tuple[_Leaf, ...]
    cyc_leaves: tuple[_Leaf, ...]
    f_top_s: int
    f_top_r: int
    f_cyc_s: int
    f_cyc_r: int

    @property
    def total(self) -> int:
        return (self.f_top_s + self.f_top_r
                + self.n_cycles * (self.f_cyc_s + self.f_cyc_r))

    def seg_shapes(self) -> dict[str, tuple[int, ...]]:
        return {"top_s": (self.f_top_s,), "top_r": (self.f_top_r,),
                "cycles_s": (self.n_cycles, self.f_cyc_s),
                "cycles_r": (self.n_cycles, self.f_cyc_r)}

    # -- unflatten ---------------------------------------------------------
    @staticmethod
    def _build(leaves, vs: torch.Tensor, vr: torch.Tensor, dtype) -> dict:
        out = []
        for l in leaves:
            src = vr if l.rep else vs
            out.append((l.path, src[l.offset:l.offset + l.size]
                        .reshape(l.shape).to(dtype)))
        return tree_from_paths(out)

    def top_params(self, vs, vr, dtype=torch.bfloat16) -> dict:
        """(f_top_s,), (f_top_r,) -> top-level params tree (views for f32)."""
        return self._build(self.top_leaves, vs, vr, dtype)

    def cycle_params(self, vs, vr, dtype=torch.bfloat16) -> dict:
        """(f_cyc_s,), (f_cyc_r,) -> one cycle's params tree."""
        return self._build(self.cyc_leaves, vs, vr, dtype)

    # -- flatten -----------------------------------------------------------
    def flatten(self, params: dict, dtype=torch.float32) -> dict:
        """Param tree (param_specs layout, local shapes) -> segment dict."""
        top = [v for p, v in tree_leaves(
            {k: v for k, v in params.items() if k != "layers"})]
        ts = _cat([x for x, l in zip(top, self.top_leaves) if not l.rep],
                  self.f_top_s, dtype)
        tr = _cat([x for x, l in zip(top, self.top_leaves) if l.rep],
                  self.f_top_r, dtype)
        cl = [x.reshape(self.n_cycles, -1)
              for _, x in tree_leaves(params["layers"])]
        cs = _cat2([x for x, l in zip(cl, self.cyc_leaves) if not l.rep],
                   self.n_cycles, self.f_cyc_s, dtype)
        cr = _cat2([x for x, l in zip(cl, self.cyc_leaves) if l.rep],
                   self.n_cycles, self.f_cyc_r, dtype)
        return {"top_s": ts, "top_r": tr, "cycles_s": cs, "cycles_r": cr}


def _cat(leaves, padded: int, dtype) -> torch.Tensor:
    dev = leaves[0].device if leaves else "cpu"
    out = torch.zeros((padded,), dtype=dtype, device=dev)
    off = 0
    for l in leaves:
        n = l.numel()
        out[off:off + n] = l.reshape(-1)
        off += n
    return out


def _cat2(leaves, rows: int, padded: int, dtype) -> torch.Tensor:
    dev = leaves[0].device if leaves else "cpu"
    out = torch.zeros((rows, padded), dtype=dtype, device=dev)
    off = 0
    for l in leaves:
        n = l.shape[1]
        out[:, off:off + n] = l
        off += n
    return out


def make_flat_spec(cfg: ArchConfig, tp: int, *,
                   pad_multiple: int = 512) -> FlatSpec:
    """Build the FlatSpec from param_specs (single source of truth)."""
    specs = param_specs(cfg, tp)
    top_tree = {k: v for k, v in specs.items() if k != "layers"}

    def scan(pairs, strip_cycle: bool):
        off = {"s": 0, "r": 0}
        out = []
        for path, s in pairs:
            shape = s.local_shape(tp)
            if strip_cycle:
                if shape[0] != cfg.n_cycles:
                    raise ValueError(f"leaf {path}: leading dim {shape[0]} "
                                     f"!= n_cycles {cfg.n_cycles}")
                shape = tuple(shape[1:])
            size = math.prod(shape)
            key = "s" if "model" in tuple(s.pspec) else "r"
            out.append(_Leaf(path, shape, off[key], size, rep=(key == "r")))
            off[key] += size
        return (out, pad_to(off["s"], pad_multiple),
                pad_to(off["r"], pad_multiple))

    top_leaves, f_ts, f_tr = scan(tree_leaves(top_tree), strip_cycle=False)
    cyc_leaves, f_cs, f_cr = scan(tree_leaves(specs["layers"]),
                                  strip_cycle=True)
    return FlatSpec(cfg=cfg, tp=tp, n_cycles=cfg.n_cycles,
                    top_leaves=tuple(top_leaves),
                    cyc_leaves=tuple(cyc_leaves),
                    f_top_s=f_ts, f_top_r=f_tr, f_cyc_s=f_cs, f_cyc_r=f_cr)


def init_flat_params(cfg: ArchConfig, generator: torch.Generator,
                     tp: int = 1, fs: FlatSpec | None = None,
                     device: str | torch.device = "cpu") -> dict:
    """Random-init LOCAL flat segments (tp=1 only), drawn from ``generator``."""
    if tp != 1:
        raise ValueError("concrete init is for tp=1 paths")
    fs = fs or make_flat_spec(cfg, tp)
    return fs.flatten(init_params(cfg, generator, tp, device=device))


def params_from_numpy(segs: dict, fs: FlatSpec,
                      device: str | torch.device) -> dict:
    """Flat segments exported from the JAX package (``np.asarray`` of
    ``repro.models.flatten.init_flat_params``) -> the port's segments.

    Each segment's shape is checked against this port's own ``fs``, so a
    leaf-order or padding drift between the packages fails here loudly.
    """
    want = fs.seg_shapes()
    if set(segs) != set(want):
        raise ValueError(f"segments {sorted(segs)} != {sorted(want)}")
    out = {}
    for k in SEG_NAMES:
        a = np.asarray(segs[k])
        if tuple(a.shape) != want[k]:
            raise ValueError(f"segment {k!r} has shape {a.shape}, the "
                             f"port's FlatSpec expects {want[k]}")
        out[k] = torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return out


# ---------------------------------------------------------------------------
# Segment-dict helpers
# ---------------------------------------------------------------------------


def bucket_atoms(shapes: dict[str, tuple[int, ...]]) -> list[int]:
    """Indivisible chunk lengths of the packed flat vector, in pack order."""
    atoms: list[int] = []
    for k in SEG_NAMES:
        s = shapes[k]
        if len(s) == 1:
            if s[0]:
                atoms.append(int(s[0]))
        else:
            rows, width = int(s[0]), int(s[1])
            if width:
                atoms.extend([width] * rows)
    return atoms


def bucket_sizes(shapes: dict[str, tuple[int, ...]],
                 n_buckets: int) -> tuple[int, ...]:
    """Group the flat vector's atoms into <= n_buckets contiguous buckets
    (greedy fill toward total/n_buckets; oversized atoms pre-split)."""
    atoms = bucket_atoms(shapes)
    total = sum(atoms)
    n_buckets = max(1, min(int(n_buckets), total))
    target = total / n_buckets
    split: list[int] = []
    for a in atoms:
        parts = max(1, round(a / target))
        base, rem = divmod(a, parts)
        split.extend(base + (1 if i < rem else 0) for i in range(parts))
    atoms = [a for a in split if a]
    sizes: list[int] = []
    cur = 0
    for j, a in enumerate(atoms):
        cur += a
        atoms_after = len(atoms) - j - 1
        buckets_after = n_buckets - len(sizes) - 1
        if buckets_after > 0 and (cur >= target or atoms_after == buckets_after):
            sizes.append(cur)
            cur = 0
    if cur:
        sizes.append(cur)
    if sum(sizes) != total or len(sizes) > n_buckets:
        raise AssertionError((sizes, total, n_buckets))
    return tuple(sizes)


def chunk_plan(n_cycles: int, n_chunks: int) -> tuple[tuple[int, int], ...]:
    """Split cycles [0, n) into <= n_chunks contiguous [a, b) chunks.

    Sizes differ by at most one. The chunked backward consumes chunks in
    REVERSE order (chunk n_chunks-1's VJP runs first), so the list is in
    forward (cycle-index) order and emission order is its reverse (see
    ``model.chunked_loss_vjp``).
    """
    k = max(1, min(int(n_chunks), int(n_cycles)))
    base, rem = divmod(int(n_cycles), k)
    bounds, a = [], 0
    for i in range(k):
        b = a + base + (1 if i < rem else 0)
        bounds.append((a, b))
        a = b
    return tuple(bounds)


def packed_offsets(shapes: dict[str, tuple[int, ...]]) -> dict[str, int]:
    """Start offset of each segment within the ``pack_segs`` flat vector."""
    out, off = {}, 0
    for k in SEG_NAMES:
        out[k] = off
        off += math.prod(shapes[k])
    return out


def emission_intervals(shapes: dict[str, tuple[int, ...]],
                       chunks: tuple[tuple[int, int], ...]
                       ) -> tuple[tuple[int, int, int], ...]:
    """Every gradient slice a K-chunk backward emits, in emission order, as
    (packed offset, length, event): chunk K-1's ``cycles_s`` rows then its
    ``cycles_r`` rows (event 0), down to chunk 0's (event K-1), then
    ``top_s`` and ``top_r``, which finalize last (event K). ``chunks`` is
    ``chunk_plan``'s."""
    offs = packed_offsets(shapes)
    f_cs = int(shapes["cycles_s"][-1])
    f_cr = int(shapes["cycles_r"][-1])
    out = []
    for ev, (a, b) in enumerate(reversed(chunks)):
        out += [(offs["cycles_s"] + a * f_cs, (b - a) * f_cs, ev),
                (offs["cycles_r"] + a * f_cr, (b - a) * f_cr, ev)]
    out += [(offs[k], math.prod(shapes[k]), len(chunks))
            for k in ("top_s", "top_r")]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Readiness-aware bucket partition for the backward-interleaved exchange.

    ``sizes`` is exactly ``bucket_sizes(shapes, n_buckets)``, so per-bucket
    compressor geometry (and numerics) are those of the bucketed exchange.
    The backward emits gradients as K+1 events (``emits``, from
    ``emission_intervals``). ``readiness[i]`` is the earliest event after
    which bucket i's packed range is fully emitted; buckets are exchanged
    in readiness order.
    """

    sizes: tuple[int, ...]          # packed-order bucket sizes
    readiness: tuple[int, ...]      # per bucket: emission event index
    n_events: int                   # n_chunks + 1 (the +1 is the top event)
    chunks: tuple[tuple[int, int], ...]  # cycle-row [a, b) per chunk
    emits: tuple[tuple[int, int, int], ...]  # (packed offset, length, event)

    @property
    def n(self) -> int:
        return len(self.sizes)

    @property
    def order(self) -> tuple[int, ...]:
        """Exchange order: by readiness, packed index breaking ties."""
        return tuple(sorted(range(self.n),
                            key=lambda i: (self.readiness[i], i)))

    def overlaps(self, off: int, n: int) -> list[tuple[int, int, int]]:
        """(bucket, lo, hi) of each bucket whose packed range meets
        [off, off + n); lo and hi are packed offsets."""
        out, o = [], 0
        for i, sz in enumerate(self.sizes):
            lo, hi = max(o, off), min(o + sz, off + n)
            if lo < hi:
                out.append((i, lo, hi))
            o += sz
        return out

    def fragments(self) -> tuple[tuple[tuple[int, int], ...], ...]:
        """Per bucket, its pieces of the emitted slices as (offset in the
        bucket, length), in emission order: the fused exchange's partial
        encodes."""
        starts = [sum(self.sizes[:i]) for i in range(self.n)]
        out: list[list[tuple[int, int]]] = [[] for _ in self.sizes]
        for off, n, _ in self.emits:
            for i, lo, hi in self.overlaps(off, n):
                out[i].append((lo - starts[i], hi - lo))
        return tuple(tuple(f) for f in out)


def bucket_plan(shapes: dict[str, tuple[int, ...]], n_buckets: int,
                n_chunks: int) -> BucketPlan:
    """Bucket partition + per-bucket readiness for a K-chunk backward:
    boundaries from ``bucket_sizes``, readiness the latest emission event
    over the bucket's packed range."""
    sizes = bucket_sizes(shapes, n_buckets)
    bounds = chunk_plan(int(shapes["cycles_s"][0]), n_chunks)
    k = len(bounds)
    emits = emission_intervals(shapes, bounds)
    readiness = []
    off = 0
    for s in sizes:
        readiness.append(max((e for lo, n, e in emits
                              if lo < off + s and off < lo + n), default=k))
        off += s
    return BucketPlan(sizes=sizes, readiness=tuple(readiness),
                      n_events=k + 1, chunks=bounds, emits=emits)


def pack_segs(segs: dict, lead: int = 0) -> torch.Tensor:
    """Segment dict -> one flat f32 vector (the compressor's view).

    ``lead`` leading dims (the worker axis) are kept: with ``lead=1`` the
    segments are (P, ...) and the result is (P, d).
    """
    return torch.cat([segs[k].reshape(segs[k].shape[:lead] + (-1,))
                      .to(torch.float32) for k in SEG_NAMES], dim=lead)


def unpack_segs(vec: torch.Tensor, like: dict, lead: int = 0) -> dict:
    out, off = {}, 0
    for k in SEG_NAMES:
        shape = like[k].shape
        n = math.prod(shape[lead:])
        out[k] = vec[..., off:off + n].reshape(shape)
        off += n
    return out
