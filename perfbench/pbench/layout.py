"""The flat parameter layout of a dense llama-style model, worked out from
a configuration file alone.

gs-SGD hashes each gradient coordinate by its index in one flat vector,
so the plain reference has to lay the parameters out exactly as the
program under test does. This module states that layout for the dense
block (attention + SwiGLU MLP, pre-norm RMSNorm gains stored as deltas
around 1) at one model rank:

    top_s     the vocabulary matrices: embed (Vp, d), then head (d, Vp)
              when the embeddings are untied
    top_r     final_norm (d,)
    cycles_s  per layer: mlp/wg, mlp/wo, mlp/wu, wk, wo, wq, wv
    cycles_r  per layer: mlp/norm, norm

Leaves sit in sorted-key order inside each segment, every segment is
zero-padded to a multiple of 512, the vocabulary is padded to a multiple
of 128, and the flat vector is top_s | top_r | cycles_s (layer-major) |
cycles_r (layer-major). The harness checks this against the program's
own layout before a run, so a program that moves a coordinate fails
loudly rather than being compared against the wrong leaf.

It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

PAD = 512
VOCAB_PAD = 128


def pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes a dense configuration file states."""

    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    tie_embeddings: bool
    norm_eps: float
    rope_theta: float

    @classmethod
    def of(cls, conf: dict) -> "Shape":
        """From a configuration file's keys (Hugging Face names)."""
        d, h = int(conf["hidden_size"]), int(conf["num_attention_heads"])
        return cls(d_model=d, n_layers=int(conf["num_hidden_layers"]),
                   n_heads=h, n_kv_heads=int(conf["num_key_value_heads"]),
                   head_dim=int(conf.get("head_dim") or d // h),
                   d_ff=int(conf["intermediate_size"]),
                   vocab_size=int(conf["vocab_size"]),
                   tie_embeddings=bool(conf["tie_word_embeddings"]),
                   norm_eps=float(conf["rms_norm_eps"]),
                   rope_theta=float(conf["rope_theta"]))

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab_size, VOCAB_PAD)


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str                 # "embed", "layer3/mlp/wg", ...
    shape: tuple[int, ...]
    offset: int               # in the flat vector
    init: bool                # drawn N(0, 0.02^2); False: zeros (gains)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class Layout:
    shape: Shape
    leaves: tuple[Leaf, ...]
    segments: dict            # name -> (offset, rows, row length)

    @property
    def d(self) -> int:
        off, rows, n = self.segments["cycles_r"]
        return off + rows * n


def _cycle_leaves(s: Shape):
    d, hd, ff = s.d_model, s.head_dim, s.d_ff
    q, kv = s.n_heads * hd, s.n_kv_heads * hd
    sharded = [("mlp/wg", (d, ff)), ("mlp/wo", (ff, d)), ("mlp/wu", (d, ff)),
               ("wk", (d, kv)), ("wo", (q, d)), ("wq", (d, q)),
               ("wv", (d, kv))]
    replicated = [("mlp/norm", (d,)), ("norm", (d,))]
    return sharded, replicated


def layout(s: Shape) -> Layout:
    """The flat layout of ``s`` (module docstring)."""
    vp, d = s.vocab_padded, s.d_model
    top_s = [("embed", (vp, d))]
    if not s.tie_embeddings:
        top_s.append(("head", (d, vp)))
    top_r = [("final_norm", (d,))]
    cyc_s, cyc_r = _cycle_leaves(s)
    leaves, segs, off = [], {}, 0

    def place(items, base, prefix, init):
        o = base
        for name, shape in items:
            leaves.append(Leaf(prefix + name, shape, o, init))
            o += math.prod(shape)
        return o - base

    n = place(top_s, off, "", True)
    segs["top_s"] = (off, 1, pad_to(n, PAD))
    off += pad_to(n, PAD)
    n = place(top_r, off, "", False)
    segs["top_r"] = (off, 1, pad_to(n, PAD))
    off += pad_to(n, PAD)
    row_s = pad_to(sum(math.prod(sh) for _, sh in cyc_s), PAD)
    segs["cycles_s"] = (off, s.n_layers, row_s)
    for c in range(s.n_layers):
        place(cyc_s, off + c * row_s, f"layer{c}/", True)
    off += s.n_layers * row_s
    row_r = pad_to(sum(math.prod(sh) for _, sh in cyc_r), PAD)
    segs["cycles_r"] = (off, s.n_layers, row_r)
    for c in range(s.n_layers):
        place(cyc_r, off + c * row_r, f"layer{c}/", False)
    return Layout(shape=s, leaves=tuple(leaves), segments=segs)


def pieces(lay: Layout):
    """The runs of the flat vector that the seeded initialisation draws
    in one call each: every top-level matrix, and each layer's whole
    sharded row (its matrices, then the row's padding, which is zeroed
    after the draw). Returns [(piece id, offset, length)]; what no
    piece covers is zero."""
    out = []
    for l in lay.leaves:
        if l.init and not l.name.startswith("layer"):
            out.append((len(out), l.offset, l.size))
    off, rows, n = lay.segments["cycles_s"]
    for c in range(rows):
        out.append((len(out), off + c * n, n))
    return out


def padding_runs(lay: Layout):
    """[(offset, length)] of the zero padding inside the pieces: the tail
    of each layer's sharded row after its last matrix."""
    off, rows, n = lay.segments["cycles_s"]
    used = sum(l.size for l in lay.leaves if l.name.startswith("layer0/")
               and l.init)
    return [(off + c * n + used, n - used) for c in range(rows)
            if n > used]
