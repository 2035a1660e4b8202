"""Per-leaf readings of a training state, the same for the program and the
reference: the norms of a gradient's leaves and of the parameters'
change since the seeded start. Each side hands over a function that
gives a leaf's values; nothing here knows either side's code."""

from __future__ import annotations

import torch

from pbench import inputs
from pbench import layout as lay_mod


def segment_view(segs: dict, lay: lay_mod.Layout, leaf: lay_mod.Leaf
                 ) -> torch.Tensor:
    """Leaf ``leaf``'s values inside one replica's segments (top ones
    (n,), the layers' (rows, n)), flat."""
    for name, (off, rows, n) in lay.segments.items():
        if off <= leaf.offset < off + rows * n:
            rel = leaf.offset - off
            seg = segs[name].reshape(-1)
            return seg[rel:rel + leaf.size]
    raise KeyError(leaf.name)


def flat_view(flat: torch.Tensor):
    return lambda leaf: flat[leaf.offset:leaf.offset + leaf.size]


def leaf_norms(view, lay: lay_mod.Layout, scale: float = 1.0) -> dict:
    """{leaf name: the L2 norm of its values times ``scale``}."""
    out = torch.stack([torch.linalg.vector_norm(view(l)) for l in
                       lay.leaves]) * scale
    return dict(zip((l.name for l in lay.leaves), out.tolist()))


def change_norms(view, lay: lay_mod.Layout, seed: int, device) -> dict:
    """{leaf name: the L2 norm of its change since the initial parameters
    of ``seed``}, drawing each piece of the start again (one at a time)."""
    out = {}
    for pid, off, n in lay_mod.pieces(lay):
        start = inputs.draw_piece(lay, seed, pid, device)
        for l in lay.leaves:
            if off <= l.offset < off + n:
                rel = l.offset - off
                out[l.name] = float(torch.linalg.vector_norm(
                    view(l) - start[rel:rel + l.size]))
        del start
    for l in lay.leaves:                 # the gains start at 0
        if l.name not in out:
            out[l.name] = float(torch.linalg.vector_norm(view(l)))
    return {l.name: out[l.name] for l in lay.leaves}
