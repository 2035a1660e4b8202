"""The inputs both sides are handed: initial parameters and token batches,
made from ``--seed`` on the device.

Parameters: the flat vector of ``layout.layout``; each piece
(``layout.pieces``) is one ``torch.randn`` call from a generator of its
own, seeded from (seed, piece), scaled by 0.02; gains and padding are 0.
Since each piece has its own generator, any piece can be drawn again
alone (the harness does, to take the parameters' change after the
checked steps without holding a second copy of the state).

Batches: step ``t`` is (workers * rows, seq + 1) token ids uniform over
the real vocabulary, from a generator seeded from (seed, t); the inputs
are its first ``seq`` columns and the labels its last ``seq``. Every row
of every step differs, and every seed gives the same sizes.
"""

from __future__ import annotations

import torch

from pbench import layout as lay_mod

INIT_SCALE = 0.02
_MASK64 = (1 << 64) - 1


def mix(*vals: int) -> int:
    """A 63-bit seed from whole numbers of any size (splitmix64 steps)."""
    x = 0x9E3779B97F4A7C15
    for v in vals:
        x = (x ^ (int(v) & _MASK64)) & _MASK64
        x = (x + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x & ((1 << 63) - 1)


def _gen(device, *vals) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(*vals))


def draw_piece(lay: lay_mod.Layout, seed: int, pid: int, device
               ) -> torch.Tensor:
    """Piece ``pid`` of the initial parameters (padding zeroed)."""
    _, off, n = lay_mod.pieces(lay)[pid]
    v = torch.randn((n,), generator=_gen(device, seed, 1, pid),
                    dtype=torch.float32, device=device).mul_(INIT_SCALE)
    for po, pn in lay_mod.padding_runs(lay):
        if off <= po < off + n:
            v[po - off:po - off + pn] = 0.0
    return v


def initial_params(lay: lay_mod.Layout, seed: int, device) -> torch.Tensor:
    """The whole flat (d,) f32 initial parameter vector."""
    flat = torch.zeros((lay.d,), dtype=torch.float32, device=device)
    for pid, off, n in lay_mod.pieces(lay):
        flat[off:off + n] = draw_piece(lay, seed, pid, device)
    return flat


def segments_of(flat: torch.Tensor, lay: lay_mod.Layout) -> dict:
    """The flat vector cut into the four segments, as the program takes
    them ((n,) for the top ones, (rows, n) for the layers'); views."""
    out = {}
    for name, (off, rows, n) in lay.segments.items():
        v = flat[off:off + rows * n]
        out[name] = v if name.startswith("top") else v.reshape(rows, n)
    return out


def batch(shape: lay_mod.Shape, traffic: dict, seed: int, step: int,
          device) -> dict:
    """Step ``step``'s global batch: tokens and labels (B, S) int64, B the
    workers times the rows of each."""
    rows = int(traffic["workers"]) * int(traffic["seqs_per_worker"])
    seq = int(traffic["seq_len"])
    ids = torch.randint(0, shape.vocab_size, (rows, seq + 1),
                        generator=_gen(device, seed, 2, step),
                        dtype=torch.int64, device=device)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}
