"""Public entry points for the Count-Sketch kernels.

Port of ``repro/kernels/ops.py``. Dispatch is per tensor device
(``kernels.dispatch``): CUDA tensors launch the hand-written kernels, CPU
tensors run the plain PyTorch versions.

``heavymix_recover`` goes through a kernel that writes the keys and counts
their first radix digit, then the radix select with the reference's
lower-index tie-break (``kernels.topk_select``), on either device, so the
CPU tests run the same Python path the card runs: ``sketch_decode`` where
the reference ranks by |est| (d > 2^22 and d > 4k), ``heavymix_scores``
below that. It selects what ``core.heavymix.heavymix`` selects, index for
index, in both regimes; on the card it syncs with the host nowhere.

``ts_heavymix_recover`` is the TS route's recovery (``GsSGD(encoder="ts")``):
the scores kernel with the TS-sketch's map, then the same select. It selects
what ``core.heavymix.heavymix(..., estimates=ts_sketch.decode(...))``
selects: the boosted-score top-k at every d.
"""

from __future__ import annotations

import torch

from repro_torch.core import count_sketch as cs
from repro_torch.core.count_sketch import SketchConfig
from repro_torch.core.heavymix import _CHUNK
from repro_torch.core.ts_sketch import TSketchConfig
from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                               heavymix_scores_ts_hist)
from repro_torch.kernels.sketch_decode import (sketch_decode,
                                               sketch_decode_bucketed,
                                               sketch_decode_hist)
from repro_torch.kernels.sketch_encode import (sketch_encode,
                                               sketch_encode_bucketed)
from repro_torch.kernels.topk_select import topk_select


def encode(cfg: SketchConfig, g: torch.Tensor, *,
           offset: int = 0) -> torch.Tensor:
    """Count-Sketch encode: any-shape ``g`` -> (rows, width) f32."""
    return sketch_encode(cfg, g, index_offset=int(offset))


def decode(cfg: SketchConfig, sketch: torch.Tensor, d: int, *,
           offset: int = 0) -> torch.Tensor:
    """Count-Sketch decode: (rows, width) -> (d,) estimates of the
    coordinates [offset, offset + d)."""
    return sketch_decode(cfg, sketch, int(d), index_offset=int(offset))


def heavymix_recover(cfg: SketchConfig, sketch: torch.Tensor, k: int, d: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """HEAVYMIX greedy recovery from a summed sketch -> (idx (k,), est (k,)).

    The ranking follows the reference's two regimes; the top-k follows
    ``jax.lax.top_k``'s tie order. For d > 2^22 and d > 4k the reference
    ranks by |est| alone (``_heavymix_chunked``: the heavy set is the
    top-|H| by |est|), so when the heavy set outnumbers k the largest
    estimates win: the decode kernel gives ``est``, and no threshold or
    scores are computed. Below that it ranks by the scores kernel's boosted
    scores, where every heavy coordinate scores 1e30 in f32 and the lower
    index wins among them; the threshold stays a device tensor (no host
    sync before the kernel). Either kernel also counts the select's first
    digit, and ``topk_select`` ranks |est| or the (non-negative) scores.
    """
    sk = sketch.to(torch.float32)
    if d > _CHUNK and d > 4 * k:
        est, hist = sketch_decode_hist(cfg, sk, int(d))
        _, idx = topk_select(est, k, hist)
        return idx, est[idx]
    thr = cs.l2sq_estimate(sk) / k
    scores, est, hist = heavymix_scores_hist(cfg, sk, thr, int(d))
    _, idx = topk_select(scores, k, hist)
    return idx, est[idx]


def ts_heavymix_recover(tcfg: TSketchConfig, sketch: torch.Tensor, k: int,
                        d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """HEAVYMIX recovery from a summed TS sketch -> (idx (k,), est (k,)).

    The reference (``repro/core/compression.py``, ``encoder="ts"``) decodes
    every coordinate (``ts.decode``) and passes the estimates to
    ``heavymix(..., estimates=)``, which takes no chunked route: at every d
    it ranks the boosted scores |est| + 1e30 * [est^2 >= l2sq / k], so when
    the heavy set outnumbers k the lowest-index heavy coordinates win. The
    TS-map scores kernel writes est and those scores and counts the select's
    first digit; the threshold stays a device tensor (no host sync).
    """
    sk = sketch.to(torch.float32)
    thr = cs.l2sq_estimate(sk) / k
    scores, est, hist = heavymix_scores_ts_hist(tcfg, sk, thr, int(d))
    _, idx = topk_select(scores, k, hist)
    return idx, est[idx]


def encode_buckets(cfgs, g: torch.Tensor, sizes) -> tuple:
    """Per-bucket encode: one (rows_i, width_i) sketch per contiguous
    bucket of ``g`` (sizes sum to g.numel())."""
    return sketch_encode_bucketed(cfgs, g, sizes)


def decode_buckets(cfgs, sketches, sizes) -> torch.Tensor:
    """Per-bucket decode concatenated back into one flat estimate vector."""
    return sketch_decode_bucketed(cfgs, sketches,
                                  tuple(int(x) for x in sizes))
