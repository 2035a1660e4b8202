"""Public entry points for the Count-Sketch kernels.

Port of ``repro/kernels/ops.py``. Dispatch is per tensor device
(``kernels.dispatch``): CUDA tensors launch the hand-written kernels, CPU
tensors run the plain PyTorch versions.

``heavymix_recover`` always goes through ``heavymix_scores`` and a top-k
with the reference's lower-index tie-break, on either device, so the CPU
tests run the same Python path the card runs. It selects what
``core.heavymix.heavymix`` selects, index for index, in both of its
regimes (see ``heavymix_recover``).
"""

from __future__ import annotations

import torch

from repro_torch.core import count_sketch as cs
from repro_torch.core.count_sketch import SketchConfig
from repro_torch.core.heavymix import _CHUNK, topk_lower_index
from repro_torch.kernels.heavymix_topk import heavymix_scores
from repro_torch.kernels.sketch_encode import (sketch_encode,
                                               sketch_encode_bucketed)


def encode(cfg: SketchConfig, g: torch.Tensor, *,
           offset: int = 0) -> torch.Tensor:
    """Count-Sketch encode: any-shape ``g`` -> (rows, width) f32."""
    return sketch_encode(cfg, g, index_offset=int(offset))


def heavymix_recover(cfg: SketchConfig, sketch: torch.Tensor, k: int, d: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """HEAVYMIX greedy recovery from a summed sketch -> (idx (k,), est (k,)).

    The heavy threshold stays a device tensor (no host sync before the
    scoring kernel); the top-k follows ``jax.lax.top_k``'s tie order.

    The ranking follows the reference's two regimes. For d > 2^22 and
    d > 4k it ranks by |est| alone (``_heavymix_chunked``: the heavy set
    is the top-|H| by |est|), so when the heavy set outnumbers k the
    largest estimates win. Below that it ranks by the kernel's scores,
    where every heavy coordinate scores 1e30 in f32 and the lower index
    wins among them.
    """
    sk = sketch.to(torch.float32)
    thr = cs.l2sq_estimate(sk) / k
    scores, est = heavymix_scores(cfg, sk, thr, int(d))
    if d > _CHUNK and d > 4 * k:
        scores = est.abs()
    _, idx = topk_lower_index(scores, k)
    return idx, est[idx]


def encode_buckets(cfgs, g: torch.Tensor, sizes) -> tuple:
    """Per-bucket encode: one (rows_i, width_i) sketch per contiguous
    bucket of ``g`` (sizes sum to g.numel())."""
    return sketch_encode_bucketed(cfgs, g, sizes)
