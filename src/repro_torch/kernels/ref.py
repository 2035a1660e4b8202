"""Plain PyTorch oracles for the Count-Sketch kernels.

Port of ``repro/kernels/ref.py``: the same math as the kernels
(multiply-shift hashing, signed bucket accumulation, median-of-rows), with
``index_add_`` / ``gather`` instead of the CUDA kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core import count_sketch as cs
from repro_torch.core import heavymix as hm


def count_sketch_encode(cfg: cs.SketchConfig, g: torch.Tensor,
                        offset: int = 0) -> torch.Tensor:
    """(d,) -> (R, W) float32 sketch. Oracle for kernels.sketch_encode."""
    return cs.encode(cfg, g, offset=offset)


def count_sketch_decode(cfg: cs.SketchConfig, sketch: torch.Tensor, d: int,
                        offset: int = 0) -> torch.Tensor:
    """(R, W) -> (d,) median-of-rows estimates of [offset, offset + d)."""
    return cs.decode(cfg, sketch, d, offset=offset)


def heavymix_recover(cfg: cs.SketchConfig, sketch: torch.Tensor, k: int,
                     d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy-fill HEAVYMIX selection (idx, est) — ``heavymix.heavymix``."""
    return hm.heavymix(cfg, sketch, k, d)
