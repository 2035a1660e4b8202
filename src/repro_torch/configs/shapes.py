"""The reference's input-shape set (``repro/configs/shapes.py``), kept as a
parity copy: the port runs only training, and no port code reads it yet
(``tests/test_torch_dense_configs.py`` holds it equal to the reference).

``train_4k`` is a training step's shape; ``prefill_32k``, ``decode_32k``
and ``long_500k`` are the reference's serving shapes, which the port does
not run. ``long_500k`` applies only to sub-quadratic architectures.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str            # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ArchConfig, shape: str) -> bool:
    """Is this (arch, shape) cell runnable? (long_500k: sub-quadratic only)"""
    if shape == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


def skip_reason(cfg: ArchConfig, shape: str) -> str | None:
    if applicable(cfg, shape):
        return None
    return (f"{cfg.name} is pure full-attention; a 512k-token dense-attention "
            "decode is skipped per assignment rules (sub-quadratic archs only)")
