"""Architecture registry: ``--arch <id>`` resolves here.

Port of ``repro/configs/__init__.py`` for the families the port runs so
far: the dense family (``qwen3-4b``). ``DP_MODE`` and ``TRAIN_OVERRIDES``
keep the reference's per-arch policy tables for the archs listed.
"""

from __future__ import annotations

from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.qwen3_4b import SMOKE as _qwen3_s
from repro_torch.models.common import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    "qwen3-4b": _qwen3,
}

SMOKES: dict[str, ArchConfig] = {
    "qwen3-4b": _qwen3_s,
}

# Production data-axis policy (see repro/configs/__init__.py).
DP_MODE: dict[str, str] = {
    "qwen3-4b": "dp",
}

# Per-arch training overrides (none of the ported archs has one yet).
TRAIN_OVERRIDES: dict[str, dict] = {}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke(name: str) -> ArchConfig:
    return SMOKES[name]


__all__ = ["ARCHS", "SMOKES", "DP_MODE", "TRAIN_OVERRIDES", "get",
           "get_smoke"]
