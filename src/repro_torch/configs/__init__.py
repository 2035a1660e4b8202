"""Architecture registry: ``--arch <id>`` resolves here.

Port of ``repro/configs/__init__.py`` for the families the port runs so
far: the dense family (``qwen3-4b``, ``yi-9b``, ``minicpm-2b``,
``starcoder2-3b``). ``DP_MODE`` and ``TRAIN_OVERRIDES`` keep the
reference's per-arch policy tables for the archs listed. ``yi-9b``'s
production mode is fsdp, which the port does not run yet
(``make_train_step`` raises); its smoke config runs in dp.
"""

from __future__ import annotations

from repro_torch.configs import shapes
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.minicpm_2b import SMOKE as _minicpm_s
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.qwen3_4b import SMOKE as _qwen3_s
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.starcoder2_3b import SMOKE as _starcoder2_s
from repro_torch.configs.yi_9b import CONFIG as _yi
from repro_torch.configs.yi_9b import SMOKE as _yi_s
from repro_torch.models.common import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    "qwen3-4b": _qwen3,
    "yi-9b": _yi,
    "minicpm-2b": _minicpm,
    "starcoder2-3b": _starcoder2,
}

SMOKES: dict[str, ArchConfig] = {
    "qwen3-4b": _qwen3_s,
    "yi-9b": _yi_s,
    "minicpm-2b": _minicpm_s,
    "starcoder2-3b": _starcoder2_s,
}

# Production data-axis policy (see repro/configs/__init__.py).
DP_MODE: dict[str, str] = {
    "qwen3-4b": "dp",                 # ~4.0B
    "yi-9b": "fsdp",                  # ~8.8B
    "minicpm-2b": "dp",               # ~2.7B
    "starcoder2-3b": "dp",            # ~3.0B
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
           "get_smoke", "shapes"]
