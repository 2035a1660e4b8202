"""Architecture registry: ``--arch <id>`` resolves here.

Port of ``repro/configs/__init__.py``: ``ARCHS``/``SMOKES`` map the ten
assigned architecture ids to their exact published configs and to reduced
same-family smoke configs. ``DP_MODE`` keeps the reference's production
data-axis policy per arch ('dp' replicated, 'fsdp' sharded over the in-pod
data axis); like the reference's ``RunSpec``, the train step built from a
spec runs every arch in 'dp' on the simulated workers. ``TRAIN_OVERRIDES``
keeps the reference's per-arch training overrides, keyed by the full
config's name.
"""

from __future__ import annotations

from repro_torch.configs import shapes
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite
from repro_torch.configs.granite_moe_3b_a800m import SMOKE as _granite_s
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _llava
from repro_torch.configs.llama_3_2_vision_11b import SMOKE as _llava_s
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.minicpm_2b import SMOKE as _minicpm_s
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.musicgen_large import SMOKE as _musicgen_s
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.qwen3_4b import SMOKE as _qwen3_s
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3moe
from repro_torch.configs.qwen3_moe_235b_a22b import SMOKE as _qwen3moe_s
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.rwkv6_7b import SMOKE as _rwkv6_s
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.starcoder2_3b import SMOKE as _starcoder2_s
from repro_torch.configs.yi_9b import CONFIG as _yi
from repro_torch.configs.yi_9b import SMOKE as _yi_s
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.configs.zamba2_2_7b import SMOKE as _zamba2_s
from repro_torch.models.common import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    "llama-3.2-vision-11b": _llava,
    "qwen3-moe-235b-a22b": _qwen3moe,
    "granite-moe-3b-a800m": _granite,
    "qwen3-4b": _qwen3,
    "yi-9b": _yi,
    "minicpm-2b": _minicpm,
    "starcoder2-3b": _starcoder2,
    "rwkv6-7b": _rwkv6,
    "musicgen-large": _musicgen,
    "zamba2-2.7b": _zamba2,
}

SMOKES: dict[str, ArchConfig] = {
    "llama-3.2-vision-11b": _llava_s,
    "qwen3-moe-235b-a22b": _qwen3moe_s,
    "granite-moe-3b-a800m": _granite_s,
    "qwen3-4b": _qwen3_s,
    "yi-9b": _yi_s,
    "minicpm-2b": _minicpm_s,
    "starcoder2-3b": _starcoder2_s,
    "rwkv6-7b": _rwkv6_s,
    "musicgen-large": _musicgen_s,
    "zamba2-2.7b": _zamba2_s,
}

# Production data-axis policy (see repro/configs/__init__.py).
DP_MODE: dict[str, str] = {
    "llama-3.2-vision-11b": "fsdp",   # ~10.7B params
    "qwen3-moe-235b-a22b": "fsdp",    # ~235B params
    "granite-moe-3b-a800m": "dp",     # ~3.4B
    "qwen3-4b": "dp",                 # ~4.0B
    "yi-9b": "fsdp",                  # ~8.8B
    "minicpm-2b": "dp",               # ~2.7B
    "starcoder2-3b": "dp",            # ~3.0B
    "rwkv6-7b": "fsdp",               # ~7.6B
    "musicgen-large": "dp",           # ~3.3B
    "zamba2-2.7b": "dp",              # ~2.7B
}

# Per-arch training overrides, keyed by the FULL config's name (a smoke
# config's name differs, so it gets none). qwen3-moe-235b runs SGD with
# momentum and a bf16 error-feedback accumulator (stored bf16, added and
# encoded in f32: ``core.gs_sgd.make_state(..., ef_dtype=)``).
TRAIN_OVERRIDES: dict[str, dict] = {
    "qwen3-moe-235b-a22b": {"optimizer": "sgdm", "ef_dtype": "bfloat16",
                            "microbatch": 2},
}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke(name: str) -> ArchConfig:
    return SMOKES[name]


__all__ = ["ARCHS", "SMOKES", "DP_MODE", "TRAIN_OVERRIDES", "get",
           "get_smoke", "shapes"]
