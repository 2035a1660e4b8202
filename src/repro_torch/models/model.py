"""Training forward for the dense family (tp=1): embed -> cycles -> norm -> CE.

Port of ``repro/models/model.py`` (``_backbone`` and ``loss_fn``,
``mode="train"``). Parameters arrive as flat segments
(``flatten.FlatSpec``); the per-cycle views are sliced from the cycle
segments, so autograd lands the gradient of every leaf in its segment.

``remat``: accepted for interface parity and a numerical no-op here. The
reference's sqrt-n remat only trades memory for recompute; at the slice's
depth (2 cycles) and sequence length the activations are small next to
the optimizer state, so the port keeps them.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig, tree_map
from repro_torch.models.flatten import FlatSpec
from repro_torch.models.layers import (attention_block, embed_lookup,
                                       lm_loss, mlp_block, rmsnorm)


def _apply_cycle(cfg: ArchConfig, cyc_p: dict, x: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    occ: dict[str, int] = {}
    for kind in cfg.cycle:
        j = occ.get(kind, 0)
        occ[kind] = j + 1
        if kind != "attn" or cfg.parallel_block:
            raise NotImplementedError(
                f"block kind {kind!r} (parallel_block={cfg.parallel_block})"
                " is not ported yet")
        p = tree_map(lambda a: a[j], cyc_p[kind])
        x = attention_block(p, cfg, x, pos)
        x = mlp_block(p["mlp"], cfg, x)
    return x


def _backbone(cfg: ArchConfig, fs: FlatSpec, segs: dict,
              tokens: torch.Tensor, pos: torch.Tensor,
              dtype: torch.dtype) -> tuple[torch.Tensor, dict]:
    """Embed -> cycles -> final norm. Returns (hidden, top params)."""
    top = fs.top_params(segs["top_s"], segs["top_r"], dtype)
    x = embed_lookup(top["embed"], tokens, dtype)
    cs, cr = segs["cycles_s"], segs["cycles_r"]
    for c in range(fs.n_cycles):
        x = _apply_cycle(cfg, fs.cycle_params(cs[c], cr[c], dtype), x, pos)
    return rmsnorm(x, top["final_norm"], cfg.norm_eps), top


def _head_w(cfg: ArchConfig, top: dict) -> torch.Tensor:
    return top["embed"].T if cfg.tie_embeddings else top["head"]


def loss_fn(cfg: ArchConfig, fs: FlatSpec, segs: dict, batch: dict, *,
            dtype: torch.dtype = torch.float32,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token CE. batch: tokens/labels (B, S)."""
    del remat  # see module docstring
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    hid, top = _backbone(cfg, fs, segs, tokens, pos, dtype)
    return lm_loss(hid, _head_w(cfg, top), batch["labels"], cfg)
