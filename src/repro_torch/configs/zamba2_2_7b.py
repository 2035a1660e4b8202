"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (MHA kv=32) d_ff=10240
vocab=32000, ssm_state=64, Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

Cycle = 6 Mamba2 blocks + 1 weight-tied shared attention block, scanned 9
times (54 mamba layers total, the shared block applied 9 times with one set
of weights — faithful to Zamba2's parameter-sharing idea; the concat+LoRA
input variant is simplified to a standard pre-norm block, see DESIGN.md).
Hybrid: eligible for long_500k (mamba state O(1); the 9 shared-attn KV
caches are the only seq_len-proportional memory).
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    shared_attn_every=6,
    block="mamba",
    notes="Mamba2 + shared attn; eligible for long_500k",
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_state=8,
    ssm_head_dim=16,
    shared_attn_every=2,
    block="mamba",
)
