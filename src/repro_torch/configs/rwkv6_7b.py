"""rwkv6-7b [ssm] — Finch: 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536, data-dependent decay [arXiv:2404.05892].

Attention-free: runs the ``long_500k`` cell (chunked linear-attention form,
O(S*L) work, O(1) decode state). 64 wkv heads of dim 64.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=32,        # unused by the rwkv block (wkv heads from ssm_head_dim)
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=65536,
    ssm_head_dim=64,
    block="rwkv",
    notes="Finch data-dependent decay; eligible for long_500k",
)

SMOKE = ArchConfig(
    name="rwkv6-7b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_head_dim=16,
    block="rwkv",
)
