"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm, head_dim=128, tied embeddings [hf:Qwen/Qwen3 family].
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    notes="qk_norm, GQA",
)

SMOKE = ArchConfig(
    name="qwen3-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    qk_norm=True,
    tie_embeddings=True,
)
