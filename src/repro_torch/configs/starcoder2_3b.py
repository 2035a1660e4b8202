"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, GQA + RoPE [arXiv:2402.19173].

Documented deviation: starcoder2 uses LayerNorm + GELU; our unified block is
RMSNorm + SwiGLU (same shapes, same sharding, same FLOP class) — recorded in
DESIGN.md §Arch-applicability. kv=2 < TP=16 -> KV storage replicated, each
shard serving a disjoint Q-head group.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    rope_theta=999999.0,
    notes="GQA kv=2 -> replicated KV storage at TP=16; RMSNorm/SwiGLU "
          "stand in for LN/GELU (documented)",
)

SMOKE = ArchConfig(
    name="starcoder2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=1,    # extreme GQA: exercises kv-replicated storage path
    d_ff=128,
    vocab_size=256,
)
