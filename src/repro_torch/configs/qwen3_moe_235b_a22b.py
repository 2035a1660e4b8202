"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8, qk_norm [hf:Qwen/Qwen3-30B-A3B family].

d_ff is the per-expert FFN width. head_dim=128 (decoupled from d_model/H).
Expert parallelism: 128 experts / TP=16 -> 8 experts per model shard.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    n_experts=128,
    experts_per_tok=8,
    block="moe",
    notes="128 experts top-8; EP over the model axis",
)

SMOKE = ArchConfig(
    name="qwen3-moe-235b-a22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=256,
    head_dim=16,
    qk_norm=True,
    n_experts=8,
    experts_per_tok=2,
    block="moe",
)
