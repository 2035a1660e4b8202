"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite/granite-3.0 family].

40 experts pad to 48 for TP=16 (router masks the pads); 24 Q heads pad to
32. Embeddings tied (granite MoE convention).
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    experts_per_tok=8,
    block="moe",
    tie_embeddings=True,
    notes="40 experts top-8; experts pad 40->48, Q heads 24->32 at TP=16",
)

SMOKE = ArchConfig(
    name="granite-moe-3b-a800m-smoke",
    family="moe",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab_size=130,   # deliberately non-multiple-of-128: exercises padding
    n_experts=5,      # deliberately odd: exercises expert padding + masking
    experts_per_tok=2,
    block="moe",
    tie_embeddings=True,
)
