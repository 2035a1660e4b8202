"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

Backbone only: every 5th layer is cross-attention against precomputed patch
embeddings supplied by the stub frontend (``input_specs`` provides
(B, n_cross_tokens, d_model) bf16). Cycle = 4x self-attn + 1x cross, scanned
8 times.
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_every=5,
    n_cross_tokens=4096,   # stub vision frontend: precomputed patch embeds
    notes="cross-attn image layers; modality frontend is a stub",
)

SMOKE = ArchConfig(
    name="llama-3.2-vision-11b-smoke",
    family="vlm",
    n_layers=10,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    cross_attn_every=5,
    n_cross_tokens=16,
)
