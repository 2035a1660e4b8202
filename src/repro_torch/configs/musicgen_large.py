"""musicgen-large [audio] — 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048, decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone only: the EnCodec frontend is a stub — ``input_specs`` provides
token ids over the 2048-entry codebook vocabulary (the interleaved-codebook
delay pattern lives in the tokenizer, outside the backbone).
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    notes="decoder-only over EnCodec tokens; frontend is a stub",
)

SMOKE = ArchConfig(
    name="musicgen-large-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=64,
)
