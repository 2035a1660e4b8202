"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-style GQA [arXiv:2403.04652]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=10000.0,
    notes="llama-arch GQA",
)

SMOKE = ArchConfig(
    name="yi-9b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
)
