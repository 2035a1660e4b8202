"""minicpm-2b [dense] — 40L d_model=2304 36H (MHA kv=36) d_ff=5760
vocab=122753, WSD schedule, tied embeddings [arXiv:2404.06395].

Arch is llama-like; the paper's contribution this config carries into our
framework is the WSD (warmup-stable-decay) LR schedule, implemented in
``repro_torch.optim.schedule.wsd``. 36 heads pad to 48 at TP=16 (Q and KV alike —
MHA padding preserves q_per_kv = 1).
"""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    notes="WSD schedule (optim/schedule.py); MHA pads 36->48 heads at TP=16",
)

SMOKE = ArchConfig(
    name="minicpm-2b-smoke",
    family="dense",
    n_layers=2,
    d_model=60,      # deliberately non-128-aligned: exercises head padding
    n_heads=6,
    n_kv_heads=6,
    d_ff=96,
    vocab_size=250,
    tie_embeddings=True,
)
