"""The model's training FLOPs per step, from a configuration's shapes.

Per token, 6 times the matmul parameters (forward 2, backward 4): per
layer the q, k, v and output projections and the three SwiGLU matrices,
and the head over the real vocabulary (the embedding lookup does none).
Attention adds, per layer and sequence, the score and value products of
a causal mask: 2 * S^2 * H * hd forward (half of the full 4 * S^2 * H *
hd), three times that for training. Recomputation (remat) is not
counted: this is the work the step needs, not what it executes.
"""

from __future__ import annotations


def matmul_params(shape) -> int:
    d, hd, ff = shape.d_model, shape.head_dim, shape.d_ff
    per_layer = (d * shape.n_heads * hd * 2          # wq, wo
                 + d * shape.n_kv_heads * hd * 2     # wk, wv
                 + 3 * d * ff)                       # wg, wu, wo
    return shape.n_layers * per_layer + d * shape.vocab_size


def train_flops(shape, seqs: int, seq_len: int) -> float:
    """FLOPs of one forward and backward over ``seqs`` sequences of
    ``seq_len`` tokens."""
    dense = 6.0 * matmul_params(shape) * seqs * seq_len
    attn = (6.0 * seq_len * seq_len * shape.n_heads * shape.head_dim
            * shape.n_layers * seqs)
    return dense + attn
