"""Deterministic synthetic LM stream.

Port of ``repro/data/pipeline.py`` ``LMStream``: the same learnable
recurrence (next token = (tok * 31 + 17) % V, replaced by a uniform token
with probability 0.1), drawn from a ``torch.Generator`` seeded by
(seed, step). It matches the reference in shape, dtype role and
distribution, not token for token (``jax.random`` bits cannot be
reproduced in torch); parity tests feed both packages the reference's
batches as numpy instead.
"""

from __future__ import annotations

import dataclasses

import torch


def _step_seed(seed: int, step: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (1 << 63)


@dataclasses.dataclass(frozen=True)
class LMStream:
    """Synthetic token stream. Global batch is deterministic per step."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    learnable: bool = True

    def _tokens(self, gen: torch.Generator, n: int) -> torch.Tensor:
        V, L = self.vocab_size, self.seq_len + 1
        if not self.learnable:
            return torch.randint(0, V, (n, L), generator=gen)
        start = torch.randint(0, V, (n,), generator=gen)
        noise = torch.rand((n, L), generator=gen) < 0.1
        rand = torch.randint(0, V, (n, L), generator=gen)
        seq = torch.empty((n, L), dtype=torch.int64)
        tok = start
        for t in range(L):
            nxt = (tok * 31 + 17) % V
            tok = torch.where(noise[:, t], rand[:, t], nxt)
            seq[:, t] = tok
        return seq

    def global_batch_at(self, step: int, device="cpu") -> dict:
        gen = torch.Generator().manual_seed(_step_seed(self.seed, step))
        seq = self._tokens(gen, self.global_batch).to(device)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
