"""Deterministic synthetic data streams.

Port of ``repro/data/pipeline.py``: ``LMStream``, the same learnable
recurrence (next token = (tok * 31 + 17) % V, replaced by a uniform token
with probability 0.1), and ``ImageStream``, the K-cluster Gaussian images
of CIFAR-10's geometry. Each draws from a ``torch.Generator`` seeded by
(seed, step) (``_fold``), so a batch is a pure function of them. They
match the reference in shape, dtype role and distribution, not number for
number (``jax.random`` bits cannot be reproduced in torch); parity tests
feed both packages the reference's batches as numpy instead.
"""

from __future__ import annotations

import dataclasses

import torch


def _step_seed(seed: int, step: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (1 << 63)


def _fold(seed: int, *vals: int) -> int:
    """A generator seed derived from ``seed`` and each of ``vals`` in turn
    (the counterpart of the reference's ``jax.random.fold_in`` chain)."""
    for v in vals:
        seed = _step_seed(seed, v)
    return seed


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


@dataclasses.dataclass(frozen=True)
class ImageStream:
    """K-cluster Gaussian images (CIFAR-10 geometry): learnable classes.

    The class means are fixed by the seed; a batch is a pure function of
    (seed, step). Images are NHWC f32, labels int64."""

    n_classes: int = 10
    hw: int = 32
    global_batch: int = 64
    seed: int = 0
    noise: float = 0.6

    def _means(self) -> torch.Tensor:
        # the reference's seed + 7, folded with -1, which no step takes
        gen = torch.Generator().manual_seed(_fold(self.seed + 7, -1))
        return 0.8 * torch.randn((self.n_classes, self.hw, self.hw, 3),
                                 generator=gen)

    def global_batch_at(self, step: int, device="cpu") -> dict:
        gen = torch.Generator().manual_seed(_fold(self.seed, step))
        labels = torch.randint(0, self.n_classes, (self.global_batch,),
                               generator=gen)
        x = self._means()[labels] + self.noise * torch.randn(
            (self.global_batch, self.hw, self.hw, 3), generator=gen)
        return {"images": x.to(device), "labels": labels.to(device)}

    def shard_at(self, step: int, shard: int, n_shards: int,
                 device="cpu") -> dict:
        """Worker ``shard``'s rows: the matching slice of
        ``global_batch_at(step)``."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {n_shards} shards")
        per = self.global_batch // n_shards
        b = self.global_batch_at(step, device)
        return {k: v[shard * per:(shard + 1) * per] for k, v in b.items()}
