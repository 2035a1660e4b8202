"""Paged and contiguous KV-cache backends for the serving engine.

Port of ``repro/serve/kvcache.py``. Both backends manage the cache of
``models.model.init_cache`` for a fixed number of batch *slots* and
expose one interface to the scheduler:

    ensure(slot, length)   — make positions [0, length) addressable
    write_prefill(slot, cache, length)  — install a B=1 prefill cache
    gather()               — contiguous (slots, T) view for decode_fn
    scatter(cache, kv_len, active)      — write back one decode step
    free(slot)             — release the slot's storage

``PagedKVCache`` stores KV in fixed-size blocks: each pool leaf is
(n, cnt, num_blocks, block_size, nkv, hd) and a logical block spans ALL
cycles/kinds at once (one shared block table + free list, physical index
reused in every kind's pool). ``gather`` assembles the per-slot block
lists into the contiguous layout decode expects (the whole (slots,
max_len) cache, every step, as the reference does); ``scatter`` writes
back only the position each active row just wrote.

Bit-exactness: the gathered view equals the contiguous cache on every
VALID position; positions >= kv_len may differ (stale blocks vs stale
dense rows) but ``decode_attention`` masks them with a finite -1e30
whose exp underflows to exactly 0.0, so they cannot perturb the output
bitwise.

Recurrent state kinds (rwkv/mamba — no time axis) are dense per-slot in
both backends; paging only applies to the KV kinds (``KV_CACHE_KINDS``).
Every tensor lives on the ``device`` the backend is built for; the block
tables and lengths are host-side NumPy, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.common import ArchConfig, tree_leaves, tree_map

_GiB = 1024 ** 3


class OutOfBlocks(RuntimeError):
    """Free list exhausted — the scheduler must evict or queue."""


def _leaf_list(tree: dict) -> list[torch.Tensor]:
    return [leaf for _, leaf in tree_leaves(tree)]


def _pairs(a: dict, b: dict):
    """(leaf of a, leaf of b) for the same path, in sorted-key order."""
    return zip(_leaf_list(a), _leaf_list(b))


class _CacheBase:
    """Shared slot/length bookkeeping + dense recurrent-state handling."""

    def __init__(self, cfg: ArchConfig, *, slots: int, block_size: int,
                 max_len: int, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cpu"):
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} is not a multiple of "
                             f"block_size {block_size}")
        self.cfg = cfg
        self.slots = slots
        self.block_size = block_size
        self.max_len = max_len
        self.max_blocks = max_len // block_size
        self.dtype = dtype
        self.device = torch.device(device)
        self.lengths = np.zeros(slots, np.int64)  # addressable positions
        kv, _ = M.split_cache(M.cache_shapes(cfg, slots, max_len, dtype))
        self._kv_shape = kv                       # meta tensors
        _, self.state = M.split_cache(     # dense (n, cnt, slots, ...)
            M.init_cache(cfg, slots, 1, dtype, device=self.device))

    def blocks_for(self, length: int) -> int:
        return -(-length // self.block_size)

    def _check_len(self, length: int) -> None:
        if length > self.max_len:
            raise OutOfBlocks(
                f"request length {length} exceeds cache max_len "
                f"{self.max_len}")

    def _write_state(self, slot: int, state_b1: dict) -> None:
        """Install a B=1 prefill state at ``slot`` (axis 2)."""
        for dense, s1 in _pairs(self.state, state_b1):
            dense[:, :, slot] = s1[:, :, 0].to(dense.dtype)


class ContiguousKVCache(_CacheBase):
    """Dense reference backend: one (slots, max_len) cache, no paging.

    ``gather`` is the identity; ``scatter`` stores the step's cache back
    wholesale (recurrent state included). It pins the paged backend
    bit-exact and is the static-batch baseline's storage.
    """

    def __init__(self, cfg: ArchConfig, *, slots: int, block_size: int,
                 max_len: int, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cpu"):
        super().__init__(cfg, slots=slots, block_size=block_size,
                         max_len=max_len, dtype=dtype, device=device)
        self.kv, _ = M.split_cache(M.init_cache(cfg, slots, max_len, dtype,
                                                device=self.device))

    @property
    def free_blocks(self) -> int:  # parity with PagedKVCache invariants
        return self.slots * self.max_blocks - sum(
            self.blocks_for(int(n)) for n in self.lengths)

    def ensure(self, slot: int, length: int) -> None:
        self._check_len(length)
        self.lengths[slot] = max(self.lengths[slot], length)

    def free(self, slot: int) -> None:
        self.lengths[slot] = 0

    def write_prefill(self, slot: int, cache_b1: dict, length: int) -> None:
        self.ensure(slot, length)
        kv1, st1 = M.split_cache(cache_b1)
        if length:
            for dense, c1 in _pairs(self.kv, kv1):
                dense[:, :, slot, :length] = c1[:, :, 0, :length].to(
                    dense.dtype)
        self._write_state(slot, st1)

    def gather(self) -> dict:
        return M.merge_cache(self.kv, self.state)

    def scatter(self, cache: dict, kv_len: np.ndarray,
                active: np.ndarray) -> None:
        self.kv, self.state = M.split_cache(cache)


class PagedKVCache(_CacheBase):
    """Block-pooled KV storage with a free-list allocator.

    Physical block 0 is reserved and always zero — unallocated block-table
    entries gather from it, so the assembled view never reads stale pool
    memory outside a slot's own blocks.
    """

    def __init__(self, cfg: ArchConfig, *, slots: int, block_size: int,
                 max_len: int, num_blocks: int,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cpu"):
        super().__init__(cfg, slots=slots, block_size=block_size,
                         max_len=max_len, dtype=dtype, device=device)
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2, got {num_blocks}")
        self.num_blocks = num_blocks
        self.pool = tree_map(
            lambda s: torch.zeros(
                (s.shape[0], s.shape[1], num_blocks, block_size)
                + tuple(s.shape[4:]), dtype=s.dtype, device=self.device),
            self._kv_shape)
        # block 0 reserved (always zero); LIFO free list for locality
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self.tables = np.full((slots, self.max_blocks), -1, np.int32)

    # -- sizing ------------------------------------------------------------

    @staticmethod
    def block_bytes(cfg: ArchConfig, block_size: int,
                    dtype: torch.dtype = torch.bfloat16) -> int:
        """Bytes one logical block occupies across ALL kinds' pools."""
        kv, _ = M.split_cache(M.cache_shapes(cfg, 1, block_size, dtype))
        return sum(l.numel() * l.element_size() for l in _leaf_list(kv))

    @classmethod
    def from_cluster(cls, cfg: ArchConfig, cluster, serve,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cpu") -> "PagedKVCache":
        """Size the pool from ``ClusterSpec.mem_gb * ServeSpec.kv_frac``
        (or the explicit ``kv_blocks`` override), capped at the most the
        slot set can ever address (slots * max_blocks + zero block)."""
        max_len = serve.resolved_max_len()
        cap = serve.batch * (max_len // serve.block_size) + 1
        if serve.kv_blocks is not None:
            n = serve.kv_blocks
        else:
            per_block = cls.block_bytes(cfg, serve.block_size, dtype)
            budget = int(cluster.mem_gb * serve.kv_frac * _GiB)
            n = cap if per_block == 0 else budget // per_block
        return cls(cfg, slots=serve.batch, block_size=serve.block_size,
                   max_len=max_len, num_blocks=max(2, min(int(n), cap)),
                   dtype=dtype, device=device)

    # -- allocator ---------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def used_blocks(self, slot: int) -> int:
        return int((self.tables[slot] >= 0).sum())

    def ensure(self, slot: int, length: int) -> None:
        self._check_len(length)
        have = self.used_blocks(slot)
        need = self.blocks_for(length) - have
        if need > len(self._free):
            raise OutOfBlocks(
                f"need {need} blocks for slot {slot}, "
                f"{len(self._free)} free")
        for j in range(have, have + need):
            self.tables[slot, j] = self._free.pop()
        self.lengths[slot] = max(self.lengths[slot], length)

    def free(self, slot: int) -> None:
        phys = self.tables[slot]
        self._free.extend(int(p) for p in phys[phys >= 0])
        self.tables[slot] = -1
        self.lengths[slot] = 0

    # -- data movement -----------------------------------------------------

    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.device)

    def write_prefill(self, slot: int, cache_b1: dict, length: int) -> None:
        """Install a B=1 prefill cache: KV leaves are (n, cnt, 1, P, ...)
        with P a whole number of blocks <= max_len; positions beyond
        ``length`` in the last block are prefill padding (masked later)."""
        kv1, st1 = M.split_cache(cache_b1)
        leaves = _leaf_list(kv1)
        if length and leaves:  # pure-SSM archs have no KV kinds
            P = leaves[0].shape[3]
            if P % self.block_size or length > P:
                raise ValueError(f"prefill of {P} positions (valid "
                                 f"{length}) is not whole blocks of "
                                 f"{self.block_size}")
            self.ensure(slot, P)
            nb = P // self.block_size
            phys = self._index(self.tables[slot, :nb])
            for pool, c1 in _pairs(self.pool, kv1):
                pool[:, :, phys] = c1[:, :, 0].reshape(
                    tuple(c1.shape[:2]) + (nb, self.block_size)
                    + tuple(c1.shape[4:])).to(pool.dtype)
            self.lengths[slot] = length
        self._write_state(slot, st1)

    def gather(self) -> dict:
        """Assemble the contiguous (slots, max_len) view decode expects.

        Unallocated table entries read physical block 0 (always zero)."""
        tbl = self._index(np.where(self.tables < 0, 0, self.tables)
                          .reshape(-1))

        def asm(pool):
            v = pool.index_select(2, tbl)        # (n, cnt, slots*maxb, bs, ..)
            return v.reshape(tuple(pool.shape[:2])
                             + (self.slots, self.max_len)
                             + tuple(pool.shape[4:]))

        return M.merge_cache(tree_map(asm, self.pool), self.state)

    def scatter(self, cache: dict, kv_len: np.ndarray,
                active: np.ndarray) -> None:
        """Write back ONE decode step: row i of ``cache`` wrote position
        ``kv_len[i]``; copy just that position of each ACTIVE row into its
        block (the reference drops inactive rows' writes)."""
        kv, self.state = M.split_cache(cache)
        kv_len = np.asarray(kv_len)
        rows = np.flatnonzero(np.asarray(active))
        if not rows.size:
            return
        blk, off = kv_len[rows] // self.block_size, kv_len[rows] % \
            self.block_size
        phys = self.tables[rows, blk]
        if (phys < 0).any():
            raise RuntimeError("decode wrote to an unallocated block")
        ri, ti = self._index(rows), self._index(kv_len[rows])
        pj, oj = self._index(phys), self._index(off)
        for pool, leaf in _pairs(self.pool, kv):
            pool[:, :, pj, oj] = leaf[:, :, ri, ti].to(pool.dtype)
