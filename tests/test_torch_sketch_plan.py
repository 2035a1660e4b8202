"""The Count-Sketch encode kernel's decomposition, checked on the CPU.

``csrc/sketch_encode.cu`` partitions the (element, row) pairs by sketch
tile (2^13 flat buckets) and accumulates each tile in one CTA, or in
several CTAs each over a share of the blocks; the CUDA code cannot run
here, so its plan (``encode_plan``) and its index arithmetic, mirrored in
numpy uint32, are held to the reference's hashes and encode.

Tolerance: the binned encode adds in another order than ``index_add_``
and the reference (rtol=atol=1e-4, as tests/test_torch_count_sketch.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_sketch as jcs
from repro_torch.core import count_sketch as tcs
from repro_torch.kernels import sketch_encode as ske

M32 = 0xFFFFFFFF


def _cfgs(rows, width, seed):
    return (jcs.SketchConfig(rows=rows, width=width, seed=seed),
            tcs.SketchConfig(rows=rows, width=width, seed=seed))


def _flat_buckets(cfg, offset, n):
    """Mirror of the kernel's flat_bucket: r * W + ((a * i + b) mod 2^32)
    >> (32 - log2 W), with i = (offset + j) mod 2^32. -> (R, n) uint64."""
    hp = cfg.hash_params.astype(np.uint64)
    i = (np.arange(n, dtype=np.uint64) + np.uint64(offset)) & np.uint64(M32)
    h = (hp[:, 0:1] * i + hp[:, 1:2]) & np.uint64(M32)
    bucket = (h >> np.uint64(32 - cfg.log2_width) if cfg.log2_width
              else np.zeros_like(h))
    rows = np.arange(cfg.rows, dtype=np.uint64)[:, None]
    return (rows << np.uint64(cfg.log2_width)) + bucket


def _signs(cfg, offset, n):
    hp = cfg.hash_params.astype(np.uint64)
    i = (np.arange(n, dtype=np.uint64) + np.uint64(offset)) & np.uint64(M32)
    hs = (hp[:, 2:3] * i + hp[:, 3:4]) & np.uint64(M32)
    return np.where(hs >> np.uint64(31), -1.0, 1.0).astype(np.float32)


def _binned_encode(cfg, g, offset, plan):
    """numpy mirror of bin_kernel + accum_kernel under ``plan``: blocks of
    plan.block elements stage their (offset-in-tile, value) pairs by tile;
    the tile-major descriptors hold (run start | run length << 16); each
    of a tile's min(splits, blocks) CTAs sums the runs of its share of the
    blocks. One CTA a tile: the first pass stores, later passes add;
    several: every CTA adds into a zeroed output."""
    tile = 1 << ske.TILE_LOG
    entries = plan.entries
    out = np.zeros(cfg.rows * cfg.width, dtype=np.float32)
    if plan.splits == 1:
        out[:] = np.nan    # torch.empty: every bucket must be written
    for c0 in range(0, len(g), plan.chunk):
        gc = g[c0:c0 + plan.chunk]
        nblocks = -(-len(gc) // plan.block)
        off_s = np.zeros(nblocks * entries, dtype=np.uint16)
        val_s = np.zeros(nblocks * entries, dtype=np.float32)
        desc = np.zeros(plan.ntiles * nblocks, dtype=np.uint32)
        flat = _flat_buckets(cfg, offset + c0, len(gc))
        sv = _signs(cfg, offset + c0, len(gc)) * gc
        for b in range(nblocks):
            e = np.arange(b * plan.block, min(len(gc), (b + 1) * plan.block))
            e = e[gc[e] != 0]                       # zeros add nothing
            f = flat[:, e].T.reshape(-1)            # (element, row) order
            v = sv[:, e].T.reshape(-1)
            t = (f >> np.uint64(ske.TILE_LOG)).astype(np.int64)
            order = np.argsort(t, kind="stable")    # runs by tile
            counts = np.bincount(t, minlength=plan.ntiles)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            assert len(f) <= entries <= 65535
            off_s[b * entries:b * entries + len(f)] = (
                f[order] & np.uint64(tile - 1)).astype(np.uint16)
            val_s[b * entries:b * entries + len(f)] = v[order]
            desc[np.arange(plan.ntiles) * nblocks + b] = (
                starts.astype(np.uint32) | (counts.astype(np.uint32) << 16))
        sp = min(plan.splits, nblocks)
        for t in range(plan.ntiles):
            part = out[t * tile:(t + 1) * tile]
            n = len(part)
            for s in range(sp):
                acc = np.zeros(tile, dtype=np.float32)
                for b in range(s * nblocks // sp, (s + 1) * nblocks // sp):
                    dsc = int(desc[t * nblocks + b])
                    lo = b * entries + (dsc & 0xFFFF)
                    run = slice(lo, lo + (dsc >> 16))
                    np.add.at(acc, off_s[run].astype(np.int64), val_s[run])
                store = plan.splits == 1 and c0 == 0
                part[:] = acc[:n] if store else part + acc[:n]
    return out.reshape(cfg.rows, cfg.width)


@pytest.mark.parametrize("rows,log2w", [(1, 8), (3, 8), (5, 12), (5, 19),
                                        (5, 20), (29, 12), (64, 20)])
def test_tiles_partition_every_bucket(rows, log2w):
    """Every bucket of every row lies in exactly one tile, and a tile holds
    a contiguous bucket range of one row or several whole rows."""
    plan = ske.encode_plan(rows, log2w, 10**6)
    size, tile = rows << log2w, 1 << ske.TILE_LOG
    assert plan.ntiles == -(-size // tile)
    covered = 0
    for t in range(plan.ntiles):
        lo, hi = t * tile, min(size, (t + 1) * tile)
        assert lo == covered and hi > lo     # disjoint, in order, no gap
        covered = hi
        assert lo >> ske.TILE_LOG == t == (hi - 1) >> ske.TILE_LOG
        if lo >> log2w != (hi - 1) >> log2w:  # several rows: whole rows
            assert lo % (1 << log2w) == 0 and hi % (1 << log2w) == 0
    assert covered == size


@pytest.mark.parametrize("rows", [1, 3, 5, 29, 64])
@pytest.mark.parametrize("log2w", [0, 8, 12, 19, 20, 21])
def test_plan_fits_shared_memory(rows, log2w):
    plan = ske.encode_plan(rows, log2w, 388_956_160)
    assert plan.bin_smem <= ske.SMEM_PER_SM // 2   # two binning CTAs an SM
    assert (1 << ske.TILE_LOG) * 4 <= ske.SMEM_PER_SM  # one tile a CTA
    assert 1 <= plan.block <= ske.MAX_BLOCK
    assert plan.block & (plan.block - 1) == 0
    assert plan.entries <= 65_535                  # 16-bit ranks and starts
    assert plan.chunk <= ske.CHUNK and plan.chunk % plan.block == 0
    assert plan.nblocks == -(-plan.chunk // plan.block)


@pytest.mark.parametrize("rows", [5, 29, 64])
@pytest.mark.parametrize("log2w", [12, 19, 20, 21])
def test_plan_bounds_scratch(rows, log2w):
    """A pass's off/val/descriptor scratch stays within SCRATCH_BYTES
    whatever R and W, and the main cell's geometry keeps full passes."""
    d = 388_956_160
    plan = ske.encode_plan(rows, log2w, d)
    n_entries = plan.nblocks * plan.entries
    assert plan.scratch_bytes == (2 * n_entries + 4 * n_entries
                                  + 4 * plan.nblocks * plan.ntiles)
    assert plan.scratch_bytes <= ske.SCRATCH_BYTES
    if rows == 5 and log2w in (19, 20):
        assert plan.chunk == ske.CHUNK


@pytest.mark.parametrize("rows,log2w,d,ntiles,splits,group_warps", [
    (5, 20, 388_956_160, 640, 1, 1),    # main cell, bucket 0
    (5, 19, 201_864_704, 320, 1, 1),    # main cell, bucket 1
    (5, 17, 10**8, 80, 4, 4),
    (5, 14, 388_956_160, 10, 39, 16),   # CLI default width
    (3, 9, 53_760, 1, 27, 16),          # smoke spec: one tile, 27 blocks
    (5, 12, 1000, 3, 1, 16),            # one block: one CTA a tile
    (29, 20, 388_956_160, 3712, 1, 1)])
def test_plan_fills_the_card_with_few_tiles(rows, log2w, d, ntiles, splits,
                                            group_warps):
    """Each tile gets enough accumulating CTAs that all tiles together fill
    the card's 132 SMs, never more CTAs than the tile has blocks; the
    longer a (tile, block) run, the more warps share a group of runs."""
    plan = ske.encode_plan(rows, log2w, d)
    assert (plan.ntiles, plan.splits, plan.group_warps) == (
        ntiles, splits, group_warps)
    assert 1 <= plan.splits <= plan.nblocks
    if plan.splits > 1:
        assert plan.ntiles * plan.splits <= ske.H100_SMS * ske.ACC_CTAS_PER_SM
    assert ske.ACC_WARPS % plan.group_warps == 0
    # one warp per 32 entries of the mean run, at least one
    run = plan.block * rows / plan.ntiles
    assert plan.group_warps == ske.ACC_WARPS or plan.group_warps <= max(
        1, run / 32) < 2 * plan.group_warps


def test_plan_rejects_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError):
        ske.encode_plan(65, 8, 100)
    with pytest.raises(ValueError):
        ske.encode_plan(64, 22, 100)   # 2^28 buckets: 2^15 tiles


@pytest.mark.parametrize("offset", [0, 12345, 2**32 - 300, 2**32 + 17])
@pytest.mark.parametrize("rows,width", [(1, 256), (5, 4096), (29, 1 << 14)])
def test_flat_bucket_matches_hash_buckets(offset, rows, width):
    """The kernel's tile and in-tile offset come from r * W + h_r(i), with
    a * i + b in uint32 (i wrapping past 2^32): the buckets
    ``hash_buckets`` gives, hence the tiles."""
    _, t = _cfgs(rows, width, rows)
    n = 3000
    flat = _flat_buckets(t, offset, n).astype(np.int64)
    buckets, signs = tcs.hash_buckets(
        t, torch.arange(offset, offset + n, dtype=torch.int64))
    want = buckets.numpy() + (np.arange(rows)[:, None] << t.log2_width)
    np.testing.assert_array_equal(flat, want)
    np.testing.assert_array_equal(_signs(t, offset, n), signs.numpy())


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("offset", [0, 2**32 - 2500])
@pytest.mark.parametrize("rows,width", [(1, 256), (5, 256), (29, 256),
                                        (1, 4096), (5, 4096), (29, 4096)])
def test_binned_encode_matches_reference(offset, rows, width, splits):
    """The two passes, chunked (passes of 2,048 elements in blocks of 256,
    so the later passes add to the first's tiles), with one or three
    accumulating CTAs a tile, give cs.encode and the JAX encode; zeros are
    skipped."""
    j, t = _cfgs(rows, width, 3)
    d = 5001
    g = np.random.RandomState(rows + width).randn(d).astype(np.float32)
    g[::7] = 0.0
    plan = ske.encode_plan(rows, t.log2_width, d)
    block = min(plan.block, 256)
    plan = dataclasses.replace(plan, block=block, chunk=2048,
                               nblocks=2048 // block, splits=splits)
    got = _binned_encode(t, g, offset, plan)
    want_t = tcs.encode(t, torch.from_numpy(g), offset=offset).numpy()
    # the reference hashes offset + j as uint32; with JAX's 32-bit ints
    # the same indices come from the offset's signed 32-bit form
    j_off = offset - 2**32 if offset >= 2**31 else offset
    want_j = np.asarray(jcs.encode(j, jnp.asarray(g), offset=j_off))
    np.testing.assert_allclose(got, want_t, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_j, rtol=1e-4, atol=1e-4)
