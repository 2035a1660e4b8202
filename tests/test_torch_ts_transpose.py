"""The TS-map scores kernel's layout: the row-transposed sketch
(``kernels.heavymix_topk.ts_transpose``) read through ``TsMapT``
(``csrc/ts_map.cuh``, modelled here by ``ts_buckets_transposed``), against
the reference's ``repro.core.ts_sketch.buckets_at`` / ``signs_at`` and
``decode``, on numpy sketches made from a seed.

For every coordinate i < d the transposed layout must give the same sketch
value as the reference's bucket and the same sign: the scores kernel then
gathers the same floats with the same signs as ``ts.decode``, so its est is
bit-equal (for odd R to the reference's too; for even R ``jnp.median``
averages the middle pair in another order, so against the reference the
est is held at rtol 1e-6, as ``tests/test_torch_ts_sketch.py`` holds the
port's decode). At the main cell's sizes the index walk samples
coordinates: random ones, the last 5,000 below d, and 200 around the d_pad
wrap of every row's offset. The CUDA transpose's tile walk
(``ts_transpose_kernel``) is repeated in numpy and must write what the
plain transpose writes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ts_sketch as jts
from repro_torch.core import ts_sketch as tts
from repro_torch.core.count_sketch import median_rows
from repro_torch.kernels.heavymix_topk import ts_transpose, ts_transpose_plain

# (d, R, W): the main cell's buckets at their own widths; bucket 0 at the
# CLI's default width 16,384 (n_r reaches W); the smoke spec's buckets at
# its width 512; small W at large d (n_r > W); R = 1, even R, d not a power
# of two, d <= 2W.
GEOMETRIES = [
    (388_956_160, 5, 1 << 20), (201_864_704, 5, 1 << 19),
    (388_956_160, 5, 1 << 14), (53_760, 3, 512), (37_888, 3, 512),
    (3_000_001, 5, 16), (100_000, 7, 64), (70_000, 1, 256),
    (50_001, 4, 1024), (20_000, 6, 512), (3000, 3, 1024), (1500, 5, 1024),
    (2 ** 32 - 5, 5, 1 << 12),
]


def ts_buckets_transposed(cfg, idx):
    """(R, *idx.shape) int64: where ``TsMapT`` reads coordinate idx in the
    row-transposed sketch: q_r * P_r + (i mod P_r) with q_r = ib div m_r
    where n_r < W, q_r mod W where n_r >= W."""
    i = idx.to(torch.int64) & 0xFFFFFFFF
    out = []
    for a, b in zip(cfg.log_m, cfg.offsets):
        q = ((i + b) & (cfg.d_pad - 1)) >> a
        nlog = cfg.bits - a
        if nlog >= cfg.log2_width:
            out.append(q & (cfg.width - 1))
        else:
            plog = cfg.log2_width - nlog
            out.append((q << plog) | (i & ((1 << plog) - 1)))
    return torch.stack(out)


def _coords(cfg, d, seed, n_random=100_000):
    """Sampled coordinates of [0, d): random, the last 5,000, and 200
    around each row's d_pad wrap (where i + b_r passes d_pad)."""
    rs = np.random.RandomState(seed)
    parts = [rs.randint(0, d, n_random, dtype=np.int64),
             np.arange(max(0, d - 5000), d)]
    for b in cfg.offsets:
        w = (cfg.d_pad - b) % cfg.d_pad
        parts.append(np.arange(max(0, w - 100), min(d, w + 100)))
    return np.unique(np.concatenate(parts))


def _ids(cfg, d, seed):
    return (np.arange(d) if d <= 200_000 else _coords(cfg, d, seed))


@pytest.mark.parametrize("d,rows,width", GEOMETRIES)
def test_transposed_map_reads_the_reference_bucket(d, rows, width):
    """Sketch value and sign through the transposed layout equal the
    reference's at every sampled (or, at small d, every) i < d."""
    cfg = tts.TSketchConfig(d=d, rows=rows, width=width, seed=rows)
    jcfg = jts.TSketchConfig(d=d, rows=rows, width=width, seed=rows)
    sk = np.random.RandomState(d % 1000).randn(rows, cfg.width).astype(
        np.float32)
    ids = _ids(cfg, d, rows)
    i_j = jnp.asarray(ids.astype(np.uint32))
    want = np.take_along_axis(sk, np.asarray(jts.buckets_at(jcfg, i_j)),
                              axis=1)
    sk_t = ts_transpose(cfg, torch.from_numpy(sk))
    it = torch.from_numpy(ids)
    got = torch.gather(sk_t, 1, ts_buckets_transposed(cfg, it)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(tts.signs_at(cfg, it).numpy(),
                                  np.asarray(jts.signs_at(jcfg, i_j)))


@pytest.mark.parametrize("d,rows,width", GEOMETRIES)
def test_est_from_the_transposed_layout(d, rows, width):
    """The median of the signed values read through the transposed layout
    is bit-equal to the port's ``ts.decode`` at the sampled coordinates and
    to the reference's ``decode`` (odd R; rtol 1e-6 for even R)."""
    cfg = tts.TSketchConfig(d=d, rows=rows, width=width, seed=rows + 1)
    sk = np.random.RandomState(rows).randn(rows, cfg.width).astype(
        np.float32)
    skt = torch.from_numpy(sk)
    ids = torch.from_numpy(_ids(cfg, d, rows + 1))
    vals = torch.gather(ts_transpose(cfg, skt), 1,
                        ts_buckets_transposed(cfg, ids))
    est = median_rows(vals * tts.signs_at(cfg, ids)).numpy()
    port = median_rows(torch.gather(skt, 1, tts.buckets_at(cfg, ids))
                       * tts.signs_at(cfg, ids)).numpy()
    np.testing.assert_array_equal(est.view(np.uint32), port.view(np.uint32))
    if d <= 200_000:
        np.testing.assert_array_equal(
            est.view(np.uint32), tts.decode(cfg, skt, d).numpy()
            .view(np.uint32))
        jcfg = jts.TSketchConfig(d=d, rows=rows, width=width, seed=rows + 1)
        ref = np.asarray(jts.decode(jcfg, jnp.asarray(sk), d))
        if rows % 2:
            np.testing.assert_array_equal(est.view(np.uint32),
                                          ref.view(np.uint32))
        else:
            np.testing.assert_allclose(est, ref, rtol=1e-6, atol=0)


def _kernel_tiles(cfg, sk):
    """``ts_transpose_kernel``'s tile walk in numpy: CTA (x, r) copies or
    transposes one tile of min(W, 1024) elements of row r through a padded
    shared tile, with the kernel's index arithmetic."""
    rows, w = sk.shape
    log2w, bits = cfg.log2_width, cfg.bits
    elog = min(log2w, 10)
    out = np.full_like(sk, np.nan)
    for r in range(rows):
        nlog = bits - cfg.log_m[r]
        for bx in range(1 << (log2w - elog)):
            e0 = bx << elog
            if nlog == 0 or nlog >= log2w:
                out[r, e0:e0 + (1 << elog)] = sk[r, e0:e0 + (1 << elog)]
                continue
            plog = log2w - nlog
            tq = min(nlog, 5)
            tc = elog - tq
            if tc > plog:
                tc, tq = plog, elog - plog
            c0 = (bx & ((1 << (plog - tc)) - 1)) << tc
            q0 = (bx >> (plog - tc)) << tq
            pitch = (1 << tc) + 1
            tile = np.full(2 * 1024, np.nan, np.float32)
            lane = np.arange(1 << elog)
            lc, lq = lane >> tq, lane & ((1 << tq) - 1)
            assert (lq * pitch + lc).max() < tile.shape[0]
            tile[lq * pitch + lc] = sk[r, ((c0 + lc) << nlog) + q0 + lq]
            lq, lc = lane >> tc, lane & ((1 << tc) - 1)
            out[r, ((q0 + lq) << plog) + c0 + lc] = tile[lq * pitch + lc]
    return out


@pytest.mark.parametrize("d,rows,width", [
    (388_956_160, 5, 1 << 20), (201_864_704, 5, 1 << 19),
    (388_956_160, 5, 1 << 14), (53_760, 3, 512), (3_000_001, 5, 16),
    (20_000, 17, 512), (5000, 2, 4), (2 ** 32 - 5, 5, 1 << 12)])
def test_kernel_tile_walk_writes_the_plain_transpose(d, rows, width):
    """Every element of the transposed copy is written once, with the
    plain transpose's value."""
    cfg = tts.TSketchConfig(d=d, rows=rows, width=width, seed=3)
    sk = np.random.RandomState(rows).randn(rows, cfg.width).astype(
        np.float32)
    want = ts_transpose_plain(cfg, torch.from_numpy(sk)).numpy()
    np.testing.assert_array_equal(_kernel_tiles(cfg, sk), want)


def _group_reads(cfg, i0):
    """``ts_scores_kernel``'s reads for the coordinates i0..i0+3 (i0 a
    multiple of 4, W >= 4): (R, 4) offsets into the row-transposed rows,
    by each row's kind (P_r >= 4: a float4; P_r = 2: a float2 read as
    x, y, x, y; n_r >= W: one float)."""
    out = np.zeros((cfg.rows, 4), np.int64)
    for r, (a, b) in enumerate(zip(cfg.log_m, cfg.offsets)):
        q = (((i0 + b) & 0xFFFFFFFF) & (cfg.d_pad - 1)) >> a
        nlog = cfg.bits - a
        plog = cfg.log2_width - nlog if nlog < cfg.log2_width else 0
        if nlog >= cfg.log2_width:
            out[r] = q & (cfg.width - 1)
        elif plog == 1:
            out[r] = (q << 1) + np.array([0, 1, 0, 1])
        else:
            out[r] = ((q << plog) | (i0 & ((1 << plog) - 1))) + np.arange(4)
    return out


@pytest.mark.parametrize("d,rows,width", [
    g for g in GEOMETRIES if g[1] <= 8 and g[2] >= 4] + [
    (100_000, 5, 16), (100_000, 3, 4), (5000, 2, 4)])
def test_kernel_groups_of_four_read_the_map(d, rows, width):
    """Four coordinates a thread: the kernel's per-row float4 / float2 /
    broadcast reads give, coordinate for coordinate, TsMapT's offsets, at
    every group of four below d (sampled at the main cell's sizes; the
    groups around each row's d_pad wrap included)."""
    cfg = tts.TSketchConfig(d=d, rows=rows, width=width, seed=rows)
    ids = _ids(cfg, d, rows)
    i0s = np.unique(ids // 4 * 4)
    i0s = i0s[i0s + 4 <= d]
    kinds = set()
    for r, a in enumerate(cfg.log_m):
        nlog = cfg.bits - a
        kinds.add(0 if nlog >= cfg.log2_width else
                  (1 if cfg.log2_width - nlog == 1 else 2))
    want = ts_buckets_transposed(
        cfg, torch.from_numpy((i0s[:, None] + np.arange(4)).reshape(-1)))
    want = want.numpy().reshape(cfg.rows, -1, 4)
    got = np.stack([_group_reads(cfg, int(i0)) for i0 in i0s[:20_000]],
                   axis=1)
    np.testing.assert_array_equal(got, want[:, :got.shape[1]])
    if (d, rows, width) == (100_000, 5, 16):   # n_r = 1, 8, 64, 512, 4096
        assert kinds == {0, 1, 2}


def test_transpose_leaves_rows_with_n_one_or_at_least_w():
    """Rows with n_r = 1 (row 0) or n_r >= W are copied as they are; the
    others are permutations of the row."""
    cfg = tts.TSketchConfig(d=388_956_160, rows=5, width=1 << 14, seed=0)
    ns = [1 << (cfg.bits - a) for a in cfg.log_m]
    assert ns == [1, 16, 128, 1024, 16384]
    sk = torch.randn(5, cfg.width, generator=torch.Generator().manual_seed(0))
    st = ts_transpose_plain(cfg, sk)
    for r, n in enumerate(ns):
        same = torch.equal(st[r], sk[r])
        assert same == (n == 1 or n >= cfg.width)
        assert torch.equal(st[r].sort().values, sk[r].sort().values)
