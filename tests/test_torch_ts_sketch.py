"""Port parity: repro_torch.core.ts_sketch and kernels.ts_encode against
repro.core.ts_sketch and the reference's Pallas ``ts_encode`` in interpret
mode, on the same numpy inputs.

Tolerances: the config's parameters, bucket ids and signs are integer
arithmetic and must be bit-equal. Sketches are f32 sums taken in another
order, held at rtol = atol = 1e-4 as tests/test_ts_sketch.py holds the
Pallas kernel; half-width inputs at 2e-2, as there. Decoded estimates of
one sketch gather the same elements, so for odd R they are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ts_sketch as jts
from repro.kernels.ts_encode import ts_encode as j_ts_encode
from repro_torch.core import ts_sketch as tts
from repro_torch.kernels import ts_encode as tk


def _cfgs(d, rows, width, seed):
    return (jts.TSketchConfig(d=d, rows=rows, width=width, seed=seed),
            tts.TSketchConfig(d=d, rows=rows, width=width, seed=seed))


@pytest.mark.parametrize("d,rows,width,seed", [
    (1000, 1, 512, 2), (100000, 5, 512, 2), (65536, 3, 2048, 3),
    ((1 << 21) + 3, 5, 512, 7), (388956160, 5, 1 << 20, 0),
    (201864704, 5, 1 << 19, 1), (37, 4, 3, 0)])
def test_config_params_equal(d, rows, width, seed):
    j, t = _cfgs(d, rows, width, seed)
    assert (t.width, t.log2_width, t.d_pad, t.size) == (
        j.width, j.log2_width, j.d_pad, j.size)
    assert t.log_m == j.log_m and t.offsets == j.offsets
    np.testing.assert_array_equal(t.sign_params, j.sign_params)


@pytest.mark.parametrize("d,rows,width", [(4096, 5, 512), (100000, 3, 256),
                                          ((1 << 21) + 3, 5, 512)])
def test_buckets_and_signs_bit_equal(d, rows, width):
    j, t = _cfgs(d, rows, width, 4)
    idx = np.concatenate([np.arange(3000), np.arange(d - 3000, d),
                          np.random.RandomState(0).randint(0, j.d_pad, 3000)])
    np.testing.assert_array_equal(
        tts.buckets_at(t, torch.from_numpy(idx)).numpy(),
        np.asarray(jts.buckets_at(j, jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tts.signs_at(t, torch.from_numpy(idx)).numpy(),
        np.asarray(jts.signs_at(j, jnp.asarray(idx))))


@pytest.mark.parametrize("d", [1000, 4096, 65536, 100000])
@pytest.mark.parametrize("rows", [1, 3, 5])
def test_encode_matches_reference_and_pallas(d, rows):
    j, t = _cfgs(d, rows, 512, 2)
    g = np.random.RandomState(d).randn(d).astype(np.float32)
    got = tk.ts_encode(t, torch.from_numpy(g)).numpy()
    assert got.shape == (rows, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jts.encode(j, jnp.asarray(g))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(j_ts_encode(j, jnp.asarray(g), interpret=True)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_encode_half_inputs(dtype):
    j, t = _cfgs(8192, 4, 512, 2)
    g = jnp.asarray(np.random.RandomState(0).randn(8192).astype(np.float32))
    gh = g.astype(dtype)
    want = np.asarray(j_ts_encode(j, gh, interpret=True))
    got = tk.ts_encode(t, torch.from_numpy(np.array(g)).to(
        getattr(torch, dtype))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_encode_wide_rows_and_no_padding_copy():
    """Rows whose n_r exceeds W (d_pad > 2 W^2) and a d far below d_pad:
    coordinates past d count as zero without padding g."""
    j, t = _cfgs(70000, 5, 16, 1)
    assert max(t.bits - a for a in t.log_m) > t.log2_width
    g = np.random.RandomState(1).randn(70000).astype(np.float32)
    np.testing.assert_allclose(tk.ts_encode(t, torch.from_numpy(g)).numpy(),
                               np.asarray(jts.encode(j, jnp.asarray(g))),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="d_pad"):
        tk.ts_encode(t, torch.zeros(t.d_pad + 1))


@pytest.mark.parametrize("rows", [3, 4, 5])
def test_decode_and_l2_match(rows):
    d = 65536
    j, t = _cfgs(d, rows, 2048, 3)
    sk = np.random.RandomState(rows).randn(rows, 2048).astype(np.float32)
    want = np.asarray(jts.decode(j, jnp.asarray(sk), d))
    got = tts.decode(t, torch.from_numpy(sk), d).numpy()
    if rows % 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(tts.l2sq_estimate(torch.from_numpy(sk))),
        float(jts.l2sq_estimate(jnp.asarray(sk))), rtol=1e-6)


def test_decode_chunked_matches():
    """d beyond one chunk of the reference's scan and of the port's loop."""
    d = (1 << 22) + 4099
    j, t = _cfgs(d, 3, 1024, 5)
    sk = np.random.RandomState(9).randn(3, 1024).astype(np.float32)
    np.testing.assert_array_equal(
        tts.decode(t, torch.from_numpy(sk), d).numpy(),
        np.asarray(jts.decode(j, jnp.asarray(sk), d)))


def _kernel_contributors(t, r, tau):
    """The CUDA kernel's enumeration (csrc/ts_encode.cu), in numpy: the
    bucket thread ``tau`` of row ``r`` owns, and the padded coordinates
    ib = (i + b) mod d_pad it sums, in its order."""
    a, n_log, lw = t.log_m[r], t.bits - t.log_m[r], t.log2_width
    per_bucket = np.arange(t.d_pad // t.width, dtype=np.int64)
    if n_log <= lw:
        g_log = lw - n_log
        q, s = tau >> g_log, tau & ((1 << g_log) - 1)
        return (s << n_log) | q, (q << a) + s + (per_bucket << g_log)
    ib = ((tau + ((per_bucket >> a) << lw)) << a) + (per_bucket & ((1 << a)
                                                                  - 1))
    return tau, ib


@pytest.mark.parametrize("d,rows,width", [(100000, 5, 512), (70000, 5, 16),
                                          (3000, 2, 4)])
def test_kernel_buckets_own_every_coordinate_once(d, rows, width):
    """Each (row, bucket) thread sums exactly the coordinates that
    ``buckets_at`` sends to its bucket: every ib once, over all threads."""
    t = tts.TSketchConfig(d=d, rows=rows, width=width, seed=6)
    i_all = torch.arange(t.d_pad)
    want = tts.buckets_at(t, i_all).numpy()
    for r in range(rows):
        seen = np.zeros(t.d_pad, np.int64)
        for tau in range(t.width):
            bucket, ib = _kernel_contributors(t, r, tau)
            i = (ib - t.offsets[r]) % t.d_pad
            seen[i] += 1
            assert (want[r, i] == bucket).all()
        assert (seen == 1).all()


@pytest.mark.parametrize("d,rows,width", [(100000, 5, 512), (37, 4, 3)])
def test_row_params_pack_the_config(d, rows, width):
    t = tts.TSketchConfig(d=d, rows=rows, width=width, seed=8)
    p = tk.row_params_on_device(t, "cpu").numpy().view(np.uint32)
    assert p.shape == (rows, 4)
    assert list(p[:, 0]) == list(t.log_m) and list(p[:, 1]) == list(
        t.offsets)
    np.testing.assert_array_equal(p[:, 2:], t.sign_params)


def test_ts_geometry_at_the_full_width_cell():
    """Bucket 0 of the chip cell: d_pad = 2^29, n_r = 1, 4, ..., 256, so
    every row takes the kernel's n_r <= W path."""
    t = tts.TSketchConfig(d=388956160, rows=5, width=1 << 20)
    assert (t.d_pad, [t.bits - a for a in t.log_m]) == (
        1 << 29, [0, 2, 4, 6, 8])
    assert all(t.bits - a <= t.log2_width for a in t.log_m)


def _onepass_walk(t, plan):
    """The one-pass kernel's walk (csrc/ts_encode.cu
    ts_encode_onepass_kernel), in numpy: per row, the coordinate i and the
    bucket that each (CTA, thread, column, block) add lands in, with the
    bucket taken at the flush that ends the add's run, as the kernel's
    index math computes it."""
    lw, nl_max = t.log2_width, plan.nmax_log
    gmin_log = lw - nl_max
    cta, tid, e = (a.reshape(-1) for a in np.meshgrid(
        np.arange(plan.ctas), np.arange(plan.threads), np.arange(4),
        indexing="ij"))
    h, y = tid & 1, tid >> 1
    c0 = 8 * cta
    x = 4 * h + e
    t_col = c0 + x + (y << gmin_log)
    nblk = -(-t.d // t.width)
    j = np.arange(nblk)
    out = []
    for r in range(t.rows):
        a = t.log_m[r]
        nl, rl = t.bits - a, a - lw
        rb = nl_max - nl
        jp = (j + (t.offsets[r] >> lw)) & ((t.d_pad >> lw) - 1)
        ends = (j == nblk - 1) | ((nl > 0) & (((jp + 1) & ((1 << rl) - 1))
                                             == 0))
        # the flush that closes block j's add: the first flush at or after j
        flush_at = np.flatnonzero(ends)[np.searchsorted(np.flatnonzero(ends),
                                                        j)]
        q = jp[flush_at] >> rl
        assert (q == jp >> rl).all()    # a run never changes bucket
        ylo = y & ((1 << rb) - 1)
        # sb[r][((ylo * 8 + x) << nl) + q], written at the end to bucket
        # ((c0 + (ylo << G_min_log)) << nl) + (k & ((8 << nl) - 1))
        k = ((ylo * 8 + x) << nl)[:, None] + q[None, :]
        bucket = ((c0[:, None] + ((k >> (nl + 3)) << gmin_log)) << nl) + (
            k & ((8 << nl) - 1))
        i = (j[None, :] << lw) + t_col[:, None]
        keep = i < t.d
        out.append((i[keep], bucket[keep]))
    return out


def _reduce_sources(nl_max, rb):
    """The y of the columns that the one-pass flush sums into bucket
    y_lo < 2^rb: lanes after the xor shuffles over y bits [rb, 4), then
    the warps ``(y_lo >> 4) + (wh << wlo)``."""
    nwarps = (2 << nl_max) >> 5
    wlo = max(rb - 4, 0)
    out = []
    for ylo in range(1 << rb):
        lane_y = ylo & 15
        ys = set()
        for wh in range(nwarps >> wlo):
            w = (ylo >> 4) + (wh << wlo)
            # the lane's value: the sum over its y bits [rb, 4) (shuffles)
            for yb in range(16):
                if rb >= 4 or (yb & ((1 << rb) - 1)) == lane_y:
                    ys.add(yb + 16 * w if rb < 4 else lane_y + 16 * w)
        out.append(ys)
    return out


@pytest.mark.parametrize("nl_max", [4, 5, 8, 9])
def test_onepass_flush_sums_each_bucket_columns_once(nl_max):
    """Every bucket's flush sums exactly the y with y mod 2^rb = y_lo."""
    for rb in range(nl_max):
        for ylo, ys in enumerate(_reduce_sources(nl_max, rb)):
            assert ys == {y for y in range(1 << nl_max)
                          if y & ((1 << rb) - 1) == ylo}


# (d, rows, width, the plan's kernel): the main cell's two buckets and the
# CLI's default width at bucket 0's d, scaled down 2^8 / 2^12 in d_pad and
# d with d_pad / W (so every n_r and run length in blocks) kept; the smoke
# spec's bucket at full size; a geometry with n_r > W.
@pytest.mark.parametrize("d,rows,width,kernel", [
    (388956160 >> 8, 5, 1 << 12, "onepass"),   # b0: n_r 1..256, runs 512..2
    (201864704 >> 8, 5, 1 << 11, "onepass"),   # b1: the same, G_min = 8
    (388956160 >> 12, 5, 1 << 8, "rows"),      # CLI width: G_min = 1
    (53760, 3, 256, "rows"),                   # smoke spec: n_r 1, 16, 128
    (70000, 5, 16, "rows")])                   # n_r > W
def test_plan_walk_sums_every_coordinate_once(d, rows, width, kernel):
    """Each plan's index walk adds every coordinate i < d exactly once per
    row, into the bucket ``buckets_at`` gives it."""
    t = tts.TSketchConfig(d=d, rows=rows, width=width, seed=2)
    plan = tk.ts_encode_plan(t, sms=1)
    assert plan.kernel == kernel
    want = tts.buckets_at(t, torch.arange(d)).numpy()
    if kernel == "onepass":
        for r, (i, bucket) in enumerate(_onepass_walk(t, plan)):
            assert (np.bincount(i, minlength=d) == 1).all()
            np.testing.assert_array_equal(bucket, want[r, i])
        return
    for r in range(rows):
        seen = np.zeros(t.d_pad, np.int64)
        for tau in range(t.width):
            bucket, ib = _kernel_contributors(t, r, tau)
            i = (ib - t.offsets[r]) % t.d_pad
            seen[i] += 1
            assert (want[r, i[i < d]] == bucket).all()
        assert (seen == 1).all()


@pytest.mark.parametrize("d,width,sms,kernel,ctas", [
    (388956160, 1 << 20, 132, "onepass", 512),
    (201864704, 1 << 19, 132, "onepass", 256),
    (388956160, 16384, 132, "rows", 320),
    (3_000_001, 1 << 16, 132, "onepass", 256),
    (3_000_001, 1 << 16, 300, "rows", 1280),   # one-pass grid too small
    (1 << 20, 1 << 14, 132, "rows", 320)])
def test_plan_picks_from_geometry(d, width, sms, kernel, ctas):
    t = tts.TSketchConfig(d=d, rows=5, width=width)
    plan = tk.ts_encode_plan(t, sms)
    assert (plan.kernel, plan.ctas) == (kernel, ctas)
    if kernel == "onepass":
        # every column in one CTA: G_min / 8 CTAs of 2 n_max threads, four
        # columns a thread; shared memory (8 R + 16) n_max floats
        assert plan.ctas * plan.threads * 4 == t.width
        assert plan.smem == 4 * (8 * 5 + 16) << plan.nmax_log
    else:
        assert tk.onepass_plan(t) is None or tk.onepass_plan(t).ctas < sms


def test_encode_refuses_another_geometrys_onepass_plan():
    """A one-pass plan sizes the kernel's shared memory and reductions
    from n_max: one made for another geometry is refused."""
    t = tts.TSketchConfig(d=3_000_001, rows=5, width=1 << 16)
    other = tk.onepass_plan(tts.TSketchConfig(d=9_000_001, rows=5,
                                              width=1 << 15))
    assert other is not None and other != tk.onepass_plan(t)
    with pytest.raises(ValueError, match="one-pass plan"):
        tk.ts_encode(t, torch.zeros(10), other)
    # its own plans, and the R-pass plan of any geometry, pass
    g = torch.randn(3000)
    want = tk.ts_encode(t, g)
    for plan in (tk.onepass_plan(t), tk.rows_plan(t)):
        assert torch.equal(tk.ts_encode(t, g, plan), want)
