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
