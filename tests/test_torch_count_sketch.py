"""Port parity: repro_torch.core.count_sketch against repro.core.count_sketch.

Same numpy inputs through both packages. Hash parameters, bucket ids and
signs must be bit-equal (integer arithmetic); sketches are f32 sums taken
in another order, held at rtol=atol=1e-4 as tests/test_kernels.py holds
the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_sketch as jcs
from repro_torch.core import count_sketch as tcs


def _cfgs(rows, width, seed):
    return (jcs.SketchConfig(rows=rows, width=width, seed=seed),
            tcs.SketchConfig(rows=rows, width=width, seed=seed))


@pytest.mark.parametrize("rows,width,seed", [(1, 256, 0), (3, 512, 7),
                                             (5, 1000, 3), (29, 2048, 11)])
def test_hash_params_equal(rows, width, seed):
    j, t = _cfgs(rows, width, seed)
    assert t.width == j.width and t.log2_width == j.log2_width
    np.testing.assert_array_equal(t.hash_params, j.hash_params)


@pytest.mark.parametrize("offset", [0, 12345, 2**31 - 10, 2**32 - 300])
def test_hash_buckets_bit_equal(offset):
    """Indices near 2^32 wrap exactly as the reference's uint32 hashing."""
    j, t = _cfgs(5, 4096, 1)
    idx = (np.arange(600, dtype=np.int64) + offset) % (2**32)
    jb, js = jcs.hash_buckets(j, jnp.asarray(idx.astype(np.uint32)))
    tb, ts = tcs.hash_buckets(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("d,offset", [(3001, 0), (3001, 777), (1500, 2**20)])
@pytest.mark.parametrize("rows,width", [(3, 256), (4, 1024)])
def test_encode_matches(d, offset, rows, width):
    j, t = _cfgs(rows, width, 2)
    g = np.random.RandomState(d + rows).randn(d).astype(np.float32)
    want = np.asarray(jcs.encode(j, jnp.asarray(g), offset=offset))
    got = tcs.encode(t, torch.from_numpy(g), offset=offset).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows", [3, 4])
def test_decode_and_l2sq_match(rows):
    """Odd R: the median is an element (exact). Even R: the mean of the
    two middle values, rounded once more (held at 1e-6)."""
    j, t = _cfgs(rows, 512, 4)
    sk = np.random.RandomState(rows).randn(rows, 512).astype(np.float32)
    d = 2500
    want = np.asarray(jcs.decode(j, jnp.asarray(sk), d))
    got = tcs.decode(t, torch.from_numpy(sk), d).numpy()
    if rows % 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(tcs.l2sq_estimate(torch.from_numpy(sk))),
        float(jcs.l2sq_estimate(jnp.asarray(sk))), rtol=1e-6)
    idx = np.array([0, 5, 2499, 77], dtype=np.int64)
    np.testing.assert_allclose(
        tcs.decode_at(t, torch.from_numpy(sk), torch.from_numpy(idx)).numpy(),
        np.asarray(jcs.decode_at(j, jnp.asarray(sk), jnp.asarray(idx))),
        rtol=1e-6, atol=1e-7)


def test_median_even_is_mean_of_middles():
    """torch.median would give 2.0 here; the reference gives 2.5."""
    x = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    assert float(tcs.median_rows(x)[0]) == 2.5


def test_merge_is_linear():
    t = tcs.SketchConfig(rows=3, width=256, seed=0)
    rs = np.random.RandomState(0)
    a, b = (torch.from_numpy(rs.randn(700).astype(np.float32))
            for _ in range(2))
    np.testing.assert_allclose(
        tcs.merge(tcs.encode(t, a), tcs.encode(t, b)).numpy(),
        tcs.encode(t, a + b).numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# NaN: jnp.median gives NaN when any of the values is NaN, so a NaN in g
# makes NaN estimates wherever one of a coordinate's R buckets holds it.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x", [
    [[1, 5], [np.nan, 6], [2, 7]],              # odd R
    [[1, 5], [np.nan, 6], [2, 7], [3, np.nan]],  # even R
    [[np.nan], [np.nan], [1]]])
def test_median_rows_nan_like_jnp(x):
    x = np.array(x, np.float32)
    np.testing.assert_array_equal(tcs.median_rows(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x), axis=0)))


def _nan_case():
    """d = 4,096, R = 5, W = 256, seed 0, k = 64, g[100] = NaN."""
    g = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    g[100] = np.nan
    return g, 4096, 5, 256, 0, 64


@pytest.mark.parametrize("route", ["decode", "decode_at", "ts_decode",
                                   "heavymix_recover", "ts_heavymix_recover"])
def test_nan_estimates_and_selection_match_reference(route):
    """The reference's sketch of g holds one NaN a row. Estimates: NaN at
    the reference's coordinates, the rest equal (odd R: the same middle
    value). Recoveries: the reference's indices in its order (NaN
    first)."""
    from repro.core import heavymix as jhm
    from repro.core import ts_sketch as jts
    from repro_torch.core import ts_sketch as tts
    from repro_torch.kernels import ops
    g, d, rows, width, seed, k = _nan_case()
    jc, tc = _cfgs(rows, width, seed)
    ts_route = route.startswith("ts_")
    if ts_route:
        jt = jts.TSketchConfig(d=d, rows=rows, width=width, seed=seed)
        tt = tts.TSketchConfig(d=d, rows=rows, width=width, seed=seed)
        sk = np.asarray(jts.encode(jt, jnp.asarray(g)))
        want_est = np.asarray(jts.decode(jt, jnp.asarray(sk), d))
    else:
        sk = np.asarray(jcs.encode(jc, jnp.asarray(g)))
        want_est = np.asarray(jcs.decode(jc, jnp.asarray(sk), d))
    assert np.isnan(sk).sum(axis=1).tolist() == [1] * rows
    n_nan = int(np.isnan(want_est).sum())
    assert 0 < n_nan < d and (ts_route or n_nan > k), n_nan
    skt = torch.from_numpy(sk.copy())
    if route == "decode":
        got = tcs.decode(tc, skt, d).numpy()
    elif route == "decode_at":
        idx = np.arange(0, d, 3)
        got = tcs.decode_at(tc, skt, torch.from_numpy(idx)).numpy()
        want_est = np.asarray(jcs.decode_at(jc, jnp.asarray(sk),
                                            jnp.asarray(idx)))
    elif route == "ts_decode":
        got = tts.decode(tt, skt, d).numpy()
    if route in ("decode", "decode_at", "ts_decode"):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want_est))
        np.testing.assert_array_equal(got, want_est)
        return
    if ts_route:
        idx, est = ops.ts_heavymix_recover(tt, skt, k, d)
        want, _ = jhm.heavymix(jc, jnp.asarray(sk), k, d,
                               estimates=jnp.asarray(want_est))
    else:
        idx, est = ops.heavymix_recover(tc, skt, k, d)
        want, _ = jhm.heavymix(jc, jnp.asarray(sk), k, d)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(est.numpy(), want_est[np.asarray(want)])
    # the NaN estimates rank first (70 of them on the exact route, 42 on
    # the TS route)
    assert np.isnan(est.numpy()[:min(k, n_nan)]).all()
