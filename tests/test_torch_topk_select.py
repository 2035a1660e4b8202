"""Port parity for the HEAVYMIX top-k radix select (``kernels/topk_select``):
its plain version, and ``ops.heavymix_recover`` through it, against
``core.heavymix.topk_lower_index`` and the reference's ``jax.lax.top_k``,
on numpy inputs made from a seed and handed to both.

The select ranks |x| with ``jax.lax.top_k``'s order (values descending,
ties to the lower index): indices must be equal as returned and values
bit-equal. The fused kernels' first-digit histogram is held to
``numpy.histogram`` of the same key bits, count for count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_sketch as jcs
from repro.core import heavymix as jhm
from repro_torch.core import count_sketch as tcs
from repro_torch.core.heavymix import topk_lower_index
from repro_torch.kernels import ops as tops
from repro_torch.kernels.heavymix_topk import (heavymix_scores_hist,
                                               heavymix_scores_plain)
from repro_torch.kernels.sketch_decode import (sketch_decode_hist,
                                               sketch_decode_plain)
from repro_torch.kernels.topk_select import (RADIX_BINS, radix_hist_plain,
                                             select_plan, topk_select,
                                             topk_select_plain)


def _check(x: np.ndarray, k: int, hist=None):
    """The plain select and the dispatching wrapper, from ``hist`` or the
    plain first-digit histogram of x, against topk_lower_index(|x|) and,
    for k <= n, jax.lax.top_k(|x|)."""
    xt = torch.from_numpy(x)
    if hist is None:
        hist = radix_hist_plain(xt)
    want_v, want_i = topk_lower_index(xt.abs(), k)
    for v, i in (topk_select_plain(xt, k, hist), topk_select(xt, k, hist)):
        assert i.dtype == torch.int64
        np.testing.assert_array_equal(i.numpy(), want_i.numpy())
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      want_v.numpy().view(np.uint32))
    if k <= x.shape[0]:
        jv, ji = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
        np.testing.assert_array_equal(want_i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(want_v.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))


def _est_like(n, seed):
    """|est|-like keys: medians of a few sketch cells, so many repeat."""
    rs = np.random.RandomState(seed)
    cells = (0.1 * rs.randn(n // 50 + 1)).astype(np.float32)
    x = cells[rs.randint(0, cells.shape[0], n)]
    x[rs.choice(n, 8, replace=False)] = 10.0 * rs.randn(8)
    return x


@pytest.mark.parametrize("n,k", [(5000, 40), (20_000, 1), (20_000, 19_999),
                                 (20_000, 1000), (3001, 3001), (300, 500)])
def test_select_est_like_keys(n, k):
    _check(_est_like(n, n + k), k)


@pytest.mark.parametrize("k", [1, 17, 999, 1000, 1500])
def test_select_all_keys_equal(k):
    _check(np.full(1000, -0.75, dtype=np.float32), k)


def test_select_zeros_and_negative_zeros():
    rs = np.random.RandomState(4)
    x = np.zeros(2000, dtype=np.float32)
    x[rs.rand(2000) < 0.5] = -0.0
    x[rs.choice(2000, 30, replace=False)] = rs.randn(30)
    assert np.signbit(x).sum() > 100
    for k in (10, 30, 31, 500, 1999):
        _check(x, k)


def test_select_subnormals_and_inf():
    rs = np.random.RandomState(5)
    x = (rs.randn(4000) * 1e-39).astype(np.float32)   # subnormal
    assert (np.abs(x[x != 0]) < np.finfo(np.float32).tiny).all()
    x[rs.choice(4000, 5, replace=False)] = np.inf
    x[rs.choice(4000, 5, replace=False)] = -np.inf
    x[:3] = np.float32(1.4e-45)                        # the least subnormal
    for k in (1, 10, 11, 100, 3999):
        _check(x, k)


@pytest.mark.parametrize("k", [1, 100, 2048, 40_000])
def test_select_many_ties_at_1e30(k):
    """HEAVYMIX scores with |H| > k: every heavy score is exactly 1e30, so
    the k lowest-index heavy coordinates win."""
    rs = np.random.RandomState(k)
    s = np.abs(rs.randn(100_000)).astype(np.float32)
    heavy = rs.rand(100_000) < 0.5
    s[heavy] = s[heavy] + np.float32(1e30)
    assert (s[heavy] == np.float32(1e30)).all() and heavy.sum() > k
    _check(s, k)
    st = torch.from_numpy(s)
    got = topk_select_plain(st, k, radix_hist_plain(st))[1].numpy()
    np.testing.assert_array_equal(got, np.flatnonzero(heavy)[:k])


def test_select_with_a_fused_kernels_histogram():
    """The histogram the fused decode hands over gives the same selection
    as the plain histogram of its est."""
    cfg = tcs.SketchConfig(rows=5, width=256, seed=7)
    rs = np.random.RandomState(7)
    sk = torch.from_numpy(rs.randn(5, 256).astype(np.float32))
    est, hist = sketch_decode_hist(cfg, sk, 50_000)
    _check(est.numpy(), 321, hist)


def test_plain_histogram_matches_numpy():
    rs = np.random.RandomState(11)
    x = np.concatenate([rs.randn(10_000) * 10.0 ** rs.randint(-40, 38,
                                                               10_000),
                        [0.0, -0.0, np.inf, -np.inf, 1.4e-45]]
                       ).astype(np.float32)
    bits = (x.view(np.uint32) & 0x7FFFFFFF) >> 20
    want, _ = np.histogram(bits, bins=RADIX_BINS, range=(0, RADIX_BINS))
    got = radix_hist_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (RADIX_BINS,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_kernels_plain_versions_count_their_keys():
    """On CPU tensors the fused decode and scores return the plain
    outputs and the plain histogram of |est| and of the scores."""
    cfg = tcs.SketchConfig(rows=5, width=512, seed=2)
    rs = np.random.RandomState(2)
    sk = torch.from_numpy(rs.randn(5, 512).astype(np.float32))
    est, hist = sketch_decode_hist(cfg, sk, 7000)
    assert torch.equal(est, sketch_decode_plain(cfg, sk, 7000))
    assert torch.equal(hist, radix_hist_plain(est.abs()))
    thr = tcs.l2sq_estimate(sk) / 50
    sc, e, h = heavymix_scores_hist(cfg, sk, thr, 7000)
    sc_p, e_p = heavymix_scores_plain(cfg, sk, thr, 7000)
    assert torch.equal(sc, sc_p) and torch.equal(e, e_p)
    assert torch.equal(h, radix_hist_plain(sc_p))
    assert int(h.sum()) == 7000


@pytest.mark.parametrize("sms", [132, 16])
def test_select_plan_covers_every_key(sms):
    """The grid is sized from the card's SMs: at most 8 CTAs an SM."""
    for n in (1, 1000, 1024, 1025, 1024 * 1056 + 1, 388_956_160):
        grid, chunk = select_plan(n, sms)
        assert chunk % 1024 == 0 and grid * chunk >= n
        assert (grid - 1) * chunk < n and grid <= sms * 8


def test_recover_scores_regime_heavy_set_outnumbers_k():
    """d <= 2^22: the reference ranks the boosted scores, so with |H| >> k
    the k lowest-index heavy coordinates win; ops.heavymix_recover (scores
    kernel's route, then the select) returns the reference's idx and est.
    W = k/2, the paper's regime: the sketch noise alone makes most
    estimates heavy."""
    d, rows, width, k = 300_000, 5, 512, 1024
    jc = jcs.SketchConfig(rows=rows, width=width, seed=3)
    tc = tcs.SketchConfig(rows=rows, width=width, seed=3)
    g = np.random.RandomState(3).randn(d).astype(np.float32)
    sk = tcs.encode(tc, torch.from_numpy(g))
    est = tcs.decode(tc, sk, d)
    assert int((est * est >= tcs.l2sq_estimate(sk) / k).sum()) > 10 * k
    j_idx, j_est = jhm.heavymix(jc, jnp.asarray(sk.numpy()), k, d)
    t_idx, t_est = tops.heavymix_recover(tc, sk, k, d)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_est.numpy(), np.asarray(j_est))


def test_select_property_small():
    """Any small key vector from a pool full of ties, any k: the select
    returns jax.lax.top_k's indices and values. (hypothesis is imported
    here, so the module's other tests never depend on it.)"""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=60, deadline=None)
    @hypothesis.given(
        data=st.lists(st.sampled_from([0.0, -0.0, 1.0, -1.0, 2.5, 1e30,
                                       np.inf, 1e-40, 3.0e-5, 7.0, -7.0]),
                      min_size=1, max_size=60),
        k=st.integers(min_value=1, max_value=70))
    def prop(data, k):
        _check(np.asarray(data, dtype=np.float32), k)

    prop()


# ---------------------------------------------------------------------------
# NaN keys: jax.lax.top_k ranks NaN above +inf (IEEE total order), NaNs tied
# by the lower index. ``topk_lower_index`` and the compressor baselines that
# select through it must return its indices in its order.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_topk_lower_index_nan_keys_like_jax(k):
    x = np.abs(np.array([1, np.nan, 3, 2, np.nan, 0.5], np.float32))
    v, i = topk_lower_index(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                  np.asarray(jv).view(np.uint32))
    _check(x, k)   # the radix select ranks them the same way


def test_topk_lower_index_signed_keys_like_jax():
    """Signed keys in IEEE total order: +NaN > +inf > +0 > -0 > -inf > -NaN."""
    x = np.array([1., -0.0, 0.0, np.nan, -np.nan, -np.inf, np.inf, 0.0,
                  -0.0, np.nan], np.float32)
    for k in range(1, x.shape[0] + 1):
        i = topk_lower_index(torch.from_numpy(x), k)[1]
        np.testing.assert_array_equal(
            i.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))


@pytest.mark.parametrize("name", ["topk", "gtopk"])
def test_baselines_select_nan_like_the_reference(name):
    """P = 2, d = 64, k = 8, worker 0's coordinate 5 NaN, zero EF: the
    port's step selects the reference's coordinates (NaN first) and leaves
    the same update and error feedback, NaN where the reference has NaN."""
    from repro.core import compression as jcomp
    from repro_torch.core import compression as tcomp
    from repro_torch.core.compression import _topk_rows
    g = np.random.default_rng(1).standard_normal((2, 64)).astype(np.float32)
    g[0, 5] = np.nan
    acc = np.zeros_like(g)
    jc, tc = jcomp.make(name, k=8), tcomp.make(name, k=8)
    j_upd, j_ef, _ = jax.vmap(
        lambda a, b: jc.step(a, b, axis="data", nworkers=2),
        axis_name="data")(jnp.asarray(acc), jnp.asarray(g))
    t_upd, t_ef, _ = tc.step(torch.from_numpy(acc), torch.from_numpy(g),
                             nworkers=2)
    np.testing.assert_array_equal(t_upd.numpy(), np.asarray(j_upd))
    np.testing.assert_array_equal(t_ef.numpy(), np.asarray(j_ef))
    for p in range(2):
        np.testing.assert_array_equal(
            _topk_rows(torch.from_numpy(g), 8)[p].numpy(),
            np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(g[p])), 8)[1]))
    assert _topk_rows(torch.from_numpy(g), 8)[0, 0] == 5
