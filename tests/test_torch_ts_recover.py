"""Port parity: the TS route's recovery, ``kernels.ops.ts_heavymix_recover``
(the TS-map scores with their first-digit histogram, then the radix
select; on CPU tensors their plain versions), against the JAX reference's
``repro.core.heavymix.heavymix(cfg, sk, k, d,
estimates=repro.core.ts_sketch.decode(...))``, on the same numpy sketches.

Tolerances: for odd R both packages gather and take the middle of the same
values, so the estimates are bit-equal and the selected indices equal as
returned (the reference's ``jax.lax.top_k`` order, ties at 1e30 to the lower
index). For even R ``jnp.median`` averages the middle pair in another
order, so the estimates are held at rtol 1e-6 as
``test_torch_ts_sketch.py::test_decode_and_l2_match`` holds them, and the
indices are compared with the reference's HEAVYMIX given the port's
estimates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_sketch as jcs
from repro.core import heavymix as jhm
from repro.core import ts_sketch as jts
from repro_torch.core import count_sketch as tcs
from repro_torch.core import heavymix as thm
from repro_torch.core import ts_sketch as tts
from repro_torch.kernels import ops
from repro_torch.kernels.heavymix_topk import (heavymix_scores_ts_hist,
                                               heavymix_scores_ts_plain)
from repro_torch.kernels.topk_select import radix_hist_plain


def _sketch(kind, rows, width, d, seed):
    """(R, W) f32 numpy sketch. "noise": every cell N(0, 1), so the heavy
    set is a fixed share of d (far more than k). "spiky": the reference's
    TS encode of small noise plus 20 large coordinates (heavy set < k)."""
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randn(rows, width).astype(np.float32)
    g = (0.01 * rng.randn(d)).astype(np.float32)
    g[rng.choice(d, 20, replace=False)] = 10.0
    j = jts.TSketchConfig(d=d, rows=rows, width=width, seed=seed)
    return np.array(jts.encode(j, jnp.asarray(g)))


def _reference(sk, rows, width, k, d, seed, est=None):
    j = jts.TSketchConfig(d=d, rows=rows, width=width, seed=seed)
    sk_j = jnp.asarray(sk)
    if est is None:
        est = jts.decode(j, sk_j, d)
    idx, _ = jhm.heavymix(jcs.SketchConfig(rows=rows, width=width, seed=seed),
                          sk_j, k, d, estimates=jnp.asarray(est))
    return np.asarray(idx), np.asarray(est)


@pytest.mark.parametrize("kind,rows,width,k,d", [
    ("noise", 5, 256, 512, 50_000),        # heavy set >> k: ties at 1e30
    ("noise", 3, 512, 300, 40_000),
    ("spiky", 5, 512, 200, 30_000),         # heavy set < k: greedy fill
    ("spiky", 3, 256, 500, 20_000),         # (R = 3: spikes collide in
    #                                         every row, ~400 heavy)
    ("noise", 3, 1024, 2048, (1 << 22) + 5000),  # past 2^22: still boosted
    ("noise", 5, 1024, 2048, (1 << 22) + 3)])
def test_recover_matches_reference(kind, rows, width, k, d):
    seed = rows + width
    sk = _sketch(kind, rows, width, d, seed)
    t = tts.TSketchConfig(d=d, rows=rows, width=width, seed=seed)
    idx, est = ops.ts_heavymix_recover(t, torch.from_numpy(sk), k, d)
    want_idx, want_est = _reference(sk, rows, width, k, d, seed)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(est.numpy(), want_est[want_idx])
    thr = float(tcs.l2sq_estimate(torch.from_numpy(sk))) / k
    n_heavy = int((want_est.astype(np.float64) ** 2 >= thr).sum())
    assert n_heavy > 4 * k if kind == "noise" else n_heavy < k, n_heavy


@pytest.mark.parametrize("rows", [2, 4])
def test_recover_even_rows(rows):
    d, width, k, seed = 30_000, 512, 400, 7
    sk = _sketch("noise", rows, width, d, seed)
    t = tts.TSketchConfig(d=d, rows=rows, width=width, seed=seed)
    idx, est = ops.ts_heavymix_recover(t, torch.from_numpy(sk), k, d)
    est_all = tts.decode(t, torch.from_numpy(sk), d).numpy()
    want_idx, _ = _reference(sk, rows, width, k, d, seed, est=est_all)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(est.numpy(), est_all[want_idx])
    j = jts.TSketchConfig(d=d, rows=rows, width=width, seed=seed)
    np.testing.assert_allclose(est_all,
                               np.asarray(jts.decode(j, jnp.asarray(sk), d)),
                               rtol=1e-6, atol=1e-7)


def test_recover_matches_the_plain_route():
    """The port's own old route (``ts.decode`` + ``heavymix(estimates=)``,
    which ``_SketchBased._select`` took before) selects the same indices."""
    d, rows, width, k = 60_000, 5, 512, 700
    sk = torch.from_numpy(_sketch("noise", rows, width, d, 3))
    t = tts.TSketchConfig(d=d, rows=rows, width=width, seed=3)
    est = tts.decode(t, sk, d)
    want = thm.heavymix(tcs.SketchConfig(rows=rows, width=width, seed=3), sk,
                        k, d, estimates=est)
    got = ops.ts_heavymix_recover(t, sk, k, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_scores_ts_plain_counts_its_keys():
    """The CPU path of ``heavymix_scores_ts_hist``: the plain scores, est
    from ``ts.decode`` and the histogram of the scores' first digit."""
    d, rows, width, k = 20_000, 3, 256, 100
    sk = torch.from_numpy(_sketch("noise", rows, width, d, 5))
    t = tts.TSketchConfig(d=d, rows=rows, width=width, seed=5)
    thr = tcs.l2sq_estimate(sk) / k
    sc, est, hist = heavymix_scores_ts_hist(t, sk, thr, d)
    sc_p, est_p = heavymix_scores_ts_plain(t, sk, thr, d)
    assert torch.equal(sc, sc_p) and torch.equal(est, est_p)
    assert torch.equal(est, tts.decode(t, sk, d))
    assert torch.equal(hist, radix_hist_plain(sc))
    assert int(hist.sum()) == d
    heavy = est * est >= thr
    assert bool((sc[heavy] == 1e30).all())
    assert torch.equal(sc[~heavy], est[~heavy].abs())
