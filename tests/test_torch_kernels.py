"""Port parity for the kernel modules: the plain PyTorch versions (what CPU
tensors run) against the JAX package's Pallas kernels in interpret mode,
as tests/test_kernels.py runs them on the CPU.

Tolerances: sketches are f32 sums in another order (rtol=atol=1e-4, the
reference kernel test's own); half-width inputs feed both sides the same
rounded values, so they are held at the same 1e-4. Estimates for odd R
are one gathered element and must be equal; the selected indices must be
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_sketch as jcs
from repro.core import heavymix as jhm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.heavymix_topk import heavymix_scores as j_scores
from repro.kernels.sketch_decode import sketch_decode as j_decode
from repro.kernels.sketch_encode import sketch_encode as j_encode
from repro_torch.core import count_sketch as tcs
from repro_torch.core.compression import GsSGD
from repro_torch.core.heavymix import topk_lower_index
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.dispatch import resolve_dispatch
from repro_torch.kernels.heavymix_topk import heavymix_scores as t_scores
from repro_torch.kernels.sketch_decode import sketch_decode as t_decode
from repro_torch.kernels.sketch_encode import (sketch_encode as t_encode,
                                               sketch_encode_bucketed)


def test_dispatch_table():
    assert resolve_dispatch("cpu") is False
    assert resolve_dispatch("cuda") is True
    assert resolve_dispatch("meta") is True  # never a silent plain path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d,rows,width,offset", [(2000, 3, 512, 0),
                                                 (1537, 5, 256, 4099)])
def test_encode_plain_matches_pallas(dtype, d, rows, width, offset):
    jc = jcs.SketchConfig(rows=rows, width=width, seed=3)
    tc = tcs.SketchConfig(rows=rows, width=width, seed=3)
    g32 = np.random.RandomState(d).randn(d).astype(np.float32)
    gj = jnp.asarray(g32).astype(dtype)
    g_same = np.array(gj.astype(jnp.float32))   # the rounded values
    want = np.asarray(j_encode(jc, gj, index_offset=offset, interpret=True))
    gt = torch.from_numpy(g_same).to(getattr(torch, dtype))
    got = t_encode(tc, gt, index_offset=offset).numpy()
    assert got.shape == (rows, width) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_encode_bucketed_matches_per_bucket():
    cfgs = [tcs.SketchConfig(rows=3, width=256, seed=s) for s in (0, 1)]
    g = torch.from_numpy(np.random.RandomState(1).randn(900)
                         .astype(np.float32))
    a, b = sketch_encode_bucketed(cfgs, g, (500, 400))
    np.testing.assert_array_equal(a.numpy(), tcs.encode(cfgs[0], g[:500])
                                  .numpy())
    np.testing.assert_array_equal(b.numpy(), tcs.encode(cfgs[1], g[500:])
                                  .numpy())
    with pytest.raises(ValueError):
        sketch_encode_bucketed(cfgs, g, (500, 300))


def _sketch(rows, width, seed, d, spikes=8):
    """A summed sketch of a heavy-tailed vector (a few large spikes)."""
    rs = np.random.RandomState(seed)
    g = (0.1 * rs.randn(d)).astype(np.float32)
    g[rs.choice(d, spikes, replace=False)] = 10.0 * rs.randn(spikes)
    cfg = tcs.SketchConfig(rows=rows, width=width, seed=seed)
    return tcs.encode(cfg, torch.from_numpy(g)).numpy()


@pytest.mark.parametrize("rows,width,d,offset", [
    (1, 512, 3000, 0), (3, 384, 2000, 0), (5, 1000, 4096, 4099),
    (5, 256, 1537, 2**30 + 700), (29, 512, 3001, 17)])
def test_decode_plain_matches_pallas(rows, width, d, offset):
    """Odd R: bit-equal to the reference's Pallas decode, with an
    index_offset and widths that are not a multiple of the Pallas kernel's
    512-wide bucket block."""
    jc = jcs.SketchConfig(rows=rows, width=width, seed=rows)
    tc = tcs.SketchConfig(rows=rows, width=width, seed=rows)
    sk = _sketch(rows, tc.width, rows, 5000)
    want = np.asarray(j_decode(jc, jnp.asarray(sk), d, index_offset=offset,
                               block_w=384 if width == 384 else 512,
                               interpret=True))
    got = t_decode(tc, torch.from_numpy(sk), d, index_offset=offset)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.decode(tc, torch.from_numpy(sk), d, offset=offset).numpy(), want)


def test_decode_even_rows_matches_pallas():
    """Even R: the mean of the two middles, rounded in another place."""
    jc, tc = (m.SketchConfig(rows=4, width=512, seed=4) for m in (jcs, tcs))
    sk = _sketch(4, 512, 4, 3000)
    want = np.asarray(j_decode(jc, jnp.asarray(sk), 3000, interpret=True))
    got = t_decode(tc, torch.from_numpy(sk), 3000).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_decode_buckets_matches_reference():
    sizes = (1200, 800, 333)
    jcfgs = [jcs.SketchConfig(rows=3, width=256, seed=s) for s in range(3)]
    tcfgs = [tcs.SketchConfig(rows=3, width=256, seed=s) for s in range(3)]
    sks = [_sketch(3, 256, s, sz) for s, sz in enumerate(sizes)]
    want = np.asarray(jops.decode_buckets(jcfgs, [jnp.asarray(x) for x in sks],
                                          sizes, use_pallas=True,
                                          interpret=True))
    got = tops.decode_buckets(tcfgs, [torch.from_numpy(x) for x in sks],
                              sizes)
    assert got.shape == (sum(sizes),)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows", [3, 5, 4])
def test_scores_plain_matches_pallas(rows):
    d, width, k = 3000, 512, 40
    jc = jcs.SketchConfig(rows=rows, width=width, seed=rows)
    tc = tcs.SketchConfig(rows=rows, width=width, seed=rows)
    sk = _sketch(rows, width, rows, d)
    thr = float(jcs.l2sq_estimate(jnp.asarray(sk))) / k
    js, je = j_scores(jc, jnp.asarray(sk), jnp.float32(thr), d,
                      interpret=True)
    ts, te = t_scores(tc, torch.from_numpy(sk),
                      torch.tensor(thr, dtype=torch.float32), d)
    if rows % 2:
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:  # mean of two middles, rounded in another place
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=1e-7)
    assert int((ts >= 1e30).sum()) > 0  # the heavy branch is exercised


@pytest.mark.parametrize("rows,k", [(3, 40), (5, 100)])
def test_heavymix_recover_matches_ref(rows, k):
    d, width = 3000, 512
    jc = jcs.SketchConfig(rows=rows, width=width, seed=rows)
    tc = tcs.SketchConfig(rows=rows, width=width, seed=rows)
    sk = _sketch(rows, width, rows, d)
    j_idx, j_est = jref.heavymix_recover(jc, jnp.asarray(sk), k, d)
    t_idx, t_est = tops.heavymix_recover(tc, torch.from_numpy(sk), k, d)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_est.numpy(), np.asarray(j_est))
    r_idx, _ = tref.heavymix_recover(tc, torch.from_numpy(sk), k, d)
    np.testing.assert_array_equal(r_idx.numpy(), np.asarray(j_idx))
    # the reference's own Pallas route agrees too
    p_idx, _ = jops.heavymix_recover(jc, jnp.asarray(sk), k, d,
                                     use_pallas=True, interpret=True)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(p_idx))


@pytest.mark.parametrize("vals,k", [([1, 5, 5, 5, 2], 2),
                                    ([3, 3, 3, 3], 3),
                                    ([0, 1e30, 2, 1e30, 1e30, 2], 4)])
def test_topk_tie_break_lower_index(vals, k):
    x = np.asarray(vals, dtype=np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = topk_lower_index(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if vals == [1, 5, 5, 5, 2]:
        assert ti.tolist() == [1, 2]


@pytest.fixture(scope="module")
def chunked_case():
    """d > 2^22 and d > 4k, where the reference takes _heavymix_chunked, in
    the paper's regime W = k/2: the sketch noise makes far more than k
    coordinates heavy, so the ranking among heavy coordinates decides the
    selection. One sketch feeds both sides, so estimates are bit-equal."""
    d, rows, width, k = (1 << 22) + 5000, 5, 1024, 2048
    jc = jcs.SketchConfig(rows=rows, width=width, seed=9)
    tc = tcs.SketchConfig(rows=rows, width=width, seed=9)
    sk = _sketch(rows, width, 9, d, spikes=20)
    j_idx, j_est = (np.array(a) for a in
                    jhm.heavymix(jc, jnp.asarray(sk), k, d))
    est = tcs.decode(tc, torch.from_numpy(sk), d)
    n_heavy = int((est * est >= tcs.l2sq_estimate(torch.from_numpy(sk)) / k)
                  .sum())
    assert n_heavy > k  # the case the boosted scores would get wrong
    return tc, sk, k, d, j_idx, j_est


def test_heavymix_chunked_regime(chunked_case):
    """The port's plain HEAVYMIX and ops.heavymix_recover (the scores
    kernel's route) both return the reference's idx and est as returned:
    the k largest |est|, ties to the lower index."""
    tc, sk, k, d, j_idx, j_est = chunked_case
    r_idx, _ = tref.heavymix_recover(tc, torch.from_numpy(sk), k, d)
    np.testing.assert_array_equal(r_idx.numpy(), j_idx)
    o_idx, o_est = tops.heavymix_recover(tc, torch.from_numpy(sk), k, d)
    np.testing.assert_array_equal(o_idx.numpy(), j_idx)
    np.testing.assert_array_equal(o_est.numpy(), j_est)


def test_recover_chunked_regime_matches_reference(chunked_case):
    """GsSGD._recover, the train step's recovery, selects the reference's
    indices on every worker when the heavy set outnumbers k."""
    tc, sk, k, d, j_idx, _ = chunked_case
    comp = GsSGD(k=k, sketch=tc)
    u = torch.from_numpy(np.random.RandomState(3).randn(2, d)
                         .astype(np.float32))
    sk_sum = torch.from_numpy(sk).expand(2, *sk.shape)
    upd, idx = comp._recover(sk_sum, u, d)
    for p in range(2):
        np.testing.assert_array_equal(idx[p].numpy(), j_idx)
    np.testing.assert_array_equal(upd[0, j_idx].numpy(),
                                  u[:, j_idx].sum(0).numpy())
