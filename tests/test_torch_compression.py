"""Port parity: repro_torch.core.compression against repro.core.compression.

The reference step runs under ``jax.vmap(..., axis_name="data")``; the
port carries the worker axis first. The same per-worker (acc, g) go
through both. Selected indices and the new error feedback must be equal
(the residual zeroes the same coordinates of the same u); the update is
a psum of the same k values, held at rtol 1e-6 for the P=3 summation
order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import heavymix as jhm
from repro_torch.core import compression as tcomp
from repro_torch.kernels import ops as tops


def _inputs(p, d, seed):
    rs = np.random.RandomState(seed)
    acc = (0.05 * rs.randn(p, d)).astype(np.float32)
    g = (0.1 * rs.randn(p, d)).astype(np.float32)
    g[:, rs.choice(d, 10, replace=False)] += 3.0 * rs.randn(10).astype(
        np.float32)
    return acc, g


def _pair(mode, k=64, rows=5, width=512):
    j = jcomp.make("gs-sgd", k=k, rows=rows, width=width, seed=1,
                   allreduce_mode=mode)
    t = tcomp.make("gs-sgd", k=k, rows=rows, width=width, seed=1,
                   allreduce_mode=mode)
    return j, t


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("mode", ["psum", "tree"])
def test_gs_sgd_step_matches(p, mode):
    d = 4000
    jc, tc = _pair(mode)
    acc, g = _inputs(p, d, p)
    j_upd, j_ef, j_stats = jax.vmap(
        lambda a, b: jc.step(a, b, axis="data", nworkers=p),
        axis_name="data")(jnp.asarray(acc), jnp.asarray(g))
    t_upd, t_ef, t_stats = tc.step(torch.from_numpy(acc),
                                   torch.from_numpy(g), nworkers=p)
    np.testing.assert_allclose(t_upd.numpy(), np.asarray(j_upd), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(t_ef.numpy(), np.asarray(j_ef))
    assert (t_stats.bytes_out, t_stats.rounds) == (j_stats.bytes_out,
                                                   j_stats.rounds)
    # the selection itself, from each package's summed sketch
    j_sum = jax.vmap(lambda a, b: jc.stage_reduce(
        jc.stage_encode(a, b)[1], axis="data", nworkers=p)[0],
        axis_name="data")(jnp.asarray(acc), jnp.asarray(g))
    _, t_sk = tc.stage_encode(torch.from_numpy(acc), torch.from_numpy(g))
    t_sum, _ = tc.stage_reduce(t_sk, nworkers=p)
    np.testing.assert_allclose(t_sum.numpy(), np.asarray(j_sum), rtol=1e-5,
                               atol=1e-5)
    j_idx, _ = jhm.heavymix(jc.sketch, j_sum[0], jc.k, d)
    for w in range(p):
        t_idx, _ = tops.heavymix_recover(tc.sketch, t_sum[w], tc.k, d)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def test_gs_sgd_step_straggler_mask():
    p, d = 3, 3000
    jc, tc = _pair("psum")
    acc, g = _inputs(p, d, 11)
    inc = np.array([True, False, True])
    j_upd, j_ef, _ = jax.vmap(
        lambda a, b, i: jc.step(a, b, axis="data", nworkers=p, include=i),
        axis_name="data")(jnp.asarray(acc), jnp.asarray(g), jnp.asarray(inc))
    t_upd, t_ef, _ = tc.step(torch.from_numpy(acc), torch.from_numpy(g),
                             nworkers=p, include=torch.from_numpy(inc))
    np.testing.assert_allclose(t_upd.numpy(), np.asarray(j_upd), rtol=1e-6)
    np.testing.assert_array_equal(t_ef.numpy(), np.asarray(j_ef))


def test_dense_step_matches():
    p, d = 3, 500
    _, g = _inputs(p, d, 2)
    j_upd, _, _ = jax.vmap(
        lambda b: jcomp.DenseAllReduce().step((), b, axis="data",
                                              nworkers=p),
        axis_name="data")(jnp.asarray(g))
    t_upd, _, _ = tcomp.DenseAllReduce().step((), torch.from_numpy(g),
                                              nworkers=p)
    np.testing.assert_allclose(t_upd.numpy(), np.asarray(j_upd), rtol=1e-6)


@pytest.mark.parametrize("sizes", [(1000,), (700, 300), (53760, 37888),
                                   (388956160, 201864704), (5, 5, 90000)])
@pytest.mark.parametrize("k,width", [(1024, 16384), (2363283, 2097152)])
def test_bucketize_geometry_equal(sizes, k, width):
    jb = jcomp.bucketize(jcomp.make("gs-sgd", k=k, rows=5, width=width),
                         sizes)
    tb = tcomp.bucketize(tcomp.make("gs-sgd", k=k, rows=5, width=width),
                         sizes)
    assert tb.spec.sizes == jb.spec.sizes
    assert tb.spec.offsets == jb.spec.offsets
    for jp, tp in zip(jb.parts, tb.parts):
        assert tp.k == jp.k
        assert dataclasses.astuple(tp.sketch) == dataclasses.astuple(jp.sketch)
    cs_t = tb.comm_stats(sum(sizes), 4)
    cs_j = jb.comm_stats(sum(sizes), 4)
    assert (cs_t.bytes_out, cs_t.rounds) == (cs_j.bytes_out, cs_j.rounds)


def test_slice_geometry_at_full_width():
    """The chip cell: qwen3-4b cut to 2 layers, paper-regime sketch."""
    tb = tcomp.bucketize(tcomp.make("gs-sgd", k=2363283, rows=5,
                                    width=2097152), (388956160, 201864704))
    assert [(p.k, p.sketch.width) for p in tb.parts] == [
        (1555824, 1 << 20), (807459, 1 << 19)]


@pytest.mark.parametrize("d,n", [(10, 3), (1000, 7), (5, 9)])
def test_even_bucket_sizes_equal(d, n):
    assert tcomp.even_bucket_sizes(d, n) == jcomp.even_bucket_sizes(d, n)


def test_one_bucket_equals_monolithic():
    p, d = 2, 2500
    _, tc = _pair("psum")
    acc, g = _inputs(p, d, 5)
    mono = tc.step(torch.from_numpy(acc), torch.from_numpy(g), nworkers=p)
    bc = tcomp.bucketize(tc, (d,))
    assert bc.parts == (tc,)
    buck = bc.step((torch.from_numpy(acc),), torch.from_numpy(g),
                   nworkers=p)
    np.testing.assert_array_equal(buck[0].numpy(), mono[0].numpy())
    np.testing.assert_array_equal(buck[1][0].numpy(), mono[1].numpy())


def test_unported_compressor_raises():
    with pytest.raises(KeyError):
        tcomp.make("topk", k=5)
