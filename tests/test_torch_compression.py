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
    """Every reference compressor is ported; an unknown name raises."""
    assert sorted(tcomp.REGISTRY) == sorted(jcomp.REGISTRY)
    with pytest.raises(KeyError, match="unknown compressor"):
        tcomp.make("top-k", k=5)


# ---------------------------------------------------------------------------
# Baselines at P = 4: each step against the reference's under jax.vmap.
#
# Tolerances: indices are compared exactly (through the zero pattern of the
# new error feedback, or the support of the update); elementwise EF
# arithmetic is the same f32 op on the same inputs and is compared
# exactly; sums over the 4 workers are held at rtol 1e-6, values that come
# out of a sketch (f32 sums in another order) at rtol 1e-5, and PowerSGD's
# matrix products and QR at rtol 1e-4 with an atol of 1e-5 * max|x| (its
# elements near zero carry the products' absolute rounding).
# ---------------------------------------------------------------------------

P4 = 4


def _jstep(comp, state, g, steps=1):
    """The reference's step under jax.vmap(axis_name="data")."""
    fn = jax.vmap(lambda s, b: comp.step(s, b, axis="data", nworkers=P4)[:2],
                  axis_name="data")
    for _ in range(steps):
        upd, state = fn(state, jnp.asarray(g))
    return np.asarray(upd), jax.tree_util.tree_map(np.asarray, state)


def _tstep(comp, state, g, steps=1):
    for _ in range(steps):
        upd, state, _ = comp.step(state, torch.from_numpy(g), nworkers=P4)
    return upd.numpy(), jax.tree_util.tree_map(lambda t: t.numpy(), state)


@pytest.mark.parametrize("name", ["topk", "gtopk", "signsgd"])
def test_dense_ef_baselines_match(name):
    d, k = 3000, 50
    acc, g = _inputs(P4, d, 21)
    jc, tc = jcomp.make(name, k=k), tcomp.make(name, k=k)
    j_upd, j_acc = _jstep(jc, jnp.asarray(acc), g)
    t_upd, t_acc = _tstep(tc, torch.from_numpy(acc), g)
    np.testing.assert_array_equal(t_upd != 0, j_upd != 0)
    if name == "signsgd":
        # the mean |u| scale is a sum in another order (1 ulp), and the
        # four signed scales cancel in the update: atol of a few ulps
        np.testing.assert_allclose(t_upd, j_upd, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(t_acc, j_acc, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_allclose(t_upd, j_upd, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(t_acc, j_acc)
        assert int((t_acc == 0).sum()) >= k  # selections were made
    assert (tc.comm_stats(d, P4).bytes_out, tc.comm_stats(d, P4).rounds) == \
        (jc.comm_stats(d, P4).bytes_out, jc.comm_stats(d, P4).rounds)


@pytest.mark.parametrize("p", [3, 4])
def test_gtopk_tree_with_parking_matches(p):
    """A non-power-of-two P parks a worker in the tree (paper Fig. 1)."""
    d, k = 2000, 30
    acc, g = _inputs(p, d, 5 + p)
    jc, tc = jcomp.make("gtopk", k=k), tcomp.make("gtopk", k=k)
    j_upd, j_acc, _ = jax.vmap(
        lambda a, b: jc.step(a, b, axis="data", nworkers=p),
        axis_name="data")(jnp.asarray(acc), jnp.asarray(g))
    t_upd, t_acc, _ = tc.step(torch.from_numpy(acc), torch.from_numpy(g),
                              nworkers=p)
    np.testing.assert_array_equal(t_upd.numpy() != 0, np.asarray(j_upd) != 0)
    np.testing.assert_allclose(t_upd.numpy(), np.asarray(j_upd), rtol=1e-6)
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))


@pytest.mark.parametrize("encoder", ["exact", "ts"])
def test_sketched_sgd_matches(encoder):
    d, k = 5000, 64
    acc, g = _inputs(P4, d, 31)
    kw = dict(k=k, rows=5, width=512, seed=2, encoder=encoder)
    jc, tc = jcomp.make("sketched-sgd", **kw), tcomp.make("sketched-sgd", **kw)
    j_upd, j_acc = _jstep(jc, jnp.asarray(acc), g)
    t_upd, t_acc = _tstep(tc, torch.from_numpy(acc), g)
    np.testing.assert_array_equal(t_acc == 0, j_acc == 0)  # the selection
    np.testing.assert_array_equal(t_acc, j_acc)
    np.testing.assert_allclose(t_upd, j_upd, rtol=1e-6, atol=0)


def test_fetchsgd_matches_over_two_steps():
    d, k = 4000, 40
    _, g = _inputs(P4, d, 41)
    kw = dict(k=k, rows=5, width=512, seed=3)
    jc, tc = jcomp.make("fetchsgd", **kw), tcomp.make("fetchsgd", **kw)
    z = np.zeros((P4, 5, 512), np.float32)
    j_upd, (j_m, j_e) = _jstep(jc, (jnp.asarray(z), jnp.asarray(z)), g, 2)
    t_upd, (t_m, t_e) = _tstep(tc, tc.init(d, P4), g, 2)
    np.testing.assert_array_equal(t_upd != 0, j_upd != 0)  # the selection
    assert int((t_upd[0] != 0).sum()) == k
    np.testing.assert_allclose(t_upd, j_upd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_m, j_m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_e, j_e, rtol=1e-5, atol=1e-5)


def test_powersgd_matches_with_the_reference_q():
    d = 3000
    acc, g = _inputs(P4, d, 51)
    jc, tc = jcomp.make("powersgd", k=9, seed=4), tcomp.make("powersgd", k=9,
                                                            seed=4)
    j_acc0, j_q0 = jc.init(d)
    assert tuple(tc.init(d, P4)[1].shape) == (P4,) + tuple(j_q0.shape)
    q = np.broadcast_to(np.asarray(j_q0), (P4,) + j_q0.shape).copy()
    j_upd, (j_acc, j_q) = _jstep(jc, (jnp.asarray(acc), jnp.asarray(q)), g, 2)
    t_upd, (t_acc, t_q) = _tstep(tc, (torch.from_numpy(acc),
                                      torch.from_numpy(q)), g, 2)
    # q's columns are fixed up to sign by the QR convention; both packages
    # use LAPACK's Householder QR on the CPU, so the signs agree too
    for t, j in ((t_upd, j_upd), (t_acc, j_acc), (t_q, j_q)):
        np.testing.assert_allclose(t, j, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(j).max()))


def test_powersgd_init_draws_q_from_the_seed():
    a = tcomp.PowerSGD(seed=3).init(1000, 2)[1]
    assert torch.equal(a, tcomp.PowerSGD(seed=3).init(1000, 2)[1])
    assert not torch.equal(a, tcomp.PowerSGD(seed=4).init(1000, 2)[1])
    assert torch.equal(a[0], a[1])  # one q, replicated to every worker


@pytest.mark.parametrize("p", [2, 4])
def test_gs_sgd_ts_encoder_step_matches(p):
    """encoder='ts': the TS encode, the TS decode's estimates and the
    boosted-score HEAVYMIX, as the reference's _recover."""
    d = 6000
    jc = jcomp.make("gs-sgd", k=64, rows=5, width=512, seed=1, encoder="ts")
    tc = tcomp.make("gs-sgd", k=64, rows=5, width=512, seed=1, encoder="ts")
    acc, g = _inputs(p, d, 61 + p)
    j_upd, j_ef, _ = jax.vmap(
        lambda a, b: jc.step(a, b, axis="data", nworkers=p),
        axis_name="data")(jnp.asarray(acc), jnp.asarray(g))
    t_upd, t_ef, _ = tc.step(torch.from_numpy(acc), torch.from_numpy(g),
                             nworkers=p)
    np.testing.assert_array_equal(t_ef.numpy(), np.asarray(j_ef))
    np.testing.assert_allclose(t_upd.numpy(), np.asarray(j_upd), rtol=1e-6)


@pytest.mark.parametrize("name", ["topk", "gtopk", "sketched-sgd",
                                  "fetchsgd", "signsgd", "powersgd", "dense"])
def test_make_drops_kwargs_as_the_reference(name):
    kw = dict(k=100, rows=3, width=256, seed=5)
    t, j = tcomp.make(name, **kw), jcomp.make(name, **kw)
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    assert set(tf) <= set(jf)
    for key, v in tf.items():
        if key == "sketch":
            assert dataclasses.astuple(v) == dataclasses.astuple(jf[key])
        else:
            assert v == jf[key], key
    d = 91_648
    assert (t.comm_stats(d, 4).bytes_out, t.comm_stats(d, 4).rounds) == \
        (j.comm_stats(d, 4).bytes_out, j.comm_stats(d, 4).rounds)


@pytest.mark.parametrize("name", ["topk", "sketched-sgd", "fetchsgd",
                                  "powersgd"])
def test_bucketized_baselines_match(name):
    """Non-staged compressors run bucket by bucket through the bucketed
    step, with the bucket-scaled geometry, as the reference."""
    d, sizes = 4000, (2500, 1500)
    acc, g = _inputs(P4, d, 71)
    kw = dict(k=80, rows=3, width=512, seed=2)
    jb = jcomp.bucketize(jcomp.make(name, **kw), sizes)
    tb = tcomp.bucketize(tcomp.make(name, **kw), sizes)
    tstate = tb.init(d, P4)
    if name == "powersgd":   # the reference's q per bucket, fed to both
        inits = [c.init(s) for c, s in zip(jb.parts, sizes)]
        jstate = tuple((jnp.asarray(np.broadcast_to(a, (P4,) + a.shape)),
                        jnp.asarray(np.broadcast_to(q, (P4,) + q.shape)))
                       for a, q in inits)
        tstate = jax.tree_util.tree_map(
            lambda x: torch.from_numpy(np.array(x)), jstate)
    else:
        jstate = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x.numpy()), tstate)
        if name != "fetchsgd":
            jstate = tuple(jnp.asarray(acc[:, o:o + s]) for o, s in
                           zip(jb.spec.offsets, sizes))
            tstate = tuple(torch.from_numpy(acc[:, o:o + s].copy())
                           for o, s in zip(tb.spec.offsets, sizes))
    j_upd, j_state = _jstep(jb, jstate, g)
    t_upd, t_state = _tstep(tb, tstate, g)
    np.testing.assert_array_equal(t_upd != 0, j_upd != 0)
    np.testing.assert_allclose(t_upd, j_upd, rtol=1e-4, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(t_state),
                    jax.tree_util.tree_leaves(j_state)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
