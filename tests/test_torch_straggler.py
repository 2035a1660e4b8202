"""Port parity: the straggler policy (``runtime/straggler.py``) and the
``include`` mask through the exchange, against the JAX package.

* ``DeadlinePolicy`` on the reference's cases (an outlier, the drop cap
  keeping the fastest, a zero drop fraction, all-equal durations, the
  window's eviction): the same masks, and the same ``straggler.drop``
  instant through each package's tracer.
* tests/test_runtime.py's bucketed straggler drop (P = 4, d = 8,192, four
  buckets, k 512, R 5, W 2,048; worker 3 dropped by the policy) through
  the port's ``exchange_bucketed``, skewed and not, psum and tree: the
  update and every bucket's EF equal to the reference's (rtol 1e-6, the
  sketch sums in another order), the update on the selected coordinates
  the live workers' sum x P/live (1e-4 relative), and the dropped
  worker's EF its whole error-corrected gradient, bit for bit.
* The interleave under a mask, with and without the fused encode: the
  port's interleaved step bit-equal to its bucketed(4) step on the same
  mask (the interleave runs the same ops, bucket by bucket).

The whole masked step against the reference, for every exchange path, is
in tests/test_torch_straggler_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core.gs_sgd import exchange_bucketed as j_exchange_bucketed
from repro.obs import trace as jtrace
from repro.runtime import DeadlinePolicy as JPolicy
from repro_torch.core import compression as tcomp
from repro_torch.core.gs_sgd import exchange_bucketed as t_exchange_bucketed
from repro_torch.launch.train import shard_batch
from repro_torch.obs import trace as ttrace
from repro_torch.runtime import DeadlinePolicy
from tests.test_torch_elastic import batches, t_step

torch.set_num_threads(2)

# (policy kwargs, observed history, durations to mask)
POLICY_CASES = {
    "outlier": (dict(factor=3.0), [[1.0, 1.1, 0.9, 1.0]] * 4,
                [1.0, 1.05, 0.95, 30.0]),
    "no_history": (dict(factor=3.0), [], [1.0, 1.0, 1.0, 9.0]),
    "cap_keeps_fastest": (dict(factor=1.5, max_drop_frac=0.25),
                          [[1.0] * 8], [9.0] * 6 + [1.0, 1.0]),
    "cap_ties": (dict(factor=1.5, max_drop_frac=0.25), [[1.0] * 8],
                 [5.0, 9.0, 7.0, 9.0, 1.0, 6.0, 1.0, 8.0]),
    "zero_drop_frac": (dict(factor=1.5, max_drop_frac=0.0),
                       [[1.0] * 4] * 4, [1.0, 1.0, 1.0, 500.0]),
    "all_equal": (dict(factor=3.0, max_drop_frac=0.5), [[2.0] * 6],
                  [2.0] * 6),
    "window_evicts": (dict(factor=1.5, max_drop_frac=0.5, window=4),
                      [[1.0] * 4] + [[10.0] * 4] * 4, [10.0] * 4),
    "window_holds": (dict(factor=1.5, max_drop_frac=0.5, window=4),
                     [[1.0] * 4] + [[10.0] * 4] * 2, [10.0] * 4),
}


def _policy_run(cls, trace_mod, kw, hist, durs):
    tr = trace_mod.Tracer(clock=lambda: 0.0, epoch=0.0)
    pol = cls(**kw)
    with tr.activate():
        for h in hist:
            pol.observe(h)
        mask = pol.mask(durs)
    return mask, [(e["name"], e["cat"], e["args"]) for e in tr.events], \
        [h.tolist() for h in pol._hist]


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_deadline_policy_equals_the_reference(case):
    kw, hist, durs = POLICY_CASES[case]
    t_mask, t_ev, t_hist = _policy_run(DeadlinePolicy, ttrace, kw, hist, durs)
    j_mask, j_ev, j_hist = _policy_run(JPolicy, jtrace, kw, hist, durs)
    assert t_mask.dtype == np.bool_
    assert t_mask.tolist() == j_mask.tolist()
    assert t_ev == j_ev and t_hist == j_hist
    assert len(t_hist) <= kw.get("window", 32)
    n_drop = int((~t_mask).sum())
    assert n_drop <= int(len(durs) * kw.get("max_drop_frac", 0.25))
    assert bool(t_ev) == bool(n_drop)
    if case == "cap_keeps_fastest":  # 6 outliers, the cap drops 2
        assert n_drop == 2 and t_mask[6:].all()
    if case in ("zero_drop_frac", "all_equal", "window_evicts"):
        assert t_mask.all()


P_, D, N_BUCKETS = 4, 8192, 4


def _exchange_inputs():
    pol = DeadlinePolicy(factor=3.0, max_drop_frac=0.25)
    for _ in range(4):
        pol.observe([1.0, 1.0, 1.1, 0.9])
    include = pol.mask([1.0, 1.05, 0.95, 30.0])  # worker 3 blows it
    assert include.tolist() == [True, True, True, False]
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (P_, D)))
    return include.astype(np.float32), g


@pytest.mark.parametrize("mode", ["psum", "tree"])
@pytest.mark.parametrize("overlap", [True, False])
def test_bucketed_straggler_drop_equals_the_reference(mode, overlap):
    include, g = _exchange_inputs()
    kw = dict(k=512, rows=5, width=2048, allreduce_mode=mode)
    sizes = jcomp.even_bucket_sizes(D, N_BUCKETS)
    jbc = jcomp.bucketize(jcomp.make("gs-sgd", **kw), sizes)
    tbc = tcomp.bucketize(tcomp.make("gs-sgd", **kw), sizes)
    jstate = jax.vmap(lambda _: jbc.init(D))(jnp.arange(P_))

    def step(s, gg, inc):
        return j_exchange_bucketed(jbc, s, gg, axis="data", nworkers=P_,
                                   overlap=overlap, include=inc)

    j_upd, j_ef, _ = jax.vmap(step, axis_name="data")(
        jstate, jnp.asarray(g), jnp.asarray(include))
    t_upd, t_ef, _ = t_exchange_bucketed(
        tbc, tbc.init(D, P_, "cpu"), torch.from_numpy(g.copy()),
        nworkers=P_, overlap=overlap, include=torch.from_numpy(include))
    np.testing.assert_allclose(t_upd.numpy(), np.asarray(j_upd), rtol=1e-6,
                               atol=1e-6)
    for b, (te, je) in enumerate(zip(t_ef, j_ef)):
        np.testing.assert_array_equal(te.numpy() == 0, np.asarray(je) == 0,
                                      err_msg=f"bucket {b}")
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                                   atol=1e-6, err_msg=f"bucket {b}")
    # every replica applies the same update: the merged sketch of the
    # live workers, rescaled by P/live on the selected coordinates
    upd = t_upd.numpy()
    assert (upd == upd[0:1]).all()
    sel = np.nonzero(upd[0])[0]
    assert 0 < sel.size <= 512
    live_sum = g[:3].sum(0)
    np.testing.assert_allclose(upd[0][sel], live_sum[sel] * (4 / 3),
                               rtol=1e-4, atol=1e-4)
    # the dropped worker keeps its entire update, bucket by bucket
    dropped = np.concatenate([e[3].numpy() for e in t_ef])
    np.testing.assert_array_equal(dropped, g[3])
    # the live workers' residual is zero exactly on the selection
    for w in range(3):
        live = np.concatenate([e[w].numpy() for e in t_ef])
        np.testing.assert_array_equal(live[sel], 0.0)


@pytest.mark.parametrize("fuse", [False, True])
def test_interleave_under_a_mask_equals_bucketed(fuse):
    """Two steps (worker 2 dropped in the first) of the interleaved step
    (buckets 4, bwd_chunks 2) against the bucketed(4) step from the same
    state and batches: losses, every bucket's EF and the params
    bit-equal."""
    kw = dict(buckets=4, bwd_chunks=2, fuse_encode=fuse)
    tts_i, topt = t_step(4, **kw)
    tts_b, _ = t_step(4, buckets=4)
    assert tts_i.bwd_chunks == 2 and tts_i.plan is not None
    s_i = tts_i.init_state(topt, torch.Generator().manual_seed(0))
    s_b = tts_b.init_state(topt, torch.Generator().manual_seed(0))
    masks = [torch.tensor([1.0, 1.0, 0.0, 1.0]), torch.ones(4)]
    for gb, inc in zip(batches(2, global_batch=8, seq=16), masks):
        tb = shard_batch({k: torch.from_numpy(v.copy())
                          for k, v in gb.items()}, 4)
        s_i, m_i = tts_i.fn(s_i, tb, inc)
        s_b, m_b = tts_b.fn(s_b, tb, inc)
        assert torch.equal(m_i["worker_loss"], m_b["worker_loss"])
        for e_i, e_b in zip(s_i["ef"], s_b["ef"]):
            assert torch.equal(e_i, e_b)
    for k in s_i["params"]:
        assert torch.equal(s_i["params"][k], s_b["params"][k]), k
        assert (s_i["params"][k] == s_i["params"][k][0:1]).all(), k
