"""Port parity: HEAVYMIX's faithful fill (paper Alg. 2's random fill).

The reference draws the non-heavy coordinates' priorities with
``jax.random.uniform(key, (d,))`` (key ``PRNGKey(0)`` when none is
given, as its train step does), which torch cannot reproduce; the tests
export that filler as numpy and hand it to the port (ROADMAP ground rule
"Parity"). With the same filler the port must select the reference's
indices, in order: the plain ``heavymix``, ``ops.heavymix_recover`` (the
scores kernel's path with the filler operand), the TS route, and two
gs-SGD smoke steps with ``faithful_heavymix=True`` (losses at rtol 1e-4,
selections equal, EF and params at rtol 1e-4 / atol 1e-6, as
tests/test_torch_gs_sgd.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JSpec
from repro.core import count_sketch as jcs
from repro.core import heavymix as jhm
from repro.core import ts_sketch as jts_
from repro.core.gs_sgd import make_train_step as j_make_train_step
from repro_torch.api import RunSpec as TSpec
from repro_torch.core import compression as tcomp
from repro_torch.core import count_sketch as tcs
from repro_torch.core import heavymix as thm
from repro_torch.core import ts_sketch as tts_
from repro_torch.core.gs_sgd import make_train_step as t_make_train_step
from repro_torch.kernels import heavymix_topk as hk
from repro_torch.kernels import ops
from tests.test_torch_gs_sgd import SPEC, _run


def ref_filler(d: int) -> np.ndarray:
    """The reference's faithful filler with no key: uniform(PRNGKey(0))."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (d,)))


def _sketch(rows, width, d, seed, spikes):
    rs = np.random.RandomState(seed)
    g = (0.1 * rs.randn(d)).astype(np.float32)
    g[rs.choice(d, spikes, replace=False)] = 10.0 * rs.randn(spikes)
    j = jcs.SketchConfig(rows=rows, width=width, seed=seed)
    t = tcs.SketchConfig(rows=rows, width=width, seed=seed)
    return j, t, np.array(jcs.encode(j, jnp.asarray(g))), g


@pytest.mark.parametrize("rows,width,d,k,spikes", [
    (5, 256, 5000, 200, 30), (3, 512, 20000, 1000, 400),
    (4, 1024, 9000, 64, 200),            # heavy set outnumbers k
    (3, 1024, (1 << 22) + 5000, 2048, 50)])  # past 2^22: no chunked route
def test_faithful_selects_the_reference_indices(rows, width, d, k, spikes):
    j, t, sk, _ = _sketch(rows, width, d, rows + d % 7, spikes)
    fill = ref_filler(d)
    want_i, want_e = jhm.heavymix(j, jnp.asarray(sk), k, d, faithful=True)
    f_t = torch.from_numpy(fill.copy())
    got_i, got_e = thm.heavymix(t, torch.from_numpy(sk), k, d,
                                faithful=True, filler=f_t)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    idx, est = ops.heavymix_recover(t, torch.from_numpy(sk), k, d,
                                    filler=f_t)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(est.numpy(), np.asarray(want_e))


def test_scores_plain_with_filler():
    """The scores kernel's plain version: heavy coordinates score
    |est| + 1e30, the others their filler value; the histogram counts
    those scores."""
    _, t, sk, _ = _sketch(3, 256, 3000, 1, 40)
    skt = torch.from_numpy(sk)
    thr = tcs.l2sq_estimate(skt) / 100
    fill = torch.from_numpy(ref_filler(3000).copy())
    s, e, h = hk.heavymix_scores_hist(t, skt, thr, 3000, fill)
    s0, e0 = hk.heavymix_scores_plain(t, skt, thr, 3000)
    heavy = e0 * e0 >= thr
    assert torch.equal(e, e0)
    assert torch.equal(s, torch.where(heavy, s0, fill))
    assert 0 < int(heavy.sum()) < 3000
    from repro_torch.kernels.topk_select import radix_hist_plain
    assert torch.equal(h, radix_hist_plain(s))


def test_ts_route_faithful_matches_reference():
    d, k = 6000, 300
    rs = np.random.RandomState(2)
    g = (0.1 * rs.randn(d)).astype(np.float32)
    g[rs.choice(d, 50, replace=False)] = 5.0
    jc = jts_.TSketchConfig(d=d, rows=4, width=512, seed=2)
    tc = tts_.TSketchConfig(d=d, rows=4, width=512, seed=2)
    sk = np.array(jts_.encode(jc, jnp.asarray(g)))
    est = jts_.decode(jc, jnp.asarray(sk), d)
    want, _ = jhm.heavymix(jcs.SketchConfig(rows=4, width=512, seed=2),
                           jnp.asarray(sk), k, d, faithful=True,
                           estimates=est)
    got, _ = ops.ts_heavymix_recover(
        tc, torch.from_numpy(sk), k, d,
        filler=torch.from_numpy(ref_filler(d).copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_default_filler_is_seeded():
    """``faithful_heavymix=True`` draws from a generator seeded 0: the same
    priorities every call."""
    a = thm.draw_filler(1000, "cpu")
    assert torch.equal(a, thm.draw_filler(1000, "cpu"))
    assert a.dtype == torch.float32 and 0 <= float(a.min()) and float(
        a.max()) < 1
    assert torch.equal(a, torch.rand(
        (1000,), generator=torch.Generator().manual_seed(0)))


def test_faithful_gs_sgd_steps_match_reference(monkeypatch):
    """The port's recoveries draw the reference's filler in place of the
    seeded one (``compression.draw_filler`` patched)."""
    monkeypatch.setattr(tcomp, "draw_filler",
                        lambda n, dev: torch.from_numpy(
                            ref_filler(n).copy()).to(dev))
    jspec, tspec = JSpec.load(SPEC), TSpec.load(SPEC)
    jopt, topt = jspec.make_optimizer(), tspec.make_optimizer()
    d = 91_648
    kw = dict(jspec.exchange.compressor_kw(d), faithful_heavymix=True)
    jts = j_make_train_step(jspec.arch_config(), jspec.mesh_axes(), jopt,
                            compressor_name="gs-sgd", compressor_kw=kw,
                            buckets=jspec.exchange.buckets,
                            remat=jspec.remat, dtype=jnp.float32)
    assert jts.d_local == d
    tkw = dict(tspec.exchange.compressor_kw(d), faithful_heavymix=True)
    tts = t_make_train_step(tspec.arch_config(), tspec.mesh_axes(), topt,
                            compressor_name="gs-sgd", compressor_kw=tkw,
                            buckets=tspec.exchange.buckets,
                            remat=tspec.remat, dtype=torch.float32,
                            device="cpu")
    assert all(c.faithful_heavymix for c in tts.compressor.parts)
    out = _run(jspec, jts, jopt, tts, topt)
    np.testing.assert_allclose(out["t_loss"], out["j_loss"], rtol=1e-4)
    for step, (jefs, tefs) in enumerate(zip(out["j_ef"], out["t_ef"])):
        for b, (je, te) in enumerate(zip(jefs, tefs)):
            np.testing.assert_array_equal(te == 0, je == 0,
                                          err_msg=f"step {step} bucket {b}")
            np.testing.assert_allclose(te, je, rtol=1e-4, atol=1e-6)
    for k, v in out["t_params"].items():
        np.testing.assert_allclose(v, out["j_params"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
