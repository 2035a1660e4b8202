"""Port parity: microbatch accumulation and the global-norm clip of
``make_train_step`` against the JAX package's.

Two gs-SGD steps of examples/specs/qwen3_smoke.json at batch 8 (P = 2, so
4 rows a worker) in both packages, from the reference's params and
batches (``tests/test_torch_gs_sgd.py``'s ``_run``). Tolerances as that
file's: losses at rtol 1e-4, the selected coordinates (EF zero pattern)
equal every step, EF and final params at rtol 1e-4 / atol 1e-6 (f32 model
math in another order; the clip's norm is a sum in another order too).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JSpec
from repro.core.gs_sgd import make_train_step as j_make_train_step
from repro_torch.api import RunSpec as TSpec
from repro_torch.core.gs_sgd import make_train_step as t_make_train_step
from tests.test_torch_gs_sgd import SPEC, _run


def _pair(microbatch, clip_norm, batch=8):
    jspec, tspec = JSpec.load(SPEC), TSpec.load(SPEC)
    jspec = dataclasses.replace(jspec, batch=batch, exchange=(
        dataclasses.replace(jspec.exchange, microbatch=microbatch)))
    tspec = dataclasses.replace(tspec, batch=batch, exchange=(
        dataclasses.replace(tspec.exchange, microbatch=microbatch)))
    opt, topt = jspec.make_optimizer(), tspec.make_optimizer()
    jts = j_make_train_step(jspec.arch_config(), jspec.mesh_axes(), opt,
                            spec=jspec.exchange, remat=jspec.remat,
                            dtype=jnp.float32, clip_norm=clip_norm)
    tts = t_make_train_step(tspec.arch_config(), tspec.mesh_axes(), topt,
                            spec=tspec.exchange, remat=tspec.remat,
                            dtype=torch.float32, clip_norm=clip_norm,
                            device="cpu")
    return jspec, jts, opt, tts, topt


@pytest.mark.parametrize("microbatch,clip_norm", [
    (2, None), (1, None), (None, 0.05), (2, 0.05), (2, 1e6)])
def test_microbatch_and_clip_match_reference(microbatch, clip_norm):
    out = _run(*_pair(microbatch, clip_norm))
    np.testing.assert_allclose(out["t_loss"], out["j_loss"], rtol=1e-4)
    for step, (jefs, tefs) in enumerate(zip(out["j_ef"], out["t_ef"])):
        for b, (je, te) in enumerate(zip(jefs, tefs)):
            np.testing.assert_array_equal(te == 0, je == 0,
                                          err_msg=f"step {step} bucket {b}")
            np.testing.assert_allclose(te, je, rtol=1e-4, atol=1e-6)
    for k, v in out["t_params"].items():
        np.testing.assert_allclose(v, out["j_params"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _step_once(microbatch, clip_norm):
    """One port step from fixed params and batch: (state, metrics)."""
    _, _, _, tts, topt = _pair(microbatch, clip_norm)
    st = tts.init_state(topt, torch.Generator().manual_seed(0))
    t = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 4, 16)))
    return tts.fn(st, {"tokens": t, "labels": t.roll(-1, -1)})


def test_microbatch_is_the_mean_of_the_slices():
    """microbatch 4 (one slice) is the monolithic step bit for bit;
    microbatch 2 gives the same loss up to f32 rounding of the mean."""
    s_full, m_full = _step_once(None, None)
    s_one, m_one = _step_once(4, None)
    assert torch.equal(m_full["worker_loss"], m_one["worker_loss"])
    for k in s_full["params"]:
        assert torch.equal(s_full["params"][k], s_one["params"][k])
    _, m_two = _step_once(2, None)
    np.testing.assert_allclose(m_two["worker_loss"].numpy(),
                               m_full["worker_loss"].numpy(), rtol=1e-5)


def test_clip_bounds_the_applied_gradient():
    """With clip 1e-3 the applied mean gradient's norm is at most 1e-3
    (it was larger): the first AdamW step is scale-free, so compare SGD."""
    spec = TSpec.load(SPEC)
    from repro_torch.optim import make
    for clip in (None, 1e-3):
        opt = make("sgdm", lr=1.0, momentum=0.0)
        ts = t_make_train_step(spec.arch_config(), spec.mesh_axes(), opt,
                               spec=spec.exchange, clip_norm=clip,
                               device="cpu")
        st = ts.init_state(opt, torch.Generator().manual_seed(0))
        t = torch.from_numpy(np.random.default_rng(3).integers(
            0, 256, (2, 2, 16)))
        new, m = ts.fn(st, {"tokens": t, "labels": t})
        moved = torch.cat([(st["params"][k] - new["params"][k])[0].reshape(-1)
                           for k in st["params"]])
        norm = float(torch.linalg.vector_norm(moved))
        if clip is None:
            assert norm > 1e-3
            np.testing.assert_allclose(norm, float(m["grad_norm"][0]),
                                       rtol=1e-4)
        else:
            np.testing.assert_allclose(norm, clip, rtol=1e-4)


def test_indivisible_microbatch_raises_like_reference():
    msgs = []
    jspec, jts, _, tts, topt = _pair(3, None)
    st = tts.init_state(topt, torch.Generator().manual_seed(0))
    t = torch.zeros((2, 4, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="not divisible") as e:
        tts.fn(st, {"tokens": t, "labels": t})
    msgs.append(str(e.value))
    import jax
    from repro.core.gs_sgd import make_state
    from repro.models.flatten import init_flat_params
    params = init_flat_params(jspec.arch_config(), jax.random.PRNGKey(0), 1,
                              jts.fs)
    jst = make_state(params, jspec.make_optimizer(), jts.compressor,
                     jts.d_local)
    jt = jnp.zeros((4, 16), dtype=jnp.int32)
    with pytest.raises(ValueError, match="not divisible") as e:
        jts.fn(jst, {"tokens": jt, "labels": jt})
    msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
