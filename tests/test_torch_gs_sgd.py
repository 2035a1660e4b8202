"""The slices as a whole: two gs-SGD steps of examples/specs/qwen3_smoke.json
(qwen3-4b smoke config, P=2, buckets=2, psum, AdamW) in both packages,
and two steps of the same spec with the Sketched-SGD baseline and with
gs-SGD's TS-sketch encoder (``compressor_kw`` ``encoder="ts"``).

Params come from the JAX package's ``init_flat_params`` (through
``params_from_numpy``) and batches from its ``LMStream``, passed as numpy.
The reference runs ``jax.vmap(ts.fn, axis_name="data")``; the port runs
its own step over a leading worker axis.

Tolerances: per-step loss at rtol 1e-4; final params at rtol 1e-4, atol
1e-6 (f32 model math in another order, then AdamW). The selected
coordinates must be equal every step: they are exactly the zeros the
error-feedback residual writes, so the EF zero patterns are compared.
With seed 0 every bucket has more heavy coordinates than k, so the k
lowest-index heavy ones are selected (jax.lax.top_k's tie order); no
coordinate up to the last winner sits within 1e-4 (relative) of the heavy
threshold (asserted below), so the selection is not decided by rounding.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import RunSpec as JSpec
from repro.core.gs_sgd import make_state as j_make_state
from repro.core.gs_sgd import make_train_step as j_make_train_step
from repro.data import LMStream as JStream
from repro.launch.train import build as j_build
from repro.models.flatten import init_flat_params as j_init
from repro_torch.api import RunSpec as TSpec
from repro_torch.core.gs_sgd import make_state as t_make_state
from repro_torch.core.gs_sgd import make_train_step as t_make_train_step
from repro_torch.launch import train as ttrain
from repro_torch.models.flatten import params_from_numpy

SPEC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "specs", "qwen3_smoke.json")


def _batches(spec, steps):
    cfg = spec.arch_config()
    stream = JStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                     global_batch=spec.batch, seed=spec.seed)
    return [{k: np.asarray(v) for k, v in stream.global_batch_at(s).items()}
            for s in range(steps)]


def _run(jspec, jts, opt, tts, topt, steps=2):
    """Both packages' steps from the reference's initial params, on the
    reference's batches."""
    P = jspec.cluster.p
    batches = _batches(jspec, steps)
    params = j_init(jspec.arch_config(), jax.random.PRNGKey(jspec.seed), 1,
                    jts.fs)
    seg_np = {k: np.asarray(v) for k, v in params.items()}
    jstate = j_make_state(params, opt, jts.compressor, jts.d_local)
    jstate = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (P,) + a.shape), jstate)
    jstep = jax.jit(jax.vmap(jts.fn, axis_name="data"))
    tstate = t_make_state(params_from_numpy(seg_np, tts.fs, "cpu"), topt,
                          tts.compressor, tts.d_local, P)
    out = {"j_loss": [], "t_loss": [], "j_ef": [], "t_ef": [], "t_u": []}
    for gb in batches:
        jb = {k: jnp.asarray(v.reshape((P, -1) + v.shape[1:]))
              for k, v in gb.items()}
        jstate, jm = jstep(jstate, jb)
        out["j_loss"].append(float(jm["loss"][0]))
        out["j_ef"].append([np.asarray(e) for e in jstate["ef"]])
        tb = ttrain.shard_batch({k: torch.from_numpy(v.copy())
                                 for k, v in gb.items()}, P)
        tstate, tm = tts.fn(tstate, tb)
        out["t_loss"].append(float(tm["loss"]))
        out["t_ef"].append([e.numpy().copy() for e in tstate["ef"]])
    out["j_params"] = {k: np.asarray(v) for k, v in jstate["params"].items()}
    out["t_params"] = {k: v.numpy() for k, v in tstate["params"].items()}
    out["tts"] = tts
    return out


@pytest.fixture(scope="module")
def runs():
    jspec = JSpec.load(SPEC)
    tspec = TSpec.load(SPEC)
    assert jspec.cluster.p == 2 and tspec.cluster.p == 2
    _, opt, _, jts = j_build(jspec)
    _, topt, _, tts = ttrain.build(tspec, "cpu")
    return _run(jspec, jts, opt, tts, topt)


def _variant(name):
    """(jspec, reference step, optimizer, port step, optimizer) of the smoke
    spec with another compressor, or with gs-SGD's TS-sketch encoder."""
    jspec, tspec = JSpec.load(SPEC), TSpec.load(SPEC)
    if name == "ts":
        _, opt, ma, jts0 = j_build(jspec)
        kw = dict(jspec.exchange.compressor_kw(jts0.d_local), encoder="ts")
        jts = j_make_train_step(
            jspec.arch_config(), ma, opt, compressor_name="gs-sgd",
            compressor_kw=kw, buckets=jspec.exchange.buckets, overlap=True,
            remat=jspec.remat, dtype=jnp.float32)
        topt = tspec.make_optimizer()
        tkw = dict(tspec.exchange.compressor_kw(jts0.d_local), encoder="ts")
        tts = t_make_train_step(
            tspec.arch_config(), tspec.mesh_axes(), topt,
            compressor_name="gs-sgd", compressor_kw=tkw,
            buckets=tspec.exchange.buckets, overlap=True, remat=tspec.remat,
            dtype=torch.float32, device="cpu")
        assert all(c.encoder == "ts" for c in tts.compressor.parts)
        return jspec, jts, opt, tts, topt
    jspec = dataclasses.replace(jspec, exchange=dataclasses.replace(
        jspec.exchange, compressor=name))
    tspec = dataclasses.replace(tspec, exchange=dataclasses.replace(
        tspec.exchange, compressor=name))
    _, opt, _, jts = j_build(jspec)
    _, topt, _, tts = ttrain.build(tspec, "cpu")
    assert tts.compressor.parts[0].name == name
    return jspec, jts, opt, tts, topt


@pytest.mark.parametrize("name", ["sketched-sgd", "ts"])
def test_smoke_train_variant_matches(name):
    """Two steps: losses at rtol 1e-4, the selected coordinates (the EF
    zero pattern) equal every step, final params at rtol 1e-4 / atol 1e-6.
    On the TS route every bucket's heavy set outnumbers k, so the
    lowest-index heavy coordinates win; the nearest estimate up to the
    last winner sits 1.9e-3 (relative) from the heavy threshold, so the
    selection is not decided by rounding."""
    out = _run(*_variant(name))
    np.testing.assert_allclose(out["t_loss"], out["j_loss"], rtol=1e-4)
    for step, (jefs, tefs) in enumerate(zip(out["j_ef"], out["t_ef"])):
        for b, (je, te) in enumerate(zip(jefs, tefs)):
            np.testing.assert_array_equal(te == 0, je == 0,
                                          err_msg=f"step {step} bucket {b}")
            np.testing.assert_allclose(te, je, rtol=1e-4, atol=1e-6)
    for k, v in out["t_params"].items():
        np.testing.assert_allclose(v, out["j_params"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_losses_match(runs):
    np.testing.assert_allclose(runs["t_loss"], runs["j_loss"], rtol=1e-4)


def test_selection_and_error_feedback_match(runs):
    for step, (jefs, tefs) in enumerate(zip(runs["j_ef"], runs["t_ef"])):
        for b, (je, te) in enumerate(zip(jefs, tefs)):
            np.testing.assert_array_equal(te == 0, je == 0,
                                          err_msg=f"step {step} bucket {b}")
            np.testing.assert_allclose(te, je, rtol=1e-4, atol=1e-6)


def test_final_params_match(runs):
    for k, v in runs["t_params"].items():
        np.testing.assert_allclose(v, runs["j_params"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_selection_gap_is_wide():
    """The k-th score sits clearly above the (k+1)-th in every bucket of
    the first step, so equal selections are not luck of the rounding."""
    from repro_torch.core import count_sketch as tcs
    from repro_torch.kernels.heavymix_topk import heavymix_scores
    from repro_torch.models import model as tmdl
    from repro_torch.models.flatten import SEG_NAMES, pack_segs
    jspec, tspec = JSpec.load(SPEC), TSpec.load(SPEC)
    jcfg, _, _, jts = j_build(jspec)
    _, _, _, tts = ttrain.build(tspec, "cpu")
    seg_np = {k: np.asarray(v) for k, v in
              j_init(jcfg, jax.random.PRNGKey(jspec.seed), 1, jts.fs).items()}
    params = params_from_numpy(seg_np, tts.fs, "cpu")
    gb = _batches(jspec, 1)[0]
    g = []
    for p in range(2):
        segs = {k: params[k].clone().requires_grad_() for k in SEG_NAMES}
        wb = {k: torch.from_numpy(v.reshape((2, -1) + v.shape[1:])[p].copy())
              for k, v in gb.items()}
        tmdl.loss_fn(tspec.arch_config(), tts.fs, segs, wb).backward()
        g.append(pack_segs({k: segs[k].grad for k in SEG_NAMES}))
    bc = tts.compressor
    for part, g_b in zip(bc.parts, bc.spec.split(torch.stack(g))):
        s = sum(tcs.encode(part.sketch, g_b[p]) for p in range(2))
        thr = tcs.l2sq_estimate(s) / part.k
        scores, est = heavymix_scores(part.sketch, s, thr, g_b.shape[-1])
        heavy = scores >= 1e30
        if int(heavy.sum()) >= part.k:
            # more heavy coordinates than k: the k lowest-index heavy ones
            # win, so what decides is heaviness up to the last winner
            last = int(torch.nonzero(heavy).reshape(-1)[part.k - 1])
            margin = torch.abs(est[:last + 1] ** 2 - thr) / thr
            assert float(margin.min()) > 1e-4, float(margin.min())
        else:
            top = torch.sort(scores, descending=True).values
            kth, nxt = float(top[part.k - 1]), float(top[part.k])
            assert kth - nxt > 1e-4 * abs(kth), (kth, nxt)


def test_cli_runs_on_cpu(capsys):
    out = ttrain.main(["--spec", SPEC, "--device", "cpu", "--steps", "2"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1].startswith('{"final_loss": ')
    assert len(out["history"]) == 2 and np.isfinite(out["final_loss"])
