"""Port parity: the MoE block (``models/moe.py``) and the MoE archs
(granite-moe-3b-a800m, qwen3-moe-235b-a22b) through ``loss_fn``, the
chunked backward and two gs-SGD steps.

Tolerances as tests/test_torch_families.py states them. The routing's
tie order and the capacity dispatch's drop set are held equal outright.
qwen3-moe's override row (``configs.TRAIN_OVERRIDES``: SGD with momentum
and a bf16 error feedback) is keyed by the full config's name, so its
smoke run gets it only when the test passes it in, as here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconf
from repro.models import moe as jmoe
from repro_torch import configs as tconf
from repro_torch.core.gs_sgd import make_state
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import rmsnorm
from repro_torch.models.flatten import init_flat_params
from tests.test_torch_families import (CTX, assert_steps_match,
                                       block_parity, chunked_matches_loss_fn,
                                       loss_parity, one_thread, params_np,
                                       smoke_batch, specs_for)

_ = one_thread   # the module-wide single-thread fixture


@pytest.mark.parametrize("arch,B,S", [
    ("granite-moe-3b-a800m", 2, 16),    # C = 16 against a mean load of 12.8
    ("granite-moe-3b-a800m", 3, 40),    # more tokens, more overflow
    ("qwen3-moe-235b-a22b", 2, 13),     # padded-free, qk_norm arch
])
def test_moe_block_matches(arch, B, S):
    cfg, tcfg = jconf.SMOKES[arch], tconf.SMOKES[arch]
    rs = np.random.RandomState(21)
    p = params_np(cfg, "moe", 21)["moe"]
    # a sharper router and a component common to every token, so that
    # the tokens crowd the same experts and overflow their capacity
    p["router"] = (4.0 * p["router"] / np.abs(p["router"]).max()).astype(
        np.float32)
    x = (rs.randn(B, S, cfg.d_model)
         + 1.5 * rs.randn(cfg.d_model)).astype(np.float32)
    T = B * S
    C = tmoe.expert_capacity(tcfg, T)
    assert C == jmoe.expert_capacity(cfg, T, 1)
    block_parity(lambda p, x: jmoe.moe_block(p, cfg, CTX, x),
                 lambda p, x: tmoe.moe_block(p, tcfg, x), {"p": p, "x": x})
    # the block's routing, re-derived: the case must overflow a capacity
    h = rmsnorm(torch.from_numpy(x), torch.from_numpy(p["norm"]),
                cfg.norm_eps).reshape(T, -1)
    logits = h @ torch.from_numpy(p["router"])
    ne = logits.shape[1]
    logits = torch.where(torch.arange(ne) < cfg.n_experts, logits, -1e30)
    _, eidx = tmoe.route(tcfg, torch.softmax(logits, -1))
    _, keeps = tmoe.dispatch(eidx, ne, C)
    kept = sum(int(k.sum()) for k in keeps)
    assert kept < T * cfg.experts_per_tok


def test_dispatch_drop_set_matches_reference():
    """The kept (token, choice) pairs and their slots equal the
    reference's: choice-major, a running per-expert counter."""
    cfg, tcfg = jconf.SMOKES["granite-moe-3b-a800m"], \
        tconf.SMOKES["granite-moe-3b-a800m"]
    rs = np.random.RandomState(3)
    T, ne, C = 48, 5, 16
    probs = rs.dirichlet(np.full(ne, 0.3), size=T).astype(np.float32)
    _, j_idx = jax.lax.top_k(jnp.asarray(probs), cfg.experts_per_tok)
    _, t_idx = tmoe.route(tcfg, torch.from_numpy(probs))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    dests, keeps = tmoe.dispatch(t_idx, ne, C)
    # the reference's dispatch, written out in numpy
    counts = np.zeros(ne, np.int64)
    for j in range(cfg.experts_per_tok):
        e = np.asarray(j_idx)[:, j]
        for t in range(T):
            pos = counts[e[t]]
            counts[e[t]] += 1
            keep = pos < C
            assert bool(keeps[j][t]) == keep
            assert int(dests[j][t]) == (e[t] * C + pos if keep else ne * C)
    assert sum(int(k.sum()) for k in keeps) < T * cfg.experts_per_tok


def test_routing_ties_go_to_the_lower_expert():
    """Exactly tied probabilities: jax.lax.top_k's order (lower index
    first), which the stable descending sort reproduces."""
    tcfg = tconf.SMOKES["qwen3-moe-235b-a22b"]        # top-2 of 8
    probs = np.array([[0.1, 0.3, 0.1, 0.3, 0.05, 0.05, 0.05, 0.05],
                      [0.125] * 8,
                      [0.0, 0.2, 0.2, 0.2, 0.2, 0.2, 0.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), tcfg.experts_per_tok)
    tv, ti = tmoe.route(tcfg, torch.from_numpy(probs))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 3], [0, 1], [1, 2]]


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_moe_loss_and_grad_match(arch):
    loss_parity(arch, smoke_batch(tconf.SMOKES[arch], 2, 16, 9))


@pytest.mark.parametrize("chunks", [1, 2])
def test_moe_chunked_backward_equals_loss_fn(chunks):
    """granite's aux loss runs on across the chunk boundaries: the chunked
    loss and gradients equal the monolithic ones bit for bit."""
    fs, _ = chunked_matches_loss_fn("granite-moe-3b-a800m", chunks)
    assert fs.n_cycles == 2


def test_granite_two_steps_match_reference():
    assert_steps_match("granite-moe-3b-a800m")


def test_qwen3_moe_two_steps_match_reference():
    assert_steps_match("qwen3-moe-235b-a22b")


def test_qwen3_moe_override_row_two_steps_match_reference():
    """The override row's optimizer and EF dtype, passed in: SGD with
    momentum, the EF stored as bf16 and added and encoded in f32."""
    row = tconf.TRAIN_OVERRIDES["qwen3-moe-235b-a22b"]
    assert row == jconf.TRAIN_OVERRIDES["qwen3-moe-235b-a22b"]
    assert tconf.SMOKES["qwen3-moe-235b-a22b"].name not in \
        tconf.TRAIN_OVERRIDES
    out = assert_steps_match("qwen3-moe-235b-a22b",
                             optimizer=row["optimizer"], ef_bf16=True)
    j_dt, t_dt = out["ef_dtypes"]
    assert j_dt == ["bfloat16"] * len(j_dt)
    assert t_dt == [torch.bfloat16] * len(t_dt)


def test_make_state_ef_dtype():
    _, tspec = specs_for("qwen3-moe-235b-a22b", "sgdm")
    cfg, opt, _, ts = ttrain.build(tspec, "cpu")
    params = init_flat_params(cfg, torch.Generator().manual_seed(0), 1, ts.fs)
    st = make_state(params, opt, ts.compressor, ts.d_local, ts.nworkers,
                    ef_dtype=torch.bfloat16)
    assert [e.dtype for e in st["ef"]] == [torch.bfloat16] * ts.n_buckets
    st32 = make_state(params, opt, ts.compressor, ts.d_local, ts.nworkers)
    assert [e.dtype for e in st32["ef"]] == [torch.float32] * ts.n_buckets
