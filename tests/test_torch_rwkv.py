"""Port parity: the RWKV6 block (``models/rwkv.py``) and rwkv6-7b's smoke
config through ``loss_fn`` and two gs-SGD steps.

Tolerances as tests/test_torch_families.py states them. ``wkv_chunked``
runs at a chunk that divides S and at one that does not (the padding
path), from a zero and from a random initial state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconf
from repro.models import rwkv as jrk
from repro_torch import configs as tconf
from repro_torch.models import rwkv as trk
from tests.test_torch_families import (CTX, assert_steps_match,
                                       block_parity, loss_parity, one_thread,
                                       params_np, smoke_batch)

_ = one_thread   # the module-wide single-thread fixture


@pytest.mark.parametrize("S,chunk,warm", [(16, 8, False), (20, 8, True),
                                          (13, 64, False)])
def test_wkv_chunked_matches(S, chunk, warm):
    B, H, hd = 2, 3, 4
    rs = np.random.RandomState(S)
    # r, k, v at the model's scale (projections of a normalized input by
    # 0.02-scale weights: entries of a few tenths). A step's log-decay
    # enters the chunk twice, through e^{cum_{t-1}} and e^{-cum_s}, and
    # where the two terms cancel exactly d/d logw is their f32 difference:
    # rounding of the size of r k v decides it in both packages.
    args = {k: (0.3 * rs.randn(B, S, H, hd)).astype(np.float32)
            for k in ("r", "k", "v")}
    args["logw"] = -np.exp(rs.uniform(-4, 1.5, (B, S, H, hd))).astype(
        np.float32)
    args["u"] = (0.3 * rs.randn(H, hd)).astype(np.float32)
    args["s0"] = (rs.randn(B, H, hd, hd) if warm
                  else np.zeros((B, H, hd, hd))).astype(np.float32)
    block_parity(lambda **a: jrk.wkv_chunked(**a, chunk=chunk),
                 lambda **a: trk.wkv_chunked(**a, chunk=chunk), args)


@pytest.mark.parametrize("S", [1, 16, 70])
def test_rwkv_block_matches(S):
    """S = 70 runs two chunks of 64, the second padded; S = 1 the
    single-token recurrence."""
    cfg, tcfg = jconf.SMOKES["rwkv6-7b"], tconf.SMOKES["rwkv6-7b"]
    rs = np.random.RandomState(31)
    args = {"p": params_np(cfg, "rwkv", 31),
            "x": rs.randn(2, S, cfg.d_model).astype(np.float32)}
    block_parity(lambda p, x: jrk.rwkv_block(p, cfg, CTX, x)[0],
                 lambda p, x: trk.rwkv_block(p, tcfg, x), args)


def test_token_shift_and_clip_match():
    rs = np.random.RandomState(2)
    h = rs.randn(2, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(
        trk._token_shift(torch.from_numpy(h)).numpy(),
        np.asarray(jrk._token_shift(jnp.asarray(h), None)))
    # exact ties with the clip's bounds: the gradient splits as jnp.clip's
    x = np.array([-12.0, -13.0, 0.5, 3.0, 4.0], np.float32)
    block_parity(lambda x: jnp.clip(x, -12.0, 3.0),
                 lambda x: trk._clip(x, -12.0, 3.0), {"x": x})


def test_rwkv_loss_and_grad_match():
    loss_parity("rwkv6-7b", smoke_batch(tconf.SMOKES["rwkv6-7b"], 2, 16, 10))


def test_rwkv_two_steps_match_reference():
    assert_steps_match("rwkv6-7b")
