"""Port parity: the Mamba2 block (``models/mamba.py``) and zamba2-2.7b's
smoke config (Mamba2 + the weight-tied shared attention block) through
``loss_fn``, the chunked backward and two gs-SGD steps.

Tolerances as tests/test_torch_families.py states them. ``ssd_chunked``
runs at a chunk that divides S and at one that does not (the padding
path), from a zero and from a random initial state.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconf
from repro.models import mamba as jmb
from repro_torch import configs as tconf
from repro_torch.models import mamba as tmb
from repro_torch.models import model as tmdl
from repro_torch.models.flatten import (SEG_NAMES, init_flat_params,
                                        make_flat_spec)
from tests.test_torch_families import (CTX, assert_steps_match,
                                       block_parity, chunked_matches_loss_fn,
                                       loss_parity, one_thread, params_np,
                                       smoke_batch)

_ = one_thread   # the module-wide single-thread fixture


@pytest.mark.parametrize("S,chunk,warm", [(16, 8, False), (21, 8, True),
                                          (11, 64, False)])
def test_ssd_chunked_matches(S, chunk, warm):
    B, H, hd, ns = 2, 3, 4, 5
    rs = np.random.RandomState(S)
    args = {"xh": rs.randn(B, S, H, hd).astype(np.float32),
            "b": rs.randn(B, S, H, ns).astype(np.float32),
            "c": rs.randn(B, S, H, ns).astype(np.float32),
            "dt": rs.uniform(0.01, 0.5, (B, S, H)).astype(np.float32),
            "a_neg": -np.exp(rs.uniform(-1, 1, H)).astype(np.float32),
            "h0": (rs.randn(B, H, ns, hd) if warm
                   else np.zeros((B, H, ns, hd))).astype(np.float32)}
    block_parity(lambda **a: jmb.ssd_chunked(**a, chunk=chunk),
                 lambda **a: tmb.ssd_chunked(**a, chunk=chunk), args)


@pytest.mark.parametrize("S", [1, 16, 70])
def test_mamba_block_matches(S):
    """S = 70 runs two chunks of 64, the second padded; S = 1 the
    one-token step."""
    cfg, tcfg = jconf.SMOKES["zamba2-2.7b"], tconf.SMOKES["zamba2-2.7b"]
    rs = np.random.RandomState(41)
    args = {"p": params_np(cfg, "mamba", 41),
            "x": rs.randn(2, S, cfg.d_model).astype(np.float32)}
    block_parity(lambda p, x: jmb.mamba_block(p, cfg, CTX, x)[0],
                 lambda p, x: tmb.mamba_block(p, tcfg, x), args)


def test_zamba2_loss_and_grad_match():
    loss_parity("zamba2-2.7b",
                smoke_batch(tconf.SMOKES["zamba2-2.7b"], 2, 16, 11))


@pytest.mark.parametrize("chunks", [1, 2])
def test_zamba2_chunked_backward_equals_loss_fn(chunks):
    """Every cycle reads the shared block: its gradient gathers one term a
    cycle, which the chunked backward adds in the monolithic order, so
    loss and gradients are bit-equal to ``loss_fn``'s."""
    fs, got = chunked_matches_loss_fn("zamba2-2.7b", chunks)
    shared = [l for l in fs.top_leaves if l.path[0] == "shared_attn"
              and not l.rep]
    assert shared and fs.n_cycles == 2
    assert float(got["top_s"][shared[0].offset:shared[0].offset
                              + shared[0].size].abs().sum()) > 0


def test_zamba2_chunked_backward_three_cycles():
    """Three cycles in two chunks (sizes 2 and 1): the shared block's terms
    still add up in the monolithic order, bit for bit."""
    cfg = dataclasses.replace(tconf.SMOKES["zamba2-2.7b"], n_layers=6)
    fs = make_flat_spec(cfg, 1)
    segs = init_flat_params(cfg, torch.Generator().manual_seed(2), 1, fs)
    batch = {k: torch.from_numpy(v) for k, v in
             smoke_batch(cfg, 2, 16, 12).items()}
    leaves = {k: v.clone().requires_grad_() for k, v in segs.items()}
    tmdl.loss_fn(cfg, fs, leaves, batch).backward()
    _, steps, top = tmdl.chunked_loss_vjp(cfg, fs, segs, batch, chunks=2)
    got = {"cycles_s": torch.zeros_like(segs["cycles_s"]),
           "cycles_r": torch.zeros_like(segs["cycles_r"])}
    for s in steps:
        (a, b), g_cs, g_cr = s()
        got["cycles_s"][a:b], got["cycles_r"][a:b] = g_cs, g_cr
    got["top_s"], got["top_r"] = top()
    for k in SEG_NAMES:
        assert torch.equal(got[k], leaves[k].grad), k


def test_zamba2_two_steps_match_reference():
    assert_steps_match("zamba2-2.7b")
