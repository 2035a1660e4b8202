"""Port parity: flat layout, model loss and gradient, optimizers.

Both packages start from the JAX package's flat init (exported as numpy,
carried over by ``params_from_numpy``) and take the same token batch. The
forward is f32 in both; the loss is held at rtol 1e-5 and the gradients
at rtol 1e-4, atol 1e-6 (matmul and reduction order differ between XLA
and PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SMOKES as J_SMOKES
from repro.models import model as jmdl
from repro.models.common import ShardCtx
from repro.models.flatten import bucket_sizes as j_bucket_sizes
from repro.models.flatten import init_flat_params as j_init
from repro.models.flatten import make_flat_spec as j_fs
from repro.optim import optimizers as jopt
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SMOKES as T_SMOKES
from repro_torch.models import model as tmdl
from repro_torch.models.common import param_specs
from repro_torch.models.flatten import (SEG_NAMES, bucket_sizes,
                                        make_flat_spec, pack_segs,
                                        params_from_numpy, unpack_segs)
from repro_torch.optim import optimizers as topt


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_flat_spec_equal(which):
    jcfg = (J_SMOKES if which == "smoke" else J_ARCHS)["qwen3-4b"]
    tcfg = (T_SMOKES if which == "smoke" else T_ARCHS)["qwen3-4b"]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    j, t = j_fs(jcfg, 1), make_flat_spec(tcfg, 1)
    assert t.seg_shapes() == j.seg_shapes()
    for jl, tl in zip(j.top_leaves + j.cyc_leaves,
                      t.top_leaves + t.cyc_leaves):
        assert (tl.shape, tl.offset, tl.size, tl.rep) == (
            jl.shape, jl.offset, jl.size, jl.rep)
    for n in (1, 2, 3, 5):
        assert bucket_sizes(t.seg_shapes(), n) == j_bucket_sizes(
            j.seg_shapes(), n)
    assert tcfg.params_count() == jcfg.params_count()


def test_full_width_slice_geometry():
    """qwen3-4b at published widths, cut to 2 layers (the chip cell)."""
    cfg = dataclasses.replace(T_ARCHS["qwen3-4b"], n_layers=2)
    fs = make_flat_spec(cfg, 1)
    assert fs.total == 590_820_864
    assert bucket_sizes(fs.seg_shapes(), 2) == (388_956_160, 201_864_704)


def test_leaf_order_is_sorted():
    layers = param_specs(T_SMOKES["qwen3-4b"])["layers"]["attn"]
    fs = make_flat_spec(T_SMOKES["qwen3-4b"], 1)
    paths = [l.path for l in fs.cyc_leaves]
    assert paths == [("attn",) + p for p in sorted(
        [("k_norm",), ("mlp", "norm"), ("mlp", "wg"), ("mlp", "wo"),
         ("mlp", "wu"), ("norm",), ("q_norm",), ("wk",), ("wo",), ("wq",),
         ("wv",)])]
    assert set(layers) >= {"wq", "mlp", "q_norm"}


def _batch(vocab, b, s, seed):
    rs = np.random.RandomState(seed)
    seq = rs.randint(0, vocab, (b, s + 1))
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def test_loss_and_grad_match():
    jcfg, tcfg = J_SMOKES["qwen3-4b"], T_SMOKES["qwen3-4b"]
    jfs, tfs = j_fs(jcfg, 1), make_flat_spec(tcfg, 1)
    segs = {k: np.asarray(v) for k, v in
            j_init(jcfg, jax.random.PRNGKey(3), 1, jfs).items()}
    batch = _batch(jcfg.vocab_size, 3, 12, 0)
    batch["labels"][0, -2:] = -1  # ignored positions
    ctx = ShardCtx(dtype=jnp.float32)

    def jloss(s):
        return jmdl.loss_fn(jcfg, ctx, jfs, s,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            remat=True)

    j_l, j_g = jax.value_and_grad(jloss)({k: jnp.asarray(v)
                                          for k, v in segs.items()})
    tsegs = {k: v.requires_grad_() for k, v in
             params_from_numpy(segs, tfs, "cpu").items()}
    t_l = tmdl.loss_fn(tcfg, tfs, tsegs,
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    t_l.backward()
    np.testing.assert_allclose(float(t_l.detach()), float(j_l), rtol=1e-5)
    for k in SEG_NAMES:
        np.testing.assert_allclose(tsegs[k].grad.numpy(), np.asarray(j_g[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_params_from_numpy_checks_shapes():
    tfs = make_flat_spec(T_SMOKES["qwen3-4b"], 1)
    good = {k: np.zeros(s, np.float32) for k, s in tfs.seg_shapes().items()}
    params_from_numpy(good, tfs, "cpu")
    bad = dict(good, top_r=np.zeros((7,), np.float32))
    with pytest.raises(ValueError):
        params_from_numpy(bad, tfs, "cpu")


def test_pack_unpack_roundtrip_with_worker_axis():
    tfs = make_flat_spec(T_SMOKES["qwen3-4b"], 1)
    rs = np.random.RandomState(0)
    segs = {k: torch.from_numpy(rs.randn(2, *s).astype(np.float32))
            for k, s in tfs.seg_shapes().items()}
    flat = pack_segs(segs, lead=1)
    assert flat.shape == (2, tfs.total)
    back = unpack_segs(flat, segs, lead=1)
    for k in SEG_NAMES:
        assert torch.equal(back[k], segs[k])


@pytest.mark.parametrize("name,kw", [("adamw", {"lr": 1e-3}),
                                     ("sgdm", {"lr": 0.1,
                                               "weight_decay": 0.01})])
def test_optimizers_match(name, kw):
    rs = np.random.RandomState(1)
    p = rs.randn(2, 50).astype(np.float32)
    jo, to = jopt.make(name, **kw), topt.make(name, **kw)
    jp, js = jnp.asarray(p), jo.init(p.shape)
    tp, ts = torch.from_numpy(p.copy()), to.init(p.shape)
    for step in range(3):
        g = rs.randn(2, 50).astype(np.float32)
        jp, js = jo.apply(jp, jnp.asarray(g), js, jnp.int32(step))
        tp, ts = to.apply(tp, torch.from_numpy(g), ts, step)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
