"""Port parity: tensor parallelism (tp = 2) against the JAX package's
vmap'd ``model`` axis, and against the port at tp = 1.

The reference's tests/test_tp.py, ported: the loss of every arch of its
``ARCHS_TP``, prefill and decode of four, and three dense train steps of
three, each run in both packages from the reference's own ``shard_segs``
output (its global params at PRNGKey(0), cut per rank), carried into the
port by ``params_from_numpy``; the port's own ``flatten.shard_segs`` is
held bit-equal to it. The port runs the model axis as a rank dimension
of one autograd graph (``models.common.ShardCtx``).

Tolerances: the port against the reference at the same layout within
1e-5 relative (losses, logits; f32 in another summation order); the
port's tp = 2 against its tp = 1 as the reference's test holds its own
(loss 2e-4, three train steps 5e-4 relative); decode ids equal. The fp8
wire: torch's ``float8_e4m3fn`` cast bit-equal to XLA's on scaled
values; the reference's decode and loss checks (tests/test_perf_opts.py:
greedy-token agreement >= 0.75, the loss within 2% of the exact wire) in
f32, where the fp8 path is off and the wires agree exactly, and in bf16,
where it is on; in both, each wire's logits, ids and loss held against
the reference's own run with that wire (bf16 tolerances below), and at
12 smoke layers the fp8 ids and so the agreement equal to the
reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.core.gs_sgd import MeshAxes as JMesh
from repro.core.gs_sgd import make_train_step as j_make_train_step
from repro.models import model as jmdl
from repro.models.common import init_params as j_init_params
from repro.models.flatten import SEG_NAMES
from repro.models.flatten import make_flat_spec as j_fs
from repro.optim import make as j_opt
from repro_torch.configs import SMOKES as T_SMOKES
from repro_torch.core.gs_sgd import MeshAxes, local_seg_shapes
from repro_torch.core.gs_sgd import make_serve_fns, make_train_step
from repro_torch.models import model as tmdl
from repro_torch.models.common import tree_from_paths
from repro_torch.models.flatten import (make_flat_spec, params_from_numpy,
                                        shard_segs)
from repro_torch.optim import make as t_opt
from tests.test_tp import ARCHS_TP, TP, _batch, _tp_machinery
from tests.test_tp import shard_segs as j_shard_segs

REL = 1e-5          # port against the reference, same layout
LOSS_TP_RTOL = 2e-4  # tp = 2 against tp = 1 (tests/test_tp.py)
TRAIN_TP_RTOL = 5e-4
# bf16 activations, the port against the reference (the fp8 wire on):
# prefill logits (|x| < 1) within 4 bf16 ulps at 2 smoke layers (read:
# 0.0039 exact, 0.0063 fp8) and 8 at 12 (read: 0.0068, 0.0208), where a
# value that rounds to the other side of an e4m3 step moves by 2^-4 of
# itself; the loss within 2e-4 relative (read: 1.3e-5, 3.3e-5)
BF16_ATOL, BF16_ATOL_DEEP = 2.0 ** -6, 2.0 ** -5
BF16_LOSS_RTOL = 2e-4
MA1 = MeshAxes(tp=1, data=1, tp_axis=None, data_axis=None)
MA2 = MeshAxes(tp=TP, data=1, tp_axis="model", data_axis=None)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE: dict = {}


def params(name: str) -> dict:
    """The reference's params of ``name``'s smoke config, made once: the
    global tree (numpy), its tp = 1 segments, and its ``shard_segs``
    output at tp = 2 with that FlatSpec."""
    if name not in _CACHE:
        cfg = J_SMOKES[name]
        key = jax.random.PRNGKey(0)
        fs2, segs2 = j_shard_segs(cfg, key, TP)
        glob = j_init_params(cfg, key, TP)   # tp = 1's padding, too
        _CACHE[name] = {
            "global": jax.tree_util.tree_map(np.asarray, glob),
            "segs1": {k: np.asarray(v) for k, v in
                      j_fs(cfg, 1).flatten(glob).items()},
            "fs2": fs2, "segs2": segs2}
    return _CACHE[name]


def port_segs(name: str) -> tuple[dict, dict, object]:
    """(tp = 1 segments, tp = 2 rank-stacked segments, FlatSpec at 2) of
    the reference's params, in the port."""
    p = params(name)
    cfg = T_SMOKES[name]
    fs1, fs2 = make_flat_spec(cfg, 1), make_flat_spec(cfg, TP)
    s1 = params_from_numpy(p["segs1"], fs1, "cpu")
    s2 = params_from_numpy({k: np.asarray(v) for k, v in p["segs2"].items()},
                           fs2, "cpu", shapes=local_seg_shapes(fs2, MA2, "dp"),
                           lead=(TP,))
    return s1, s2, fs2


def use2(segs2: dict) -> dict:
    """The tp = 2 storage of one replica in the model's use layout."""
    from repro_torch.core.gs_sgd import _gather_closures
    gather, _ = _gather_closures(MA2, "dp")
    return gather({k: v[:, None] for k, v in segs2.items()})


def t_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("name", ARCHS_TP)
def test_shard_segs_equal_reference(name):
    p = params(name)
    leaves = jax.tree_util.tree_leaves_with_path(p["global"])
    tree = tree_from_paths([(tuple(k.key for k in path),
                             torch.from_numpy(np.array(v)))
                            for path, v in leaves])
    fs, got = shard_segs(T_SMOKES[name], tree, TP)
    assert fs.seg_shapes() == p["fs2"].seg_shapes()
    for k in SEG_NAMES:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(p["segs2"][k]), err_msg=k)


@pytest.mark.parametrize("name", ARCHS_TP)
def test_tp_loss_matches_reference(name):
    cfg = J_SMOKES[name]
    p = params(name)
    batch = _batch(cfg)
    _, ctx, gathers = _tp_machinery(cfg)
    want = np.asarray(jax.vmap(
        lambda s: jmdl.loss_fn(cfg, ctx, p["fs2"], s, batch, gathers=gathers,
                               remat=False), axis_name="model")(p["segs2"]))
    s1, s2, fs2 = port_segs(name)
    tcfg = T_SMOKES[name]
    got = tmdl.loss_fn(tcfg, fs2, use2(s2), t_batch(batch),
                       dtype=torch.float32, ctx=MA2.ctx(torch.float32))
    assert got.shape == (TP,) and float(got[0]) == float(got[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=REL)
    one = tmdl.loss_fn(tcfg, make_flat_spec(tcfg, 1), s1, t_batch(batch),
                       dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), float(one), rtol=LOSS_TP_RTOL,
                               atol=LOSS_TP_RTOL)


def j_serve(cfg, p, batch, S, T, ctx, gathers):
    """The reference's tp = 2 prefill logits (tp, B, V_loc) and decode
    ids (tp, B)."""
    B = batch["tokens"].shape[0]
    cache = jax.vmap(lambda _: jmdl.init_cache(cfg, ctx, B, T, jnp.float32))(
        jnp.arange(TP))
    logits, cache = jax.jit(jax.vmap(
        lambda s, c: jmdl.prefill_fn(
            cfg, ctx, p["fs2"], s,
            dict(batch, tokens=batch["tokens"][:, :S - 1]), c,
            gathers=gathers), axis_name="model"))(p["segs2"], cache)
    ids, _ = jax.jit(jax.vmap(
        lambda s, c: jmdl.decode_fn(
            cfg, ctx, p["fs2"], s, batch["tokens"][:, S - 1:],
            jnp.int32(S - 1), c, cross_kv=batch.get("cross_kv"),
            gathers=gathers), axis_name="model"))(p["segs2"], cache)
    return np.asarray(logits), np.asarray(ids)


def t_serve(tcfg, ma, segs, batch, S, T, dtype=torch.float32,
            comm_dtype=None):
    """The port's prefill logits and decode ids through make_serve_fns."""
    pre, dec = make_serve_fns(tcfg, ma, dtype=dtype, comm_dtype=comm_dtype)
    B = batch["tokens"].shape[0]
    cache = tmdl.init_cache(tcfg, B, T, torch.float32,
                            ctx=ma.ctx(dtype, comm_dtype))
    logits, cache = pre(segs, dict(batch, tokens=batch["tokens"][:, :S - 1]),
                        cache)
    ids, _ = dec(segs, batch["tokens"][:, S - 1:], S - 1, cache,
                 cross_kv=batch.get("cross_kv"))
    return logits, ids


@pytest.mark.parametrize("name", ["qwen3-4b", "starcoder2-3b", "rwkv6-7b",
                                  "zamba2-2.7b"])
def test_tp_decode_matches_reference(name):
    cfg = J_SMOKES[name]
    p = params(name)
    S, T = 8, 16
    batch = _batch(cfg, 2, S)
    _, ctx, gathers = _tp_machinery(cfg)
    want_logits, want_ids = j_serve(cfg, p, batch, S, T, ctx, gathers)
    s1, s2, _ = port_segs(name)
    tcfg = T_SMOKES[name]
    logits, ids = t_serve(tcfg, MA2, s2, t_batch(batch), S, T)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=REL,
                               atol=REL)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    logits1, ids1 = t_serve(tcfg, MA1, s1, t_batch(batch), S, T)
    np.testing.assert_array_equal(ids.numpy()[0], ids1.numpy())
    np.testing.assert_allclose(  # the ranks' vocab shards side by side
        logits.permute(1, 0, 2).reshape(logits1.shape).numpy(),
        logits1.numpy(), rtol=LOSS_TP_RTOL, atol=LOSS_TP_RTOL)


@pytest.mark.parametrize("name", ["qwen3-4b", "starcoder2-3b",
                                  "zamba2-2.7b"])
def test_tp_train_matches_reference(name):
    """3 dense train steps (sgdm): the port at tp = 2 against the
    reference's vmap'd tp = 2 step (losses, params) and against the port
    at tp = 1 (losses, tests/test_tp.py's bound)."""
    cfg = J_SMOKES[name]
    p = params(name)
    opt = j_opt("sgdm", lr=5e-2, momentum=0.9)
    batch = _batch(cfg, B=2, S=12)
    jts = j_make_train_step(cfg, JMesh(tp=TP, data=1, tp_axis="model",
                                       data_axis=None), opt, dp_mode="dp",
                            compressor_name=None, remat=False,
                            dtype=jnp.float32, fs=p["fs2"])
    jst = {"params": p["segs2"],
           "opt": {k: jax.vmap(lambda v: opt.init(v.shape))(p["segs2"][k])
                   for k in SEG_NAMES},
           "ef": jnp.zeros((TP, 0), jnp.float32),
           "step": jnp.zeros((TP,), jnp.int32)}
    jstep = jax.jit(jax.vmap(jts.fn, in_axes=(0, None), axis_name="model"))

    tcfg = T_SMOKES[name]
    topt = t_opt("sgdm", lr=5e-2, momentum=0.9)
    s1, s2, fs2 = port_segs(name)
    ts2 = make_train_step(tcfg, MA2, topt, compressor_name=None, remat=False,
                          dtype=torch.float32, fs=fs2, device="cpu")
    ts1 = make_train_step(tcfg, MA1, topt, compressor_name=None, remat=False,
                          dtype=torch.float32, device="cpu")
    st2, st1 = ts2.state_from(s2, topt), ts1.state_from(s1, topt)
    tb = {k: v[None] for k, v in t_batch(batch).items()}
    for i in range(3):
        jst, jm = jstep(jst, batch)
        st2, m2 = ts2.fn(st2, tb)
        st1, m1 = ts1.fn(st1, tb)
        want, got, one = float(jm["loss"][0]), float(m2["loss"]), float(
            m1["loss"])
        assert abs(got - want) <= REL * abs(want), (i, got, want)
        assert abs(got - one) < TRAIN_TP_RTOL * max(1.0, abs(one)), (i, got,
                                                                      one)
        np.testing.assert_allclose(m2["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"])[:1],
                                   rtol=1e-4)
    for k in SEG_NAMES:
        np.testing.assert_allclose(st2["params"][k][:, 0].numpy(),
                                   np.asarray(jst["params"][k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_tp_parallel_block_loss_matches_reference():
    """The PaLM-style parallel block's one psum at tp = 2."""
    cfg = dataclasses.replace(J_SMOKES["qwen3-4b"], parallel_block=True)
    tcfg = dataclasses.replace(T_SMOKES["qwen3-4b"], parallel_block=True)
    p = params("qwen3-4b")
    batch = _batch(cfg, B=2, S=16)
    _, ctx, gathers = _tp_machinery(cfg)
    want = np.asarray(jax.vmap(
        lambda s: jmdl.loss_fn(cfg, ctx, p["fs2"], s, batch, gathers=gathers,
                               remat=False), axis_name="model")(p["segs2"]))
    _, s2, fs2 = port_segs("qwen3-4b")
    got = tmdl.loss_fn(tcfg, fs2, use2(s2), t_batch(batch),
                       dtype=torch.float32, ctx=MA2.ctx(torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=REL)


def test_fp8_cast_bit_equal_reference():
    """The wire's cast: torch and XLA round scaled f32 to float8_e4m3fn
    alike (values within +-448, as the amax scaling makes them)."""
    rs = np.random.RandomState(0)
    x = (rs.randn(100_000) * rs.choice([1e-4, 1e-2, 1.0, 1e2], 100_000)
         ).astype(np.float32)
    y = (x * (np.float32(448.0) / np.abs(x).max())).astype(np.float32)
    want = np.asarray(jnp.asarray(y).astype(jnp.float8_e4m3fn)
                      .astype(jnp.float32))
    got = torch.from_numpy(y).to(torch.float8_e4m3fn).to(torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def fp8_cell(name: str, n_layers: int | None = None):
    """(reference cfg, port cfg, reference params, port tp = 2 segments)
    of ``name``'s smoke config, at ``n_layers`` if given (drawn anew)."""
    cfg, tcfg = J_SMOKES[name], T_SMOKES[name]
    if n_layers is None:
        return cfg, tcfg, params(name), port_segs(name)[1]
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    fs2, segs2 = j_shard_segs(cfg, jax.random.PRNGKey(0), TP)
    tfs2 = make_flat_spec(tcfg, TP)
    s2 = params_from_numpy({k: np.asarray(v) for k, v in segs2.items()},
                           tfs2, "cpu", shapes=local_seg_shapes(tfs2, MA2,
                                                                "dp"),
                           lead=(TP,))
    return cfg, tcfg, {"fs2": fs2, "segs2": segs2}, s2


def fp8_decode(name: str, dtype: str, n_layers: int | None = None) -> dict:
    """tests/test_perf_opts.py's decode cell (4 prompts of 12 tokens, one
    decode step, tp = 2) in both packages, with the exact and the fp8
    wire: {wire: (reference logits, ids; port logits, ids)}, the logits
    the prefill's (tp, B, V_loc) in f32, the ids rank 0's."""
    cfg, tcfg, p, s2 = fp8_cell(name, n_layers)
    B, S, T = 4, 12, 16
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         cfg.vocab_size))
    _, ctx, gathers = _tp_machinery(cfg)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    out = {}
    for wire, jcd, tcd in [("exact", None, None),
                           ("fp8", jnp.float8_e4m3fn, torch.float8_e4m3fn)]:
        c = dataclasses.replace(ctx, dtype=jdt, comm_dtype=jcd)
        jl, jid = j_serve(cfg, p, {"tokens": jnp.asarray(toks)}, S, T, c,
                          gathers)
        tl, tid = t_serve(tcfg, MA2, s2, {"tokens": torch.from_numpy(
            toks.copy())}, S, T, dtype=tdt, comm_dtype=tcd)
        out[wire] = (np.asarray(jl, np.float32), jid[0],
                     tl.to(torch.float32).numpy(), tid[0].numpy())
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fp8_comm_decode_token_agreement(dtype):
    """tests/test_perf_opts.py's check in the port: greedy tokens with the
    fp8 wire against the exact wire, >= 0.75 agreement (an untrained
    model); and each wire held against the reference's on the same
    inputs: decode ids equal, prefill logits within REL (f32, where the
    fp8 path is off, as in the reference) or BF16_ATOL (bf16, where it
    is on)."""
    out = fp8_decode("qwen3-4b", dtype)
    assert (out["exact"][3] == out["fp8"][3]).mean() >= 0.75, out
    tol = REL if dtype == "f32" else BF16_ATOL
    for wire, (jl, jid, tl, tid) in out.items():
        np.testing.assert_array_equal(tid, jid, err_msg=wire)
        np.testing.assert_allclose(tl, jl, rtol=tol, atol=tol, err_msg=wire)
    if dtype == "f32":   # the fp8 path is off: the same logits bits
        np.testing.assert_array_equal(out["fp8"][2], out["exact"][2])


def test_fp8_comm_agreement_with_depth_matches_reference():
    """The fp8 wire's greedy agreement falls with depth in the reference
    too: at 12 smoke layers (bf16, the fp8 path on) the port's ids equal
    the reference's on each wire, so its agreement is the reference's
    (0.75 on this cell, against 1.0 at the 2 layers above)."""
    out = fp8_decode("qwen3-4b", "bf16", n_layers=12)
    for wire, (jl, jid, tl, tid) in out.items():
        np.testing.assert_array_equal(tid, jid, err_msg=wire)
        np.testing.assert_allclose(tl, jl, rtol=BF16_ATOL_DEEP,
                                   atol=BF16_ATOL_DEEP, err_msg=wire)
    agree = (out["exact"][3] == out["fp8"][3]).mean()
    assert agree == (out["exact"][1] == out["fp8"][1]).mean() == 0.75


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fp8_comm_loss_close(dtype):
    """The loss with the fp8 wire within 2% of the exact wire's
    (tests/test_perf_opts.py), and each wire's loss held against the
    reference's on the same batch: REL in f32 (the fp8 path off: the
    same bits on both wires), BF16_LOSS_RTOL in bf16."""
    name = "qwen3-4b"
    cfg, tcfg = J_SMOKES[name], T_SMOKES[name]
    p = params(name)
    _, s2, fs2 = port_segs(name)
    _, ctx, gathers = _tp_machinery(cfg)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                         cfg.vocab_size))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    batch = {"tokens": torch.from_numpy(toks.copy()),
             "labels": torch.from_numpy(toks.copy())}
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    vals, want = {}, {}
    for wire, jcd, tcd in [("exact", None, None),
                           ("fp8", jnp.float8_e4m3fn, torch.float8_e4m3fn)]:
        c = dataclasses.replace(ctx, dtype=jdt, comm_dtype=jcd)
        want[wire] = float(jax.vmap(
            lambda s: jmdl.loss_fn(cfg, c, p["fs2"], s, jbatch,
                                   gathers=gathers, remat=False),
            axis_name="model")(p["segs2"])[0])
        vals[wire] = float(tmdl.loss_fn(tcfg, fs2, use2(s2), batch,
                                        dtype=tdt, ctx=MA2.ctx(tdt, tcd))[0])
    assert abs(vals["fp8"] - vals["exact"]) < 0.02 * vals["exact"], vals
    tol = REL if dtype == "f32" else BF16_LOSS_RTOL
    for wire in vals:
        assert abs(vals[wire] - want[wire]) <= tol * want[wire], (wire, vals,
                                                                  want)
    if dtype == "f32":   # the fp8 path is off: the same loss bits
        assert vals["fp8"] == vals["exact"]
