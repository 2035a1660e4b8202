"""Port parity: 'fsdp' storage (parameters, optimizer state and EF sharded
over the in-pod ``data`` axis, gathered once a pod and step) with and
without a ``pod`` axis.

- The reference's tests/test_gs_sgd_integration.py check in the port: at
  a single pod fsdp equals dp (yi-9b smoke, P = 4, dense SGD with
  momentum, 3 steps, rtol 2e-4), and the port's fsdp equals the
  reference's fsdp step under ``jax.vmap`` (1e-5 relative).
- pod = 2 x data = 2 gs-SGD against the reference's nested vmap (``pod``
  outside, ``data`` inside; workers pod-major): the exchange runs over
  the pods once per data shard, so each shard's selected coordinates
  must be equal, every bucket and step (tolerances as in
  tests/test_torch_tp_gs_sgd.py).
- A single-pod fsdp step is dense and EF-free, whatever compressor is
  named.
- The reduce-scatter: after one gs-SGD step from a zero EF, each
  worker's EF is its packed gradient with the selected coordinates
  zeroed; that gradient must be the sum over its pod of the workers'
  full gradients (each on its own rows, the pod's gathered params),
  sliced to the worker's shard (rtol 1e-5, atol 1e-8).
- fsdp at tp = 2 (both gathers) equals dp at tp = 2, and fsdp serving
  (one pod's shards, gathered) equals dp serving; both are also held
  against the reference's fsdp step and serve fns at tp = 2 x data = 2
  under nested vmap (``model`` outside), from its ``shard_segs`` params
  (the port's fsdp storage equal to the reference's, bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.core.gs_sgd import MeshAxes as JMesh
from repro.core.gs_sgd import make_state as j_make_state
from repro.core.gs_sgd import make_train_step as j_make_train_step
from repro.models.flatten import init_flat_params as j_init
from repro.optim import make as j_opt
from repro_torch.configs import SMOKES as T_SMOKES
from repro_torch.core.gs_sgd import MeshAxes, _gather_closures
from repro_torch.core.gs_sgd import make_serve_fns, make_train_step
from repro_torch.models import model as tmdl
from repro_torch.models.common import init_params
from repro_torch.models.flatten import (SEG_NAMES, pack_segs,
                                        params_from_numpy, shard_segs)
from repro_torch.optim import make as t_opt
from tests.test_torch_tp_gs_sgd import KW, batches, buckets_of, hold, t_run

NAME = "yi-9b"
POD, D = 2, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def segs1() -> dict:
    """The reference's tp = 1 flat params of the yi-9b smoke config."""
    fs = make_train_step(T_SMOKES[NAME], MeshAxes(tp=1, data=1), t_opt(
        "sgdm"), compressor_name=None, device="cpu").fs
    from repro.models.flatten import make_flat_spec
    params = j_init(J_SMOKES[NAME], jax.random.PRNGKey(0), 1,
                    make_flat_spec(J_SMOKES[NAME], 1))
    out = {k: np.asarray(v) for k, v in params.items()}
    params_from_numpy(out, fs, "cpu")   # shapes agree
    return out


def j_shard(a, j: int, n: int):
    per = a.shape[-1] // n
    return a[..., j * per:(j + 1) * per]


def test_fsdp_single_pod_matches_dp_and_reference(segs1):
    P = POD * D
    cfg, tcfg = J_SMOKES[NAME], T_SMOKES[NAME]
    opt = j_opt("sgdm", lr=5e-2, momentum=0.9)
    topt = t_opt("sgdm", lr=5e-2, momentum=0.9)
    jma = JMesh(tp=1, data=P, tp_axis=None, data_axis="data")
    jts = j_make_train_step(cfg, jma, opt, dp_mode="fsdp",
                            compressor_name=None, remat=False,
                            dtype=jnp.float32)
    st = [j_make_state({k: j_shard(jnp.asarray(v), w, P)
                        for k, v in segs1.items()}, opt, None, jts.d_local)
          for w in range(P)]
    st = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *st)
    fn = jax.jit(jax.vmap(jts.fn, axis_name="data"))
    bs = batches(cfg.vocab_size, P, seed=9)
    want = []
    for gb in bs:
        st, m = fn(st, {k: jnp.asarray(v.reshape((P, -1) + v.shape[1:]))
                        for k, v in gb.items()})
        want.append(float(m["loss"][0]))
    out = {}
    for mode in ("dp", "fsdp"):
        ma = MeshAxes(tp=1, data=P)
        ts = make_train_step(tcfg, ma, topt, dp_mode=mode,
                             compressor_name=None, remat=False,
                             dtype=torch.float32, device="cpu")
        tst = ts.state_from(params_from_numpy(segs1, ts.fs, "cpu"), topt)
        out[mode] = t_run(ts, tst, bs,
                          lambda v: v.reshape((P, -1) + v.shape[1:]))
    np.testing.assert_allclose(out["fsdp"]["loss"], want, rtol=1e-5)
    np.testing.assert_allclose(out["dp"]["loss"], out["fsdp"]["loss"],
                               rtol=2e-4, atol=2e-4)
    for k in SEG_NAMES:
        np.testing.assert_allclose(out["fsdp"]["params"][k],
                                   np.asarray(st["params"][k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("buckets", [2, None])
def test_fsdp_pod2_data2_gs_sgd_matches_nested_vmap(segs1, buckets):
    P = POD * D
    cfg, tcfg = J_SMOKES[NAME], T_SMOKES[NAME]
    opt, topt = j_opt("adamw", lr=2e-3), t_opt("adamw", lr=2e-3)
    jma = JMesh(tp=1, data=D, pod=POD, tp_axis=None, pod_axis="pod")
    jts = j_make_train_step(cfg, jma, opt, dp_mode="fsdp",
                            compressor_name="gs-sgd", compressor_kw=KW,
                            buckets=buckets, remat=False, dtype=jnp.float32)
    st = [j_make_state({k: j_shard(jnp.asarray(v), j, D)
                        for k, v in segs1.items()}, opt, jts.compressor,
                       jts.d_local) for j in range(D)]
    st = jax.tree_util.tree_map(
        lambda *a: jnp.broadcast_to(jnp.stack(a), (POD, D) + a[0].shape),
        *st)
    fn = jax.jit(jax.vmap(jax.vmap(jts.fn, axis_name="data"),
                          axis_name="pod"))
    bs = batches(cfg.vocab_size, P, seed=9)
    j_out = {"loss": [], "gnorm": [], "ef": []}
    for gb in bs:
        st, m = fn(st, {k: jnp.asarray(v.reshape((POD, D, -1) + v.shape[1:]))
                        for k, v in gb.items()})
        j_out["loss"].append(float(m["loss"][0, 0]))
        j_out["gnorm"].append(np.asarray(m["grad_norm"]).reshape(P))
        j_out["ef"].append([[np.asarray(e[:, j]) for e in buckets_of(st["ef"])]
                            for j in range(D)])
    j_out["params"] = {k: np.asarray(v).reshape((P,) + v.shape[2:])
                       for k, v in st["params"].items()}

    ma = MeshAxes(tp=1, data=D, pod=POD, pod_axis="pod")
    ts = make_train_step(tcfg, ma, topt, dp_mode="fsdp",
                         compressor_name="gs-sgd", compressor_kw=KW,
                         buckets=buckets, remat=False, dtype=torch.float32,
                         device="cpu")
    assert ts.d_local == jts.d_local and ts.nworkers == P
    # one exchange a data shard, over the pods (workers j, j + D)
    assert ts.comp_groups == tuple((0, slice(j, P, D)) for j in range(D))
    t_out = t_run(ts, ts.state_from(params_from_numpy(segs1, ts.fs, "cpu"),
                                    topt), bs,
                  lambda v: v.reshape((P, -1) + v.shape[1:]))
    hold(j_out, t_out, ts.comp_groups)


def test_fsdp_single_pod_is_dense_and_ef_free(segs1):
    ma = MeshAxes(tp=1, data=4)
    topt = t_opt("adamw", lr=2e-3)
    ts = make_train_step(T_SMOKES[NAME], ma, topt, dp_mode="fsdp",
                         compressor_name="gs-sgd", compressor_kw=KW,
                         buckets=2, remat=False, dtype=torch.float32,
                         device="cpu")
    dense = make_train_step(T_SMOKES[NAME], ma, topt, dp_mode="fsdp",
                            compressor_name=None, remat=False,
                            dtype=torch.float32, device="cpu")
    assert ts.compressor is None and ts.comp_groups == () and ts.plan is None
    st = ts.state_from(params_from_numpy(segs1, ts.fs, "cpu"), topt)
    assert st["ef"].shape == (4, 0)
    st_d = dense.state_from(params_from_numpy(segs1, ts.fs, "cpu"), topt)
    gb = batches(J_SMOKES[NAME].vocab_size, 4)[0]
    tb = {k: torch.from_numpy(v.reshape((4, -1) + v.shape[1:]).copy())
          for k, v in gb.items()}
    st, m = ts.fn(st, tb)
    st_d, m_d = dense.fn(st_d, tb)
    assert st["ef"].shape == (4, 0)
    assert float(m["loss"]) == float(m_d["loss"])
    for k in SEG_NAMES:
        assert torch.equal(st["params"][k], st_d["params"][k])


def test_fsdp_reduce_scatter_is_the_pod_sum_sliced(segs1):
    P = POD * D
    tcfg = T_SMOKES[NAME]
    topt = t_opt("adamw", lr=2e-3)
    ma = MeshAxes(tp=1, data=D, pod=POD, pod_axis="pod")
    ts = make_train_step(tcfg, ma, topt, dp_mode="fsdp",
                         compressor_name="gs-sgd", compressor_kw=KW,
                         buckets=2, remat=False, dtype=torch.float32,
                         device="cpu")
    st = ts.state_from(params_from_numpy(segs1, ts.fs, "cpu"), topt)
    gb = batches(J_SMOKES[NAME].vocab_size, P)[0]
    tb = {k: torch.from_numpy(v.reshape((P, -1) + v.shape[1:]).copy())
          for k, v in gb.items()}
    gather, scatter = _gather_closures(ma, "fsdp")
    want = torch.empty((P, ts.d_local))
    for pod in range(POD):
        ws = range(pod * D, (pod + 1) * D)
        full = {k: v.detach().requires_grad_() for k, v in gather(
            {k: st["params"][k][None, pod * D:(pod + 1) * D]
             for k in SEG_NAMES}).items()}
        total = None
        for w in ws:
            g = torch.autograd.grad(
                tmdl.loss_fn(tcfg, ts.fs, full, {k: v[w] for k, v in
                                                 tb.items()}),
                [full[k] for k in SEG_NAMES])
            total = g if total is None else [a + b for a, b in zip(total, g)]
        shards = scatter(dict(zip(SEG_NAMES, total)), D)
        for j, w in enumerate(ws):
            want[w] = pack_segs({k: shards[k][0, j] for k in SEG_NAMES})
    st, _ = ts.fn(st, tb)
    for gi, (_, sl) in enumerate(ts.comp_groups):
        ef = torch.cat(list(st["ef"][gi]), dim=-1)   # (pods, d_local)
        kept = ef != 0
        assert int((~kept).sum()) > 0
        np.testing.assert_allclose(ef[kept].numpy(), want[sl][kept].numpy(),
                                   rtol=1e-5, atol=1e-8)


def test_fsdp_tp2_matches_dp_tp2_and_serving():
    """Both gathers at once: fsdp at tp = 2 x data = 2 (one pod) equals dp
    at the same mesh over 3 dense steps; fsdp serving (one pod's shards)
    equals dp serving."""
    tcfg = T_SMOKES["qwen3-4b"]
    glob = init_params(tcfg, torch.Generator().manual_seed(0), 2)
    _, segs2 = shard_segs(tcfg, glob, 2)
    topt = t_opt("sgdm", lr=5e-2, momentum=0.9)
    ma = MeshAxes(tp=2, data=D)
    bs = batches(tcfg.vocab_size, D)
    out, states = {}, {}
    for mode in ("dp", "fsdp"):
        ts = make_train_step(tcfg, ma, topt, dp_mode=mode,
                             compressor_name=None, remat=False,
                             dtype=torch.float32, device="cpu")
        st = ts.state_from(segs2, topt)
        if mode == "fsdp":
            assert st["params"]["top_r"].shape[-1] == (
                segs2["top_r"].shape[-1] // D)
        out[mode] = t_run(ts, st, bs,
                          lambda v: v.reshape((D, -1) + v.shape[1:]))
        states[mode] = ts.state_from(segs2, topt)["params"]
    np.testing.assert_allclose(out["fsdp"]["loss"], out["dp"]["loss"],
                               rtol=2e-4, atol=2e-4)
    toks = torch.from_numpy(bs[0]["tokens"][:2, :9].copy())
    ids = {}
    for mode, params in (("dp", {k: v[:, 0] for k, v in
                                 states["dp"].items()}),
                         ("fsdp", states["fsdp"])):
        pre, dec = make_serve_fns(tcfg, ma, dp_mode=mode,
                                  dtype=torch.float32)
        cache = tmdl.init_cache(tcfg, 2, 16, torch.float32,
                                ctx=ma.ctx(torch.float32))
        logits, cache = pre(params, {"tokens": toks[:, :8]}, cache)
        ids[mode] = (logits, dec(params, toks[:, 8:], 8, cache)[0])
    torch.testing.assert_close(ids["fsdp"][0], ids["dp"][0], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(ids["fsdp"][1], ids["dp"][1])


def j_fsdp_store(segs2: dict, tp: int, n: int) -> dict:
    """The reference's fsdp storage at tp > 1 from ``shard_segs`` output:
    (tp, n, *local). A ``*_s`` segment's shard j of rank r is the j-th
    1/n of the rank's segment (``gdata``); a ``*_r`` segment's is chunk
    j * tp + r of the replica's whole segment (``gdata(gmodel(v))``:
    data-major)."""
    out = {}
    for k, v in segs2.items():
        v = np.asarray(v)
        if k.endswith("_r"):
            whole = np.concatenate(list(v), axis=-1)
            out[k] = np.stack([np.stack([j_shard(whole, j * tp + r, n * tp)
                                         for j in range(n)])
                               for r in range(tp)])
        else:
            out[k] = np.stack([np.stack([j_shard(v[r], j, n)
                                         for j in range(n)])
                               for r in range(tp)])
    return out


def test_fsdp_tp2_matches_reference():
    """Both gathers at once, against the reference: fsdp at tp = 2 x
    data = 2 (one pod: dense) under nested vmap (``model`` outside,
    ``data`` inside) from the reference's ``shard_segs`` params, 3 sgdm
    steps (losses 1e-5 relative, the global norm over ranks and data
    shards 1e-4, params rtol 1e-4 / atol 1e-6); then fsdp serving, one
    pod's shards gathered, against the reference's fsdp serve fns
    (prefill logits 1e-5, decode ids equal)."""
    from repro.core.gs_sgd import make_serve_fns as j_make_serve_fns
    from repro.models import model as jmdl
    from tests.test_tp import shard_segs as j_shard_segs
    name, TP = "qwen3-4b", 2
    cfg, tcfg = J_SMOKES[name], T_SMOKES[name]
    fs2, segs2 = j_shard_segs(cfg, jax.random.PRNGKey(0), TP)
    store = j_fsdp_store(segs2, TP, D)
    opt = j_opt("sgdm", lr=5e-2, momentum=0.9)
    topt = t_opt("sgdm", lr=5e-2, momentum=0.9)
    jma = JMesh(tp=TP, data=D, tp_axis="model", data_axis="data")
    jts = j_make_train_step(cfg, jma, opt, dp_mode="fsdp",
                            compressor_name=None, remat=False,
                            dtype=jnp.float32, fs=fs2)
    st = jax.vmap(jax.vmap(lambda s: j_make_state(s, opt, None,
                                                  jts.d_local)))(
        {k: jnp.asarray(v) for k, v in store.items()})
    fn = jax.jit(jax.vmap(jax.vmap(jts.fn, in_axes=(0, 0), axis_name="data"),
                          in_axes=(0, None), axis_name="model"))
    bs = batches(cfg.vocab_size, D, seed=9)
    want_loss, want_gnorm = [], []
    for gb in bs:
        st, m = fn(st, {k: jnp.asarray(v.reshape((D, -1) + v.shape[1:]))
                        for k, v in gb.items()})
        want_loss.append(float(m["loss"][0, 0]))
        want_gnorm.append(np.asarray(m["grad_norm"][0]))

    ma = MeshAxes(tp=TP, data=D)
    ts = make_train_step(tcfg, ma, topt, dp_mode="fsdp",
                         compressor_name=None, remat=False,
                         dtype=torch.float32, device="cpu")
    assert ts.d_local == jts.d_local
    tsegs2 = params_from_numpy({k: np.asarray(v) for k, v in segs2.items()},
                               ts.fs, "cpu", shapes={
                                   k: v.shape[1:] for k, v in segs2.items()},
                               lead=(TP,))
    tst = ts.state_from(tsegs2, topt)
    for k in SEG_NAMES:   # the port's fsdp storage is the reference's
        np.testing.assert_array_equal(tst["params"][k].numpy(), store[k],
                                      err_msg=k)
    out = t_run(ts, tst, bs, lambda v: v.reshape((D, -1) + v.shape[1:]))
    np.testing.assert_allclose(out["loss"], want_loss, rtol=1e-5)
    np.testing.assert_allclose(np.stack(out["gnorm"]), np.stack(want_gnorm),
                               rtol=1e-4)
    for k in SEG_NAMES:
        np.testing.assert_allclose(out["params"][k],
                                   np.asarray(st["params"][k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)

    # serving: the updated shards of one pod (its D workers), both packages
    B, S, T = 2, 8, 16
    toks = bs[0]["tokens"][:B, :S + 1]
    jpre, jdec = j_make_serve_fns(cfg, jma, dp_mode="fsdp",
                                  dtype=jnp.float32, fs=fs2)
    jcache = jax.vmap(jax.vmap(
        lambda _: jmdl.init_cache(cfg, jma.ctx(jnp.float32), B, T,
                                  jnp.float32)))(jnp.zeros((TP, D)))
    both = dict(in_axes=(0, None, 0))
    jl, jcache = jax.jit(jax.vmap(jax.vmap(jpre, axis_name="data", **both),
                                  axis_name="model", **both))(
        st["params"], {"tokens": jnp.asarray(toks[:, :S])}, jcache)
    jid, _ = jax.jit(jax.vmap(jax.vmap(
        lambda p, t, c: jdec(p, t, jnp.int32(S), c), axis_name="data",
        **both), axis_name="model", **both))(
        st["params"], jnp.asarray(toks[:, S:]), jcache)
    pre, dec = make_serve_fns(tcfg, ma, dp_mode="fsdp", dtype=torch.float32)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in
               out["params"].items()}
    cache = tmdl.init_cache(tcfg, B, T, torch.float32,
                            ctx=ma.ctx(torch.float32))
    tl, cache = pre(tparams, {"tokens": torch.from_numpy(toks[:, :S].copy())},
                    cache)
    tid, _ = dec(tparams, torch.from_numpy(toks[:, S:].copy()), S, cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl[:, 0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid[:, 0]))
