"""Port parity: the chunked backward and the backward-interleaved exchange
on the sharded layouts (tp > 1 in 'dp'; 'fsdp' with and without a pod
axis), against the JAX package's step under nested ``jax.vmap``
(``model`` or ``pod`` outside, ``data`` inside), as
tests/test_torch_tp_gs_sgd.py and tests/test_torch_fsdp.py build it.

Cells, three steps each from the reference's params and ``LMStream``
batches, each run with the same exchange knobs in both packages:

- tp = 2 x data = 2, qwen3-4b smoke: buckets 2 and 4, ``bwd_chunks`` 1
  and 2, ``fuse_encode`` on and off, in four cells that take every pair
  of two knobs' values (the port-internal pins below run all eight);
- tp = 2 x data = 2 at ``bwd_chunks`` 2, buckets 2, fused: zamba2-2.7b
  smoke (the shared block, read by every cycle) and granite-moe smoke
  (the MoE aux carried from chunk to chunk);
- fsdp at pod = 2 x data = 2, yi-9b smoke, ``bwd_chunks`` 2, buckets 2,
  fused (one exchange a data shard, over the pods);
- single-pod fsdp (data = 4), ``bwd_chunks`` 2: dense and EF-free, the
  post-accumulation exchange; SGD with momentum and
  tests/test_torch_fsdp.py's single-pod tolerances (rtol 1e-4, atol
  1e-6), as that file holds the monolithic step: AdamW's division by
  sqrt(v) moves a dense step's coordinate whose gradient nearly cancels
  by a rounding-sized fraction of lr.

Held at tests/test_torch_tp_gs_sgd.py's tolerances: losses within 1e-5
relative, the global norm at 1e-4, every step's selections (the EF's zero
pattern) equal for every exchange group and bucket, the EF within 1e-6
absolute, params at rtol 1e-4, atol 2e-5.

Port-internal pins: the sharded chunked gradient (``chunked_loss_vjp``
with the gathers, in the storage layout) equals the sharded monolithic
one (``loss_fn`` on the gathered leaves, scattered) bit for bit, for
every block kind and on both layouts; the interleaved step equals the
port's bucketed step bit for bit (the exact encode makes the fused
sketch the whole-bucket one), at one chunk and at two; the spans and
``TrainStep`` report the schedule that ran. The module runs one torch
thread: on several CPU threads the ranked embedding lookup's backward (an
index accumulation over two index tensors) adds a repeated id's rows in
another order from run to run, the monolithic backward's too (about
2e-9 on ``top_s`` at a batch of 4 x 64); the H100 run of the full-width
cells found them bit-equal (PERF.md, section 6). Where the ranks' sums are
added in another order (a process mesh against the batched simulation),
tests/test_torch_mesh.py states the bound.
"""

import dataclasses

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
from repro.models.flatten import make_flat_spec as j_flat_spec
from repro.optim import make as j_opt
from repro_torch.configs import SMOKES as T_SMOKES
from repro_torch.core.gs_sgd import (MeshAxes, _gather_closures,
                                     local_seg_shapes, make_train_step)
from repro_torch.models import model as tmdl
from repro_torch.models.common import init_params
from repro_torch.models.flatten import (SEG_NAMES, make_flat_spec,
                                        params_from_numpy, shard_segs)
from repro_torch.obs.trace import Tracer
from repro_torch.optim import make as t_opt
from tests.test_torch_tp_gs_sgd import (KW, batches, buckets_of, hold,
                                        t_run)
from tests.test_tp import shard_segs as j_shard_segs

TP, D, POD = 2, 2, 2
ADAMW = ("adamw", dict(lr=2e-3))
SGDM = ("sgdm", dict(lr=5e-2, momentum=0.9))   # tests/test_torch_fsdp.py's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bkw(kw: dict) -> dict:
    return {k: kw[k] for k in ("buckets", "bwd_chunks", "fuse_encode")
            if k in kw}


def _j_tp(name: str, kw: dict) -> dict:
    """The reference's tp = 2 x data = 2 step under nested vmap."""
    cfg = J_SMOKES[name]
    opt = j_opt("adamw", lr=2e-3)
    fs2, segs2 = j_shard_segs(cfg, jax.random.PRNGKey(0), TP)
    jts = j_make_train_step(cfg, JMesh(tp=TP, data=D), opt,
                            compressor_name="gs-sgd", compressor_kw=KW,
                            remat=False, dtype=jnp.float32, fs=fs2,
                            **_bkw(kw))
    st = jax.vmap(lambda s: j_make_state(s, opt, jts.compressor,
                                         jts.d_local))(segs2)
    st = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[:, None], (TP, D) + a.shape[1:]), st)
    fn = jax.jit(jax.vmap(jax.vmap(jts.fn, in_axes=(0, 0), axis_name="data"),
                          in_axes=(0, None), axis_name="model"))
    out = {"loss": [], "gnorm": [], "ef": []}
    for gb in batches(cfg.vocab_size, D):
        st, m = fn(st, {k: jnp.asarray(v.reshape((D, -1) + v.shape[1:]))
                        for k, v in gb.items()})
        out["loss"].append(float(m["loss"][0, 0]))
        out["gnorm"].append(np.asarray(m["grad_norm"][0]))
        out["ef"].append([[np.asarray(e[r]) for e in buckets_of(st["ef"])]
                          for r in range(TP)])
    out["params"] = {k: np.asarray(v) for k, v in st["params"].items()}
    out["segs"] = {k: np.asarray(v) for k, v in segs2.items()}
    return out


def _segs1(name: str) -> dict:
    """The reference's tp = 1 flat params."""
    cfg = J_SMOKES[name]
    return {k: np.asarray(v) for k, v in j_init(
        cfg, jax.random.PRNGKey(0), 1, j_flat_spec(cfg, 1)).items()}


def _j_shard(a, j: int, n: int):
    per = a.shape[-1] // n
    return a[..., j * per:(j + 1) * per]


def _j_fsdp(name: str, kw: dict, pod: int, data: int, opt_kw) -> dict:
    """The reference's fsdp step: pod x data under nested vmap (``pod``
    outside), or one pod of ``data`` workers under one vmap."""
    cfg, segs1 = J_SMOKES[name], _segs1(name)
    P = pod * data
    opt = j_opt(opt_kw[0], **opt_kw[1])
    jma = (JMesh(tp=1, data=data, pod=pod, tp_axis=None, pod_axis="pod")
           if pod > 1 else JMesh(tp=1, data=data, tp_axis=None))
    jts = j_make_train_step(cfg, jma, opt, dp_mode="fsdp",
                            compressor_name="gs-sgd", compressor_kw=KW,
                            remat=False, dtype=jnp.float32, **_bkw(kw))
    st = [j_make_state({k: _j_shard(jnp.asarray(v), j, data)
                        for k, v in segs1.items()}, opt, jts.compressor,
                       jts.d_local) for j in range(data)]
    st = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *st)
    if pod > 1:
        st = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (pod,) + a.shape), st)
        fn = jax.jit(jax.vmap(jax.vmap(jts.fn, axis_name="data"),
                              axis_name="pod"))
        shape = (pod, data)
    else:
        fn = jax.jit(jax.vmap(jts.fn, axis_name="data"))
        shape = (data,)
    out = {"loss": [], "gnorm": [], "ef": []}
    for gb in batches(cfg.vocab_size, P, seed=9):
        st, m = fn(st, {k: jnp.asarray(v.reshape(shape + (-1,) + v.shape[1:]))
                        for k, v in gb.items()})
        out["loss"].append(float(np.asarray(m["loss"]).reshape(-1)[0]))
        out["gnorm"].append(np.asarray(m["grad_norm"]).reshape(P))
        if pod > 1:
            out["ef"].append([[np.asarray(e[:, j])
                               for e in buckets_of(st["ef"])]
                              for j in range(data)])
    out["params"] = {k: np.asarray(v).reshape((P,) + v.shape[len(shape):])
                     for k, v in st["params"].items()}
    out["segs1"] = segs1
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The reference's runs, each made once for the module."""
    cache: dict = {}

    def get(layout: str, name: str, kw: dict) -> dict:
        key = (layout, name, tuple(sorted(_bkw(kw).items())))
        if key not in cache:
            cache[key] = (_j_tp(name, kw) if layout == "tp" else
                          _j_fsdp(name, kw, POD, D, ADAMW)
                          if layout == "fsdp_pod"
                          else _j_fsdp(name, kw, 1, POD * D, SGDM))
        return cache[key]

    return get


def _t_tp(name: str, kw: dict, segs2: dict):
    ma = MeshAxes(tp=TP, data=D)
    topt = t_opt("adamw", lr=2e-3)
    ts = make_train_step(T_SMOKES[name], ma, topt, compressor_name="gs-sgd",
                         compressor_kw=KW, remat=False, dtype=torch.float32,
                         device="cpu", **_bkw(kw))
    p = params_from_numpy(segs2, ts.fs, "cpu",
                          shapes=local_seg_shapes(ts.fs, ma, "dp"),
                          lead=(TP,))
    return ts, t_run(ts, ts.state_from(p, topt),
                     batches(J_SMOKES[name].vocab_size, D),
                     lambda v: v.reshape((D, -1) + v.shape[1:]))


def _t_fsdp(name: str, kw: dict, ma: MeshAxes, segs1: dict,
            opt_kw=ADAMW):
    topt = t_opt(opt_kw[0], **opt_kw[1])
    ts = make_train_step(T_SMOKES[name], ma, topt, dp_mode="fsdp",
                         compressor_name="gs-sgd", compressor_kw=KW,
                         remat=False, dtype=torch.float32, device="cpu",
                         **_bkw(kw))
    P = ma.dp_size
    return ts, t_run(ts, ts.state_from(params_from_numpy(segs1, ts.fs,
                                                         "cpu"), topt),
                     batches(J_SMOKES[name].vocab_size, P, seed=9),
                     lambda v: v.reshape((P, -1) + v.shape[1:]))


TP_CELLS = {f"b{b}_k{k}_{'fused' if f else 'unfused'}":
            dict(buckets=b, bwd_chunks=k, fuse_encode=f)
            for b, k, f in ((2, 1, False), (2, 2, True), (4, 1, True),
                            (4, 2, False))}


@pytest.mark.parametrize("cell", list(TP_CELLS))
def test_tp2_data2_interleave_matches_nested_vmap(jax_run, cell):
    kw = TP_CELLS[cell]
    j_out = jax_run("tp", "qwen3-4b", kw)
    ts, t_out = _t_tp("qwen3-4b", kw, j_out["segs"])
    assert ts.sharded and ts.interleave and ts.bwd_chunks == kw["bwd_chunks"]
    assert [r for r, _ in ts.comp_groups] == [0, 1]
    hold(j_out, t_out, ts.comp_groups)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "granite-moe-3b-a800m"])
def test_tp2_data2_interleave_families_match_nested_vmap(jax_run, name):
    kw = dict(buckets=2, bwd_chunks=2, fuse_encode=True)
    j_out = jax_run("tp", name, kw)
    ts, t_out = _t_tp(name, kw, j_out["segs"])
    assert ts.interleave and len(ts.plan.chunks) == 2
    hold(j_out, t_out, ts.comp_groups)


def test_fsdp_pod2_data2_interleave_matches_nested_vmap(jax_run):
    kw = dict(buckets=2, bwd_chunks=2, fuse_encode=True)
    j_out = jax_run("fsdp_pod", "yi-9b", kw)
    ma = MeshAxes(tp=1, data=D, pod=POD, pod_axis="pod")
    ts, t_out = _t_fsdp("yi-9b", kw, ma, j_out["segs1"])
    assert ts.interleave and ts.comp_groups == tuple(
        (0, slice(j, POD * D, D)) for j in range(D))
    hold(j_out, t_out, ts.comp_groups)


def test_fsdp_single_pod_chunked_matches_vmap(jax_run):
    """One pod: no exchange axis, so the step is dense and EF-free; the
    chunked backward runs and the post-accumulation path takes its
    gradient (``flat_of_chunks`` in the storage layout)."""
    kw = dict(bwd_chunks=2)
    j_out = jax_run("fsdp_one", "yi-9b", kw)
    ts, t_out = _t_fsdp("yi-9b", kw, MeshAxes(tp=1, data=POD * D),
                        j_out["segs1"], SGDM)
    _, mono = _t_fsdp("yi-9b", {}, MeshAxes(tp=1, data=POD * D),
                      j_out["segs1"], SGDM)
    assert ts.compressor is None and ts.bwd_chunks == 2
    assert not ts.interleave and ts.plan is None
    np.testing.assert_allclose(t_out["loss"], j_out["loss"], rtol=1e-5)
    np.testing.assert_allclose(t_out["gnorm"], j_out["gnorm"], rtol=1e-4)
    assert t_out["loss"] == mono["loss"]   # the port's monolithic step
    for k in SEG_NAMES:
        np.testing.assert_allclose(t_out["params"][k], j_out["params"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(t_out["params"][k], mono["params"][k])


# ---------------------------------------------------------------------------
# Port-internal pins
# ---------------------------------------------------------------------------


GRAD_CASES = [("qwen3-4b", 2, 1, "dp", 2), ("qwen3-4b", 2, 2, "fsdp", 2),
              ("yi-9b", 1, 2, "fsdp", 2), ("zamba2-2.7b", 2, 1, "dp", 2),
              ("zamba2-2.7b", 2, 2, "fsdp", 3),
              ("granite-moe-3b-a800m", 2, 1, "dp", 2),
              ("rwkv6-7b", 2, 1, "dp", 2),
              ("llama-3.2-vision-11b", 2, 1, "dp", 2)]


def _deeper(name: str):
    """The smoke config with four cycles (zamba2: 3 of its blocks a
    cycle; the vlm: 5), so that a chunk holds several cycles, the shared
    block's gradient more than two terms and the remat two sqrt-n
    groups."""
    cfg = T_SMOKES[name]
    per = len(cfg.cycle) - cfg.cycle.count("shared_attn")
    return dataclasses.replace(cfg, n_layers=4 * per)


@pytest.mark.parametrize("name,tp,data,mode,chunks", GRAD_CASES)
def test_sharded_chunked_gradient_equals_monolithic(name, tp, data, mode,
                                                    chunks):
    """One gather group: its storage (tp, n, *local), n = data workers
    sharing the gathered leaves in 'fsdp'. The chunked backward's
    gradients, each chunk's scattered at its step and the top's once,
    against ``loss_fn`` on the gathered leaves (each worker seeded 1/tp,
    their gradients accumulated on the leaves) scattered: bit for bit,
    and the losses too."""
    cfg = _deeper(name)
    fs = make_flat_spec(cfg, tp)
    glob = init_params(cfg, torch.Generator().manual_seed(0), tp)
    segs = (shard_segs(cfg, glob, tp, fs)[1] if tp > 1
            else {k: v[None] for k, v in fs.flatten(glob).items()})
    ma = MeshAxes(tp=tp, data=data)
    gather, scatter = _gather_closures(ma, mode)
    store = {k: v[:, None] for k, v in segs.items()}
    if mode == "fsdp":
        store = scatter(gather(store), data)
    n = store["top_s"].shape[1]
    ctx = ma.ctx(torch.float32)
    gen = torch.Generator().manual_seed(3)
    wbs = []
    for _ in range(n):
        t = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        wb = {"tokens": t, "labels": t}
        if cfg.family == "vlm":
            wb["cross_kv"] = 0.02 * torch.randn(
                (2, cfg.n_cross_tokens, cfg.d_model), generator=gen)
        wbs.append(wb)
    use = {k: v.detach().requires_grad_() for k, v in gather(store).items()}
    want_loss = []
    for wb in wbs:
        with torch.enable_grad():
            loss = (1.0 / tp) * tmdl.loss_fn(cfg, fs, use, wb,
                                             dtype=torch.float32, ctx=ctx)
            loss.sum().backward()
        want_loss.append(loss.detach())
    want = scatter({k: v.grad for k, v in use.items()}, n)
    loss, steps, top = tmdl.chunked_loss_vjp(
        cfg, fs, store, wbs, chunks=chunks, dtype=torch.float32, ctx=ctx,
        gathers=(gather, scatter), grad_seed=1.0 / tp)
    assert len(steps) == chunks
    got = {k: torch.full_like(v, float("nan")) for k, v in want.items()}
    spans = []
    for s in steps:
        (a, b), d_cs, d_cr = s()
        spans.append((a, b))
        assert d_cs.shape == want["cycles_s"][:, :, a:b].shape
        got["cycles_s"][:, :, a:b], got["cycles_r"][:, :, a:b] = d_cs, d_cr
    assert spans == sorted(spans, reverse=True)
    got["top_s"], got["top_r"] = top()
    for k in SEG_NAMES:
        assert torch.equal(got[k], want[k]), k
    for j in range(n):
        assert torch.equal((1.0 / tp) * loss[j], want_loss[j])


STEP_CASES = {
    "tp2_b4": ("qwen3-4b", MeshAxes(tp=TP, data=D), "dp", 4),
    "fsdp_pod": ("yi-9b", MeshAxes(tp=1, data=D, pod=POD, pod_axis="pod"),
                 "fsdp", 2),
    "fsdp_tp2_pod": ("qwen3-4b", MeshAxes(tp=TP, data=D, pod=POD,
                                          pod_axis="pod"), "fsdp", 2),
}


def _port_steps(name, ma, mode, kw, steps=2, trace=False):
    cfg = T_SMOKES[name]
    topt = t_opt("adamw", lr=2e-3)
    ts = make_train_step(cfg, ma, topt, dp_mode=mode, compressor_name="gs-sgd",
                         compressor_kw=KW, remat=False, dtype=torch.float32,
                         device="cpu", **kw)
    st = ts.init_state(topt, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    losses, tr = [], Tracer()
    for s in range(steps):
        t = torch.randint(0, cfg.vocab_size, (2 * ma.dp_size, 16),
                          generator=gen)
        if trace and s == steps - 1:
            with tr.activate():
                st, m = ts.fn(st, ts.shard({"tokens": t, "labels": t}))
        else:
            st, m = ts.fn(st, ts.shard({"tokens": t, "labels": t}))
        losses.append(float(m["loss"]))
    return ts, st, losses, tr


def _same_state(a: dict, b: dict) -> None:
    for k in SEG_NAMES:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for ga, gb in zip(a["ef"], b["ef"]):
        for x, y in zip(ga, gb):
            assert torch.equal(x, y)


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("chunks,fuse", [(1, False), (2, False), (2, True)])
def test_sharded_interleave_equals_bucketed_bit_for_bit(case, chunks, fuse):
    """One chunk: the interleave's readiness loop runs the bucketed
    exchange's ops (the reference pins this at tp = 1); two chunks and the
    fused encode: the same, since each bucket's chain is the bucketed
    one's and the exact encode makes the merged fragments the whole
    bucket's sketch."""
    name, ma, mode, b = STEP_CASES[case]
    _, base, lb, _ = _port_steps(name, ma, mode, dict(buckets=b))
    ts, st, li, _ = _port_steps(name, ma, mode, dict(
        buckets=b, bwd_chunks=chunks, fuse_encode=fuse))
    assert ts.interleave and ts.bwd_chunks == chunks
    assert li == lb
    _same_state(st, base)


def test_sharded_interleave_spans_report_the_chunked_schedule():
    """tp = 2 x data = 2, buckets 4, two chunks, fused: the step runs the
    chunked forward and backward (no ``loss_and_grad``), each chunk's
    backward under ``backward/chunk{j}``, the top's under
    ``backward/top``, every bucket's encode, all-reduce and recovery a
    model rank (two exchange groups), the readiness instants in the
    plan's order, interleaved with the backward."""
    ts, _, _, tr = _port_steps("qwen3-4b", MeshAxes(tp=TP, data=D), "dp",
                               dict(buckets=4, bwd_chunks=2,
                                    fuse_encode=True), steps=1, trace=True)
    assert ts.interleave and ts.bwd_chunks == 2 and ts.fuse_encode
    # the phases' spans (the port's detail spans nest inside them)
    names = [e["name"] for e in tr.events
             if e["ph"] == "X" and e["cat"] != "detail"]
    assert "loss_and_grad" not in names and "backward" not in names
    assert names[0] == "forward" and names[-1] == "optimizer"
    bwd = [x for x in names if x.startswith("backward")]
    assert bwd == ["backward/chunk0", "backward/chunk1", "backward/top"]
    n = ts.n_buckets
    for i in range(n):
        assert names.count(f"allreduce/b{i}") == TP
        assert names.count(f"recover/b{i}") == TP
    ready = [e["args"]["bucket"] for e in tr.events if e["ph"] == "i"
             and e["name"].startswith("ready/")]
    assert ready == list(ts.plan.order)
    # a bucket complete at the first event is all-reduced (for both
    # ranks) before the second chunk's backward runs
    early = [i for i in range(n) if ts.plan.readiness[i] == 0]
    assert early
    first = names.index("backward/chunk1")
    assert names[:first].count(f"allreduce/b{early[0]}") == TP


def test_sharded_post_accumulation_reports_chunked():
    """Without the pipelined schedule (overlap off) the chunked backward
    still runs, its gradient assembled after it (``backward``) and the
    bucketed exchange after that: equal to the monolithic step."""
    ma = MeshAxes(tp=TP, data=D)
    _, base, lb, _ = _port_steps("qwen3-4b", ma, "dp",
                                 dict(buckets=2, overlap=False))
    ts, st, lc, tr = _port_steps("qwen3-4b", ma, "dp",
                                 dict(buckets=2, bwd_chunks=2,
                                      overlap=False), trace=True)
    assert ts.bwd_chunks == 2 and not ts.interleave
    names = [e["name"] for e in tr.events
             if e["ph"] == "X" and e["cat"] != "detail"]
    assert names[:2] == ["forward", "backward"]
    assert "loss_and_grad" not in names
    assert lc == lb
    _same_state(st, base)
