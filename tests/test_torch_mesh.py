"""The port's train and serve steps on a real process mesh: one model rank
and one data-parallel worker a process, gloo over a ``FileStore`` on the
CPU (``repro_torch.launch.mesh.spawn``; the rank bodies are in
tests/torch_mesh_ranks.py). Four worlds (2, 3, 4 and 8 processes) each
run several cases, every case on a mesh of its own with the reference's
axis names ('pod', 'data', 'model').

Held against the port's simulated layout (the same ``MeshAxes`` sizes
without a mesh, from the same params and batches), rank by rank:

- (a) the reference test's own case (tests/test_shard_map_mesh.py):
  qwen3-4b smoke, SGD with momentum, dense exchange, (2, 2, 2), 3 steps
  from the reference's ``shard_segs`` params and batch (the other cases
  take 2 steps of seeded batches): losses within
  2e-4 of the reference's vmap dp = 4 losses (its test's bound) and
  within 1e-6 relative of the port's simulated tp = 2 x P = 4 step (the
  ranks' shares of a replicated leaf's gradient and the four workers'
  sum are all-reduced in another order than the simulation adds them);
- (b) gs-SGD psum at P = 2, buckets 2, with a straggler mask at the
  second step (one flag a process), and the backward interleave (2
  chunks, the fused encode): losses, params and EF bit-equal (every sum
  is two-way);
- (c) the Alg. 1 tree at P = 4 and P = 3 (parking): the tree all-reduce
  itself bit-equal to the simulation's (signed zeros included: a rank
  that receives nothing adds where(mask, x, 0), as the simulation's
  rows do); the step bit-equal: losses, params and EF (the second
  round's exact values are one psum over P workers, which the mesh adds
  as an ordered all-reduce in the simulation's worker order,
  ``core.pgroup.fold_sum``); and at P = 4 with microbatch slices and
  the global-norm clip (the norm's per-worker partial computed by the
  call a process makes on its own row): bit-equal too;
- (c') the psum all-reduce at P = 3 and 4 (an ordered all-reduce, as
  every sum over more than two processes) bit-equal to the
  simulation's left fold of the rows, on rows whose sum depends on the
  order;
- (d) gTop-k at P = 4: bit-equal (every merge is pairwise);
- (e) fsdp at pod = 2 x data = 2 (the gathers over 'data', the
  reduce-scatter, gs-SGD over 'pod'): bit-equal; and at tp = 2 in the
  8-process world (the replicated segments over ('data', 'model')):
  selections equal, losses and params within 1e-6 relative;
- (e') the chunked backward and the backward-interleaved exchange at
  tp = 2 x data = 2 (buckets 2, 2 chunks, the fused encode): each
  process bit-equal (losses, params, EF every step) to the simulated
  step run with the rank-stacked kernels one rank at a time
  (``launch.mesh.per_rank_kernels``, rounded as the processes round);
  against the plain simulation the losses, the selections every step
  and the model-sharded segments bit-equal, the replicated ones (the
  norm gains, whose gradient the simulation sums over every rank's rows
  in one reduction) within 1e-6 relative; every process issues the same
  collectives in the same order, the top segments' reduce-scatter once
  a step and each chunk's rows' at its chunk;
- (f) serving at tp = 2 for qwen3-4b, starcoder2-3b (replicated KV),
  rwkv6-7b, zamba2-2.7b and granite-moe-3b-a800m smoke: each rank's
  prefill logits shard and decode ids equal to the simulated rank's.

Every process's initial state equals ``launch.specs.local_of`` of the
global params at its coordinates. A step whose sizes differ from its
mesh's (an elastic re-plan) raises, and a rank that asks for a card
where none is visible raises.
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
from repro.models.flatten import init_flat_params as j_init_flat_params
from repro.optim import make as j_opt
from repro_torch.configs import SMOKES as T_SMOKES
from repro_torch.core import allreduce as ar
from repro_torch.core import pgroup
from repro_torch.core.gs_sgd import MeshAxes, make_serve_fns
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tsp
from repro_torch.models import model as tmdl
from repro_torch.models.common import init_params
from repro_torch.models.flatten import SEG_NAMES, make_flat_spec, shard_segs
from tests.test_tp import shard_segs as j_shard_segs
from tests.torch_mesh_ranks import (build_step, run_cases, run_steps,
                                    train_params)

AXES = ("pod", "data", "model")
GS_KW = dict(k=2048, rows=5, width=4096)
ADAMW = ("adamw", dict(lr=2e-3))
SIM_RTOL = 1e-6
REF_TOL = 2e-4          # tests/test_shard_map_mesh.py's bound
SERVE_ARCHS = ("qwen3-4b", "starcoder2-3b", "rwkv6-7b", "zamba2-2.7b",
               "granite-moe-3b-a800m")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(vocab: int, gb: int, steps: int = 2, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        t = rng.integers(0, vocab, (gb, 16)).astype(np.int64)
        out.append({"tokens": t, "labels": t})
    return out


def train(shape, arch="qwen3-4b", kw=None, opt=ADAMW, dp_mode="dp",
          params=None, data=None, include=None) -> dict:
    """A train case: the port's init at tp (seeded) unless ``params``."""
    pod, dpar, tp = shape
    cfg = T_SMOKES[arch]
    case = dict(kind="train", shape=shape, axes=AXES, arch=arch, opt=opt,
                kw=kw if kw is not None else dict(compressor_kw=GS_KW,
                                                  buckets=2),
                dp_mode=dp_mode, include=include)
    if params is None:
        g = init_params(cfg, torch.Generator().manual_seed(0), tp)
        fs = build_step(case, sim_ma(shape))[1].fs
        params = {k: v.numpy() for k, v in
                  (shard_segs(cfg, g, tp, fs)[1] if tp > 1
                   else fs.flatten(g)).items()}
    case["params"] = params
    case["batches"] = data or batches(cfg.vocab_size, 2 * pod * dpar)
    return case


def tree(p: int) -> dict:
    """Rows with signed zeros and values whose sum depends on the order."""
    rng = np.random.default_rng(p)
    x = rng.standard_normal((p, 64)).astype(np.float32) * np.float32(1e3)
    x[:, :8] = -0.0
    x[0, 8:16] = 1e8
    x[1, 8:16] = 1.0
    return dict(kind="tree", shape=(1, p, 1), axes=AXES, x=x)


def serve(arch: str, **wire) -> dict:
    cfg = T_SMOKES[arch]
    fs = make_flat_spec(cfg, 2)
    segs = shard_segs(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                       2), 2, fs)[1]
    rng = np.random.default_rng(1)
    return dict(kind="serve", shape=(1, 1, 2), axes=AXES, arch=arch,
                params={k: v.numpy() for k, v in segs.items()},
                tokens=rng.integers(0, cfg.vocab_size, (2, 8)),
                feed=[rng.integers(0, cfg.vocab_size, (2, 1))
                      for _ in range(2)], t_cache=16, **wire)


def sim_ma(shape) -> MeshAxes:
    pod, data, tp = shape
    return MeshAxes(tp=tp, data=data, pod=pod, tp_axis="model",
                    data_axis="data", pod_axis="pod")


def ref_case_222() -> tuple[dict, list]:
    """The reference test's (2, 2, 2) case and its vmap dp = 4 losses."""
    cfg = J_SMOKES["qwen3-4b"]
    key = jax.random.PRNGKey(0)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                         cfg.vocab_size))
    gb = {"tokens": toks, "labels": toks}
    opt = j_opt("sgdm", lr=5e-2, momentum=0.9)
    ts = j_make_train_step(cfg, JMesh(tp=1, data=4, tp_axis=None,
                                      data_axis="data"), opt,
                           dp_mode="dp", compressor_name="dense",
                           remat=False, dtype=jnp.float32)
    st = j_make_state(j_init_flat_params(cfg, key, 1, ts.fs), opt,
                      ts.compressor, ts.d_local)
    st = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (4,) + a.shape), st)
    vb = {k: jnp.asarray(v.reshape((4, 1) + v.shape[1:]))
          for k, v in gb.items()}
    fn = jax.jit(jax.vmap(ts.fn, axis_name="data"))
    ref = []
    for _ in range(3):
        st, m = fn(st, vb)
        ref.append(float(m["loss"][0]))
    _, segs2 = j_shard_segs(cfg, key, 2)
    case = train((2, 2, 2), kw=dict(compressor_name="dense"),
                 opt=("sgdm", dict(lr=5e-2, momentum=0.9)),
                 params={k: np.asarray(v) for k, v in segs2.items()},
                 data=[gb] * 3)
    return case, ref


WORLDS = {
    2: lambda: {"psum2": train((1, 2, 1), include=[None, [True, False]]),
                "interleave2": train((1, 2, 1), kw=dict(
                    compressor_kw=GS_KW, buckets=2, bwd_chunks=2,
                    fuse_encode=True)),
                **{f"serve_{a}": serve(a) for a in SERVE_ARCHS},
                "serve_fp8": serve("qwen3-4b", dtype=torch.bfloat16,
                                   comm=torch.float8_e4m3fn)},
    3: lambda: {"tree3_raw": tree(3),
                "psum3_raw": dict(tree(3), kind="psum"),
                "tree3": train((1, 3, 1), kw=dict(
                    compressor_kw=dict(GS_KW, allreduce_mode="tree"),
                    buckets=2))},
    4: lambda: {"tree4_raw": tree(4),
                "psum4_raw": dict(tree(4), kind="psum"),
                "tree4": train((1, 4, 1), kw=dict(
                    compressor_kw=dict(GS_KW, allreduce_mode="tree"),
                    buckets=2)),
                "tree4_mb_clip": train((1, 4, 1), kw=dict(
                    compressor_kw=dict(GS_KW, allreduce_mode="tree"),
                    buckets=2, microbatch=1, clip_norm=0.5)),
                "gtopk4": train((1, 4, 1), kw=dict(
                    compressor_name="gtopk", compressor_kw=dict(k=2048))),
                "fsdp": train((2, 2, 1), arch="yi-9b", dp_mode="fsdp"),
                "tp_interleave": train((1, 2, 2), kw=dict(
                    compressor_kw=GS_KW, buckets=2, bwd_chunks=2,
                    fuse_encode=True))},
    8: lambda: {"fsdp_tp": train((2, 2, 2), dp_mode="fsdp")},
}


_RUNS: dict = {}


def world(n: int) -> dict:
    """{case name: (case, [each rank's result])}, spawned once a world."""
    if n not in _RUNS:
        cases = WORLDS[n]()
        ref = None
        if n == 8:
            cases["ref222"], ref = ref_case_222()
        names = list(cases)
        res = tmesh.spawn(run_cases, n, [cases[k] for k in names],
                          device_type="cpu", timeout_s=300)
        _RUNS[n] = {k: (cases[k], [r[i] for r in res])
                    for i, k in enumerate(names)}
        _RUNS[n]["_ref"] = ref
    return _RUNS[n]


def sim_train(case: dict) -> tuple:
    """The simulated step's run of a train case (include masks whole)."""
    ma = sim_ma(case["shape"])
    opt, ts = build_step(case, ma)
    state = ts.state_from(train_params(case, ts, ma), opt)
    return ts, run_steps(ts, state, case["batches"], case.get("include"))[1]


def _buckets(ef) -> tuple:
    return ef if isinstance(ef, tuple) else (ef,)


def sim_rows(ts, out: dict, r: int, w: int) -> dict:
    """The simulation's state of model rank ``r``, worker ``w``."""
    ma = ts.ma
    params = {k: v[r, w] if ma.tp > 1 else v[w]
              for k, v in out["params"].items()}
    if not ts.comp_groups:
        efs = [[b[w] for b in _buckets(e)] for e in out["ef"]]
    else:
        g, i = ((r, w) if ts.dp_mode == "dp" else
                (r * ma.data + w % ma.data, w // ma.data))
        efs = [[b[i] for b in _buckets(e[g])] for e in out["ef"]]
    return {"params": params, "ef": efs}


def mesh_rows(ts, out: dict) -> dict:
    params = {k: v[0, 0] if ts.ma.tp > 1 else v[0]
              for k, v in out["params"].items()}
    efs = [[b[0] for b in _buckets(e if not ts.comp_groups else e[0])]
           for e in out["ef"]]
    return {"params": params, "ef": efs}


def each_rank(n: int, name: str):
    """(sim ts, sim out, [(mesh out, sim rows, mesh rows)]) of a case."""
    case, res = world(n)[name]
    ts, sim = sim_train(case)
    rows = []
    for out in res:
        r, w = out["coords"]["model"], out["worker"]
        rows.append((out, sim_rows(ts, sim, r, w), mesh_rows(ts, out)))
    return ts, sim, rows


def assert_bits(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    assert a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32)), what


def hold_bit_equal(n: int, name: str) -> None:
    ts, sim, rows = each_rank(n, name)
    for out, s, m in rows:
        assert out["loss"] == sim["loss"], (out["loss"], sim["loss"])
        for k in SEG_NAMES:
            assert_bits(m["params"][k], s["params"][k], k)
        for step, (me, se) in enumerate(zip(m["ef"], s["ef"])):
            for b, (x, y) in enumerate(zip(me, se)):
                assert_bits(x, y, f"EF step {step} bucket {b}")


def hold_close(n: int, name: str, first_bits: bool) -> None:
    """Selections equal every step; losses and params within SIM_RTOL;
    with ``first_bits`` the first step's loss and EF bit-equal."""
    ts, sim, rows = each_rank(n, name)
    for out, s, m in rows:
        np.testing.assert_allclose(out["loss"], sim["loss"], rtol=SIM_RTOL)
        for step, (me, se) in enumerate(zip(m["ef"], s["ef"])):
            for b, (x, y) in enumerate(zip(me, se)):
                assert torch.equal(x == 0, y == 0), (step, b)
                if first_bits and step == 0:
                    assert_bits(x, y, f"EF step 0 bucket {b}")
        if first_bits:
            assert out["loss"][0] == sim["loss"][0]
        for k in SEG_NAMES:
            np.testing.assert_allclose(m["params"][k], s["params"][k],
                                       rtol=SIM_RTOL, atol=SIM_RTOL, err_msg=k)


def test_reference_case_222_matches_reference_and_simulation():
    case, res = world(8)["ref222"]
    ref = world(8)["_ref"]
    _, sim = sim_train(case)
    for out in res:
        np.testing.assert_allclose(out["loss"], ref, rtol=REF_TOL,
                                   atol=REF_TOL)
        np.testing.assert_allclose(out["loss"], sim["loss"], rtol=SIM_RTOL)
        assert out["loss"] == res[0]["loss"]   # every rank reports one loss


@pytest.mark.parametrize("name", ["psum2", "interleave2"])
def test_gs_sgd_p2_bit_equal(name):
    hold_bit_equal(2, name)


@pytest.mark.parametrize("p", [3, 4])
def test_tree_allreduce_bit_equal(p):
    case, res = world(p)[f"tree{p}_raw"]
    x = torch.from_numpy(case["x"])
    want = ar.tree_allreduce(x, p)
    for out in res:
        assert_bits(out["y"][0], want[out["worker"]], f"worker "
                    f"{out['worker']}")


@pytest.mark.parametrize("p", [3, 4])
def test_ordered_psum_bit_equal_left_fold(p):
    """A sum over p > 2 processes (all-to-all, a left fold in group order,
    all-gather) is the simulation's ``psum_allreduce``: the left fold of
    the rows in worker order, bit for bit, on rows whose sum depends on
    the order (signed zeros, 1e8 + 1)."""
    case, res = world(p)[f"psum{p}_raw"]
    x = torch.from_numpy(case["x"])
    want = ar.psum_allreduce(x, p)
    assert_bits(want[0], pgroup.fold_sum(x), "simulation")
    for out in res:
        assert_bits(out["y"][0], want[out["worker"]], f"worker "
                    f"{out['worker']}")


@pytest.mark.parametrize("kind", ["tree", "psum"])
@pytest.mark.parametrize("p", [3, 4])
def test_wire_counter_matches_the_simulation(kind, p):
    """Each process counts its collectives where they run (``pgroup``'s,
    a permute a tree round, one all-reduce for the ordered sum) as the
    simulation counts the worker axis's: the same calls and one worker's
    row of payload each."""
    case, res = world(p)[f"{kind}{p}_raw"]
    x = torch.from_numpy(case["x"])
    before = dict(pgroup.WIRE)
    (ar.tree_allreduce if kind == "tree" else ar.psum_allreduce)(x, p)
    want = {k: v - before[k] for k, v in pgroup.WIRE.items()}
    assert want["bytes"] == want["calls"] * x[0].numel() * x.element_size()
    for out in res:
        assert out["wire"] == want, f"worker {out['worker']}"


@pytest.mark.parametrize("p", [3, 4])
def test_tree_step_matches_simulation(p):
    hold_bit_equal(p, f"tree{p}")


def test_tree_step_microbatch_clip_bit_equal():
    hold_bit_equal(4, "tree4_mb_clip")


def test_gtopk_p4_bit_equal():
    hold_bit_equal(4, "gtopk4")


def test_tp2_interleave_bit_equal_to_the_per_rank_simulation():
    case, res = world(4)["tp_interleave"]
    with tmesh.per_rank_kernels(2):
        ts, sim = sim_train(case)
    assert ts.bwd_chunks == 2 and ts.interleave and ts.sharded
    for out in res:
        s, m = sim_rows(ts, sim, out["coords"]["model"], out["worker"]), \
            mesh_rows(ts, out)
        assert out["loss"] == sim["loss"], (out["loss"], sim["loss"])
        for k in SEG_NAMES:
            assert_bits(m["params"][k], s["params"][k], k)
        for step, (me, se) in enumerate(zip(m["ef"], s["ef"])):
            for b, (x, y) in enumerate(zip(me, se)):
                assert_bits(x, y, f"EF step {step} bucket {b}")


def test_tp2_interleave_against_the_batched_simulation():
    """The plain simulation batches the ranks: a replicated norm gain's
    gradient is one reduction over every rank's rows there, a process's
    own rows plus the two-way all-reduce on the mesh. Everything else is
    bit-equal."""
    ts, sim, rows = each_rank(4, "tp_interleave")
    for out, s, m in rows:
        assert out["loss"] == sim["loss"], (out["loss"], sim["loss"])
        for step, (me, se) in enumerate(zip(m["ef"], s["ef"])):
            for b, (x, y) in enumerate(zip(me, se)):
                assert torch.equal(x == 0, y == 0), (step, b)
        for k in SEG_NAMES:
            if k.endswith("_s"):
                assert_bits(m["params"][k], s["params"][k], k)
            np.testing.assert_allclose(m["params"][k], s["params"][k],
                                       rtol=SIM_RTOL, atol=SIM_RTOL, err_msg=k)


def test_tp2_interleave_collectives_in_one_order():
    """Every process issues the same collectives in the same order (a
    mismatch deadlocks NCCL): per step the top segments' replicated
    slices gathered and reduce-scattered over ``model`` once, each
    chunk's rows gathered in the forward and reduce-scattered in its
    backward step, then the exchange over the dp axes."""
    case, res = world(4)["tp_interleave"]
    seqs = [out["collectives"] for out in res]
    assert all(q == seqs[0] for q in seqs[1:])
    steps = len(case["batches"])
    rs = [c for c in seqs[0] if c[0] == "reduce-scatter"]
    assert len(rs) == steps * (2 + 1) and all(c[1] == ("model",) for c in rs)
    gathers = [c for c in seqs[0] if c[0] == "all-gather"
               and c[1] == ("model",)]
    assert len(gathers) == steps * (1 + 2)
    ex = [i for i, c in enumerate(seqs[0]) if c[1] == ("pod", "data")
          and c[0] == "all-reduce"]
    # each step's sketch and value all-reduces: two buckets
    assert len(ex) == steps * 4


def test_fsdp_pod2_data2_bit_equal():
    hold_bit_equal(4, "fsdp")


def test_fsdp_tp2_pod2_data2_matches_simulation():
    hold_close(8, "fsdp_tp", first_bits=False)


@pytest.mark.parametrize("n,name", [(2, "psum2"), (4, "fsdp"),
                                    (8, "fsdp_tp"), (8, "ref222")])
def test_initial_state_is_local_of_global_params(n, name):
    case, res = world(n)[name]
    ma = sim_ma(case["shape"])
    opt, ts = build_step(case, ma)
    one = train_params(case, ts, ma)   # rank-stacked at tp > 1
    glob = {k: (v.movedim(0, -2).reshape(v.shape[1:-1] + (-1,))
                if ma.tp > 1 else v) for k, v in one.items()}
    specs = tsp.param_specs_global(ts.fs, ma, case["dp_mode"])
    for out in res:
        want = tsp.local_of(glob, specs, ma, out["coords"])
        for k in SEG_NAMES:
            got = out["params0"][k]
            got = got[0, 0] if ma.tp > 1 else got[0]
            assert torch.equal(got, want[k]), (k, out["coords"])


@pytest.mark.parametrize("key", [f"serve_{a}" for a in SERVE_ARCHS]
                         + ["serve_fp8"],
                         ids=list(SERVE_ARCHS) + ["qwen3-4b-fp8"])
def test_serve_tp2_matches_simulation(key):
    """Each rank's logits shard and ids bit-equal to the simulated tp = 2
    serve's; ``serve_fp8``: bf16 with the fp8 wire, whose payloads and
    scales the ranks all-gather (as bytes) and sum in rank order."""
    case, res = world(2)[key]
    cfg = T_SMOKES[case["arch"]]
    dtype, comm = case.get("dtype", torch.float32), case.get("comm")
    ma = MeshAxes(tp=2, data=1, data_axis=None)
    pre, dec = make_serve_fns(cfg, ma, dtype=dtype, comm_dtype=comm)
    segs = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    tokens = torch.from_numpy(case["tokens"])
    cache = tmdl.init_cache(cfg, 2, case["t_cache"], dtype,
                            ctx=ma.ctx(dtype, comm))
    logits, cache = pre(segs, {"tokens": tokens}, cache)
    ids, kv = [], tokens.shape[1]
    for t in case["feed"]:
        tok, cache = dec(segs, torch.from_numpy(t), kv, cache)
        ids.append(tok)
        kv += 1
    for out in res:
        r = out["coords"]["model"]
        assert torch.equal(out["logits"][0], logits[r])
        for a, b in zip(out["ids"], ids):
            assert torch.equal(a[0], b[r])


def test_step_on_a_mesh_of_other_sizes_raises():
    class Mesh:   # a mesh of 2 data-parallel processes
        def size(self, name):
            return {"data": 2}.get(name, 1)

    with pytest.raises(ValueError, match="elastic re-plan"):
        build_step(train((1, 3, 1), params={}, data=[{}]),
                   MeshAxes(tp=1, data=3, mesh=Mesh()))


def test_rank_without_its_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.transport(2, 2, "cuda")
    with pytest.raises(RuntimeError, match="cannot reach"):
        tmesh.rank_device(0, 2, "cuda")


@pytest.mark.parametrize("world,local_world,want", [
    (4, 4, "nccl"),        # one host, a card a rank
    (8, 8, "gloo"),        # one host, two ranks a card
    (256, 4, "nccl"),      # 64 hosts of 4 ranks, a card a rank
    (256, 8, None),        # several hosts, ranks outnumber a host's cards
])
def test_transport_follows_the_ranks_on_each_host(monkeypatch, world,
                                                  local_world, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    if want is None:
        with pytest.raises(RuntimeError, match="several hosts"):
            tmesh.transport(world, local_world, "cuda")
    else:
        assert tmesh.transport(world, local_world, "cuda") == want
    assert tmesh.rank_device(world - 1, local_world, "cuda") == \
        torch.device("cuda", (local_world - 1) % 4)
