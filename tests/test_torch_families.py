"""Port parity: the model zoo's other families (MoE, RWKV6, the Mamba2 +
shared-attention hybrid, the vlm's cross-attention, musicgen), their
configs and flat layouts, and the cross-attention and parallel blocks.

Both packages start from the JAX package's flat init (exported as numpy,
carried over by ``params_from_numpy``) or from seeded numpy arrays, and
take the same inputs. Tolerances (those of tests/test_torch_model.py):
outputs, losses and aux at rtol 1e-5 (atol 1e-6 for block outputs, whose
entries may sit near 0); gradients at rtol 1e-4 / atol 1e-6. The gs-SGD
steps are held as tests/test_torch_dense_configs.py holds the dense
configs: losses at rtol 1e-4, the EF zero pattern (the selected
coordinates) equal every step, EF and params at rtol 1e-4 / atol 1e-6.

The helpers here (``block_parity``, ``params_np``, ``assert_steps_match``)
serve tests/test_torch_moe.py, tests/test_torch_rwkv.py and
tests/test_torch_mamba.py too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconf
from repro.api import RunSpec as JSpec
from repro.launch.train import build as j_build
from repro.models import layers as jlay
from repro.models import model as jmdl
from repro.models.common import ShardCtx
from repro.models.common import init_params as j_init_params
from repro.models.flatten import bucket_sizes as j_bucket_sizes
from repro.models.flatten import init_flat_params as j_init
from repro.models.flatten import make_flat_spec as j_fs
from repro_torch import configs as tconf
from repro_torch.api import RunSpec as TSpec
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlay
from repro_torch.models import model as tmdl
from repro_torch.models.flatten import (SEG_NAMES, bucket_sizes,
                                        make_flat_spec, params_from_numpy)
from tests.test_torch_gs_sgd import SPEC, _run

CTX = ShardCtx(dtype=jnp.float32)
NEW = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "rwkv6-7b",
       "zamba2-2.7b", "llama-3.2-vision-11b", "musicgen-large")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread, as the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def params_np(cfg, kind: str, seed: int) -> dict:
    """One block's params (the reference's init of the whole model, cycle
    0, occurrence 0 of ``kind``), as numpy, with every zero-init leaf
    replaced by a small seeded draw so each leaf's gradient is exercised."""
    tree = j_init_params(cfg, jax.random.PRNGKey(seed), 1)
    sub = jax.tree_util.tree_map(lambda a: np.asarray(a[0, 0]),
                                 tree["layers"][kind])
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (a if np.any(a) else
                   (0.1 * rs.randn(*a.shape)).astype(np.float32)), sub)


def _t_tree(tree):
    if isinstance(tree, dict):
        return {k: _t_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_()


def _t_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _t_leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def block_parity(jfn, tfn, args: dict, seed: int = 0,
                 out_tol=(1e-5, 1e-6), grad_tol=(1e-4, 1e-6)):
    """``jfn(**jax args)`` and ``tfn(**torch args)`` (each returning one
    array or a tuple) on the same numpy ``args`` (arrays or nested dicts of
    them): the outputs at ``out_tol``, then the gradients of every arg
    under the same seeded cotangents at ``grad_tol``. Returns the port's
    outputs (detached)."""
    j_args = jax.tree_util.tree_map(jnp.asarray, args)
    j_out, vjp = jax.vjp(jax.jit(lambda a: jfn(**a)), j_args)
    t_args = {k: _t_tree(v) for k, v in args.items()}
    t_out = tfn(**t_args)
    j_outs = j_out if isinstance(j_out, tuple) else (j_out,)
    t_outs = t_out if isinstance(t_out, tuple) else (t_out,)
    assert len(j_outs) == len(t_outs)
    rs = np.random.RandomState(seed)
    cots = [np.asarray(rs.randn(*np.shape(o)), np.float32) for o in j_outs]
    for i, (jo, to) in enumerate(zip(j_outs, t_outs)):
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                                   rtol=out_tol[0], atol=out_tol[1],
                                   err_msg=f"output {i}")
    (j_g,) = vjp(tuple(jnp.asarray(c) for c in cots)
                 if isinstance(j_out, tuple) else jnp.asarray(cots[0]))
    t_leaves = [leaf for k in sorted(t_args)
                for leaf in _t_leaves(t_args[k], (k,))]
    grads = torch.autograd.grad(
        t_outs, [v for _, v in t_leaves],
        grad_outputs=[torch.from_numpy(c) for c in cots], allow_unused=True)
    j_leaves = dict(jax.tree_util.tree_flatten_with_path(j_g)[0])
    j_by_path = {tuple(getattr(k, "key", k) for k in path): v
                 for path, v in j_leaves.items()}
    for (path, _), g in zip(t_leaves, grads):
        want = np.asarray(j_by_path[path])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=grad_tol[0],
                                   atol=grad_tol[1], err_msg=str(path))
    return tuple(o.detach() for o in t_outs)


def smoke_batch(cfg, b: int, s: int, seed: int, cross: bool = False) -> dict:
    rs = np.random.RandomState(seed)
    seq = rs.randint(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    batch["labels"][0, -2:] = -1  # ignored positions
    if cross:
        batch["cross_kv"] = rs.randn(b, cfg.n_cross_tokens,
                                     cfg.d_model).astype(np.float32)
    return batch


def loss_parity(arch: str, batch: dict, seed: int = 3):
    """``loss_fn`` and its gradient over the flat segments, both packages,
    from the reference's flat init. Returns the port's flat spec and its
    segments, with their gradients."""
    jcfg, tcfg = jconf.SMOKES[arch], tconf.SMOKES[arch]
    jfs, tfs = j_fs(jcfg, 1), make_flat_spec(tcfg, 1)
    segs = {k: np.asarray(v) for k, v in
            j_init(jcfg, jax.random.PRNGKey(seed), 1, jfs).items()}

    def jloss(s):
        return jmdl.loss_fn(jcfg, CTX, jfs, s,
                            {k: jnp.asarray(v) for k, v in batch.items()})

    j_l, j_g = jax.value_and_grad(jloss)({k: jnp.asarray(v)
                                          for k, v in segs.items()})
    tsegs = {k: v.requires_grad_() for k, v in
             params_from_numpy(segs, tfs, "cpu").items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_l = tmdl.loss_fn(tcfg, tfs, tsegs, tb)
    t_l.backward()
    np.testing.assert_allclose(float(t_l.detach()), float(j_l), rtol=1e-5)
    for k in SEG_NAMES:
        np.testing.assert_allclose(tsegs[k].grad.numpy(), np.asarray(j_g[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    return tfs, tsegs


def chunked_matches_loss_fn(arch: str, chunks: int, seed: int = 5):
    """The port's ``chunked_loss_vjp`` against its ``loss_fn`` on one smoke
    config: the loss and every gradient bit-equal."""
    cfg = tconf.SMOKES[arch]
    batch = {k: torch.from_numpy(v) for k, v in
             smoke_batch(cfg, 2, 16, seed).items()}
    jfs = j_fs(jconf.SMOKES[arch], 1)
    fs = make_flat_spec(cfg, 1)
    segs = params_from_numpy(
        {k: np.asarray(v) for k, v in
         j_init(jconf.SMOKES[arch], jax.random.PRNGKey(seed), 1,
                jfs).items()}, fs, "cpu")
    leaves = {k: v.clone().requires_grad_() for k, v in segs.items()}
    loss_m = tmdl.loss_fn(cfg, fs, leaves, batch)
    loss_m.backward()
    loss_c, steps, top = tmdl.chunked_loss_vjp(cfg, fs, segs, batch,
                                               chunks=chunks)
    assert float(loss_c) == float(loss_m.detach())
    d_cs = torch.zeros_like(segs["cycles_s"])
    d_cr = torch.zeros_like(segs["cycles_r"])
    for s in steps:
        (a, b), g_cs, g_cr = s()
        d_cs[a:b], d_cr[a:b] = g_cs, g_cr
    d_ts, d_tr = top()
    got = {"top_s": d_ts, "top_r": d_tr, "cycles_s": d_cs, "cycles_r": d_cr}
    for k in SEG_NAMES:
        assert torch.equal(got[k], leaves[k].grad), k
    return fs, got


def specs_for(arch: str, optimizer: str | None = None):
    jspec = dataclasses.replace(JSpec.load(SPEC), arch=arch,
                                optimizer=optimizer)
    tspec = dataclasses.replace(TSpec.load(SPEC), arch=arch,
                                optimizer=optimizer)
    return jspec, tspec


def assert_steps_match(arch: str, optimizer: str | None = None,
                       ef_bf16: bool = False) -> dict:
    """Two gs-SGD steps of the smoke spec with ``arch`` (and optionally the
    optimizer and a bf16 EF) in both packages."""
    jspec, tspec = specs_for(arch, optimizer)
    _, opt, _, jts = j_build(jspec)
    _, topt, _, tts = ttrain.build(tspec, "cpu")
    assert tts.d_local == jts.d_local
    out = _run(jspec, jts, opt, tts, topt, ef_bf16=ef_bf16)
    np.testing.assert_allclose(out["t_loss"], out["j_loss"], rtol=1e-4)
    for step, (jefs, tefs) in enumerate(zip(out["j_ef"], out["t_ef"])):
        for b, (je, te) in enumerate(zip(jefs, tefs)):
            np.testing.assert_array_equal(te == 0, je == 0,
                                          err_msg=f"step {step} bucket {b}")
            if not ef_bf16:
                np.testing.assert_allclose(te, je, rtol=1e-4, atol=1e-6)
                continue
            # a bf16 EF is stored rounded: f32 residuals a few f32 ulps
            # apart round one bf16 ulp apart, and the next step's u = ef +
            # g carries that ulp of the old residual; so the packages'
            # residuals sit within two bf16 ulps (2^-7 relative each) of
            # the larger of the new and the old residual (plus the f32
            # atol, 1e-6, for entries near 0)
            prev = out["j_ef"][step - 1][b] if step else np.zeros_like(je)
            bound = 2.0 ** -6 * np.maximum(np.abs(je), np.abs(prev)) + 1e-6
            worst = np.max(np.abs(te - je) - bound)
            assert worst <= 0, f"step {step} bucket {b}: {worst}"
    for k, v in out["t_params"].items():
        np.testing.assert_allclose(v, out["j_params"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    return out


# ---------------------------------------------------------------------------
# Configs and the flat layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["smoke", "full"])
@pytest.mark.parametrize("arch", sorted(jconf.ARCHS))
def test_flat_layout_and_counts_equal_reference(arch, which):
    reg_j = jconf.SMOKES if which == "smoke" else jconf.ARCHS
    reg_t = tconf.SMOKES if which == "smoke" else tconf.ARCHS
    jcfg, tcfg = reg_j[arch], reg_t[arch]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    j, t = j_fs(jcfg, 1), make_flat_spec(tcfg, 1)
    assert t.seg_shapes() == j.seg_shapes()
    assert len(t.top_leaves) == len(j.top_leaves)
    assert len(t.cyc_leaves) == len(j.cyc_leaves)
    for jl, tl in zip(j.top_leaves + j.cyc_leaves,
                      t.top_leaves + t.cyc_leaves):
        assert (tl.shape, tl.offset, tl.size, tl.rep) == (
            jl.shape, jl.offset, jl.size, jl.rep)
    for n in (1, 2, 4):
        assert bucket_sizes(t.seg_shapes(), n) == j_bucket_sizes(
            j.seg_shapes(), n)
    assert tcfg.params_count() == jcfg.params_count()
    assert tcfg.active_params_count() == jcfg.active_params_count()


def test_shared_block_sits_at_the_top():
    """zamba2's shared attention block is one set of weights at the top of
    the tree, not a per-cycle kind: its sharded leaves land in top_s, its
    replicated ones in top_r, and the cycle rows hold only Mamba2."""
    fs = make_flat_spec(tconf.SMOKES["zamba2-2.7b"], 1)
    shared = [l for l in fs.top_leaves if l.path[0] == "shared_attn"]
    assert {l.path[1] for l in shared} == {"mlp", "norm", "wk", "wo", "wq",
                                           "wv"}
    assert {l.rep for l in shared} == {False, True}
    assert {l.path[0] for l in fs.cyc_leaves} == {"mamba"}


def test_chip_cells_geometry():
    """The chip's full-width cells: granite-moe-3b-a800m cut to 4 layers
    and zamba2-2.7b cut to 12 (two cycles of 6 Mamba2 + the shared
    block)."""
    g = make_flat_spec(dataclasses.replace(
        tconf.ARCHS["granite-moe-3b-a800m"], n_layers=4), 1)
    assert g.total == 478_606_848
    assert bucket_sizes(g.seg_shapes(), 2) == (277_022_208, 201_584_640)
    z = make_flat_spec(dataclasses.replace(
        tconf.ARCHS["zamba2-2.7b"], n_layers=12), 1)
    assert z.total == 663_336_448 and z.n_cycles == 2


# ---------------------------------------------------------------------------
# Cross-attention and the parallel block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_kv", [True, False])
def test_cross_attention_block_matches(with_kv):
    cfg = jconf.SMOKES["llama-3.2-vision-11b"]
    B, S = 2, 7
    rs = np.random.RandomState(11)
    args = {"p": params_np(cfg, "cross", 11),
            "x": rs.randn(B, S, cfg.d_model).astype(np.float32)}
    if with_kv:
        args["kv"] = rs.randn(B, cfg.n_cross_tokens,
                              cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))

    def jfn(p, x, kv=None):
        return jlay.attention_block(p, cfg, CTX, x, jnp.asarray(pos),
                                    cross_kv=kv)[0]

    def tfn(p, x, kv=None):
        return tlay.attention_block(p, tconf.SMOKES["llama-3.2-vision-11b"],
                                    x, torch.from_numpy(pos.copy()),
                                    cross_kv=kv)

    block_parity(jfn, tfn, args)


def test_parallel_block_matches():
    cfg = dataclasses.replace(jconf.SMOKES["qwen3-4b"], parallel_block=True)
    tcfg = dataclasses.replace(tconf.SMOKES["qwen3-4b"], parallel_block=True)
    B, S = 2, 9
    rs = np.random.RandomState(12)
    args = {"p": params_np(cfg, "attn", 12),
            "x": rs.randn(B, S, cfg.d_model).astype(np.float32)}
    pos = np.broadcast_to(np.arange(S), (B, S))
    block_parity(
        lambda p, x: jlay.parallel_attn_mlp_block(
            p, cfg, CTX, x, jnp.asarray(pos))[0],
        lambda p, x: tlay.parallel_attn_mlp_block(
            p, tcfg, x, torch.from_numpy(pos.copy())), args)


def test_parallel_block_model_loss_matches():
    """A whole smoke model with ``parallel_block``: loss and gradients
    through ``_apply_cycle``'s parallel branch."""
    jcfg = dataclasses.replace(jconf.SMOKES["qwen3-4b"], parallel_block=True)
    tcfg = dataclasses.replace(tconf.SMOKES["qwen3-4b"], parallel_block=True)
    jfs, tfs = j_fs(jcfg, 1), make_flat_spec(tcfg, 1)
    segs = {k: np.asarray(v) for k, v in
            j_init(jcfg, jax.random.PRNGKey(4), 1, jfs).items()}
    batch = smoke_batch(tcfg, 2, 12, 4)
    j_l, j_g = jax.value_and_grad(lambda s: jmdl.loss_fn(
        jcfg, CTX, jfs, s, {k: jnp.asarray(v) for k, v in batch.items()}))(
        {k: jnp.asarray(v) for k, v in segs.items()})
    tsegs = {k: v.requires_grad_() for k, v in
             params_from_numpy(segs, tfs, "cpu").items()}
    t_l = tmdl.loss_fn(tcfg, tfs, tsegs,
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    t_l.backward()
    np.testing.assert_allclose(float(t_l.detach()), float(j_l), rtol=1e-5)
    for k in SEG_NAMES:
        np.testing.assert_allclose(tsegs[k].grad.numpy(), np.asarray(j_g[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The vlm and musicgen through loss_fn and the gs-SGD step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cross", [True, False])
def test_vlm_loss_and_grad_match(cross):
    """llama-3.2-vision's smoke model with ``cross_kv`` (the cross layers
    attend to the patches) and without it (the CLI's batches: they run
    as causal self-attention, and ``kv_norm`` gets a zero gradient)."""
    cfg = tconf.SMOKES["llama-3.2-vision-11b"]
    fs, tsegs = loss_parity(
        "llama-3.2-vision-11b", smoke_batch(cfg, 2, 12, 6, cross=cross))
    kv = [l for l in fs.cyc_leaves if l.path[-1] == "kv_norm"]
    assert len(kv) == 1
    g = tsegs["cycles_r" if kv[0].rep else "cycles_s"].grad
    g_kv = g[:, kv[0].offset:kv[0].offset + kv[0].size]
    assert bool(g_kv.abs().sum() > 0) == cross


def test_musicgen_loss_and_grad_match():
    loss_parity("musicgen-large",
                smoke_batch(tconf.SMOKES["musicgen-large"], 2, 12, 7))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large"])
def test_two_steps_match_reference(arch):
    assert_steps_match(arch)


def test_vlm_step_takes_cross_kv():
    """The port's step passes every batch key to the worker's loss: a
    batch with ``cross_kv`` trains the cross layers' ``kv_norm``."""
    tspec = dataclasses.replace(TSpec.load(SPEC),
                                arch="llama-3.2-vision-11b")
    cfg, opt, _, ts = ttrain.build(tspec, "cpu")
    from repro_torch.core.gs_sgd import make_state
    from repro_torch.models.flatten import init_flat_params
    params = init_flat_params(cfg, torch.Generator().manual_seed(0), 1, ts.fs)
    batch = {k: torch.from_numpy(v) for k, v in
             smoke_batch(cfg, tspec.batch, tspec.seq, 8, cross=True).items()}
    ends = []
    for b in (batch, {k: v for k, v in batch.items() if k != "cross_kv"}):
        st = make_state(params, opt, ts.compressor, ts.d_local, ts.nworkers)
        st, m = ts.fn(st, ttrain.shard_batch(b, ts.nworkers))
        assert np.isfinite(float(m["loss"]))
        ends.append(float(m["loss"]))
    assert ends[0] != ends[1]


def test_cli_runs_every_new_family_on_cpu():
    for arch in NEW:
        out = ttrain.main(["--spec", SPEC, "--arch", arch, "--device",
                           "cpu", "--steps", "1"])
        assert np.isfinite(out["final_loss"]), arch
