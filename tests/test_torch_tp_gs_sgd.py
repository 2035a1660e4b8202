"""Port parity: gs-SGD at tp = 2 x data = 2 against the JAX package's
step under nested ``jax.vmap`` (``model`` outside, ``data`` inside).

Both packages start from the reference's ``shard_segs`` params (qwen3-4b
smoke, d_local = 45,824 a rank and worker; starcoder2-3b's one KV head,
replicated over the ranks) and take the reference's ``LMStream`` batches,
passed as numpy. Each model rank exchanges over the data workers on its
own: the selected coordinates (the zeros the EF residual writes) must be
equal for every rank and bucket, every step. Exchange settings: bucketed
(2, skewed schedule), monolithic, the backward interleave with the fused
encode (2 chunks; the port runs its numbers with the bucketed exchange
after the backward, which the reference's interleave equals), and
microbatch 1 with the global-norm clip. Tolerances: losses within 1e-5
relative; EF within 1e-6 absolute; the global norm at rtol 1e-4 (these
two would show a missing or doubled 1/tp loss seed: 2x); params (AdamW)
at rtol 1e-4, atol 2e-5: AdamW divides by sqrt(v), so a coordinate whose
summed gradient nearly cancels (the ranks sum a replicated KV head's
gradient in another order) moves by a rounding-sized fraction of lr,
where a selection that differs moves a parameter by about lr = 2e-3.
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
from repro.data import LMStream
from repro.models.flatten import SEG_NAMES
from repro.optim import make as j_opt
from repro_torch.configs import SMOKES as T_SMOKES
from repro_torch.core.gs_sgd import MeshAxes, local_seg_shapes
from repro_torch.core.gs_sgd import make_train_step
from repro_torch.models.flatten import params_from_numpy
from repro_torch.optim import make as t_opt
from tests.test_tp import shard_segs as j_shard_segs

TP, D, STEPS, B, S = 2, 2, 3, 2, 16
KW = dict(k=2048, rows=5, width=4096)
REL = 1e-5

CASES = {
    "bucketed": ("qwen3-4b", dict(buckets=2)),
    "monolithic": ("qwen3-4b", dict()),
    "interleave_fused": ("qwen3-4b", dict(buckets=2, bwd_chunks=2,
                                          fuse_encode=True)),
    "microbatch_clip": ("qwen3-4b", dict(buckets=2, microbatch=1,
                                         clip_norm=0.5)),
    "replicated_kv": ("starcoder2-3b", dict(buckets=2)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(vocab: int, n_workers: int, seed: int = 7) -> list[dict]:
    stream = LMStream(vocab_size=vocab, seq_len=S,
                      global_batch=n_workers * B, seed=seed)
    return [{k: np.asarray(v) for k, v in stream.global_batch_at(i).items()}
            for i in range(STEPS)]


def hold(j_out: dict, t_out: dict, groups) -> None:
    """Losses, per-group-and-bucket selections and EF, params."""
    np.testing.assert_allclose(t_out["loss"], j_out["loss"], rtol=REL)
    np.testing.assert_allclose(t_out["gnorm"], j_out["gnorm"], rtol=1e-4)
    for step, (jef, tef) in enumerate(zip(j_out["ef"], t_out["ef"])):
        for g, (je_g, te_g) in enumerate(zip(jef, tef)):
            for b, (je, te) in enumerate(zip(je_g, te_g)):
                np.testing.assert_array_equal(
                    te == 0, je == 0,
                    err_msg=f"step {step} group {groups[g]} bucket {b}")
                np.testing.assert_allclose(te, je, atol=1e-6)
    for k in SEG_NAMES:
        np.testing.assert_allclose(t_out["params"][k], j_out["params"][k],
                                   rtol=1e-4, atol=2e-5, err_msg=k)


def buckets_of(ef) -> tuple:
    """An EF state as a tuple of buckets (a monolithic one is one)."""
    return ef if isinstance(ef, tuple) else (ef,)


def t_run(ts, state, bs, reshape) -> dict:
    """The port's steps; EF per exchange group, each a list of buckets."""
    out = {"loss": [], "gnorm": [], "ef": []}
    for gb in bs:
        tb = {k: torch.from_numpy(np.array(reshape(v)))
              for k, v in gb.items()}
        state, m = ts.fn(state, tb)
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(m["grad_norm"].numpy().copy())
        out["ef"].append([[e.numpy().copy() for e in buckets_of(grp)]
                          for grp in state["ef"]])
    out["params"] = {k: v.numpy() for k, v in state["params"].items()}
    return out


def run_tp(name: str, kw: dict) -> tuple[dict, dict, tuple]:
    cfg, tcfg = J_SMOKES[name], T_SMOKES[name]
    bkw = {k: kw[k] for k in ("buckets", "bwd_chunks", "fuse_encode",
                              "microbatch") if k in kw}
    clip = kw.get("clip_norm")
    opt, topt = j_opt("adamw", lr=2e-3), t_opt("adamw", lr=2e-3)
    fs2, segs2 = j_shard_segs(cfg, jax.random.PRNGKey(0), TP)
    jts = j_make_train_step(cfg, JMesh(tp=TP, data=D), opt,
                            compressor_name="gs-sgd", compressor_kw=KW,
                            remat=False, dtype=jnp.float32, fs=fs2,
                            clip_norm=clip, **bkw)
    st = jax.vmap(lambda s: j_make_state(s, opt, jts.compressor,
                                         jts.d_local))(segs2)
    st = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[:, None], (TP, D) + a.shape[1:]), st)
    fn = jax.jit(jax.vmap(jax.vmap(jts.fn, in_axes=(0, 0), axis_name="data"),
                          in_axes=(0, None), axis_name="model"))
    bs = batches(cfg.vocab_size, D)
    j_out = {"loss": [], "gnorm": [], "ef": []}
    for gb in bs:
        st, m = fn(st, {k: jnp.asarray(v.reshape((D, -1) + v.shape[1:]))
                        for k, v in gb.items()})
        j_out["loss"].append(float(m["loss"][0, 0]))
        j_out["gnorm"].append(np.asarray(m["grad_norm"][0]))
        j_out["ef"].append([[np.asarray(e[r]) for e in buckets_of(st["ef"])]
                            for r in range(TP)])
    j_out["params"] = {k: np.asarray(v) for k, v in st["params"].items()}

    ma = MeshAxes(tp=TP, data=D)
    ts = make_train_step(tcfg, ma, topt, compressor_name="gs-sgd",
                         compressor_kw=KW, remat=False, dtype=torch.float32,
                         clip_norm=clip, device="cpu", **bkw)
    assert ts.d_local == jts.d_local
    p = params_from_numpy({k: np.asarray(v) for k, v in segs2.items()},
                          ts.fs, "cpu", shapes=local_seg_shapes(ts.fs, ma,
                                                                "dp"),
                          lead=(TP,))
    t_out = t_run(ts, ts.state_from(p, topt), bs,
                  lambda v: v.reshape((D, -1) + v.shape[1:]))
    return j_out, t_out, ts.comp_groups


@pytest.mark.parametrize("case", list(CASES))
def test_tp2_data2_gs_sgd_matches_nested_vmap(case):
    name, kw = CASES[case]
    j_out, t_out, groups = run_tp(name, kw)
    assert [r for r, _ in groups] == [0, 1]
    hold(j_out, t_out, groups)


def test_tp2_data2_step_d_local_and_groups():
    ts = make_train_step(T_SMOKES["qwen3-4b"], MeshAxes(tp=TP, data=D),
                         t_opt("adamw", lr=2e-3), compressor_name="gs-sgd",
                         compressor_kw=KW, buckets=2, device="cpu")
    assert ts.d_local == 45_824 and ts.nworkers == D and ts.sharded
    assert ts.comp_groups == ((0, slice(0, D)), (1, slice(0, D)))
    st = ts.init_state(t_opt("adamw", lr=2e-3),
                       torch.Generator().manual_seed(0))
    assert st["params"]["top_s"].shape[:2] == (TP, D)
    assert len(st["ef"]) == TP and st["ef"][0][0].shape[0] == D
    # every worker of a rank starts from the same params
    for v in st["params"].values():
        assert torch.equal(v[:, 0], v[:, 1])
