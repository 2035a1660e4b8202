"""Port parity: the serving targets of every smoke config — ``prefill_fn``'s
last-token logits and cache, two ``decode_fn`` steps (scalar and per-row
``kv_len``), ``init_cache`` / ``cache_shapes`` and ``make_serve_fns``.

Both packages take the same flat parameter segments, drawn with numpy
from a seed (``np_segs``: every coordinate N(0, 0.02^2), norm gains and
SSM parameters included, so each leaf is exercised; the reference's
eager init would dominate the run), carried into the port by
``params_from_numpy``, and the same seeded numpy tokens; a cache the
reference returned is carried into the port's layout by
``cache_from_numpy``. Tolerances: logits and cache leaves at rtol 1e-5,
atol 1e-5 (f32 matmuls and reductions in another order; the measured
gap is ~1e-6); decode ids equal (greedy over logits whose top two are far
apart at these seeds).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.core.gs_sgd import MeshAxes as JMesh
from repro.core.gs_sgd import make_serve_fns as j_make_serve_fns
from repro.models import model as jmdl
from repro.models.common import ShardCtx
from repro.models.flatten import make_flat_spec as j_fs
from repro_torch.configs import SMOKES as T_SMOKES
from repro_torch.core.gs_sgd import MeshAxes, make_serve_fns
from repro_torch.models import model as tmdl
from repro_torch.models.common import tree_leaves
from repro_torch.models.flatten import (cache_from_numpy, make_flat_spec,
                                        params_from_numpy)

CTX = ShardCtx(dtype=jnp.float32)
ARCHS = tuple(J_SMOKES)
RTOL = ATOL = 1e-5
B, S, T = 2, 7, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_segs(fs, seed: int = 0) -> dict:
    """Flat segments of ``fs``'s shapes, every coordinate 0.02 N(0, 1)
    from ``numpy.random.RandomState(seed)``, in f32."""
    rs = np.random.RandomState(seed)
    return {k: (0.02 * rs.randn(*shape)).astype(np.float32)
            for k, shape in sorted(fs.seg_shapes().items())}


_BUILT: dict = {}


def built(arch):
    """(jax cfg, jax fs, jax segs, port cfg, port fs, port segs, inputs)."""
    if arch not in _BUILT:
        cfg, tcfg = J_SMOKES[arch], T_SMOKES[arch]
        fs = j_fs(cfg, 1)
        seg_np = np_segs(fs)
        segs = {k: jnp.asarray(v) for k, v in seg_np.items()}
        tfs = make_flat_spec(tcfg, 1)
        tsegs = params_from_numpy(seg_np, tfs, "cpu")
        rs = np.random.RandomState(3)
        tokens = rs.randint(1, cfg.vocab_size, (B, S)).astype(np.int32)
        ck = (rs.randn(B, cfg.n_cross_tokens, cfg.d_model).astype(np.float32)
              if cfg.family == "vlm" else None)
        _BUILT[arch] = (cfg, fs, segs, tcfg, tfs, tsegs, tokens, ck)
    return _BUILT[arch]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_cache_close(tc: dict, jc: dict):
    want = cache_from_numpy(_np_tree(jc), "cpu")
    got_leaves, want_leaves = tree_leaves(tc), tree_leaves(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=str(path))


_PREFILLED: dict = {}
_JDECODE: dict = {}


def j_decode(arch):
    """The reference's decode_fn, jitted once per arch (its compile costs
    less than four eager calls)."""
    if arch not in _JDECODE:
        cfg, fs = built(arch)[:2]
        _JDECODE[arch] = jax.jit(functools.partial(jmdl.decode_fn, cfg,
                                                   CTX, fs))
    return _JDECODE[arch]


def _prefill_both(arch):
    """Each package's prefill of the arch's tokens, once per module."""
    if arch in _PREFILLED:
        return _PREFILLED[arch]
    cfg, fs, segs, tcfg, tfs, tsegs, tokens, ck = built(arch)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens.astype(np.int64))}
    if ck is not None:
        jb["cross_kv"] = jnp.asarray(ck)
        tb["cross_kv"] = torch.from_numpy(ck)
    jl, jc = jmdl.prefill_fn(cfg, CTX, fs, segs, jb,
                             jmdl.init_cache(cfg, CTX, B, T, jnp.float32))
    tl, tc = tmdl.prefill_fn(tcfg, tfs, tsegs, tb,
                             tmdl.init_cache(tcfg, B, T, torch.float32))
    _PREFILLED[arch] = (jl, jc), (tl, tc)
    return _PREFILLED[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match(arch):
    (jl, jc), (tl, tc) = _prefill_both(arch)
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    _assert_cache_close(tc, jc)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_decode_steps_match(arch, per_row):
    """From the reference's prefill cache (carried across), two decode
    steps in each package: the same ids, and the cache after them. The
    per-row case puts the rows at different positions (row 1 three
    positions back, overwriting prefilled K/V there)."""
    cfg, fs, segs, tcfg, tfs, tsegs, tokens, ck = built(arch)
    (jl, jc), _ = _prefill_both(arch)
    tc = cache_from_numpy(_np_tree(jc), "cpu")
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    lens = np.array([S, S - 3]) if per_row else np.array(S)
    jck = None if ck is None else jnp.asarray(ck)
    tck = None if ck is None else torch.from_numpy(ck)
    for step in range(2):
        kl = lens + step
        jid, jc = j_decode(arch)(segs, jnp.asarray(tok),
                                 jnp.asarray(kl, jnp.int32), jc,
                                 cross_kv=jck)
        tid, tc = tmdl.decode_fn(tcfg, tfs, tsegs,
                                 torch.from_numpy(tok.astype(np.int64)),
                                 torch.as_tensor(kl) if per_row
                                 else int(kl), tc, cross_kv=tck)
        assert tid.dtype == torch.int32 and tid.shape == (B,)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        tok = np.asarray(jid)[:, None]
    _assert_cache_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_shapes_match(arch):
    cfg, tcfg = J_SMOKES[arch], T_SMOKES[arch]
    for dtype, tdtype in ((jnp.bfloat16, torch.bfloat16),
                          (jnp.float32, torch.float32)):
        want = jmdl.cache_shapes(cfg, CTX, 3, 8, dtype)
        got = tmdl.cache_shapes(tcfg, 3, 8, tdtype)
        conc = tmdl.init_cache(tcfg, 3, 8, tdtype)
        wl = jax.tree_util.tree_leaves_with_path(want)
        for g_tree in (got, conc):
            gl = tree_leaves(g_tree)
            assert len(gl) == len(wl)
            for (gp, g), (wp, w) in zip(gl, wl):
                assert gp == tuple(k.key for k in wp)
                assert tuple(g.shape) == tuple(w.shape), gp
                assert str(g.dtype).split(".")[-1] == str(w.dtype), gp
        assert all(t.device.type == "meta" for _, t in tree_leaves(got))
        assert all(not t.any() for _, t in tree_leaves(conc))
        kv, st = tmdl.split_cache(conc)
        assert set(kv) <= set(tmdl.KV_CACHE_KINDS)
        assert not set(st) & set(tmdl.KV_CACHE_KINDS)
        merged = tmdl.merge_cache(kv, st)
        assert set(merged) == set(conc)
        assert all(merged[k] is conc[k] for k in conc)


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b"])
def test_make_serve_fns_match(arch):
    """The serve fns bound to the storage layout, in f32, against the
    reference's: prefill logits, then one decode step's ids."""
    cfg, fs, segs, tcfg, tfs, tsegs, tokens, _ = built(arch)
    jpre, jdec = j_make_serve_fns(cfg, JMesh(tp=1, data=1, tp_axis=None,
                                             data_axis=None),
                                  dtype=jnp.float32, fs=fs)
    tpre, tdec = make_serve_fns(tcfg, MeshAxes(tp=1, data=1, tp_axis=None,
                                               data_axis=None),
                                dtype=torch.float32, fs=tfs,
                                comm_dtype=torch.float8_e4m3fn)
    jl, jc = jpre(segs, {"tokens": jnp.asarray(tokens)},
                  jmdl.init_cache(cfg, CTX, B, T, jnp.float32))
    tl, tc = tpre(tsegs, {"tokens": torch.from_numpy(
        tokens.astype(np.int64))}, tmdl.init_cache(tcfg, B, T, torch.float32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    jid, _ = jdec(segs, jnp.asarray(tok, jnp.int32), jnp.int32(S), jc)
    tid, _ = tdec(tsegs, torch.from_numpy(tok), S, tc)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))


def test_make_serve_fns_refuses_tp_and_fsdp():
    """tp > 1 and fsdp are ported (tests/test_torch_tp.py and
    tests/test_torch_fsdp.py hold them against the reference): both build;
    only a storage mode the reference does not know is refused."""
    cfg = T_SMOKES["qwen3-4b"]
    assert all(callable(f) for f in make_serve_fns(cfg, MeshAxes(tp=2,
                                                                 data=1)))
    assert all(callable(f) for f in make_serve_fns(
        cfg, MeshAxes(tp=1, data=2), dp_mode="fsdp"))
    with pytest.raises(ValueError, match="dp_mode"):
        make_serve_fns(cfg, MeshAxes(tp=1, data=2), dp_mode="zero3")


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-7b", "zamba2-2.7b",
                                  "llama-3.2-vision-11b"])
def test_prefill_decode_consistency(arch):
    """Within the port (tests/test_models_smoke.py's check): the argmax of
    a prefill over S tokens equals a decode of token S-1 after a prefill
    of S-1, and the cache keeps advancing."""
    _, _, _, tcfg, tfs, tsegs, tokens, ck = built(arch)
    toks = torch.from_numpy(tokens.astype(np.int64))
    extra = {} if ck is None else {"cross_kv": torch.from_numpy(ck)}
    lg, _ = tmdl.prefill_fn(tcfg, tfs, tsegs, {"tokens": toks, **extra},
                            tmdl.init_cache(tcfg, B, T, torch.float32))
    _, cache = tmdl.prefill_fn(tcfg, tfs, tsegs,
                               {"tokens": toks[:, :S - 1], **extra},
                               tmdl.init_cache(tcfg, B, T, torch.float32))
    got, cache = tmdl.decode_fn(tcfg, tfs, tsegs, toks[:, S - 1:], S - 1,
                                cache, cross_kv=extra.get("cross_kv"))
    np.testing.assert_array_equal(got.numpy(),
                                  torch.argmax(lg, -1).numpy())
    got2, _ = tmdl.decode_fn(tcfg, tfs, tsegs, got[:, None].long(), S,
                             cache, cross_kv=extra.get("cross_kv"))
    assert got2.shape == (B,)


def test_vlm_serve_needs_cross_kv():
    _, _, _, tcfg, tfs, tsegs, tokens, _ = built("llama-3.2-vision-11b")
    with pytest.raises(ValueError, match="cross_kv"):
        tmdl.prefill_fn(tcfg, tfs, tsegs,
                        {"tokens": torch.from_numpy(tokens.astype(np.int64))},
                        tmdl.init_cache(tcfg, B, T, torch.float32))


def test_train_forward_unchanged_by_cache_arguments():
    """``loss_fn`` (mode "train") against the serve backbone's machinery:
    the cycle without a cache is the train cycle, so the prefill's
    last-position hidden state equals the train forward's there."""
    _, _, _, tcfg, tfs, tsegs, tokens, _ = built("qwen3-4b")
    toks = torch.from_numpy(tokens.astype(np.int64))
    pos = torch.arange(S).expand(B, S)
    with torch.no_grad():
        hid, _, top = tmdl._backbone(tcfg, tfs, tsegs, toks, pos,
                                     torch.float32, None)
        hid2, _, _ = tmdl._backbone(tcfg, tfs, tsegs, toks, pos,
                                    torch.float32, None, "prefill",
                                    tmdl.init_cache(tcfg, B, T,
                                                    torch.float32), 0)
    assert torch.equal(hid, hid2)
    del top


def test_cache_from_numpy_keeps_dtypes():
    cfg = J_SMOKES["zamba2-2.7b"]
    jc = jmdl.init_cache(cfg, CTX, 2, 8, jnp.bfloat16)
    tc = cache_from_numpy(_np_tree(jc), "cpu")
    want = tmdl.init_cache(T_SMOKES["zamba2-2.7b"], 2, 8, torch.bfloat16)
    for (p, a), (q, b) in zip(tree_leaves(tc), tree_leaves(want)):
        assert p == q and a.dtype == b.dtype and a.shape == b.shape
    assert dataclasses.asdict(J_SMOKES["zamba2-2.7b"]) == dataclasses.asdict(
        T_SMOKES["zamba2-2.7b"])
