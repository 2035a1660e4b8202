"""Port parity: the serving pieces of the blocks — ``decode_attention``,
``_cache_append``, ``lm_logits``, ``sharded_argmax``, the Mamba2 and RWKV6
blocks' ``state=`` paths (``ssd_step``, ``wkv_step``, the conv tail and
the token-shift carries) — and, within the port, the masking guarantee
the paged cache rests on.

Both packages take the same seeded numpy inputs and block parameters.
Tolerances: outputs at rtol 1e-5, atol 1e-6 (f32 in another summation
order), as tests/test_torch_families.py holds the train blocks; the
masking guarantee bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconf
from repro.models import layers as jlay
from repro.models import mamba as jmb
from repro.models import rwkv as jrk
from repro.models.common import ShardCtx
from repro_torch import configs as tconf
from repro_torch.models import layers as tlay
from repro_torch.models import mamba as tmb
from repro_torch.models import rwkv as trk
from repro_torch.models.common import param_specs, tree_map

CTX = ShardCtx(dtype=jnp.float32)
RTOL, ATOL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _block_params(arch: str, kind: str, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    return tree_map(lambda sp: (0.02 * rs.randn(*sp.shape[2:]))
                    .astype(np.float32),
                    param_specs(tconf.SMOKES[arch])["layers"][kind])


def params_np(cfg, kind: str, seed: int) -> dict:
    """One block's params of ``cfg``'s layout, each leaf 0.02 N(0, 1) from
    ``numpy.random.RandomState(seed)`` (norm gains and SSM parameters
    included, so every leaf is exercised)."""
    return _block_params(cfg.name.removesuffix("-smoke"), kind, seed)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (8, 1)])
def test_decode_attention_matches(hq, hkv, per_row):
    B, T, hd = 3, 11, 8
    rs = np.random.RandomState(hq * 10 + hkv)
    q = rs.randn(B, 1, hq, hd).astype(np.float32)
    k = rs.randn(B, T, hkv, hd).astype(np.float32)
    v = rs.randn(B, T, hkv, hd).astype(np.float32)
    lens = np.array([1, 7, 11]) if per_row else np.array(6)
    want = jlay.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens))
    got = tlay.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(lens))
    _close(got, want)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_decode_attention_ignores_finite_garbage_past_kv_len(per_row):
    """Positions at or past kv_len hold large finite garbage: the output is
    the same bits as with zeros there (their softmax weight is exactly
    0). The guarantee the paged cache's stale blocks rely on."""
    B, T, hq, hkv, hd = 3, 16, 4, 2, 8
    rs = np.random.RandomState(5)
    q = torch.from_numpy(rs.randn(B, 1, hq, hd).astype(np.float32))
    k = torch.from_numpy(rs.randn(B, T, hkv, hd).astype(np.float32))
    v = torch.from_numpy(rs.randn(B, T, hkv, hd).astype(np.float32))
    lens = torch.tensor([3, 9, 16]) if per_row else torch.tensor(9)
    valid = (torch.arange(T)[None, :]
             < (lens[:, None] if per_row else lens))[..., None, None]
    junk_k = torch.from_numpy(
        (rs.choice([-1, 1], k.shape) * 1e18).astype(np.float32))
    junk_v = torch.from_numpy(
        (rs.choice([-1, 1], v.shape) * 3e37).astype(np.float32))
    clean = tlay.decode_attention(q, torch.where(valid, k, 0.0),
                                  torch.where(valid, v, 0.0), lens)
    dirty = tlay.decode_attention(q, torch.where(valid, k, junk_k),
                                  torch.where(valid, v, junk_v), lens)
    assert torch.equal(clean, dirty)
    assert torch.isfinite(dirty).all()


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_cache_append_matches(per_row):
    B, T, hkv, hd = 3, 10, 2, 4
    rs = np.random.RandomState(9)
    cache = {"k": rs.randn(B, T, hkv, hd).astype(np.float32),
             "v": rs.randn(B, T, hkv, hd).astype(np.float32)}
    k = rs.randn(B, 1, hkv, hd).astype(np.float32)
    v = rs.randn(B, 1, hkv, hd).astype(np.float32)
    lens = np.array([0, 4, 9]) if per_row else np.array(7)
    jk, jv = jlay._cache_append(_j(cache), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(lens))
    tc = _t(cache)
    tk, tv = tlay._cache_append(tc, torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(lens))
    assert tk is tc["k"] and tv is tc["v"]          # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_lm_logits_and_argmax_match():
    cfg = jconf.SMOKES["granite-moe-3b-a800m"]      # vocab 130, padded 256
    tcfg = tconf.SMOKES["granite-moe-3b-a800m"]
    rs = np.random.RandomState(2)
    hid = rs.randn(4, 1, cfg.d_model).astype(np.float32)
    w = rs.randn(cfg.d_model, 256).astype(np.float32)
    want = jlay.lm_logits(jnp.asarray(hid), jnp.asarray(w), cfg, CTX)
    got = tlay.lm_logits(torch.from_numpy(hid), torch.from_numpy(w), tcfg)
    _close(got, want)
    assert (got[..., cfg.vocab_size:] == -1e30).all()
    np.testing.assert_array_equal(
        tlay.sharded_argmax(got[:, 0]).numpy(),
        np.asarray(jlay.sharded_argmax(want[:, 0], CTX)))


def test_argmax_ties_go_to_lowest_index():
    logits = np.zeros((3, 9), np.float32)
    logits[0, [2, 5]] = 4.0
    logits[1, [0, 8]] = 1.0
    logits[2, :] = -1e30
    got = tlay.sharded_argmax(torch.from_numpy(logits))
    want = jlay.sharded_argmax(jnp.asarray(logits), CTX)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [2, 0, 0]


def test_ssd_step_matches():
    B, H, hd, ns = 2, 3, 4, 5
    rs = np.random.RandomState(12)
    args = (rs.randn(B, H, hd), rs.randn(B, H, ns), rs.randn(B, H, ns),
            rs.uniform(0.01, 0.5, (B, H)), -np.exp(rs.uniform(-1, 1, H)),
            rs.randn(B, H, ns, hd))
    args = [a.astype(np.float32) for a in args]
    jy, jh = jmb.ssd_step(*map(jnp.asarray, args))
    ty, th = tmb.ssd_step(*map(torch.from_numpy, args))
    _close(ty, jy)
    _close(th, jh)


def test_wkv_step_matches():
    B, H, hd = 2, 3, 4
    rs = np.random.RandomState(13)
    args = (rs.randn(B, H, hd), rs.randn(B, H, hd), rs.randn(B, H, hd),
            -rs.uniform(0.01, 2.0, (B, H, hd)), rs.randn(H, hd),
            rs.randn(B, H, hd, hd))
    args = [a.astype(np.float32) for a in args]
    jy, js = jrk.wkv_step(*map(jnp.asarray, args))
    ty, ts = trk.wkv_step(*map(torch.from_numpy, args))
    _close(ty, jy)
    _close(ts, js)


def _warm_state(state: dict, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    return {k: (0.5 * rs.randn(*v.shape)).astype(np.float32)
            for k, v in state.items()}


@pytest.mark.parametrize("S", [1, 5, 70])
def test_mamba_block_state_path_matches(S):
    """From a nonzero state (SSM state and conv tail): the output and the
    new state. S = 1 is the decode step, S = 70 two chunks."""
    cfg, tcfg = jconf.SMOKES["zamba2-2.7b"], tconf.SMOKES["zamba2-2.7b"]
    st = _warm_state(
        jax.tree_util.tree_map(np.asarray,
                               jmb.init_mamba_state(cfg, CTX, 2,
                                                    jnp.float32)), S)
    rs = np.random.RandomState(40 + S)
    p = params_np(cfg, "mamba", 41)
    x = rs.randn(2, S, cfg.d_model).astype(np.float32)
    jx, jst = jmb.mamba_block(_j(p), cfg, CTX, jnp.asarray(x), state=_j(st))
    tx, tst = tmb.mamba_block(_t(p), tcfg, torch.from_numpy(x),
                              state=_t(st))
    _close(tx, jx)
    assert set(tst) == set(jst)
    for name in jst:
        _close(tst[name], jst[name])
    tz = tmb.init_mamba_state(tcfg, 2, torch.float32)
    jz = jmb.init_mamba_state(cfg, CTX, 2, jnp.float32)
    for name in jz:
        assert tuple(tz[name].shape) == jz[name].shape


@pytest.mark.parametrize("S", [1, 5, 70])
def test_rwkv_block_state_path_matches(S):
    cfg, tcfg = jconf.SMOKES["rwkv6-7b"], tconf.SMOKES["rwkv6-7b"]
    st = _warm_state(
        jax.tree_util.tree_map(np.asarray,
                               jrk.init_rwkv_state(cfg, CTX, 2)), S)
    rs = np.random.RandomState(50 + S)
    p = params_np(cfg, "rwkv", 51)
    x = rs.randn(2, S, cfg.d_model).astype(np.float32)
    jx, jst = jrk.rwkv_block(_j(p), cfg, CTX, jnp.asarray(x), state=_j(st))
    tx, tst = trk.rwkv_block(_t(p), tcfg, torch.from_numpy(x),
                             state=_t(st))
    _close(tx, jx)
    assert set(tst) == set(jst)
    for name in jst:
        _close(tst[name], jst[name])
    tz = trk.init_rwkv_state(tcfg, 2)
    jz = jrk.init_rwkv_state(cfg, CTX, 2)
    for name in jz:
        assert tuple(tz[name].shape) == jz[name].shape


@pytest.mark.parametrize("S", [1, 6])
def test_token_shift_and_conv_with_prev_match(S):
    rs = np.random.RandomState(60 + S)
    h = rs.randn(2, S, 8).astype(np.float32)
    prev = rs.randn(2, 8).astype(np.float32)
    _close(trk._token_shift(torch.from_numpy(h), torch.from_numpy(prev)),
           jrk._token_shift(jnp.asarray(h), jnp.asarray(prev)))
    w = rs.randn(4, 8).astype(np.float32)
    tail = rs.randn(2, 3, 8).astype(np.float32)
    _close(tmb._causal_conv(torch.from_numpy(h), torch.from_numpy(w),
                            torch.from_numpy(tail)),
           jmb._causal_conv(jnp.asarray(h), jnp.asarray(w),
                            jnp.asarray(tail)))


def test_attention_block_serve_modes_match():
    """qwen3's attention block in prefill then decode (the cache written
    in place), against the reference's returned caches."""
    cfg, tcfg = jconf.SMOKES["qwen3-4b"], tconf.SMOKES["qwen3-4b"]
    B, S, T = 2, 5, 8
    rs = np.random.RandomState(70)
    p = params_np(cfg, "attn", 70)
    x = rs.randn(B, S, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    shape = (B, T, cfg.n_kv_heads, cfg.hd)
    zero = {"k": np.zeros(shape, np.float32),
            "v": np.zeros(shape, np.float32)}
    jx, jc = jlay.attention_block(_j(p), cfg, CTX, jnp.asarray(x),
                                  jnp.asarray(pos), mode="prefill",
                                  cache=_j(zero))
    tc = _t(zero)
    tx, tc2 = tlay.attention_block(_t(p), tcfg, torch.from_numpy(x),
                                   torch.from_numpy(pos), mode="prefill",
                                   cache=tc)
    assert tc2 is tc
    _close(tx, jx)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    x1 = rs.randn(B, 1, cfg.d_model).astype(np.float32)
    lens = np.array([S, S - 2])
    jx, jc = jlay.attention_block(_j(p), cfg, CTX, jnp.asarray(x1),
                                  jnp.asarray(lens[:, None]), mode="decode",
                                  cache=jc, kv_len=jnp.asarray(lens))
    tx, tc = tlay.attention_block(_t(p), tcfg, torch.from_numpy(x1),
                                  torch.from_numpy(lens[:, None]),
                                  mode="decode", cache=tc,
                                  kv_len=torch.from_numpy(lens))
    _close(tx, jx)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
