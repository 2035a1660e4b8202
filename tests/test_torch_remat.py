"""The cycle remat (``repro_torch.models.model``: ``scan_cycles``, the
reference's sqrt-n ``_scan_cycles``): the loss and every gradient with
remat on equal, bit for bit, to remat off, at n = 4, 5 and 9 cycles (the
two-level structure with n2 = 2, 2 and 3; a tail at n = 5), for a dense
arch and the hybrid (whose weight-tied shared block is read by every
cycle), through ``loss_fn`` and through ``chunked_loss_vjp``; and against
the reference's ``loss_fn`` with remat on (``jax.grad``) in f32.

What the forward holds: a saved-tensor tally
(``torch.autograd.graph.saved_tensors_hooks``: the bytes saved outside
any checkpointed region) plus the carries the top-level checkpoints keep
for their recompute. With remat the cycle stack keeps n1 + (n - n1 * n2)
carries (n1 = n // n2 groups and the tail), where a flat remat keeps n
and no remat every cycle's activations. Stated before the first reading:
at n = 9 the sqrt-n run holds at most 1/REMAT_FACTOR of the bytes the
run without remat holds.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as J_SMOKES
from repro.models import model as jmdl
from repro.models.common import ShardCtx as JCtx
from repro.models.flatten import make_flat_spec as j_make_flat_spec
from repro_torch.configs import SMOKES
from repro_torch.models import model as mdl
from repro_torch.models.flatten import make_flat_spec

REMAT_FACTOR = 10
REF_RTOL, REF_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deep(arch: str, n: int):
    base = SMOKES[arch]
    per = (base.shared_attn_every if base.family == "hybrid"
           and base.shared_attn_every else
           sum(k != "shared_attn" for k in base.cycle))
    return dataclasses.replace(base, n_layers=n * per)


def segs_np(cfg, seed: int = 0) -> dict:
    fs = make_flat_spec(cfg, 1)
    rs = np.random.RandomState(seed)
    return {k: (0.05 * rs.randn(*s)).astype(np.float32)
            for k, s in fs.seg_shapes().items()}


def batch_np(cfg, B: int = 2, S: int = 12, seed: int = 1) -> dict:
    rs = np.random.RandomState(seed)
    t = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)
    return {"tokens": t, "labels": t}


def loss_and_grads(cfg, segs: dict, batch: dict, remat: bool):
    fs = make_flat_spec(cfg, 1)
    use = {k: torch.from_numpy(v).requires_grad_() for k, v in segs.items()}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = mdl.loss_fn(cfg, fs, use, b, remat=remat)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in use.items()}


@pytest.mark.parametrize("n", [4, 5, 9])
@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b"])
def test_remat_loss_and_grads_bit_equal(arch, n):
    cfg = deep(arch, n)
    segs, batch = segs_np(cfg), batch_np(cfg)
    l0, g0 = loss_and_grads(cfg, segs, batch, remat=False)
    l1, g1 = loss_and_grads(cfg, segs, batch, remat=True)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("n,chunks", [(5, 2), (9, 2)])
@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b"])
def test_remat_chunked_vjp_bit_equal(arch, n, chunks):
    """Each chunk of ``chunked_loss_vjp`` runs its cycles in the remat's
    structure: its steps' cycle gradients and the top gradients equal
    remat off's, and the monolithic ``loss_fn``'s."""
    cfg = deep(arch, n)
    fs = make_flat_spec(cfg, 1)
    segs, batch = segs_np(cfg), batch_np(cfg)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for remat in (False, True):
        use = {k: torch.from_numpy(v) for k, v in segs.items()}
        loss, steps, top = mdl.chunked_loss_vjp(cfg, fs, use, b,
                                                chunks=chunks, remat=remat)
        rows = [step() for step in steps]
        out[remat] = (loss, rows, top())
    (l0, r0, t0), (l1, r1, t1) = out[False], out[True]
    assert torch.equal(l0, l1)
    for (ab0, cs0, cr0), (ab1, cs1, cr1) in zip(r0, r1):
        assert ab0 == ab1
        assert torch.equal(cs0, cs1) and torch.equal(cr0, cr1)
    assert torch.equal(t0[0], t1[0]) and torch.equal(t0[1], t1[1])
    lm, gm = loss_and_grads(cfg, segs, batch, remat=True)
    assert torch.equal(l1, lm)
    cs = torch.cat([c for _, c, _ in sorted(r1, key=lambda r: r[0])])
    assert torch.equal(cs, gm["cycles_s"])
    assert torch.equal(t1[0], gm["top_s"])


@pytest.mark.parametrize("n", [4, 9])
def test_remat_matches_reference(n):
    cfg, jcfg = deep("qwen3-4b", n), dataclasses.replace(
        J_SMOKES["qwen3-4b"], n_layers=n)
    segs, batch = segs_np(cfg), batch_np(cfg)
    jfs = j_make_flat_spec(jcfg, 1)

    def jloss(segs):
        return jmdl.loss_fn(jcfg, JCtx(dtype=jnp.float32), jfs, segs,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            remat=True)

    want, jg = jax.value_and_grad(jloss)(
        {k: jnp.asarray(v) for k, v in segs.items()})
    got, tg = loss_and_grads(cfg, segs, batch, remat=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REF_RTOL)
    for k in tg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=REF_RTOL, atol=REF_ATOL, err_msg=k)


class Holdings:
    """The bytes a forward leaves for its backward: tensors saved outside
    any checkpointed region (the hooks) and the inputs of the top-level
    checkpointed calls (``remat_call`` entered outside another one)."""

    def __init__(self, monkeypatch):
        self.saved = 0
        self.carries = 0
        self.calls = 0
        self.depth = 0
        self.forward = True        # counted in the forward only
        orig = mdl.remat_call

        def counting(fn, *args):
            if self.depth == 0 and self.forward:
                self.calls += 1
                self.carries += sum(a.numel() * a.element_size()
                                    for a in args
                                    if isinstance(a, torch.Tensor))
            self.depth += 1
            try:
                return orig(fn, *args)
            finally:
                self.depth -= 1

        monkeypatch.setattr(mdl, "remat_call", counting)

    def pack(self, t):
        self.saved += t.numel() * t.element_size()
        return t

    @property
    def total(self) -> int:
        return self.saved + self.carries


def held(cfg, remat: bool, monkeypatch) -> Holdings:
    h = Holdings(monkeypatch)
    fs = make_flat_spec(cfg, 1)
    segs, batch = segs_np(cfg), batch_np(cfg, B=2, S=32)
    use = {k: torch.from_numpy(v).requires_grad_() for k, v in segs.items()}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.autograd.graph.saved_tensors_hooks(h.pack, lambda t: t):
        loss = mdl.loss_fn(cfg, fs, use, b, remat=remat)
    h.forward = False
    loss.backward()
    monkeypatch.undo()
    return h


@pytest.mark.parametrize("n", [4, 5, 9])
def test_sqrt_n_structure_holds_less(n, monkeypatch):
    cfg = deep("qwen3-4b", n)
    n2 = math.isqrt(n)
    n1 = n // n2
    on = held(cfg, True, monkeypatch)
    off = held(cfg, False, monkeypatch)
    # the cycle stack's top-level checkpoints: n1 groups and the tail
    assert on.calls == n1 + (n - n1 * n2)
    assert off.calls == 0
    carry = 2 * 32 * cfg.d_model * 4 + 4        # (x, aux) in f32
    assert on.carries == on.calls * carry
    if n == 9:
        assert on.total * REMAT_FACTOR <= off.total, (on.total, off.total)
    assert on.total < off.total


def _regions(nested: bool):
    """Four regions of exp(3 t) in a row, inside one more region or not;
    returns (the gradient, the tensors saved outside every region)."""
    from repro_torch.models.remat import remat_call
    x = torch.linspace(-1.0, 1.0, 64, dtype=torch.float64,
                       requires_grad=True)
    packed = []

    def chain(t):
        for _ in range(4):
            t = remat_call(lambda u: (u * 0.5).exp(), t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: packed.append(t) or t, lambda t: t):
        y = remat_call(chain, x) if nested else chain(x)
    y.sum().backward()
    return x.grad, packed


def test_nested_regions_keep_only_the_outer_input():
    """A region inside another keeps nothing: its inputs are saved
    through the enclosing region's holders, so the forward leaves the
    outer region's input alone (the sqrt-n groups' carries); the same
    regions unnested keep each one's. The gradient is the plain one."""
    g_flat, kept_flat = _regions(nested=False)
    g_nested, kept_nested = _regions(nested=True)
    x = torch.linspace(-1.0, 1.0, 64, dtype=torch.float64,
                       requires_grad=True)
    y = x
    for _ in range(4):
        y = (y * 0.5).exp()
    y.sum().backward()
    assert torch.equal(g_flat, x.grad) and torch.equal(g_nested, x.grad)
    assert len(kept_flat) == 4 and len(kept_nested) == 1
