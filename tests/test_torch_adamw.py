"""AdamW's one-pass kernel (``kernels/adamw.py``, ``csrc/adamw.cu``).

On the CPU: the optimizer takes the plain version and launches nothing;
the plain version is the port's op-by-op AdamW bit for bit; the module
imports without ``nvcc``; ``row_layout``'s rows address every element of
the layouts the train step passes (column slices of the mean gradient,
rank and worker dimensions, cycle rows). On the card (``cuda`` marker, run
with ``python -m pytest --noconftest -m cuda tests/test_torch_adamw.py``):
the kernel is bit-equal (``torch.equal``) to the plain version over five
steps in those layouts, and one train step launches it once a segment.
"""

import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import adamw as ka
from repro_torch.kernels.dispatch import LAUNCHES, meta_shapes
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(b1=0.9, b2=0.95, eps=1e-8)


def todays_adamw(p, g, m, v, step, lr, weight_decay, b1=0.9, b2=0.95,
                 eps=1e-8):
    """A copy of the port's AdamW before the kernel (``optim/optimizers``):
    the bias corrections in f32 each call, sixteen torch ops."""
    t = torch.tensor(step + 1.0, dtype=torch.float32)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    upd = (m / bc1.item()) / (torch.sqrt(v / bc2.item()) + eps)
    upd.add_(weight_decay * p)
    lr = float(lr(step)) if callable(lr) else float(lr)
    return p - lr * upd


def _grad(shape, off, gen, device):
    """A gradient of ``shape``: contiguous where ``off`` is None, else as
    ``unpack_segs`` cuts the mean gradient: the columns [off, off + n) of
    a (lead..., n + off + 9) tensor, reshaped to ``shape``, the lead being
    the (tp, P) dimensions (size 2, 2) or P."""
    if off is None:
        return torch.randn(shape, generator=gen, device=device)
    lead = 2 if len(shape) >= 3 and shape[:2] == (2, 2) else 1
    n = math.prod(shape[lead:])
    wide = torch.randn((*shape[:lead], n + off + 9), generator=gen,
                       device=device)
    return wide[..., off:off + n].reshape(shape)


# (shape, column offset of the gradient's slice, None: contiguous):
# contiguous (P, f); column slices of a wider (P, d) at offsets 0, 4 and 5
# (5: rows whose starts differ in alignment from the params'); (tp, P, f)
# slices; (P, n_cycles, f) and (tp, P, n_cycles, f) cycle rows; (1, f)
# and (1, 1, f) rows
LAYOUTS = [((2, 1), None), ((2, 3), None), ((2, 4097), None),
           ((2, 4097), 0), ((2, 4097), 4), ((2, 4097), 5),
           ((2, 2, 4097), 11), ((2, 3, 1001), 3), ((2, 2, 3, 515), 7),
           ((1, 4097), 1), ((1, 1, 4099), 2), ((4097,), None)]


@pytest.mark.parametrize("shape,off", LAYOUTS)
def test_row_layout_addresses_every_element(shape, off):
    """The rows ``row_layout`` gives, walked as the kernel walks them,
    reach each tensor's elements in order, for gradient views of every
    layout above."""
    gen = torch.Generator().manual_seed(0)
    g = _grad(shape, off, gen, "cpu")
    p = torch.empty(shape)
    rows, strides, n = ka.row_layout((p, g))
    assert rows * n == p.numel()
    for t, st in zip((p, g), strides):
        base = t.storage_offset()
        want = torch.arange(t.untyped_storage().nbytes() // 4).as_strided(
            t.shape, t.stride(), base).reshape(-1)
        got = [torch.arange(base + r * st, base + r * st + n)
               for r in range(rows)]
        assert torch.equal(torch.cat(got), want)


def test_row_layout_raises_where_no_path_goes():
    p = torch.empty(4, 6)
    with pytest.raises(ValueError, match="stride 1"):
        ka.row_layout((p, torch.empty(6, 4).t()))
    g = torch.empty(4, 4, 16)[::2, ::2, :8]
    with pytest.raises(ValueError, match="evenly spaced"):
        ka.row_layout((torch.empty(g.shape), g))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("lr", ["const", "wsd"])
@pytest.mark.parametrize("shape,off", [((2, 4097), 5), ((2, 2, 3, 515), 7),
                                       ((2, 3), None)])
def test_plain_equals_todays_adamw_bit_for_bit(shape, off, lr,
                                               weight_decay):
    """The optimizer (the wrapper's plain path on CPU tensors) against a
    copy of today's formula: params and both moments equal to the bit over
    five steps, and no launch counted."""
    lr = 1e-3 if lr == "const" else schedule.wsd(1e-3, 2, 1, 5)
    opt = topt.adamw(lr=lr, weight_decay=weight_decay, **KW)
    gen = torch.Generator().manual_seed(1)
    p = torch.randn(shape, generator=gen)
    st = opt.init(shape)
    p_ref, m_ref, v_ref = p.clone(), *opt.init(shape)
    before = LAUNCHES["adamw"]
    for step in range(5):
        g = _grad(shape, off, gen, "cpu")
        p, st = opt.apply(p, g, st, step)
        p_ref = todays_adamw(p_ref, g, m_ref, v_ref, step, lr, weight_decay)
        assert torch.equal(p, p_ref)
        assert torch.equal(st[0], m_ref) and torch.equal(st[1], v_ref)
    assert LAUNCHES["adamw"] == before


def test_meta_tensors_follow_the_dispatch_table():
    """A meta tensor inside ``meta_shapes()`` gets an empty output of the
    params' shape; outside it, as any non-CPU tensor, the kernel path,
    which raises for a device that is not CUDA."""
    p = torch.empty((2, 8), device="meta")
    kw = dict(lr=1e-3, weight_decay=0.1, bc1=0.1, bc2=0.05, **KW)
    with meta_shapes():
        out = ka.adamw_update(p, p, p, p, **kw)
    assert out.device.type == "meta" and out.shape == p.shape
    with pytest.raises(ValueError, match="CUDA"):
        ka.adamw_update(p, p, p, p, **kw)


def test_module_imports_and_runs_on_cpu_without_nvcc():
    """Importing the wrapper and the optimizer builds nothing: with no
    ``nvcc`` and no loader the CPU path still runs."""
    code = (
        "from repro_torch.kernels import build\n"
        "def no(*a, **k): raise RuntimeError('nvcc reached')\n"
        "build.nvcc_path = build.load = no\n"
        "import torch\n"
        "from repro_torch.kernels.dispatch import LAUNCHES\n"
        "from repro_torch.optim import make\n"
        "opt = make('adamw', lr=1e-3)\n"
        "st = opt.init((2, 5))\n"
        "p, st = opt.apply(torch.ones(2, 5), torch.ones(2, 5), st, 0)\n"
        "assert LAUNCHES['adamw'] == 0 and not build._libs\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PATH="/usr/bin:/bin")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.parametrize("optimizer", ["adamw", "sgdm"])
def test_chip_smoke_counts_the_update_once_a_segment(optimizer):
    """``chip_smoke.py``'s launch model (``step_launches``) counts AdamW's
    update as often as one train step calls it: on the CPU its plain
    version, counted by the script's ``plain_calls``, once a flat segment;
    never with another optimizer."""
    import dataclasses
    import importlib

    from repro_torch.api import RunSpec
    from repro_torch.data import LMStream
    from repro_torch.launch import train as ttrain
    from repro_torch.models.flatten import SEG_NAMES
    sys.path.insert(0, ROOT)
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)
    spec = dataclasses.replace(RunSpec.load(os.path.join(
        ROOT, "examples", "specs", "qwen3_smoke.json")), optimizer=optimizer)
    cfg, opt, _, ts = ttrain.build(spec, "cpu")
    st = ts.init_state(opt, torch.Generator().manual_seed(0))
    gb = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                  global_batch=spec.batch, seed=spec.seed).global_batch_at(
                      0, "cpu")
    LAUNCHES.clear()
    with smoke.plain_calls() as plain:
        ts.fn(st, ttrain.shard_batch(gb, ts.nworkers))
    want = smoke.step_launches(ts, opt).get("adamw", 0)
    assert plain.get("adamw_update_plain", 0) == want
    assert want == (len(SEG_NAMES) if optimizer == "adamw" else 0)
    assert LAUNCHES["adamw"] == 0


# ----------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


CARD_LAYOUTS = LAYOUTS + [((2, 1 << 26), 7), ((1, (1 << 26) + 3), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("lr", ["const", "wsd"])
@pytest.mark.parametrize("shape,off", CARD_LAYOUTS,
                         ids=[f"{'x'.join(map(str, s))}-{o}"
                              for s, o in CARD_LAYOUTS])
def test_kernel_bit_equal_to_plain_on_card(card, shape, off, lr,
                                           weight_decay):
    """Five steps of the optimizer (the kernel) against the port's
    op-by-op AdamW on the same CUDA tensors: params, m and v equal to the
    bit every step; one launch a step."""
    lr = 1e-3 if lr == "const" else schedule.wsd(1e-3, 2, 1, 5)
    opt = topt.adamw(lr=lr, weight_decay=weight_decay, **KW)
    gen = torch.Generator(device=card).manual_seed(2)
    p = torch.randn(shape, generator=gen, device=card)
    st = opt.init(shape, card)
    p_ref, m_ref, v_ref = p.clone(), *opt.init(shape, card)
    for step in range(5):
        g = _grad(shape, off, gen, card)
        g[..., ::97] = 0.0          # zeros: 0 * wd, sqrt(0) paths
        before = LAUNCHES["adamw"]
        p, st = opt.apply(p, g, st, step)
        assert LAUNCHES["adamw"] == before + 1
        p_ref = todays_adamw(p_ref, g, m_ref, v_ref, step, lr, weight_decay)
        assert torch.equal(st[0], m_ref), step
        assert torch.equal(st[1], v_ref), step
        assert torch.equal(p, p_ref), step


@pytest.mark.cuda
def test_kernel_syncs_with_host_nowhere(card):
    opt = topt.adamw(lr=1e-3, **KW)
    p = torch.randn((2, 4097), device=card)
    st = opt.init(p.shape, card)
    g = torch.randn((2, 5000), device=card)[:, 3:4100]
    p, st = opt.apply(p, g, st, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p, st = opt.apply(p, g, st, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_raises_on_what_no_path_passes(card):
    kw = dict(lr=1e-3, weight_decay=0.1, bc1=0.1, bc2=0.05, **KW)
    p = torch.zeros((2, 8), device=card)
    with pytest.raises(ValueError, match="f32"):
        ka.adamw_update(p.bfloat16(), p.bfloat16(), p.bfloat16(),
                        p.bfloat16(), **kw)
    with pytest.raises(ValueError, match="stride 1"):
        ka.adamw_update(p, torch.zeros((8, 2), device=card).t(), p.clone(),
                        p.clone(), **kw)


@pytest.mark.cuda
def test_minicpm_smoke_step_launches_adamw_once_a_segment(card):
    """One train step of minicpm-2b's smoke config on the card: four
    launches, one a flat segment."""
    import dataclasses

    from repro_torch.api import RunSpec
    from repro_torch.core.gs_sgd import make_state
    from repro_torch.data import LMStream
    from repro_torch.launch import train as ttrain
    from repro_torch.models.flatten import SEG_NAMES, init_flat_params
    spec = dataclasses.replace(RunSpec.load(os.path.join(
        ROOT, "examples", "specs", "qwen3_smoke.json")), arch="minicpm-2b")
    cfg, opt, _, ts = ttrain.build(spec, card)
    params = init_flat_params(cfg, torch.Generator().manual_seed(0), 1,
                              ts.fs)
    st = make_state({k: v.to(card) for k, v in params.items()}, opt,
                    ts.compressor, ts.d_local, ts.nworkers)
    gb = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                  global_batch=spec.batch, seed=spec.seed).global_batch_at(
                      0, card)
    LAUNCHES.clear()
    st, m = ts.fn(st, ttrain.shard_batch(gb, ts.nworkers))
    torch.cuda.synchronize()
    assert LAUNCHES["adamw"] == len(SEG_NAMES) == 4
    assert torch.isfinite(m["loss"])
