"""Port parity: repro_torch.optim.schedule against repro.optim.schedule.

Every schedule is evaluated at steps 0..200 in both packages and the f32
values must be bit-equal (the port computes op for op in f32, and its
cosine is the C library's cosf, which XLA calls on the CPU). The density
stairs are integers: equal.
"""

import numpy as np
import pytest
import torch

from repro.optim import schedule as J
from repro_torch import optim as topt
from repro_torch.optim import schedule as T

STEPS = range(201)


def _bits(x) -> int:
    return int(np.asarray(x, dtype=np.float32).view(np.int32))


@pytest.mark.parametrize("name,args", [
    ("constant", (0.1,)), ("constant", (3e-4,)),
    ("warmup_cosine", (3e-4, 10, 200)), ("warmup_cosine", (0.1, 0, 150)),
    ("warmup_cosine", (1e-3, 7, 100, 0.3)), ("warmup_cosine", (0.5, 50, 60)),
    ("wsd", (1e-3, 1, 0, 2)), ("wsd", (3e-4, 10, 100, 50)),
    ("wsd", (0.01, 0, 5, 40, 0.2)), ("wsd", (2e-2, 30, 0, 1))])
def test_schedule_bit_equal(name, args):
    jf, tf = J.SCHEDULES[name](*args), T.SCHEDULES[name](*args)
    for s in STEPS:
        got = tf(s)
        assert got.dtype == torch.float32 and got.shape == ()
        assert _bits(got.numpy()) == _bits(jf(s)), (name, args, s)


def test_wsd_values_of_the_minicpm_cell():
    """warmup 1, stable 0, decay 2: 0, lr, 0.55 lr at steps 0-2."""
    f = T.wsd(1e-3, warmup=1, stable=0, decay=2)
    assert [float(f(s)) for s in range(3)] == [
        0.0, float(np.float32(1e-3)),
        float(np.float32(1e-3) * np.float32(1.0 - 0.9 * 0.5))]


@pytest.mark.parametrize("k_final,d,spe", [(1000, 100_000, 7),
                                           (10, 64, 1), (5, 10**6, 50)])
def test_warmup_density_equal(k_final, d, spe):
    jf, tf = J.warmup_density(k_final, d, spe), T.warmup_density(k_final, d,
                                                                  spe)
    for s in STEPS:
        assert int(tf(s)) == int(jf(s))


def test_constants_and_exports():
    assert T.PAPER_WARMUP_DENSITIES == J.PAPER_WARMUP_DENSITIES
    assert T.PAPER_WARMUP_LRS == J.PAPER_WARMUP_LRS
    assert sorted(T.SCHEDULES) == sorted(J.SCHEDULES)
    for name in ("constant", "warmup_cosine", "wsd", "warmup_density",
                 "SCHEDULES", "PAPER_WARMUP_DENSITIES", "schedule"):
        assert hasattr(topt, name)


def test_optimizer_takes_a_schedule():
    """AdamW under wsd: step 0's lr is 0, so the params do not move."""
    opt = topt.make("adamw", lr=T.wsd(1e-3, 1, 0, 2))
    p = torch.ones(4)
    st = opt.init((4,))
    p0, st = opt.apply(p, torch.full((4,), 0.5), st, 0)
    assert torch.equal(p0, p)
    p1, _ = opt.apply(p, torch.full((4,), 0.5), st, 1)
    assert bool((p1 < p).all())
