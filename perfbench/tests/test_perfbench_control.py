"""On the card (marker cuda; skips without one): the control, the
reference computed with TF32 matmuls in the program's place, comes out
not correct on three seeds, and the program itself correct, at a size a
test run can hold. The cells' own readings come from calibrate.py."""

import time

import pytest
import torch

import smoke
from pbench import compare, harness

# limits at this size on the card (H100, 12 seeds of the program: loss
# 0-8.59e-8, update 6.53e-8-1.59e-7, change 9.83e-8-2.69e-7; 4 seeds of
# the TF32 control: 3.43e-7-1.29e-6, 7.51e-5-4.20e-4, 1.95e-5-1.66e-4; the
# faults 4.55e-6 and up): each the geometric mean of the two readings
CARD_LIMITS = {"loss_gap": {"limit": 1.7e-7}, "grad_gap": {"limit": 3.5e-6},
               "change_gap": {"limit": 2.3e-6}}
CELL = {**smoke.cell("gqa", seqs_per_worker=2, seq_len=128),
        "limits": CARD_LIMITS}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_perfbench_control_is_not_correct(seed):
    dev = card()
    conf, traffic = CELL["conf"], CELL["traffic"]
    ref = harness.reference_readings(conf, traffic, seed, dev)
    bad = harness.reference_readings(conf, traffic, seed, dev, tf32=True)
    ok, checks = compare.judge(compare.numbers(bad, ref), CELL["limits"])
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_perfbench_program_on_the_card_is_correct(seed):
    out = harness.run_single(CELL, seed, 0.5, False, card(), time.time())
    ok, checks = compare.judge(out["numbers"], CELL["limits"])
    assert ok, checks
