"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of the run driven at
smoke size on the CPU with each fault a training cell can have planted
in the program."""

import dataclasses
import time

import pytest
import torch

import run as run_mod
import smoke
from pbench import harness

torch.set_num_threads(2)
CPU = torch.device("cpu")


def unchanged(ts):
    """A step that returns its state unchanged."""
    def fn(state, batch, include=None):
        _, m = ts.fn(state, batch, include)
        return state, m
    return dataclasses.replace(ts, fn=fn)


def half_batch(ts):
    """Half of every worker's tokens left out, the mean over the rest."""
    def fn(state, batch, include=None):
        lab = batch["labels"].clone()
        lab[..., lab.shape[-1] // 2:] = -1
        return ts.fn(state, {**batch, "labels": lab}, include)
    return dataclasses.replace(ts, fn=fn)


def no_exchange(monkeypatch):
    """The exchange between workers left out: every sum over workers
    returns the worker's own part."""
    from repro_torch.core import allreduce
    monkeypatch.setattr(allreduce, "psum_allreduce", lambda x, p=None: x)
    monkeypatch.setattr(allreduce, "allreduce",
                        lambda x, p, mode="psum": x)
    return None


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "no_exchange"])
def test_perfbench_fault_is_not_correct(fault, monkeypatch):
    step_fn = {"unchanged": unchanged, "half_batch": half_batch,
               "no_exchange": no_exchange(monkeypatch)
               if fault == "no_exchange" else None}[fault]
    cell = smoke.cell("gqa")
    out = harness.run_single(cell, 11, 0.2, False, CPU, time.time(),
                             step_fn=step_fn)
    res = run_mod.result({**cell, "end_to_end": [], "per_layer": []}, out,
                         False, "cpu")
    assert res["correct"] is False, res["checks"]
    assert list(res)[-1] == "checks"


def test_perfbench_jax_check_compares_whole_names(monkeypatch):
    import sys
    assert run_mod.banned_modules() == []   # the runs above loaded none
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert run_mod.banned_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run_mod.banned_modules() == ["jax", "repro"]
