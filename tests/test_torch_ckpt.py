"""The port's checkpoints (``repro_torch.ckpt``): atomicity, keep-N,
async, and a bit-exact training resume, mirroring tests/test_ckpt.py's
seven cases on the port's state (tensors in nested dicts and tuples).

The resume runs ``repro_torch.launch.train`` on the smoke spec: four steps
straight against two, a simulated crash (``--kill-at 2``) and a resume
(``--resume``) to step 4. The stream is counter-based and every tensor of
the state is saved, so the losses, the final params, optimizer moments
and error feedback must be bit-equal, and so must the step-4 checkpoints
of the two runs.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch import ckpt
from repro_torch.launch import train as train_mod
from tests.test_torch_gs_sgd import SPEC


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((32, 8), generator=g),
            "opt": (torch.arange(5, dtype=torch.float32),
                    torch.tensor(7, dtype=torch.int32)),
            "h": torch.randn(3, generator=g).to(torch.bfloat16),
            "step": 3}


def _equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_save_restore_roundtrip(tmp_path):
    s = _state()
    ckpt.save(str(tmp_path), 10, s, {"note": "hi"})
    r, meta = ckpt.restore(str(tmp_path), s)
    _equal(s, r)
    assert meta["step"] == 10 and meta["note"] == "hi"


def test_latest_and_keep_n(tmp_path):
    s = _state()
    for step in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), step, s, keep=3)
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_restore_specific_step(tmp_path):
    for step in (1, 2):
        ckpt.save(str(tmp_path), step, {"x": torch.tensor(float(step))})
    r, _ = ckpt.restore(str(tmp_path), {"x": torch.tensor(0.0)}, step=1)
    assert float(r["x"]) == 1.0


def test_crash_consistency_tmp_never_corrupts(tmp_path):
    """A stale .tmp- dir (simulated mid-save crash) is invisible to restore."""
    s = _state()
    ckpt.save(str(tmp_path), 1, s)
    os.makedirs(tmp_path / ".tmp-step_2.h0")  # crashed save
    (tmp_path / ".tmp-step_2.h0" / "leaf_0000.h0.npy.part").write_bytes(
        b"garbage")
    assert ckpt.latest_step(str(tmp_path)) == 1
    r, meta = ckpt.restore(str(tmp_path), s)
    assert meta["step"] == 1


def test_leaf_count_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(3),
                                     "b": torch.zeros(2)})


def test_async_checkpointer(tmp_path):
    """The snapshot is taken at save(): an in-place update right after it
    (as the optimizer makes) does not reach the files."""
    s = _state()
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    want = s["w"].clone()
    for step in (10, 20, 30):
        ac.save(step, s)
        s["w"].add_(1.0)
    ac.wait()
    assert ckpt.all_steps(str(tmp_path)) == [20, 30]
    r, _ = ckpt.restore(str(tmp_path), s, step=30)
    assert torch.equal(r["w"], want.add(1.0).add(1.0))


def _ckpt_leaves(d, step):
    path = os.path.join(d, f"step_{step}")
    return {f: np.load(os.path.join(path, f)) for f in sorted(os.listdir(path))
            if f.endswith(".npy")}


def test_training_resume_bit_exact(tmp_path):
    """train 4 straight == train 2, crash, resume 2: identical losses,
    final state and step-4 checkpoint, bit for bit."""
    base = ["--spec", SPEC, "--device", "cpu", "--steps", "4",
            "--log-every", "100"]
    d_full, d = str(tmp_path / "full"), str(tmp_path / "ck")
    r_full = train_mod.main(base + ["--ckpt-dir", d_full])
    crashed = train_mod.main(base + ["--ckpt-dir", d, "--ckpt-every", "1",
                                     "--kill-at", "2"])
    assert crashed["crashed_at"] == 2 and ckpt.latest_step(d) == 2
    r_resumed = train_mod.main(base + ["--ckpt-dir", d, "--ckpt-every", "1",
                                       "--resume"])
    assert r_full["history"][2:] == r_resumed["history"]
    assert r_full["history"][:2] == crashed["history"]
    assert r_full["final_loss"] == r_resumed["final_loss"]
    _equal(r_full["state"], r_resumed["state"])
    a, b = _ckpt_leaves(d_full, 4), _ckpt_leaves(d, 4)
    assert list(a) == list(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
