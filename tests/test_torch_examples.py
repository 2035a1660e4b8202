"""The port's four examples (``repro_torch.examples``) on the CPU at their
smallest flags: quickstart recovers all 16 planted coordinates and keeps
the replicas equal; the fault-tolerant run goes P = 5 -> 4, drops the
straggler and keeps the replicas equal; every request of the serving
demo finishes with no leaked block; ``train_lm_e2e`` at a 2-layer narrow
``ArchConfig`` resumed from its step-2 checkpoint gives step 2's loss
bit-equal to a straight 3-step run. The fault-tolerant scenario's
numbers against the JAX package are in ``test_torch_elastic.py``."""

import dataclasses
import math

import pytest
import torch

from repro_torch.examples import (fault_tolerant_training, quickstart,
                                  serve_batched, train_lm_e2e)

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart():
    out = quickstart.main(CPU)
    assert out["sketch"]["recovered"] == out["sketch"]["k"] == 16
    assert abs(out["sketch"]["est0"] - 5.0) < 0.5
    assert out["train"]["divergence"] == 0.0
    losses = out["train"]["losses"]
    assert len(losses) == 10 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]


def test_fault_tolerant_training():
    out = fault_tolerant_training.main(CPU)
    assert (out["p_before"], out["p_after"]) == (5, 4)
    assert out["survivors"] == [0, 1, 2, 4]
    assert out["mask"] == [True, False, True, True]
    assert len(out["losses"]) == 9
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["divergence"] == 0.0


def test_serve_batched():
    out = serve_batched.main(CPU)
    assert out["completed"] == out["requests"] == 8
    assert set(out["finish"]) <= {"length", "stop"}
    assert out["free_blocks"] == out["num_blocks"] - 1
    assert out["tokens"] > 0 and out["decode_steps"] > 0


NARROW = dataclasses.replace(train_lm_e2e.LM_100M, name="lm-narrow",
                             n_layers=2, d_model=64, n_heads=4,
                             n_kv_heads=4, d_ff=128, vocab_size=512)
SMALL = ["--k", "256", "--width", "1024", "--seq", "16", "--batch", "2"]


def test_train_lm_e2e_resume_equals_a_straight_run(tmp_path):
    straight = train_lm_e2e.main(CPU + SMALL + [
        "--steps", "3", "--ckpt-dir", str(tmp_path / "a")], cfg=NARROW)
    first = train_lm_e2e.main(CPU + SMALL + [
        "--steps", "2", "--ckpt-dir", str(tmp_path / "b")], cfg=NARROW)
    resumed = train_lm_e2e.main(CPU + SMALL + [
        "--steps", "3", "--resume", "--ckpt-dir", str(tmp_path / "b")],
        cfg=NARROW)
    assert straight["start"] == first["start"] == 0
    assert resumed["start"] == 2 and list(resumed["losses"]) == [2]
    assert first["losses"] == {i: straight["losses"][i] for i in (0, 1)}
    assert resumed["losses"][2] == straight["losses"][2]
    assert all(math.isfinite(x) for x in straight["losses"].values())
    assert (tmp_path / "b" / "step_3").is_dir()


def test_lm_100m_keeps_the_reference_geometry():
    """The reference's LM_100M (examples/train_lm_e2e.py), field for
    field, and so its flat size (untied embeddings: 135,285,760)."""
    from repro.models.common import ArchConfig
    from repro.models.flatten import make_flat_spec as j_flat
    from repro_torch.models.flatten import make_flat_spec
    cfg = train_lm_e2e.LM_100M
    ref = ArchConfig(
        name="lm-110m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=2048, vocab_size=32768,
        notes="GPT-2-small-scale llama-style demo model (~110M params)")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert make_flat_spec(cfg, 1).total == j_flat(ref, 1).total == 135285760
