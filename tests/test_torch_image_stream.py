"""The port's ``ImageStream`` (``repro_torch.data.pipeline``): a batch is
a pure function of (seed, step); ``shard_at`` is the slice of
``global_batch_at``; CIFAR-10 geometry (NHWC f32 images, int labels in
[0, n_classes)), as the reference's (``repro/data/pipeline.py``), whose
numbers it does not redraw."""

import pytest
import torch

from repro.data import ImageStream as JStream
from repro_torch.data import ImageStream
from repro_torch.data.pipeline import _fold, _step_seed


def test_deterministic_per_seed_and_step():
    a, b = ImageStream(global_batch=8, seed=3), ImageStream(global_batch=8,
                                                            seed=3)
    for step in (0, 5):
        x, y = a.global_batch_at(step), b.global_batch_at(step)
        assert torch.equal(x["images"], y["images"])
        assert torch.equal(x["labels"], y["labels"])
    assert not torch.equal(a.global_batch_at(0)["images"],
                           a.global_batch_at(1)["images"])
    assert not torch.equal(a.global_batch_at(0)["images"],
                           ImageStream(global_batch=8, seed=4)
                           .global_batch_at(0)["images"])


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_is_slice_of_global(n_shards):
    s = ImageStream(global_batch=8, seed=1)
    g = s.global_batch_at(2)
    per = 8 // n_shards
    for i in range(n_shards):
        sh = s.shard_at(2, i, n_shards)
        for k in ("images", "labels"):
            assert torch.equal(sh[k], g[k][i * per:(i + 1) * per])
    with pytest.raises(ValueError):
        s.shard_at(2, 0, 3)


def test_geometry_like_the_reference():
    s, j = ImageStream(global_batch=6), JStream(global_batch=6)
    b, jb = s.global_batch_at(0), j.global_batch_at(0)
    assert tuple(b["images"].shape) == tuple(jb["images"].shape) == (
        6, 32, 32, 3)
    assert b["images"].dtype == torch.float32
    assert b["labels"].shape == (6,)
    assert int(b["labels"].min()) >= 0 and int(b["labels"].max()) < 10
    big = ImageStream(global_batch=512).global_batch_at(0)
    assert len(set(big["labels"].tolist())) == 10


def test_class_means_fixed_by_seed():
    """Images of one class share the seed's mean: their average is near
    it (noise 0.6)."""
    s = ImageStream(global_batch=512, seed=0)
    means = s._means()
    assert torch.equal(means, ImageStream(seed=0)._means())
    b = s.global_batch_at(3)
    sel = b["labels"] == 4
    avg = b["images"][sel].mean(0)
    assert float((avg - means[4]).abs().mean()) < 0.6 * 3 / sel.sum() ** 0.5


def test_fold_chains_step_seeds():
    assert _fold(5) == 5
    assert _fold(5, 2) == _step_seed(5, 2)
    assert _fold(5, 2, 3) == _step_seed(_step_seed(5, 2), 3)


def test_device_argument():
    b = ImageStream(global_batch=4).global_batch_at(0, device="cpu")
    assert b["images"].device.type == "cpu"
