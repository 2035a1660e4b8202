"""The plain reference against the program at smoke size on the CPU, its
sketch arithmetic against brute force, and whole runs that must come
out correct."""

import time

import numpy as np
import pytest
import torch

import smoke
from pbench import harness, inputs, layout, port, sketch_ref

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_perfbench_hash_matches_uint32_arithmetic():
    sk = sketch_ref.Sketch(5, 256, 3, CPU)
    p = sketch_ref.hash_params(3, 5).astype(np.uint64)
    i = np.arange(0, 5000, dtype=np.uint64) * np.uint64(977)
    b, s = sk.cells(0, 5000 * 977, CPU)
    b, s = b[:, ::977].numpy(), s[:, ::977].numpy()
    for r in range(5):
        want_b = ((p[r, 0] * i + p[r, 1]) % 2 ** 32) >> np.uint64(24)
        want_s = 1 - 2 * (((p[r, 2] * i + p[r, 3]) % 2 ** 32) >> np.uint64(31)
                          ).astype(np.int64)
        assert (b[r] == want_b.astype(np.int64)).all()
        assert (s[r] == want_s).all()


def test_perfbench_encode_and_estimates_brute_force():
    g = torch.Generator().manual_seed(0)
    u = torch.randn(3000, generator=g)
    sk = sketch_ref.Sketch(5, 64, 1, CPU)
    table = sk.encode(u)
    b, s = sk.cells(0, 3000, CPU)
    want = torch.zeros(5, 64, dtype=torch.float64)
    for r in range(5):
        want[r].index_add_(0, b[r], (s[r] * u).double())
    assert torch.equal(table, want.float())
    est = sk.estimates(table, 3000)
    rows = torch.stack([table[r, b[r]] * s[r] for r in range(5)])
    assert torch.equal(est, rows.median(dim=0).values)


def test_perfbench_topk_takes_lowest_index_ties():
    score = torch.tensor([1.0, 3.0, 2.0, 2.0, 3.0, 2.0])
    assert sorted(sketch_ref.topk_lowest_index(score, 4).tolist()) == \
        [1, 2, 3, 4]


@pytest.mark.parametrize("kind", ["gqa", "mha"])
def test_perfbench_reference_loss_matches_program(kind):
    conf = smoke.CONFS[kind]
    lay = layout.layout(layout.Shape.of(conf))
    flat = inputs.initial_params(lay, 5, CPU)
    gb = inputs.batch(lay.shape, smoke.TRAFFIC, 5, 0, CPU)
    from repro_torch.models import model as mdl
    ts = port.build_step(conf, smoke.TRAFFIC, CPU)
    want = float(mdl.loss_fn(ts.fs.cfg, ts.fs, inputs.segments_of(flat, lay),
                             {k: v[:2] for k, v in gb.items()}))
    from pbench import reference
    got, _ = reference.loss_and_grad(flat, lay, gb["tokens"][:2],
                                     gb["labels"][:2])
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("kind,seed", [("gqa", 3), ("mha", 2 ** 33 + 1)])
@pytest.mark.parametrize("trace", [False, True])
def test_perfbench_run_is_correct(kind, seed, trace):
    out = harness.run_single(smoke.cell(kind), seed, 0.3, trace, CPU,
                             time.time())
    nums = out["numbers"]
    assert all(nums[n] <= smoke.LIMITS[n]["limit"] for n in nums), nums
    assert out["failed"] == 0 and out["attempted"] > harness.CHECK_STEPS
    assert out["tokens_per_s"] > 0
    if trace:   # the window, then the profiled steps
        r = out["ranks"][0]
        assert r["steps"] == smoke.TRAFFIC["profile_steps"]
        assert r["untraced_step_s"] == pytest.approx(
            out["window_s"] / len(out["step_s"]))
