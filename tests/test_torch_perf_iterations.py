"""Port parity: ``repro_torch.bench.perf_iterations`` against
``benchmarks/perf_iterations.py``.

Both packages run their three climbs once (module fixtures; the
reference's output directory is pointed at ``tmp_path``). Every
iteration's counts (FLOPs, HBM bytes, wire bytes by axis, model FLOPs,
notes) equal the reference's, and its options; the times and verdicts
are the H100 constants' and are not compared. The opt-ins move the
counts by their algebraic ratios: the parallel block x(n+1)/(2n+1) on
the model axis (within 0.1, as ``tests/test_perf_opts.py``), the fp8
wire exactly x0.25 of a serving cell's activation reductions, and
microbatch 2 -> 8 cuts the fsdp gather passes from 9 to 3.
"""

import pytest

from benchmarks import perf_iterations as jpi
from repro_torch.bench import perf_iterations as tpi
from repro_torch.configs import ARCHS

COUNTS = ("flops", "hbm_bytes", "coll_bytes_model", "coll_bytes_data",
          "coll_bytes_pod", "model_flops", "notes", "arch", "shape", "mesh",
          "dp_mode")
PAIRS = ("qwen3-4b/train_4k/multi", "qwen3-4b/train_4k/multi-dense-ref",
         "qwen3-moe-235b-a22b/train_4k/multi",
         "zamba2-2.7b/prefill_32k/single")


@pytest.fixture(scope="module")
def climbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("perf_iterations")
    mp = pytest.MonkeyPatch()
    mp.setattr(jpi, "OUT", str(tmp / "j"))
    try:
        ref = jpi.main()
    finally:
        mp.undo()
    return ref, tpi.main(["--out", str(tmp / "t")]), tmp


def _by_iter(log):
    return {e["iter"]: e for e in log}


def test_same_climbs_and_iterations(climbs):
    ref, got, tmp = climbs
    assert list(got) == list(ref) == list(PAIRS)
    for pair in PAIRS:
        assert [e["iter"] for e in got[pair]] == [e["iter"]
                                                  for e in ref[pair]]
        assert [e.get("opts") for e in got[pair]] == [e.get("opts")
                                                      for e in ref[pair]]
    assert (tmp / "t" / "perf_iterations.json").exists()


@pytest.mark.parametrize("pair", PAIRS)
def test_counts_equal_the_reference(climbs, pair):
    ref, got, _ = climbs
    for e_j, e_t in zip(ref[pair], got[pair]):
        rj, rt = e_j["result"], e_t["result"]
        assert {k: rt[k] for k in COUNTS} == {k: rj[k] for k in COUNTS}


def test_hypotheses_state_no_accelerator_figures(climbs):
    _, got, _ = climbs
    for pair in PAIRS:
        for e in got[pair]:
            assert "TPU" not in e.get("hypothesis", "")


def test_verdicts_follow_the_h100_terms(climbs):
    _, got, _ = climbs
    for pair in PAIRS:
        log = got[pair]
        for prev, e in zip(log, log[1:]):
            dom = prev["result"]["dominant"]
            gain = 1.0 - (e["result"][f"t_{dom}_s"]
                          / prev["result"][f"t_{dom}_s"])
            assert e["dominant_gain"] == gain
            want = ("confirmed" if gain > 0.05 else
                    "refuted" if gain < -0.02 else "below-5% (converging)")
            assert e["verdict"] == want


def test_algebraic_ratios(climbs):
    _, got, _ = climbs
    p1 = _by_iter(got["qwen3-4b/train_4k/multi"])
    n = ARCHS["qwen3-4b"].n_layers
    pb = (p1["parallel block"]["result"]["coll_bytes_model"]
          / p1["bf16 sketch wire"]["result"]["coll_bytes_model"])
    assert abs(pb - (n + 1) / (2 * n + 1)) < 0.1
    p3 = _by_iter(got["zamba2-2.7b/prefill_32k/single"])
    assert (p3["fp8 activation wire"]["result"]["coll_bytes_model"]
            / p3["baseline"]["result"]["coll_bytes_model"]) == 0.25
    p2 = _by_iter(got["qwen3-moe-235b-a22b/train_4k/multi"])
    assert (p2["microbatch 2->8"]["result"]["coll_bytes_data"]
            / p2["baseline"]["result"]["coll_bytes_data"]) == pytest.approx(
        3 / 9, rel=1e-12)
    assert (p2["remat re-gather skip"]["result"]["coll_bytes_data"]
            / p2["microbatch 2->8"]["result"]["coll_bytes_data"]
            ) == pytest.approx(2 / 3, rel=1e-12)
    dense = got["qwen3-4b/train_4k/multi-dense-ref"][0]["result"]
    gs = p1["dense->gs-sgd (PAPER)"]["result"]
    assert dense["coll_bytes_pod"] / gs["coll_bytes_pod"] > 50
