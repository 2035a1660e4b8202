"""Port parity: the paper's drivers (``repro_torch.bench.time_breakdown``,
``throughput``, ``convergence``, ``k_sensitivity``, ``comm_complexity``)
against ``benchmarks/``.

Models and Eq. 1 prices are pure arithmetic and must equal the
reference's: ``paper_geometry``, ``model_bucket_pipeline``,
``comm_complexity``'s curves, and ``breakdown``'s bytes, rounds and
t_commu. The flop count behind ``t_compu_model``: the port counts the
gradient's matmuls and convolutions with ``FlopCounterMode``, the
reference reads XLA's ``cost_analysis``; at ResNet-20 width 8 the port's
count is 0.970 of the reference's (XLA also counts elementwise work),
at VGG-16 width 0.25 1.199 of it (XLA leaves out the taps that fall on
SAME padding, a large share of the 2x2 and 4x4 maps' 3x3 windows).
The reference's timers are not run (its ``_time`` is replaced in this
process by one that returns 0): the tests compare no time.
"""

import json

import jax
import numpy as np
import pytest
import torch

from benchmarks import comm_complexity as jcc
from benchmarks import time_breakdown as jtb
from repro_torch.bench import comm_complexity as tcc
from repro_torch.bench import grad_noise
from repro_torch.bench import convergence as tconv
from repro_torch.bench import k_sensitivity as tks
from repro_torch.bench import throughput as ttp
from repro_torch.bench import time_breakdown as ttb
from repro_torch.models import cnn as tcnn

SMALL = {"resnet20": {"width": 8}, "vgg16": {"width_mult": 0.25}}
VGG_METHODS = {"vgg16": ["gs-sgd"]}
BREAKDOWN_KEYS = {"t_compu", "t_compr", "t_commu", "t_compu_model",
                  "t_compr_model", "bytes", "rounds", "d"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors: one intra-op thread, as the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d", [1, 1000, 68_690, 272_282, 923_130,
                               14_724_042, 600_000_000])
def test_paper_geometry_equal(d):
    assert ttb.paper_geometry(d) == jtb.paper_geometry(d)
    assert ttb.hbm_encode_time(d, 5) == jtb.hbm_encode_time(d, 5)


@pytest.mark.parametrize("d", [272_282, 14_724_042])
@pytest.mark.parametrize("n_b", [1, 4, 8])
def test_model_bucket_pipeline_equal(d, n_b):
    assert ttb.model_bucket_pipeline(d, n_b) == jtb.model_bucket_pipeline(
        d, n_b)
    kw = dict(t_backward=3e-3, bwd_chunks=n_b)
    assert (ttb.model_bucket_pipeline(d, n_b, **kw)
            == jtb.model_bucket_pipeline(d, n_b, **kw))


def test_comm_complexity_curves_equal():
    ps = [2, 8]   # the reference runs a step a point (~5 s for gs-SGD)
    assert tcc.analytic_curves(ps) == jcc.analytic_curves(ps)


@pytest.fixture(scope="module")
def reference_breakdowns():
    """The reference's breakdown of ResNet-20 width 8 (each method) and
    VGG-16 width 0.25 (gs-SGD), with its timer replaced (no time is
    compared)."""
    saved = jtb._time
    jtb._time = lambda f, *a, n=5: 0.0
    try:
        return {(m, meth): jtb.breakdown(m, meth, width_kw=SMALL[m])
                for m in SMALL for meth in VGG_METHODS.get(m, jtb.METHODS)}
    finally:
        jtb._time = saved


@pytest.mark.parametrize("model", sorted(SMALL))
def test_breakdown_prices_equal(model, reference_breakdowns):
    for method in VGG_METHODS.get(model, ttb.METHODS):
        want = reference_breakdowns[model, method]
        got = ttb.breakdown(model, method, width_kw=SMALL[model],
                            device="cpu")
        assert set(want) <= set(got)
        for key in ("bytes", "rounds", "t_commu", "d", "t_compr_model"):
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
        assert got["t_compu"] > 0 and got["t_compr"] > 0


@pytest.mark.parametrize("model, ratio", [("resnet20", 0.9697),
                                          ("vgg16", 1.1992)])
def test_flop_count_against_xla(model, ratio, reference_breakdowns):
    ref_flops = (reference_breakdowns[model, "gs-sgd"]["t_compu_model"]
                 * jtb.ACCEL_FLOPS)
    init, _ = jtb.cnn.MODELS[model]
    p0 = tcnn.params_from_reference(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), **SMALL[model])))
    from repro.data import ImageStream
    b = ImageStream(global_batch=32).global_batch_at(0)
    f = ttb.grad_fn(model, p0, torch.tensor(np.asarray(b["images"][:8])),
                    torch.tensor(np.asarray(b["labels"][:8])))
    assert ttb.count_flops(f) / ref_flops == pytest.approx(ratio, rel=1e-3)


def _keys(path):
    with open(path) as fh:
        return json.load(fh)


def test_time_breakdown_main(tmp_path):
    res = ttb.main(device="cpu", out=str(tmp_path), models=("resnet20",))
    doc = _keys(tmp_path / "time_breakdown.json")
    assert set(doc) == {"resnet20", "device"}
    assert set(doc["resnet20"]) == set(jtb.METHODS) | {"bucketed"}
    for m in jtb.METHODS:
        assert BREAKDOWN_KEYS <= set(doc["resnet20"][m])
    assert set(doc["resnet20"]["bucketed"]) == {"1", "4", "8"}
    assert set(doc["resnet20"]["bucketed"]["4"]) == {
        "n_buckets", "bwd_chunks", "per_bucket", "t_serial", "t_pipelined",
        "t_exposed", "overlap_saving", "interleaved"}
    assert doc["device"]["type"] == "cpu"
    assert res["resnet20"]["gs-sgd"]["d"] == 68_690


def test_throughput_main(tmp_path):
    res = ttp.main(device="cpu", out=str(tmp_path), models=("resnet20",),
                   width_kw=SMALL)
    doc = _keys(tmp_path / "throughput.json")
    per = doc["resnet20"]
    for m in ("gtopk", "sketched-sgd", "gs-sgd"):
        assert {"img_per_s", "img_per_s_accel"} | BREAKDOWN_KEYS <= set(
            per[m])
    for col in ("img_per_s", "img_per_s_accel"):
        for vs, m in (("gtopk", "gtopk"), ("sketched", "sketched-sgd")):
            assert per[f"speedup_vs_{vs}_{col}"] == pytest.approx(
                per["gs-sgd"][col] / per[m][col])
    assert res["resnet20"]["gs-sgd"]["img_per_s"] > 0


def test_throughput_full_size_d_and_geometry():
    """Table II's sizes: d and (k, W) of the full-size models, and the
    recovery route they take (d past 2^22 and 4k: the decode)."""
    from repro_torch.bench import cnn_dist
    from repro_torch.core import count_sketch as cs
    from repro_torch.core.heavymix import _CHUNK
    want = {"resnet20": (272_282, 1_089, 1_024, False),
            "vgg16": (14_724_042, 58_896, 32_768, True)}
    for model, (d, k, w, decode) in want.items():
        flat, _ = cs.ravel_tree(cnn_dist.init_params(model, "cpu"))
        assert flat.shape[0] == d
        assert ttb.paper_geometry(d) == (k, w)
        assert (d > _CHUNK and d > 4 * k) == decode


def test_convergence_main(tmp_path):
    tconv.main(steps=2, models=("resnet20",), device="cpu",
               out=str(tmp_path))
    doc = _keys(tmp_path / "convergence.json")
    assert set(doc) == {"resnet20", "device"}
    assert list(doc["resnet20"]) == tconv.METHODS
    for r in doc["resnet20"].values():
        assert set(r) == {"losses", "accs", "d"} and len(r["losses"]) == 2
        assert all(np.isfinite(r["losses"]))


def test_k_sensitivity_main(tmp_path):
    tks.main(steps=2, device="cpu", out=str(tmp_path))
    doc = _keys(tmp_path / "k_sensitivity.json")
    assert set(doc) == {"64", "256", "1024", "4096", "device"}
    for k in ("64", "256", "1024", "4096"):
        assert set(doc[k]) == {"losses", "accs", "d"}
        assert all(np.isfinite(doc[k]["losses"]))


def test_comm_complexity_main(tmp_path):
    res = tcc.main(out=str(tmp_path))
    doc = _keys(tmp_path / "comm_complexity.json")
    assert set(doc) == {"model", "methods", "ps", "curves", "checks"}
    assert doc["checks"]["gs_bytes_growth_8_64"] < 2.5


def test_grad_noise_main():
    rows = grad_noise.main(device="cpu")
    assert [r["worker"] for r in rows] == [0, 1, 2, 3]
    for r in rows:   # f32 against f64: rounding, and a few ReLU flips
        assert 0 < r["max_abs_err"] < 1e-2 * r["max_abs_g"]
