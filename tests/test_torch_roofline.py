"""Port parity: ``repro_torch.bench.roofline`` against
``benchmarks/roofline.py``.

The counts of every row (FLOPs, HBM bytes, wire bytes by axis, model
FLOPs) equal the reference's ``analyze_cell``; the port prices them at
the H100's rates, so each ``t_*`` is its count over the port's constant,
``dominant`` the argmax of the three and the bound their max. The
dry-run join reads the port's dry-run record (``peak_bytes_dev``, the
executed FLOPs and the measured step) from a directory the caller names.
``measure_encode`` on the CPU gives whole and fused sketches bit-equal
to each other and to the plain encode. The reference's dry-run directory
is pointed at an empty one, so no file of the repo is read.
"""

import csv
import json
import math

import pytest
import torch

from benchmarks import roofline as jrl
from repro.configs import ARCHS
from repro_torch.bench import roofline as trl

COUNTS = ("flops", "hbm_bytes", "coll_bytes_model", "coll_bytes_data",
          "coll_bytes_pod", "model_flops", "useful_ratio", "arch", "shape",
          "mesh", "dp_mode", "notes")


@pytest.fixture(autouse=True)
def empty_dryrun(tmp_path, monkeypatch):
    monkeypatch.setattr(jrl, "DRYRUN_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(trl.dryrun, "OUT_DIR", str(tmp_path / "none"))


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_rows_count_like_the_reference(arch, mesh):
    shapes = 0
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        j = jrl.analyze_cell(arch, shape, mesh)
        t = trl.analyze_cell(arch, shape, mesh)
        assert (j is None) == (t is None)
        if t is None:
            continue
        shapes += 1
        assert {k: t[k] for k in COUNTS} == {k: j[k] for k in COUNTS}
        assert t["t_compute_s"] == t["flops"] / trl.PEAK_FLOPS
        assert t["t_memory_s"] == t["hbm_bytes"] / trl.HBM_BW
        assert t["t_collective_s"] == sum([   # sum(): as the module adds
            t["coll_bytes_model"] / trl.IN_POD_BW,
            t["coll_bytes_data"] / trl.IN_POD_BW,
            t["coll_bytes_pod"] / trl.POD_BW])
        terms = {k: t[f"t_{k}_s"] for k in ("compute", "memory",
                                            "collective")}
        assert t["dominant"] == max(terms, key=terms.get)
        assert t["step_time_bound_s"] == max(terms.values())
        assert t["roofline_fraction"] == pytest.approx(
            t["model_flops"] / trl.PEAK_FLOPS / t["step_time_bound_s"],
            rel=1e-15)
        assert t["hint"] == trl.HINTS[t["dominant"]]
        assert "MXU" not in t["hint"]
        assert t["peak_bytes_dev"] is None and t["dryrun_flops"] is None
    assert shapes >= 3


def test_h100_constants():
    assert (trl.PEAK_FLOPS, trl.HBM_BW, trl.IN_POD_BW, trl.POD_BW) == (
        989.4e12, 3.35e12, 50e9, 6.25e9)
    assert trl.POD_BW == jrl.DCI_BW  # the slow-link model is unchanged


def test_pod_bw_prices_only_the_pod_axis():
    a = trl.analyze_cell("qwen3-4b", "train_4k", "multi")
    b = trl.analyze_cell("qwen3-4b", "train_4k", "multi", pod_bw=12.5e9)
    assert a["coll_bytes_pod"] > 0
    assert a["t_collective_s"] - b["t_collective_s"] == pytest.approx(
        a["coll_bytes_pod"] / 6.25e9 - a["coll_bytes_pod"] / 12.5e9)


def test_dryrun_join_reads_the_record(tmp_path):
    rec = {"memory": {"peak_bytes": 11_900_000_000,
                      "argument_bytes": 4_023_001_604},
           "cost": {"flops": 2.095e14}, "step_seconds": 5.93}
    with open(tmp_path / "qwen3-4b__train_4k__single.json", "w") as f:
        json.dump(rec, f)
    r = trl.analyze_cell("qwen3-4b", "train_4k", "single",
                         dryrun_dir=str(tmp_path))
    assert (r["peak_bytes_dev"], r["dryrun_flops"], r["dryrun_step_s"]) == (
        11_900_000_000, 2.095e14, 5.93)
    other = trl.analyze_cell("qwen3-4b", "prefill_32k", "single",
                             dryrun_dir=str(tmp_path))
    assert other["peak_bytes_dev"] is None
    assert trl.check_rows([r, other]) == []
    rec["memory"].pop("peak_bytes")
    with open(tmp_path / "qwen3-4b__train_4k__single.json", "w") as f:
        json.dump(rec, f)
    r = trl.analyze_cell("qwen3-4b", "train_4k", "single",
                         dryrun_dir=str(tmp_path))
    assert any("peak_bytes" in m for m in trl.check_rows([r]))
    bad = dict(other, t_memory_s=math.nan)
    assert trl.check_rows([bad])


def test_main_writes_both_meshes(tmp_path, capsys):
    for mesh in ("single", "multi"):
        rows = trl.main(["--mesh", mesh, "--out-dir", str(tmp_path),
                         "--dryrun-dir", str(tmp_path / "none"),
                         "--json", str(tmp_path / f"{mesh}.json")])
        with open(tmp_path / f"{mesh}.csv") as f:
            got = list(csv.DictReader(f))
        assert len(got) == len(rows) == 32
        assert trl.check_rows(rows) == []
        with open(tmp_path / f"{mesh}.json") as f:
            doc = json.load(f)
        assert doc["mesh"] == mesh and doc["measured_encode"] is None
    assert "qwen3-4b" in capsys.readouterr().out


def test_measure_encode_on_the_cpu_fused_equals_whole():
    from repro_torch.core.count_sketch import SketchConfig
    from repro_torch.kernels.sketch_encode import sketch_encode_plain
    m = trl.measure_encode(d=50_003, rows=3, width=1024, fragments=4,
                           iters=1, device="cpu")
    whole, fused = m.pop("sketches")
    assert m["bit_equal"] is True
    gen = torch.Generator("cpu").manual_seed(0)
    g = torch.randn((50_003,), generator=gen)
    plain = sketch_encode_plain(SketchConfig(rows=3, width=1024, seed=0), g)
    assert torch.equal(whole, plain) and torch.equal(fused, plain)
    assert m["bytes"] == 50_003 * 4 + 3 * 1024 * 4
    assert m["hbm_bound_Bps"] == trl.HBM_BW
    assert m["backend"] == "cpu" and m["encode_s"] > 0
    assert m["hbm_fraction"] == pytest.approx(
        m["bytes"] / m["encode_s"] / trl.HBM_BW)
