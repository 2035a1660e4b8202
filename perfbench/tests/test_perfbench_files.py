"""Every cell, configuration, traffic mix and metric of BENCHMARK.json
resolves to its files by name, and a new one needs new files only."""

import json
import os
import re
import shutil

import pytest

from pbench import cells, layout

MAN = cells.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_perfbench_cell_resolves(w):
    c = cells.cell(w)
    assert c["traffic"]["name"] == dict(
        (x["name"], x) for x in MAN["workloads"])[w]["traffic"]
    for n in ("loss_gap", "grad_gap", "change_gap"):
        assert c["limits"][n]["limit"] > 0
    assert any(m["name"] == "setup_s" for m in c["end_to_end"])
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    moved = {m["moves"] for m in c["per_layer"]}
    assert moved <= {m["name"] for m in c["end_to_end"]}


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_perfbench_config_file(conf):
    path = os.path.join(cells.ROOT, conf["file"])
    assert conf["file"].startswith("perfbench/configs/")
    with open(path) as f:
        body = json.load(f)
    assert body["name"] == conf["name"]
    lay = layout.layout(layout.Shape.of(body))
    assert sum(b["d"] for b in body["exchange"]["buckets"]) == lay.d
    for key in conf["reduced"]:
        assert key in body["published"]
        assert not key.endswith(("_dim", "_rank", "_size"))


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_perfbench_metric_reader(m):
    assert callable(cells.reader(m["name"]))
    assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    for w in m.get("workloads", []):
        assert w in {x["name"] for x in MAN["workloads"]}


def test_perfbench_names_and_units():
    names = ([c["name"] for c in MAN["configs"]]
             + [w["name"] for w in MAN["workloads"]]
             + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in MAN["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for w in MAN["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)


def test_perfbench_added_files_need_no_edit(tmp_path):
    """A new traffic mix, cell and metric: files and manifest entries
    only; the harness resolves them without a change to its code."""
    base = tmp_path / "perfbench"
    shutil.copytree(cells.PERFBENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MAN))
    mix = {**cells.traffic("tok512-p2"), "name": "tok1k-p2", "seq_len": 1024}
    (base / "traffic" / "tok1k-p2.json").write_text(json.dumps(mix))
    (base / "limits" / "minicpm-2b-8L.tok1k-p2.json").write_text(
        (base / "limits" / "minicpm-2b-8L.tok512-p2.json").read_text())
    (base / "metrics" / "steps_seen.py").write_text(
        "def read(rec):\n    return float(rec['ranks'][0]['steps'])\n")
    man["workloads"].append({"name": "minicpm-2b-8L.tok1k-p2",
                             "config": "minicpm-2b-8L", "traffic": "tok1k-p2",
                             "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "steps_seen", "unit": "steps",
                             "better": "higher", "source": "program_counter",
                             "layer": "device", "moves": "tokens_per_s",
                             "workloads": ["minicpm-2b-8L.tok1k-p2"]})
    c = cells.cell("minicpm-2b-8L.tok1k-p2", man, str(base))
    assert c["traffic"]["seq_len"] == 1024
    assert [m["name"] for m in c["per_layer"]][-1] == "steps_seen"
    assert cells.reader("steps_seen", str(base))(
        {"ranks": [{"steps": 4}]}) == 4.0
