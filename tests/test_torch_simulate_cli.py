"""Port parity: ``python -m repro_torch.launch.simulate`` against
``repro.launch.simulate`` for the same flags — the ``--out`` result, the
``--json`` curves, the ``--dump-spec`` spec and the ``--trace`` events
byte for byte (each package writes into a directory of its own under the
same relative names), and the printed timeline line for line but for the
simulator's own host wall time. ``--plan`` reads one tune plan, written by
the port's ``launch.tune`` (no error probe), in both packages.
"""

import json
import os
import re

import pytest

from repro.launch import simulate as jsim
from repro.obs import trace as jtrace
from repro_torch.launch import simulate as tsim
from repro_torch.launch import tune as ttune
from repro_torch.obs import trace as ttrace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAIL_REJOIN = os.path.join(ROOT, "examples", "traces", "fail_rejoin.json")
SPEC = os.path.join(ROOT, "examples", "specs", "qwen3_smoke.json")
FILES = ("out.json", "curves.json", "spec.json", "trace.json")

CASES = {
    "fail_rejoin": ["--p", "1024", "--method", "gs-sgd", "--buckets", "8",
                    "--fault-trace", FAIL_REJOIN],
    "fail_rejoin_loop": ["--p", "1024", "--method", "gs-sgd", "--buckets",
                         "8", "--fault-trace", FAIL_REJOIN, "--engine",
                         "loop"],
    "hier_gtopk": ["--p", "256", "--topology", "hier", "--group-size", "32",
                   "--method", "gtopk", "--steps", "20"],
    "synthetic": ["--p", "64", "--steps", "30", "--synthetic-faults",
                  "fail_rate=0.2,straggle_rate=0.3,rejoin_after=5"],
    "slow_workers": ["--p", "64", "--slow-workers", "3:10,7:2.5",
                     "--steps", "20"],
    "participation": ["--p", "2000", "--steps", "20", "--participation",
                      "0.01", "--synthetic-faults",
                      "fail_rate=0.5,straggle_rate=0.5,rejoin_after=5"],
    "watch_congest": ["--p", "8", "--d", "1000000", "--steps", "20",
                      "--compute-jitter", "0", "--watch", "--congest",
                      "8:6"],
    "spec_interleave": ["--spec", SPEC, "--p", "16", "--steps", "10",
                        "--buckets", "4", "--bwd-chunks", "2",
                        "--fuse-encode", "--synthetic-faults",
                        "fail_rate=0.3,rejoin_after=3"],
}


def _run(main, argv, where, capsys, monkeypatch):
    os.makedirs(where, exist_ok=True)
    monkeypatch.chdir(where)
    main(argv + ["--out", "out.json", "--json", "curves.json",
                 "--dump-spec", "spec.json", "--trace", "trace.json"])
    text = capsys.readouterr().out
    # the only line that may differ: the simulator's own host wall time
    return re.sub(r"in [0-9.]+s (host )?wall", "in <wall>", text)


def _compare(argv, tmp_path, capsys, monkeypatch):
    t_out = _run(tsim.main, argv, str(tmp_path / "t"), capsys, monkeypatch)
    j_out = _run(jsim.main, argv, str(tmp_path / "j"), capsys, monkeypatch)
    assert t_out == j_out
    for name in FILES[:3]:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    t_doc = json.loads((tmp_path / "t" / "trace.json").read_text())
    j_doc = json.loads((tmp_path / "j" / "trace.json").read_text())
    assert t_doc["traceEvents"] == j_doc["traceEvents"]
    assert t_doc["spec"] == j_doc["spec"] and t_doc["source"] == "sim"
    assert t_doc["provenance"]["backend"] == "cpu"
    assert _valid(ttrace.validate, t_doc) == _valid(jtrace.validate, j_doc)
    out = json.loads((tmp_path / "t" / "out.json").read_text())
    out["_trace_valid"] = _valid(ttrace.validate, t_doc)
    return out, t_out


def _valid(validate, doc) -> bool:
    try:
        validate(doc)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_cli_files_equal_the_reference(case, tmp_path, capsys,
                                                monkeypatch):
    out, text = _compare(CASES[case], tmp_path, capsys, monkeypatch)
    assert out["totals"]["steps"] == out["config"]["steps"] or \
        out["replans"][-1].get("cluster_failed")
    if case.startswith("fail_rejoin"):  # 50 steps: the fail at step 30
        assert [rp["p"] for rp in out["replans"]] == [1023]
    if case == "watch_congest":
        assert "watchdog: re-planned" in text
    # Both packages' traces validate, or neither does. The reference's
    # from_sim starts a re-executed step's span at the replan and puts the
    # heartbeat-detection wait inside it, so the span runs past the next
    # step's start: a timeline with a detected failure whose wait outlasts
    # the next step does not validate, in either package (ROADMAP, Queue
    # 3). Timelines without a detection wait do.
    if case in ("fail_rejoin", "fail_rejoin_loop", "synthetic"):
        assert not out["_trace_valid"]
    if case in ("hier_gtopk", "slow_workers", "watch_congest",
                "participation"):
        assert out["_trace_valid"]


def test_engines_write_equal_results(tmp_path, capsys, monkeypatch):
    """``--engine batched`` and ``--engine loop`` of the port write the
    same ``--out`` file."""
    for engine in ("batched", "loop"):
        _run(tsim.main, CASES["fail_rejoin"] + ["--engine", engine],
             str(tmp_path / engine), capsys, monkeypatch)
    assert ((tmp_path / "batched" / "out.json").read_bytes()
            == (tmp_path / "loop" / "out.json").read_bytes())


def test_plan_drives_both_packages(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ttune.main(["--p", "64", "--d", "15000000", "--topology", "hier",
                "--buckets", "1", "4", "--bwd-chunks", "1", "2",
                "--no-error-probe", "--out", "plan.json"])
    capsys.readouterr()
    plan = str(tmp_path / "plan.json")
    _, text = _compare(["--plan", plan, "--steps", "12",
                        "--synthetic-faults", "fail_rate=0.2"],
                       tmp_path, capsys, monkeypatch)
    assert text.count(f"plan {plan}:") == 1


def test_spec_and_plan_together_are_refused(tmp_path, capsys):
    with pytest.raises(SystemExit):
        tsim.main(["--spec", SPEC, "--plan", str(tmp_path / "p.json")])
    assert "pass one" in capsys.readouterr().err
