"""Port parity: ``repro_torch.bench.overlap_audit`` against
``benchmarks/overlap_audit.py``.

The port's versions of ``tests/test_obs.py``'s two audit tests (a
jitter-free simulator trace reproduces its own pricing oracle; a train
trace, here the port's train CLI's on the CPU, audits report-only), and
the port's audit of its own simulator trace equal, number for number, to
the reference's audit of the reference's trace of the same run (all but
the path and the provenance).
"""

import json

import numpy as np
import pytest

from benchmarks import overlap_audit as joa
from repro.launch.simulate import main as j_sim
from repro_torch.bench import overlap_audit as toa
from repro_torch.launch.simulate import main as t_sim
from repro_torch.launch.train import main as t_train

SIM_ARGV = ["--p", "4", "--d", "1000000", "--method", "gs-sgd",
            "--buckets", "4", "--bwd-chunks", "2", "--steps", "4",
            "--compute-jitter", "0", "--trace"]
TRAIN_ARGV = ["--smoke", "--workers", "2", "--steps", "3", "--batch", "4",
              "--seq", "16", "--compressor", "gs-sgd", "--buckets", "2",
              "--bwd-chunks", "2", "--log-every", "5", "--device", "cpu"]


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    import torch
    tmp = tmp_path_factory.mktemp("overlap_audit")
    p = {k: str(tmp / f"{k}.json") for k in ("j_sim", "t_sim", "t_train")}
    j_sim(SIM_ARGV + [p["j_sim"]])
    t_sim(SIM_ARGV + [p["t_sim"]])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t_train(TRAIN_ARGV + ["--trace", p["t_train"]])
    finally:
        torch.set_num_threads(n)
    return p


def test_overlap_audit_sim_self_check(traces):
    a = toa.audit_trace(traces["t_sim"])
    assert a["source"] == "sim"
    for ph in ("encode", "comm", "recover"):
        assert a["phase_deltas"][ph]["measured"] == pytest.approx(
            a["phase_deltas"][ph]["predicted"], rel=1e-6, abs=1e-12)
    assert a["measured"]["step_time"] == pytest.approx(
        a["scheduled_step"], rel=1e-6)
    if a["serial_step"] - a["scheduled_step"] > 1e-9:
        assert a["realization_ratio"] == pytest.approx(1.0, abs=1e-3)
    assert toa.check(a, 0.05) == []


def test_audit_equals_the_reference(traces):
    got = toa.audit_trace(traces["t_sim"])
    want = joa.audit_trace(traces["j_sim"])
    for a in (got, want):
        a.pop("trace")
        a.pop("provenance")
    assert got == want


def test_overlap_audit_on_train_trace(traces, tmp_path):
    path = traces["t_train"]
    a = toa.audit_trace(path)
    assert a["source"] == "train"
    assert a["measured"]["step_time"] > 0
    for ph in ("backward", "encode", "comm", "recover"):
        d = a["phase_deltas"][ph]
        assert np.isfinite(d["measured"]) and np.isfinite(d["predicted"])
    ms = a["measured_schedule"]
    assert ms is not None and ms["pipelined"] <= ms["serial"] + 1e-12
    assert toa.check(a, 0.0) == []       # measured traces are report-only
    out_p = str(tmp_path / "BENCH_obs.json")
    res = toa.main([path, "--tolerance", "10.0", "--out", out_p])
    assert res["audits"][0]["trace"] == path
    with open(out_p) as f:
        assert json.load(f)["schema"] == "repro.obs/bench@1"


def test_check_fails_a_sim_trace_off_its_oracle(traces):
    a = toa.audit_trace(traces["t_sim"])
    a["phase_deltas"]["comm"]["rel"] = 0.6
    assert len(toa.check(a, 0.5)) == 1
    with pytest.raises(SystemExit):
        toa.main([traces["t_sim"], "--tolerance", "-1",
                  "--out", traces["t_sim"] + ".out.json"])
