"""``repro_torch.bench.run``: the reference's list of benches in the
reference's order (``benchmarks/run.py``), ``--fast`` and ``--device``
passed on, exit 0 when every bench passes and 1 when one fails. Every
bench's ``main`` is replaced by a recorder, so nothing runs."""

import pytest

from repro_torch.bench import (comm_complexity, convergence, drift_audit,
                               k_sensitivity, roofline, run, serve_load,
                               throughput, time_breakdown)

ORDER = ["comm_complexity (Eq. 1)", "roofline single-pod",
         "roofline multi-pod", "drift_audit (watchdog detect/re-plan)",
         "serve_load (CB vs static on one trace)",
         "time_breakdown (Figs. 4-5)", "throughput (Table II)",
         "convergence (Figs. 2-3)", "k_sensitivity (Figs. 6-7)"]


@pytest.fixture
def calls(monkeypatch):
    got = []

    def rec(name, rc=None):
        def main(*args, **kw):
            got.append((name, args, kw))
            return rc
        return main

    for mod, name, rc in ((comm_complexity, "comm_complexity", None),
                          (roofline, "roofline", None),
                          (drift_audit, "drift_audit", 0),
                          (serve_load, "serve_load", 0),
                          (time_breakdown, "time_breakdown", None),
                          (throughput, "throughput", None),
                          (convergence, "convergence", None),
                          (k_sensitivity, "k_sensitivity", None)):
        monkeypatch.setattr(mod, "main", rec(name, rc))
    return got


def test_order_and_arguments(calls, capsys):
    assert [n for n, _ in run.benches()] == ORDER
    assert run.main(["--fast", "--device", "cpu"]) == 0
    names = [c[0] for c in calls]
    assert names == ["comm_complexity", "roofline", "roofline",
                     "drift_audit", "serve_load", "time_breakdown",
                     "throughput", "convergence", "k_sensitivity"]
    by = {}
    for name, args, kw in calls:
        by.setdefault(name, []).append((args, kw))
    assert by["roofline"] == [((["--mesh", "single"],), {}),
                              ((["--mesh", "multi"],), {})]
    assert by["drift_audit"] == [((["--fast"],), {})]
    assert by["serve_load"] == [((["--fast", "--device", "cpu"],), {})]
    assert by["time_breakdown"] == [((), {"device": "cpu"})]
    assert by["convergence"] == [((), {"steps": 15, "device": "cpu"})]
    assert by["k_sensitivity"] == [((), {"steps": 15, "device": "cpu"})]
    assert "all benches ok" in capsys.readouterr().out


def test_full_profile_defaults(calls):
    assert run.main([]) == 0
    by = {name: (args, kw) for name, args, kw in calls}
    assert by["drift_audit"] == (([],), {})
    assert by["serve_load"] == (([],), {})
    assert by["throughput"] == ((), {"device": None})
    assert by["convergence"] == ((), {"steps": 60, "device": None})


def test_a_failing_bench_exits_1(calls, monkeypatch, capsys):
    monkeypatch.setattr(drift_audit, "main", lambda argv: 1)

    def boom(**kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(throughput, "main", boom)
    assert run.main(["--fast"]) == 1
    out = capsys.readouterr().out
    assert "2 benches failed" in out
    assert "drift_audit (watchdog detect/re-plan): FAILED" in out
    # every bench still ran after the failures
    assert [c[0] for c in calls][-2:] == ["convergence", "k_sensitivity"]
