"""Port parity for ``repro_torch.obs``: the tracer, the trace@2 metrics
document and the provenance stamp, held against ``repro.obs`` on the same
scripted inputs (a fake clock, so the two documents are equal in every
event and field)."""

import json

import pytest
import torch

from repro import obs as jobs
from repro.obs import trace as jtrace
from repro_torch import obs as tobs
from repro_torch.obs import trace as ttrace


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _script(obs_pkg, trace_mod):
    """One scripted recording: nested spans on two tracks, instants, a
    closed span added directly, an ambient-tracer span."""
    clk = FakeClock()
    tr = obs_pkg.Tracer(clock=clk, epoch=0.0, pid=3)
    with tr.span("probe", cat="probe", args={"step": 1}):
        clk.t = 0.5
        for i in range(2):
            with tr.span(f"encode/b{i}", cat="encode"):
                clk.t += 0.25
            tr.instant(f"ready/b{i}", cat="encode",
                       args={"bucket": i, "event": 0})
            with tr.span(f"allreduce/b{i}", cat="comm", track="net",
                         args={"bucket": i}):
                clk.t += 0.125
            with tr.span(f"recover/b{i}", cat="recover"):
                clk.t += 1.0 / 3
        with tr.activate():
            with trace_mod.current().span("optimizer", cat="optimizer"):
                clk.t += 0.0625
    sp = tr.begin("step1", cat="step", args={"step": 1, "warmup": False})
    clk.t += 2.0
    tr.end(sp)
    tr.add_span("stall", 4.0, 4.5, cat="stall", track="net")
    tr.instant("drift.detected", cat="runtime", track="watchdog", ts=4.25,
               args={"phase": "comm"})
    return tr


def test_trace_documents_equal_from_a_scripted_clock(tmp_path):
    spec = {"schema": "x", "arch": "qwen3-4b"}
    prov = {"schema": "repro.obs/provenance@1"}
    tt, jt = _script(tobs, ttrace), _script(jobs, jtrace)
    assert tt.events == jt.events
    td = tt.to_chrome(spec=spec, provenance=prov, source="train")
    jd = jt.to_chrome(spec=spec, provenance=prov, source="train")
    assert td == jd
    tt.save(str(tmp_path / "t.json"), spec=spec, provenance=prov)
    jt.save(str(tmp_path / "j.json"), spec=spec, provenance=prov)
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert ttrace.load(str(tmp_path / "j.json")) == \
        jtrace.load(str(tmp_path / "t.json"))


def test_validate_totals_and_bucket_durations_match():
    doc = _script(jobs, jtrace).to_chrome()
    assert ttrace.validate(doc) == jtrace.validate(doc) == 10
    assert ttrace.phase_totals(doc) == jtrace.phase_totals(doc)
    for cat, prefix in (("encode", "encode/b"), ("comm", "allreduce/b"),
                        ("recover", "recover/b")):
        got = ttrace.bucket_durations(doc, cat, prefix)
        assert got == jtrace.bucket_durations(doc, cat, prefix)
        assert len(got) == 2
    assert ttrace.spans(doc, cat="comm") == jtrace.spans(doc, cat="comm")
    assert ttrace.instants(doc, "ready/b1") == \
        jtrace.instants(doc, "ready/b1")
    assert ttrace.PHASES == jtrace.PHASES
    assert ttrace.TRACE_SCHEMA == jtrace.TRACE_SCHEMA


@pytest.mark.parametrize("case", ["out_of_order", "open_export",
                                  "overlap", "wrong_schema"])
def test_tracer_errors_like_the_reference(case, tmp_path):
    def run(obs_pkg, trace_mod):
        tr = obs_pkg.Tracer(clock=FakeClock(), epoch=0.0)
        if case == "out_of_order":
            a = tr.begin("a")
            tr.begin("b")
            tr.end(a)
        elif case == "open_export":
            tr.begin("a")
            tr.to_chrome()
        elif case == "overlap":
            tr.add_span("a", 0.0, 2.0)
            tr.add_span("b", 1.0, 3.0)
            trace_mod.validate(tr)
        else:
            path = tmp_path / "bad.json"
            path.write_text(json.dumps({"schema": "nope"}))
            trace_mod.load(str(path))

    errs = []
    for obs_pkg, trace_mod in ((jobs, jtrace), (tobs, ttrace)):
        with pytest.raises(ValueError) as e:
            run(obs_pkg, trace_mod)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_null_tracer_is_inert_and_opens_a_profiler_range():
    assert ttrace.current() is ttrace.NULL
    x = torch.arange(3.0)
    with ttrace.NULL.span("encode/b0", cat="encode") as sp:
        assert sp.sync(x) is x
    assert ttrace.NULL.begin("a") is ttrace.NULL.begin("b")
    assert ttrace.NULL.end(None) is None
    assert ttrace.NULL.instant("a") is None
    tr = tobs.Tracer()
    with tr.activate():
        assert ttrace.current() is tr
    assert ttrace.current() is ttrace.NULL
    # the NULL span and a recording span each open a profiler range of
    # their name (what chip_smoke.py's span_split reads)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttrace.NULL.span("encode/b7", cat="encode"):
            torch.ones(4).sum()
        with tr.span("recover/b7", cat="recover"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"encode/b7", "recover/b7"} <= names


def test_span_sync_is_the_identity_on_cpu_tensors():
    tr = tobs.Tracer()
    nested = {"a": (torch.ones(2), [torch.zeros(1), 3]), "b": None}
    with tr.span("x") as sp:
        assert sp.sync(nested) is nested
    assert ttrace.sync(nested) is nested
    assert ttrace._cuda_devices(nested, set()) == set()


def test_metrics_and_trace2_document_match(tmp_path):
    docs = []
    for obs_pkg in (jobs, tobs):
        met = obs_pkg.Metrics()
        for i, t in enumerate((0.25, 0.5, 0.125, 1.0, 0.75)):
            met.counter("bytes_wire").inc(1024.0 * (i + 1))
            met.counter("rounds").inc(8)
            met.histogram("t_step").observe(t)
        met.gauge("recovery_error_probe").set(0.0625)
        met.histogram("never")
        recs = [{"step": s, "t_step": 0.1 * s, "rounds": 8, "bytes": 7168.0,
                 "loss": 5.5 - s, "warmup": s == 0} for s in range(3)]
        doc = obs_pkg.trace2_doc(model={"arch": "a", "p": 2}, records=recs,
                                 metrics=met, provenance={"x": 1},
                                 predicted={"step_time": 0.1})
        for suffix in ("json", "jsonl"):
            path = str(tmp_path / f"{obs_pkg.__name__}.{suffix}")
            obs_pkg.dump(doc, path)
            if suffix == "jsonl":
                assert obs_pkg.load_jsonl(path) == doc
        docs.append(doc)
    assert docs[0] == docs[1]
    assert tobs.TRACE2_SCHEMA == jobs.TRACE2_SCHEMA
    assert (tmp_path / "repro_torch.obs.json").read_text() == \
        (tmp_path / "repro.obs.json").read_text()


def test_provenance_keys_and_spec_hash():
    from repro.api import RunSpec as JSpec
    from repro_torch.api import RunSpec as TSpec
    spec = TSpec()
    t = tobs.provenance(spec, "cpu")
    j = jobs.provenance(JSpec())
    assert set(t) == (set(j) - {"jax"}) | {"torch", "cuda"}
    assert t["schema"] == j["schema"] == "repro.obs/provenance@1"
    assert t["backend"] == "cpu" and t["device_kind"] == "cpu"
    assert t["device_count"] == 1
    assert t["torch"] == torch.__version__
    assert t["runspec_sha256"] == tobs.runspec_hash(spec)
    doc = JSpec().to_json()
    assert tobs.runspec_hash(doc) == jobs.runspec_hash(doc)
