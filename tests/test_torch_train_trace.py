"""The port's train driver's ``--trace`` and ``--json`` on the CPU at the
smoke config, held against ``repro.launch.train`` on the same spec: the
reference is run once (with ``--json``) and shared through a module
fixture; the port's trace carries the events the reference's does
(``REF_EVENTS``, the reference's trace of this spec, which
``tests/test_obs.py`` pins), and its own ``detail`` spans. The re-planning half (``--auto-tune``, ``--watch``, the
tuner CLI) is in ``test_torch_train_replan.py``."""

import json
from collections import Counter

import pytest

from repro.launch.train import main as j_train
from repro_torch.launch.train import main as t_train
from repro_torch import obs
from repro_torch.obs import trace as ttrace
from repro_torch.tune import calibrate

STEPS = 3
ARGV = ["--smoke", "--workers", "2", "--steps", str(STEPS), "--batch", "4",
        "--seq", "16", "--compressor", "gs-sgd", "--buckets", "2",
        "--bwd-chunks", "2", "--log-every", "5"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke config's tensors are small: one intra-op thread runs them
    faster, and the test workers share the machine's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (ph, name, cat) of every event of the reference's trace of ARGV: one
# step span a step, the probe with its phase spans and readiness instants
REF_EVENTS = sorted(
    [("M", "thread_name", "")]
    + [("X", f"step{i}", "step") for i in range(STEPS)]
    + [("X", "probe", "probe"), ("X", "forward", "forward"),
       ("X", "backward/chunk0", "backward"),
       ("X", "backward/chunk1", "backward"),
       ("X", "backward/top", "backward"), ("X", "optimizer", "optimizer")]
    + [(ph, f"{name}/b{i}", cat) for i in range(2)
       for ph, name, cat in (("X", "encode", "encode"),
                             ("X", "allreduce", "comm"),
                             ("X", "recover", "recover"),
                             ("i", "ready", "encode"))])
# the port's own spans inside the phases (cat detail; the reference has
# none): each step's input, the probe's EF add and residual and exact
# values' round a bucket, besides its parameter views and recomputes
DETAIL_EVENTS = {"step/input": STEPS, "ef/add": 2, "ef/residual": 2,
                 "values/round": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port untraced and traced, the reference traced."""
    tmp = tmp_path_factory.mktemp("train_trace")
    p = {k: str(tmp / f"{k}.json") for k in ("t_trace", "j_json")}
    p["t_json"] = str(tmp / "t.jsonl")   # the streaming layout
    plain = t_train(ARGV + CPU)
    traced = t_train(ARGV + CPU + ["--trace", p["t_trace"],
                                   "--json", p["t_json"]])
    ref = j_train(ARGV + ["--json", p["j_json"]])
    return {"plain": plain, "traced": traced, "ref": ref, "tmp": tmp, **p}


def test_tracing_leaves_the_losses_bit_equal(runs):
    assert runs["plain"]["history"] == runs["traced"]["history"]
    assert len(runs["plain"]["history"]) == STEPS


def test_trace_structure_like_the_reference(runs):
    doc = ttrace.load(runs["t_trace"])
    assert doc["source"] == "train"
    assert ttrace.validate(doc) > 0
    assert doc["spec"]["cluster"]["p"] == 2
    assert doc["provenance"]["runspec_sha256"]
    assert doc["provenance"]["backend"] == "cpu"
    steps = ttrace.spans(doc, cat="step")
    assert len(steps) == STEPS
    warm = {s["args"]["step"]: s["args"]["warmup"] for s in steps}
    assert warm[0] is True and not any(warm[i] for i in range(1, STEPS))
    assert len(ttrace.spans(doc, cat="probe")) == 1
    totals = ttrace.phase_totals(doc)
    for ph in ("forward", "backward", "encode", "comm", "recover",
               "optimizer"):
        assert totals.get(ph, 0.0) > 0.0, f"missing phase {ph}"
    for cat, prefix in (("encode", "encode/b"), ("comm", "allreduce/b"),
                        ("recover", "recover/b")):
        assert len(ttrace.bucket_durations(doc, cat, prefix)) == 2
    assert ttrace.instants(doc, "ready/b0")

    # the same events (names, categories) and fields as the reference's,
    # and the port's detail spans
    assert sorted((e["ph"], e["name"], e.get("cat", ""))
                  for e in doc["traceEvents"]
                  if e.get("cat") != "detail") == REF_EVENTS
    detail = Counter(e["name"] for e in doc["traceEvents"]
                     if e.get("cat") == "detail")
    assert set(detail) == set(DETAIL_EVENTS) | {"params/views",
                                                "remat/recompute"}
    assert {k: detail[k] for k in DETAIL_EVENTS} == DETAIL_EVENTS
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            assert sorted(e) == ["args", "cat", "dur", "name", "ph", "pid",
                                 "tid", "ts"]
    # and the Unix time of the tracer's epoch (obs/trace.py)
    assert sorted(doc) == ["displayTimeUnit", "epoch_unix_ns", "provenance",
                           "schema", "source", "spec", "traceEvents"]


def test_trace2_static_fields_equal_the_reference(runs):
    t = obs.load_jsonl(runs["t_json"])
    with open(runs["j_json"]) as f:
        j = json.load(f)
    assert t["schema"] == j["schema"] == "repro.tune/trace@2"
    assert t["model"] == j["model"]
    assert set(t["predicted"]) == set(j["predicted"])
    for k, v in j["predicted"].items():
        assert t["predicted"][k] == pytest.approx(v, rel=1e-12, abs=0.0)
    assert t["metrics"]["counters"] == j["metrics"]["counters"]
    assert set(t["metrics"]["gauges"]) == set(j["metrics"]["gauges"])
    for k, v in j["metrics"]["gauges"].items():
        assert t["metrics"]["gauges"][k] == pytest.approx(v, rel=1e-9)
    assert t["metrics"]["histograms"]["t_step"]["count"] == STEPS - 1
    assert len(t["records"]) == len(j["records"]) == STEPS
    for a, b in zip(t["records"], j["records"]):
        assert set(a) == set(b)
        for k in ("step", "rounds", "bytes", "warmup", "bytes_wire",
                  "compression_ratio"):
            assert a[k] == b[k], k
        assert a["grad_norm"] > 0 and a["ef_residual_norm"] >= 0
    assert set(t["provenance"]) == \
        (set(j["provenance"]) - {"jax"}) | {"torch", "cuda"}
    recs = calibrate.load_trace(runs["t_json"])
    assert len(recs) == STEPS
    assert calibrate._drop_warmup(recs, 0)[0]["step"] == 1


def test_json_streams_jsonl(runs):
    with open(runs["t_json"]) as f:
        lines = [json.loads(x) for x in f.read().strip().splitlines()]
    assert len(lines) == STEPS + 1   # the header, then a record a step
    assert "records" not in lines[0] and lines[0]["model"]["p"] == 2
    assert [r["step"] for r in lines[1:]] == list(range(STEPS))
    assert "watch" not in runs["plain"]   # no watchdog unless --watch
