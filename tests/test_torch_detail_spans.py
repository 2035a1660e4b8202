"""The port's ``detail`` spans inside its step, the wire counter at the
collectives and the tracer's clock, on the CPU at the smoke spec; and the
benchmark's reduction of a profiler trace by part
(``perfbench/pbench/parts.py``, which imports nothing of the program).

One step of ``examples/specs/qwen3_smoke.json`` (P = 2, two buckets,
remat on) runs under ``torch.profiler``: every detail span is there,
inside its layer's span; the nodes of the ops made under
``params/views`` are found by sequence number; the wire counter is the
compressor's ``comm_stats``."""

import dataclasses
import json
import os
import sys
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERFBENCH = os.path.join(ROOT, "perfbench")
if PERFBENCH not in sys.path:
    sys.path.insert(0, PERFBENCH)

from pbench import parts  # noqa: E402
from pbench import trace as ptrace  # noqa: E402

from repro_torch.api import RunSpec  # noqa: E402
from repro_torch.core import pgroup  # noqa: E402
from repro_torch.data import LMStream  # noqa: E402
from repro_torch.launch.train import build, drive, train_loop  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

SPEC = os.path.join(ROOT, "examples", "specs", "qwen3_smoke.json")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(**exchange):
    """The smoke spec's step (``exchange``: fields of its ExchangeSpec
    changed), its state and its batches."""
    spec = RunSpec.load(SPEC)
    if exchange:
        spec = dataclasses.replace(
            spec, exchange=dataclasses.replace(spec.exchange, **exchange))
    cfg, opt, _, ts = build(spec, device="cpu")
    state = ts.init_state(opt, torch.Generator().manual_seed(spec.seed))
    stream = LMStream(vocab_size=cfg.vocab_size, seq_len=spec.seq,
                      global_batch=spec.batch, seed=spec.seed)
    return ts, state, stream.global_batch_at


def chrome_events(prof, tmp_path) -> dict:
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """A warm step, then one step under the profiler in the benchmark's
    window range: the trace's events."""
    ts, state, batch_at = smoke()
    state, _, _ = train_loop(ts, state, batch_at, range(1),
                             log_every=10 ** 9)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(ptrace.WINDOW):
            train_loop(ts, state, batch_at, range(1, 2), log_every=10 ** 9)
    return chrome_events(prof, tmp_path_factory.mktemp("detail"))[
        "traceEvents"]


def ranges(events, name=None, prefix=None):
    return [e for e in events if e.get("cat") == "user_annotation"
            and (name is None or e["name"] == name)
            and (prefix is None or e["name"].startswith(prefix))]


def inside(e, outer) -> bool:
    a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return any(float(o["ts"]) <= a and b <= float(o["ts"]) + float(o["dur"])
               for o in outer)


def test_step_holds_every_detail_span_in_its_layer(profiled):
    ev = profiled
    family = {"model/forward/w": "loss_and_grad",
              "model/backward/w": "loss_and_grad",
              "model/pack": "loss_and_grad",
              "params/views": "loss_and_grad",
              "remat/recompute": "model/backward/w",
              "ef/add": "encode/b", "ef/residual": "recover/b",
              "values/round": "recover/b"}
    for prefix, outer in family.items():
        got = ranges(ev, prefix=prefix)
        assert got, prefix
        assert all(inside(e, ranges(ev, prefix=outer)) for e in got), prefix
    assert {e["name"] for e in ranges(ev, prefix="model/forward/")} == \
        {"model/forward/w0", "model/forward/w1"}
    assert len(ranges(ev, prefix="model/backward/")) == 2
    assert len(ranges(ev, "ef/add")) == len(ranges(ev, "ef/residual")) == \
        len(ranges(ev, "values/round")) == 2            # one a bucket
    # the step's input is made before the step's own span
    (inp,), (step,) = ranges(ev, "step/input"), ranges(ev, "step1")
    assert float(inp["ts"]) + float(inp["dur"]) <= float(step["ts"])
    assert inside(inp, ranges(ev, ptrace.WINDOW))
    # the layers read what they read: no detail span names a layer
    for e in ranges(ev):
        if parts.part_of(e["name"]):
            assert e["name"].split("/")[0] not in ptrace.FAMILIES, e["name"]


def test_view_ops_link_to_their_backward_nodes(profiled):
    """Every select and slice made under params/views in the forward (a
    recompute's run inside a node's range, in the backward) finds its
    node's range, and only view nodes are linked."""
    ev = profiled
    views = ranges(ev, "params/views")
    nodes = [e for e in ev if e.get("cat") == "cpu_op"
             and e["name"].startswith(parts.EVAL)]
    made = Counter({"aten::select": "SelectBackward0",
                    "aten::slice": "SliceBackward0"}[e["name"]]
                   for e in ev if e.get("cat") == "cpu_op"
                   and e["name"] in ("aten::select", "aten::slice")
                   and inside(e, views) and not inside(e, nodes))
    linked = Counter(name for _, _, name in parts.assembly_ranges(ev))
    assert made["SelectBackward0"] > 0 and made["SliceBackward0"] > 0
    assert {k: linked[k] for k in made} == dict(made)
    assert set(linked) <= {"SelectBackward0", "SliceBackward0",
                           "ViewBackward0"}


def ev(cat, name, ts, dur, tid=1, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def kernel(name, launch_ts, start, dur, corr, tid=1):
    return [ev("cuda_runtime", "cudaLaunchKernel", launch_ts, 1, tid,
               correlation=corr),
            ev("kernel", name, start, dur, 7, correlation=corr)]


# A step by hand: the window 0-200 us; detail spans inside the layers'
# spans; a select made under params/views (sequence number 7), a copy
# after it that made no node and an index outside the span that made
# node 8; their nodes' ranges on autograd's thread (tid 2)
DETAIL = [
    ev("user_annotation", "step/input", 0, 10),
    ev("user_annotation", "model/forward/w0", 12, 28),
    ev("user_annotation", "params/views", 13, 2),
    ev("cpu_op", "aten::select", 13.5, 0.5, **{"Sequence number": 7}),
    ev("cpu_op", "aten::to", 14.5, 0.5, **{"Sequence number": 8}),
    ev("user_annotation", "model/backward/w0", 40, 60),
    ev("user_annotation", "remat/recompute", 72, 8, tid=2),
    ev("user_annotation", "model/pack", 100, 10),
    ev("user_annotation", "ef/add", 121, 4),
    ev("user_annotation", "values/round", 160, 10),
    ev("user_annotation", "ef/residual", 175, 5),
]
EVENTS = [
    ev("user_annotation", ptrace.WINDOW, 0, 200),
    ev("user_annotation", "step1", 10, 185),
    ev("user_annotation", "loss_and_grad", 12, 108),
    ev("cpu_op", "aten::index", 16, 1, **{"Sequence number": 8}),
    ev("cpu_op", "aten::mm", 19.5, 1.5),
    ev("cpu_op", parts.EVAL + "IndexBackward0", 50, 5, tid=2,
       **{"Sequence number": 8, "Fwd thread id": 1}),
    ev("cpu_op", parts.EVAL + "SelectBackward0", 60, 10, tid=2,
       **{"Sequence number": 7, "Fwd thread id": 1}),
    ev("user_annotation", "encode/b0", 120, 30),
    ev("user_annotation", "recover/b0", 150, 40),
    *kernel("k10", 5, 6, 1, 10), *kernel("k1", 20, 21, 15, 1),
    *kernel("k3", 52, 53, 5, 3, tid=2), *kernel("k2", 62, 63, 8, 2, tid=2),
    *kernel("k4", 75, 76, 4, 4, tid=2), *kernel("k5", 101, 102, 6, 5),
    *kernel("k6", 122, 123, 3, 6), *kernel("k7", 140, 141, 10, 7),
    *kernel("k8", 162, 163, 2, 8), *kernel("k9", 176, 177, 2, 9),
]


def test_reduce_by_layer_and_by_part_on_fixed_events():
    red = ptrace.reduce(EVENTS + DETAIL)
    # the layers as the benchmark read them before the detail spans
    assert red["window_s"] == pytest.approx(200e-6)
    assert red["busy_s"] == pytest.approx(56e-6)
    assert red["family_ms"] == pytest.approx(
        {"model": 0.038, "encode": 0.013, "recover": 0.004,
         "outside": 0.001})
    assert red["device_ops"][0] == ["k1", pytest.approx(15e-6)]
    without = ptrace.reduce(EVENTS)
    for k in ("window_s", "busy_s", "family_ms", "device_ops"):
        assert red[k] == without[k], k
    # each gap by the launching thread's innermost host event at its middle
    assert dict(red["idle_gaps"]) == pytest.approx(
        {"recover/b0": 45e-6, "model/backward/w0": 49e-6,
         "loss_and_grad": 15e-6, "encode/b0": 15e-6, "params/views": 14e-6,
         "step/input": 6e-6})

    det = parts.reduce(EVENTS + DETAIL)
    # the linked SelectBackward0 range and model/pack are the assembly;
    # the index's node, made outside params/views, is the backward's
    assert det["part_ms"] == pytest.approx(
        {"input": 0.001, "forward": 0.015, "backward": 0.005,
         "assemble": 0.014, "recompute": 0.004, "ef": 0.005,
         "values": 0.002})
    assert det["part_ops"]["assemble"] == [["k2", pytest.approx(8e-6)],
                                           ["k5", pytest.approx(6e-6)]]
    # the five largest ops by where they were launched (a part, else the
    # layer) and by the op that launched them
    assert [o[0] for o in det["op_split"]] == ["k1", "k7", "k2", "k5", "k3"]
    assert det["op_split"][0] == ["k1", pytest.approx(15e-6),
                                  {"forward": pytest.approx(15e-6)},
                                  {"aten::mm": pytest.approx(15e-6)}]
    assert det["op_split"][1][2] == {"encode": pytest.approx(10e-6)}
    assert det["idle_by_span_ms"] == pytest.approx(
        {"step/input": 0.009, "step*": 0.007, "model/forward/w*": 0.011,
         "params/views": 0.002, "model/backward/w*": 0.039,
         "remat/recompute": 0.004, "model/pack": 0.004,
         "loss_and_grad": 0.010, "encode/b*": 0.016, "ef/add": 0.002,
         "recover/b*": 0.024, "values/round": 0.008, "ef/residual": 0.003,
         "none": 0.005})
    assert sum(det["idle_by_span_ms"].values()) == pytest.approx(
        (red["window_s"] - red["busy_s"]) * 1e3)


@pytest.mark.parametrize("mode", ["psum", "tree"])
def test_wire_counter_is_comm_stats_at_p2(mode):
    """The counter's payload a worker over one step: the sketches' sum and
    the exact values' round of every bucket, as ``comm_stats`` prices
    them at P = 2 (a ring all-reduce moves the payload once; the tree's
    two rounds twice)."""
    ts, state, batch_at = smoke(allreduce_mode=mode)
    before = dict(pgroup.WIRE)
    train_loop(ts, state, batch_at, range(1), log_every=10 ** 9)
    got = {k: v - before[k] for k, v in pgroup.WIRE.items()}
    bc = ts.compressor
    want = sum(c.comm_stats(d, ts.nworkers).bytes_out
               for c, d in zip(bc.parts, bc.spec.sizes))
    assert got["bytes"] == want
    assert got["calls"] == bc.spec.n * (3 if mode == "tree" else 2)


def test_null_span_opens_a_range_only_while_profiling(monkeypatch):
    opened = []

    def counting(name):
        opened.append(name)
        return record_function(name)

    monkeypatch.setattr(ttrace, "record_function", counting)
    with ttrace.NULL.span("encode/b3", cat="encode") as sp:
        assert sp.sync(1) == 1
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttrace.NULL.span("encode/b3", cat="encode"):
            torch.ones(4).sum()
    assert opened == ["encode/b3"]
    assert "encode/b3" in {e.name for e in prof.events()}


def test_tracer_spans_land_on_the_profiler_timeline(tmp_path):
    """Each span's Unix time (the export's epoch_unix_ns plus its ts)
    within 200 us of the profiler's range of the same name (its ts plus
    baseTimeNanoseconds)."""
    tr = ttrace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.activate():
            for i in range(4):
                with ttrace.current().span(f"encode/b{i}", cat="encode"):
                    time.sleep(0.002)
                time.sleep(0.001)
    doc = tr.to_chrome()
    kin = chrome_events(prof, tmp_path)
    base = kin["baseTimeNanoseconds"] / 1e3
    prof_at = {e["name"]: (e["ts"] + base, e["dur"])
               for e in ranges(kin["traceEvents"], prefix="encode/b")}
    spans = ttrace.spans(doc, cat="encode")
    assert len(spans) == len(prof_at) == 4
    for s in spans:
        t = doc["epoch_unix_ns"] / 1e3 + s["ts"] * 1e6
        t_prof, dur = prof_at[s["name"]]
        assert abs(t - t_prof) < 200, s["name"]
        assert abs(s["dur"] * 1e6 - dur) < 200, s["name"]
    # a scripted clock has no Unix time
    assert "epoch_unix_ns" not in ttrace.Tracer(
        clock=lambda: 0.0).to_chrome()


def test_tracer_export_with_detail_spans_validates():
    """A traced run of the smoke step: the detail spans are recorded under
    their own category, the export validates, and the phases' totals
    keep their categories."""
    ts, state, batch_at = smoke()
    tr = ttrace.Tracer()
    drive(None, ts, state, batch_at, range(2), tracer=tr,
          log_every=10 ** 9)
    doc = tr.to_chrome()
    assert ttrace.validate(doc) > 0
    detail = {e["name"] for e in ttrace.spans(doc, cat="detail")}
    assert {"step/input", "model/forward/w0", "model/backward/w1",
            "model/pack", "params/views", "remat/recompute", "ef/add",
            "ef/residual", "values/round"} <= detail
    totals = ttrace.phase_totals(doc)
    assert {"step", "probe", "backward", "encode", "comm", "recover",
            "optimizer", "detail"} <= set(totals)
    assert isinstance(doc["epoch_unix_ns"], int)
