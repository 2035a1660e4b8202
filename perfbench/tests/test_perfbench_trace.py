"""The trace reduction on a hand-made trace, and the readers on its
record."""

import pytest

from pbench import cells, trace


def ev(cat, name, ts, dur, **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1,
            "args": args}


EVENTS = [
    ev("user_annotation", trace.WINDOW, 0, 100),
    ev("user_annotation", "loss_and_grad", 0, 40),
    ev("user_annotation", "encode/b0", 40, 20),
    ev("user_annotation", "allreduce/b0", 60, 10),
    ev("user_annotation", "tree/reduce0", 62, 4),
    ev("user_annotation", "recover/b0", 70, 20),
    ev("cpu_op", "aten::item", 90, 10),
    ev("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1),
    ev("cuda_runtime", "cudaLaunchKernel", 41, 1, correlation=2),
    ev("cuda_runtime", "cudaLaunchKernel", 63, 1, correlation=3),
    ev("cuda_runtime", "cudaLaunchKernel", 71, 1, correlation=4),
    ev("kernel", "gemm", 2, 30, correlation=1),
    ev("kernel", "encode", 42, 10, correlation=2),
    ev("kernel", "ncclKernel", 64, 2, correlation=3),
    ev("kernel", "decode", 72, 8, correlation=4),
    ev("kernel", "orphan", 81, 1, correlation=9),
]


def test_perfbench_reduce_attributes_innermost():
    r = trace.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(51e-6)
    assert r["family_ms"] == pytest.approx(
        {"model": 0.030, "encode": 0.010, "wire": 0.002,
         "recover": 0.008, "unlinked": 0.001})
    assert r["device_ops"][0] == ["gemm", pytest.approx(30e-6)]
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(18e-6)   # 82..100


def test_perfbench_readers_on_the_record():
    red = trace.reduce(EVENTS)
    conf = cells.config("minicpm-2b-8L")
    # the untraced window's step: 60 us, shorter than the traced 100 us
    rec = {"conf": conf, "traffic": cells.traffic("tok512-p2"), "chips": 1,
           "ranks": [{**red, "steps": 1, "workers": 2,
                      "untraced_step_s": 60e-6}]}
    got = {m: cells.reader(m)(rec) for m in (
        "model_ms", "encode_ms", "recover_ms", "optimizer_ms", "idle_pct")}
    assert got["model_ms"] == pytest.approx(0.030)
    assert got["optimizer_ms"] is None
    assert got["idle_pct"] == pytest.approx(15.0)   # 1 - 51 / 60


def test_perfbench_mfu_takes_the_untraced_step():
    """The profiler's host cost stretches the traced wall: step_mfu_pct
    reads the untraced window's step, whatever the traced wall."""
    from counts import model_flops, peaks
    from pbench import layout
    conf, traffic = cells.config("minicpm-2b-8L"), cells.traffic("tok512-p2")
    flops = model_flops.train_flops(layout.Shape.of(conf), 2, 512)
    rank = {"steps": 4, "window_s": 4.0, "busy_s": 2.0, "workers": 2,
            "untraced_step_s": 0.5, "family_ms": {}}
    mfu = cells.reader("step_mfu_pct")
    for wall in (4.0, 8.0):
        rec = {"conf": conf, "traffic": traffic, "chips": 1,
               "ranks": [{**rank, "window_s": wall}]}
        assert mfu(rec) == pytest.approx(
            100 * flops / (0.5 * peaks.FLOPS["float32"]))
        assert cells.reader("idle_pct")(rec) == pytest.approx(0.0)
