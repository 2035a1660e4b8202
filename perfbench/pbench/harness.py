"""One run of a cell: set-up, the measured window (or the traced steps),
then the check that decides ``correct``.

Set-up builds the program's train step and its state from the seeded
parameters, and drives that same state through the checked steps with
the window's own call (``launch.train.train_loop``) and feed: they warm
every shape the window uses (the kernels load or build, the first
step's optimizer temporaries pass) and give the program's readings. The
window then runs whole steps until ``seconds`` have passed, each ending
in the loss read back, as the program's loop does. A traced run measures
the same window, then profiles ``profile_steps`` more steps with the
program's tracer off (each span is only a ``record_function`` range):
the profiler's host cost stretches the traced steps' wall, so a reader
that needs a step's wall takes the untraced window's. After the window
the peak memory is read, the program's state is freed, and the reference
follows the checked steps on the same inputs.
"""

from __future__ import annotations

import gc
import json
import math
import os
import tempfile
import time

import torch

from pbench import compare, inputs, observe, port
from pbench import layout as lay_mod
from pbench import reference as ref_mod
from pbench import trace as trace_mod

CHECK_STEPS = 3
MAX_STEPS_PER_S = 1000


def tokens_per_step(traffic: dict) -> int:
    return (int(traffic["workers"]) * int(traffic["seqs_per_worker"])
            * int(traffic["seq_len"]))


def program_readings(ts, state: dict, lay, conf: dict, seed: int, device,
                     batch_at, step_fn=None) -> tuple[dict, dict]:
    """Drive ``state`` through the checked steps; returns the state and
    the program's readings (compare.numbers)."""
    from repro_torch.launch.train import train_loop
    b1 = conf["optimizer"]["b1"]
    got: dict = {}

    def after(step, st, loss):
        if step == 0:   # the first update, from worker 0's first moment
            m = {k: mv[0][0] for k, mv in st["opt"].items()}
            got["grad"] = observe.leaf_norms(
                lambda l: observe.segment_view(m, lay, l), lay,
                1.0 / (1.0 - b1))
        if step == CHECK_STEPS - 1:
            p = {k: v[0] for k, v in st["params"].items()}
            got["change"] = observe.change_norms(
                lambda l: observe.segment_view(p, lay, l), lay, seed,
                device)
        return False

    if step_fn is not None:
        ts = step_fn(ts)
    state, losses, _ = train_loop(ts, state, batch_at, range(CHECK_STEPS),
                                  log_every=10 ** 9, after_step=after)
    got["loss"] = losses
    return state, got


def reference_readings(conf: dict, traffic: dict, seed: int, device,
                       **kw) -> dict:
    """The reference's readings of the checked steps (``kw``: tf32=,
    fault= for the control and the planted faults)."""
    ref = ref_mod.Reference(conf, traffic, seed, device, **kw)
    out = {"loss": []}
    for t in range(CHECK_STEPS):
        r = ref.step()
        out["loss"].append(r["loss"])
        if t == 0:
            view = observe.flat_view(r["update"])
            out["grad"] = observe.leaf_norms(view, ref.lay)
            out["dense"] = observe.leaf_norms(observe.flat_view(r["dense"]),
                                              ref.lay)
        del r
    out["change"] = observe.change_norms(observe.flat_view(ref.params),
                                         ref.lay, seed, device)
    del ref
    return out


def measure_window(ts, state, batch_at, seconds: float):
    """Whole steps after the checked ones until ``seconds`` have passed,
    each ending in the loss read back; returns the state, the losses,
    each step's seconds and the window's seconds (from its start to the
    last step's end)."""
    from repro_torch.launch.train import train_loop
    t0 = time.perf_counter()
    deadline = t0 + seconds
    # the loop lists its steps up front: a bound no cell comes near
    last = CHECK_STEPS + MAX_STEPS_PER_S * int(math.ceil(seconds))
    state, hist, times = train_loop(
        ts, state, batch_at, range(CHECK_STEPS, last), log_every=10 ** 9,
        after_step=lambda s, st, l: time.perf_counter() >= deadline)
    return state, hist, times, time.perf_counter() - t0


def profile_steps(ts, state, batch_at, first: int, n: int):
    """``n`` steps under torch.profiler inside the window range; returns
    the state and the trace's reduction."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import train_loop
    acts = [ProfilerActivity.CPU]
    if ts.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(trace_mod.WINDOW):
            state, _, _ = train_loop(ts, state, batch_at,
                                     range(first, first + n),
                                     log_every=10 ** 9)
            if ts.device.type == "cuda":
                torch.cuda.synchronize(ts.device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return state, trace_mod.reduce(events)


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def run_single(cell: dict, seed: int, seconds: float, trace: bool, device,
               t_start: float, step_fn=None) -> dict:
    """A run of a cell of simulated workers on one device. ``step_fn``
    wraps the built train step (the tests plant faults with it)."""
    conf, traffic = cell["conf"], cell["traffic"]
    if traffic.get("mesh"):
        raise ValueError(f"{cell['name']}: a process mesh's traffic; this "
                         "harness simulates the workers on one device")
    lay = lay_mod.layout(lay_mod.Shape.of(conf))
    ts = port.build_step(conf, traffic, device)
    flat = inputs.initial_params(lay, seed, device)
    state = ts.state_from(inputs.segments_of(flat, lay),
                          port.optimizer(conf))
    del flat
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    def batch_at(t):
        return inputs.batch(lay.shape, traffic, seed, t, device)

    state, prog = program_readings(ts, state, lay, conf, seed, device,
                                   batch_at, step_fn)
    if step_fn is not None:
        ts = step_fn(ts)
    out = {"attempted": CHECK_STEPS,
           "failed": sum(not math.isfinite(x) for x in prog["loss"])}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["setup_s"] = time.time() - t_start
    state, hist, times, window_s = measure_window(ts, state, batch_at,
                                                  seconds)
    out["attempted"] += len(hist)
    out["failed"] += sum(not math.isfinite(x) for x in hist)
    out["tokens_per_s"] = len(hist) * tokens_per_step(traffic) / window_s
    out["window_s"] = window_s
    out["step_s"] = times
    if trace:
        n = int(traffic["profile_steps"])
        state, red = profile_steps(ts, state, batch_at,
                                   CHECK_STEPS + len(hist), n)
        out["attempted"] += n
        out["ranks"] = [{**red, "steps": n, "workers": ts.nworkers,
                         "untraced_step_s": window_s / len(hist)}]
    out["memory_peak_bytes"] = peak_bytes(device)
    del state, ts
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(conf, traffic, seed, device)
    out["numbers"] = compare.numbers(prog, ref)
    return out
