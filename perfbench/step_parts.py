"""A cell's step by part: one level inside the benchmark's layers.

    python3 perfbench/step_parts.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the card. The cell is set up as
``run.py`` sets it up (the checked steps warm every shape), runs an
untraced window of ``seconds``, then profiles the traffic's
``profile_steps`` steps. The last line of standard output is one JSON
object: the window's tokens a second and step, the profiled wall a step,
and per profiled step the device milliseconds by layer
(``trace.reduce``) and by part (``pbench.parts``), the parts' share of
the model layer, the idle milliseconds by program range, and the wire
counter's payload a worker (``repro_torch.core.pgroup.WIRE``, MB); and
the five largest device ops a step, each split by the part (or else the
layer) and by the op that launched it. Each part's three largest device
ops a step, those five and the idle table go to standard error. It
checks nothing: ``run.py`` decides ``correct``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "build", "perfbench", _dir)

MODEL_PARTS = ("forward", "backward", "recompute", "assemble", "views")


def profiled_events(ts, state, batch_at, first: int, n: int):
    """``n`` steps under torch.profiler inside the harness's window range:
    the state, the trace's events, the profiled steps' wall seconds and
    the wire counter's difference."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pbench import trace
    from repro_torch.core import pgroup
    from repro_torch.launch.train import train_loop
    acts = [ProfilerActivity.CPU]
    if ts.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = dict(pgroup.WIRE)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            t0 = time.perf_counter()
            state, _, _ = train_loop(ts, state, batch_at,
                                     range(first, first + n),
                                     log_every=10 ** 9)
            if ts.device.type == "cuda":
                torch.cuda.synchronize(ts.device)
            wall = time.perf_counter() - t0
    wire = {k: v - before[k] for k, v in pgroup.WIRE.items()}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return state, events, wall, wire


def measure(cell: dict, seed: int, seconds: float, device) -> dict:
    """The readings above for ``cell`` (``pbench.cells.cell``'s form)."""
    from pbench import harness, inputs, parts, port, trace
    from pbench import layout as lay_mod
    from repro_torch.launch.train import train_loop
    conf, traffic = cell["conf"], cell["traffic"]
    lay = lay_mod.layout(lay_mod.Shape.of(conf))
    ts = port.build_step(conf, traffic, device)
    flat = inputs.initial_params(lay, seed, device)
    state = ts.state_from(inputs.segments_of(flat, lay),
                          port.optimizer(conf))
    del flat

    def batch_at(t):
        return inputs.batch(lay.shape, traffic, seed, t, device)

    state, _, _ = train_loop(ts, state, batch_at,
                             range(harness.CHECK_STEPS), log_every=10 ** 9)
    state, hist, _, window_s = harness.measure_window(ts, state, batch_at,
                                                      seconds)
    n = int(traffic["profile_steps"])
    state, events, wall, wire = profiled_events(
        ts, state, batch_at, harness.CHECK_STEPS + len(hist), n)
    red, det = trace.reduce(events), parts.reduce(events)
    model = red["family_ms"].get("model", 0.0)
    covered = sum(det["part_ms"].get(p, 0.0) for p in MODEL_PARTS)
    return {
        "window_tokens_per_s": (len(hist) * harness.tokens_per_step(traffic)
                                / window_s),
        "window_step_s": window_s / len(hist), "profiled_steps": n,
        "profiled_wall_step_s": wall / n,
        "busy_ms": red["busy_s"] * 1e3 / n,
        "family_ms": {k: v / n for k, v in red["family_ms"].items()},
        "part_ms": {k: v / n for k, v in det["part_ms"].items()},
        "model_covered": covered / model if model else None,
        "idle_by_span_ms": {k: v / n
                            for k, v in det["idle_by_span_ms"].items()},
        "wire_mb": wire["bytes"] / n / 1e6, "wire_calls": wire["calls"] / n,
        "part_ops_ms": {k: [[name, s * 1e3 / n] for name, s in v]
                        for k, v in det["part_ops"].items()},
        "top_ops_ms": [[name, s * 1e3 / n,
                        {k: v * 1e3 / n for k, v in where.items()},
                        {k: v * 1e3 / n for k, v in by.items()}]
                       for name, s, where, by in det["op_split"]]}


def tables(out: dict) -> str:
    """Each part's largest device ops a step and the idle table."""
    lines = []
    for part, ops in sorted(out["part_ops_ms"].items()):
        lines.append(f"{part}: {out['part_ms'][part]:.3f} ms a step")
        lines += [f"    {ms:10.3f} ms  {name[:120]}" for name, ms in ops]
    lines.append("largest device ops, ms a step, by part or layer and "
                 "by the op that launched them:")
    for name, ms, where, by in out["top_ops_ms"]:
        lines.append(f"    {ms:10.3f} ms  {name[:120]}")
        lines.append("        " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(where.items(),
                                              key=lambda kv: -kv[1])))
        lines.append("        " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(by.items(),
                                              key=lambda kv: -kv[1])[:4]))
    lines.append("idle by program range, ms a step:")
    lines += [f"    {ms:10.3f}  {label}" for label, ms in
              sorted(out["idle_by_span_ms"].items(), key=lambda kv: -kv[1])]
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch
    from pbench import cells
    if not torch.cuda.is_available():
        print("step_parts: no CUDA device: the readings are the card's",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = measure(cells.cell(args.workload), args.seed, args.seconds, device)
    out["device"] = torch.cuda.get_device_name(device)
    print(tables(out), file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
