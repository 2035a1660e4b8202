"""Reduction of a ``torch.profiler`` Chrome trace to device time by layer.

Each device event (kernel, memcpy, memset) is counted once: it goes to
the innermost program span whose host time range holds its launch (the
runtime or driver call with the same correlation id, whatever thread
made it: the backward launches from autograd's thread inside the
step's span). The spans nest, so a sweep over them turns the trace into
non-overlapping intervals, each labelled by its innermost span, and a
launch is looked up by bisection: linear in the trace however many steps
it holds. A device event whose launch is in no span counts as
``outside``; one with no launch found as ``unlinked``.

The same sweep over the host's own events labels each idle gap of the
device with what the host was doing when it opened.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

# the program's span names (their first path component) -> layer
FAMILIES = {"loss_and_grad": "model", "forward": "model",
            "backward": "model", "optimizer": "optimizer",
            "encode": "encode", "recover": "recover",
            "allreduce": "wire", "tree": "wire", "stage": "wire",
            "exchange": "exchange"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench.window"


class Innermost:
    """Lookup of the innermost of nested intervals (start, end, label)
    that holds a time."""

    def __init__(self, spans):
        pts: list[tuple[float, object]] = []
        stack: list[tuple[float, float, object]] = []

        def pop_until(t):
            while stack and stack[-1][1] <= t:
                end = stack.pop()[1]
                pts.append((end, stack[-1][2] if stack else None))

        for s in sorted(spans, key=lambda s: (s[0], -s[1])):
            pop_until(s[0])
            stack.append(s)
            pts.append((s[0], s[2]))
        pop_until(float("inf"))
        self.starts = [p[0] for p in pts]
        self.labels = [p[1] for p in pts]

    def __call__(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        return self.labels[i] if i >= 0 else None


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list, top: int = 10) -> dict:
    """Device seconds by layer, busy seconds (the union of the device's
    events), the traced window's seconds (the harness's ``WINDOW`` range),
    the kernels that took most time and the longest idle gaps by what
    the host was doing."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' ranges")
    w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              FAMILIES[e["name"].split("/")[0]]) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name", "").split("/")[0] in FAMILIES]
    layer_of = Innermost(spans)
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    family_us: dict[str, float] = defaultdict(float)
    by_kernel: Counter = Counter()
    busy = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, dur = float(e["ts"]), float(e["dur"])
        b = a + dur
        if b <= w0 or a >= w1:
            continue
        busy.append((max(a, w0), min(b, w1)))
        by_kernel[e["name"]] += dur
        t = launch.get(e.get("args", {}).get("correlation"))
        label = "unlinked" if t is None else (layer_of(t) or "outside")
        family_us[label] += dur
    merged = _merge(busy)
    busy_us = sum(b - a for a, b in merged)
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host = _host_events(events, w0, w1)
    doing = Innermost([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"][:80]) for e in host])
    by_gap: Counter = Counter()
    for a, b in gaps:
        by_gap[doing((a + b) / 2) or "host: no event"] += b - a
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "family_ms": {k: v / 1e3 for k, v in family_us.items()},
            "device_ops": [[n, v / 1e6] for n, v in
                           by_kernel.most_common(top)],
            "idle_gaps": [[n, v / 1e6] for n, v in by_gap.most_common(top)]}


def _host_events(events, w0, w1):
    """The host events of the thread that launched most device work (the
    step's thread), inside the window, the window range itself left out."""
    ops = [e for e in events
           if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                               "cuda_driver", "python_function")
           and e.get("name") != WINDOW and "dur" in e
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    launches = Counter(e.get("tid") for e in ops
                       if e.get("cat") == "cuda_runtime")
    if not launches:
        return ops
    tid = launches.most_common(1)[0][0]
    return [e for e in ops if e.get("tid") == tid]
