"""Device time by part, one level inside the layers, and the device's idle
time by program span, from a ``torch.profiler`` Chrome trace.

``trace.reduce`` gives each device event to the innermost layer span
(``trace.FAMILIES``). This gives it to the innermost of the program's
``detail`` spans (their names in ``PARTS``), which sit inside those
layers: each worker's forward and backward, the remat's recompute, the
gradients' pack, the error feedback's add and residual, the exact
values' round, the step's input. A device event under none of them
counts in no part.

The segment gradients' assembly has no span of its own: autograd runs it
in the backward nodes of the ops that made the parameter leaves as views
of the flat segments. Those ops run under ``params/views``; under the
profiler each carries a sequence number, and its node's
``autograd::engine::evaluate_function: <Node>`` range carries the same
one (and the forward thread's id). Those ranges count as ``assemble``,
with the ``model/pack`` span; they hold the node's zero fill, its copy
and the adds that accumulate the leaves' gradients. The views a remat
recompute makes again run inside a node's range, in the backward: their
graph is thrown away, and no node of theirs runs.

Each idle gap of the device inside the window is split over time by the
innermost program range open on any thread (digits in its name read as
``*``: ``step*``, ``model/forward/w*``), ``none`` where none is.

Nothing here imports the program; ``reduce`` reads the events alone.
"""

from __future__ import annotations

import bisect
import re
from collections import Counter, defaultdict

from pbench.trace import DEVICE_CATS, FAMILIES, WINDOW, Innermost, _merge

# the program's detail spans (their first one or two path components)
PARTS = {"model/forward": "forward", "model/backward": "backward",
         "remat/recompute": "recompute", "model/pack": "assemble",
         "params/views": "views", "ef": "ef", "values/round": "values",
         "step/input": "input"}
VIEWS = "params/views"
EVAL = "autograd::engine::evaluate_function: "
SEQ = "Sequence number"
FWD = "Fwd thread id"


def part_of(name: str) -> str | None:
    comps = name.split("/")
    for n in (2, 1):
        part = PARTS.get("/".join(comps[:n]))
        if part is not None:
            return part
    return None


def _span(e) -> tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def _window(events) -> tuple[float, float]:
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' ranges")
    return _span(win[0])


def _ranges_by_tid(ranges) -> dict:
    """{tid: Innermost} of the ``ranges`` each thread opened."""
    by: dict = defaultdict(list)
    for e in ranges:
        by[e.get("tid")].append(_span(e) + (True,))
    return {t: Innermost(s) for t, s in by.items()}


def assembly_ranges(events) -> list:
    """The ``evaluate_function`` ranges of the nodes made by the ops under
    ``params/views``, linked by sequence number on the forward thread:
    [(start, end, node name)].

    Every op records the sequence number the next node will take, and an
    op that makes a node takes it, so several ops carry one number: those
    before the node's maker, made no node, and the maker, the last of them
    to start (an op inside a node's range, such as a recompute's, is the
    backward's, and left out). A number is linked where its maker ran
    under ``params/views``."""
    nodes = [e for e in events if e.get("cat") == "cpu_op"
             and e["name"].startswith(EVAL)]
    if not nodes:
        return []
    in_node = _ranges_by_tid(nodes)
    maker: dict = {}
    for e in events:
        seq = e.get("args", {}).get(SEQ)
        if e.get("cat") != "cpu_op" or seq is None or \
                e["name"].startswith(EVAL):
            continue
        tid, t = e.get("tid"), float(e["ts"])
        if tid in in_node and in_node[tid](t):
            continue
        maker[tid, seq] = max(t, maker.get((tid, seq), t))
    views = _ranges_by_tid(e for e in events
                           if e.get("cat") == "user_annotation"
                           and e.get("name") == VIEWS)
    seqs = {seq for (tid, seq), t in maker.items()
            if tid in views and views[tid](t)}
    # every node the backward runs was made on the forward's thread: its
    # id is the most common one
    fwd = Counter(e["args"].get(FWD) for e in nodes).most_common(1)[0][0]
    return [_span(e) + (e["name"][len(EVAL):],) for e in nodes
            if e["args"].get(SEQ) in seqs and e["args"].get(FWD) == fwd]


def _pieces(inner: Innermost, a: float, b: float):
    """[a, b) cut where the innermost range changes: (seconds, label)."""
    starts, labels = inner.starts, inner.labels
    i = bisect.bisect_right(starts, a) - 1   # the piece holding a; -1: none
    t = a
    while t < b:
        end = min(starts[i + 1], b) if i + 1 < len(starts) else b
        yield end - t, labels[i] if i >= 0 else None
        t = end
        i += 1


def reduce(events: list, top: int = 3, top_ops: int = 5) -> dict:
    """Device milliseconds by part (``part_ms``) with each part's ``top``
    largest device ops (``part_ops``: [name, seconds]); the ``top_ops``
    largest device ops with their seconds by where they were launched, a
    part or else the layer (or ``outside``, ``unlinked``), and by the op
    that launched them (``op_split``: [name, seconds, {where: seconds},
    {op: seconds}]); and the idle gaps' milliseconds by the innermost
    program range (``idle_by_span_ms``), over the harness's window
    range."""
    w0, w1 = _window(events)
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    spans = [_span(e) + (FAMILIES[e["name"].split("/")[0]],) for e in ann
             if e["name"].split("/")[0] in FAMILIES]
    spans += [_span(e) + (part_of(e["name"]),) for e in ann
              if part_of(e["name"])]
    spans += [(a, b, "assemble") for a, b, _ in assembly_ranges(events)]
    where_at = Innermost(spans)
    launch = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid"))
              for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    cpu: dict = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and not e["name"].startswith(EVAL):
            cpu[e.get("tid")].append(_span(e) + (e["name"],))
    op_at = {tid: Innermost(v) for tid, v in cpu.items()}
    by_where: dict = defaultdict(Counter)
    by_op: dict = defaultdict(Counter)
    busy = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = _span(e)
        if b <= w0 or a >= w1:
            continue
        busy.append((max(a, w0), min(b, w1)))
        t, tid = launch.get(e.get("args", {}).get("correlation"),
                            (None, None))
        where = "unlinked" if t is None else (where_at(t) or "outside")
        by_where[e["name"]][where] += b - a
        if tid in op_at:
            by_op[e["name"]][op_at[tid](t) or "none"] += b - a
    kinds = set(PARTS.values())
    part_us: dict = defaultdict(float)
    ops: dict = defaultdict(Counter)
    for name, c in by_where.items():
        for where, us in c.items():
            if where in kinds:
                part_us[where] += us
                ops[where][name] += us
    total = Counter({n: sum(c.values()) for n, c in by_where.items()})
    prog = Innermost([_span(e) + (re.sub(r"\d+", "*", e["name"]),)
                      for e in ann if e.get("name") != WINDOW])
    idle: dict = defaultdict(float)
    prev = w0
    for a, b in _merge(busy) + [[w1, w1]]:
        if a > prev:
            for dur, label in _pieces(prog, prev, a):
                idle[label or "none"] += dur
        prev = max(prev, b)
    return {"part_ms": {k: v / 1e3 for k, v in part_us.items()},
            "part_ops": {k: [[n, v / 1e6] for n, v in c.most_common(top)]
                         for k, c in ops.items()},
            "op_split": [[n, v / 1e6,
                          {k: u / 1e6 for k, u in by_where[n].items()},
                          {k: u / 1e6 for k, u in by_op[n].items()}]
                         for n, v in total.most_common(top_ops)],
            "idle_by_span_ms": {k: v / 1e3 for k, v in idle.items()}}
