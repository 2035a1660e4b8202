"""Span tracing for the gs-SGD stack.

Port of ``repro/obs/trace.py``: one ``Tracer`` collects nested spans
(explicit begin/end or context manager), instant events and per-track
ids, and exports Chrome/Perfetto trace-event JSON with the reference's
schema (``repro.obs/trace@1``) and event layout. The tracer is AMBIENT:
instrumented code (``core/gs_sgd.py``'s step and exchanges,
``core/allreduce.tree_allreduce``, ``obs/drift.py``) calls
``current()``, which returns the active tracer or the module ``NULL``.

Differences from the reference, for the card and its profiler:

* ``Span.sync(x)`` calls ``torch.cuda.synchronize`` on the device of every
  CUDA tensor in ``x`` (tensors inside tuples, lists and dicts), so an
  active span's duration covers its kernels; it is the identity for CPU
  tensors. A failed sync raises: nothing is swallowed.
* Every span also opens a ``torch.profiler.record_function`` range of
  the same name, so a ``torch.profiler`` trace of an untraced step keeps
  the per-phase ranges ``chip_smoke.py``, ``bench/time_paths.py`` and
  the benchmark read. The ``NULL`` tracer's span opens its range only
  while a profiler records (``torch.autograd._profiler_enabled()``, a
  flag read); otherwise it is inert, for a range enters and leaves the
  profiler's dispatcher whether or not anything records it. ``sync`` is
  the identity with tracing off: the step does the same device work with
  tracing on or off, and no host sync.
* A ``Tracer`` on its own clock (``time.perf_counter``, the epoch read
  at construction) also reads ``time.time_ns()`` beside the epoch, and
  its export carries it as ``epoch_unix_ns``: a span's Unix time in us
  is ``epoch_unix_ns / 1e3 + ts``, as a ``torch.profiler`` trace's event
  is at ``ts + baseTimeNanoseconds / 1e3``, so the program's spans land
  on the profiler's timeline. A tracer on an injected clock or epoch has
  no Unix time and exports none.

The train driver runs one PROBE step under the tracer (on a copy of the
state, its output discarded) for per-phase attribution, and wraps every
step in a driver-level ``step{n}`` span (see ``launch/train.py``).

Span taxonomy — the ``cat`` field (the reference's, and ``detail``):

    step       one whole training step (driver timeline)
    probe      the instrumented step the phase spans live under
    forward    forward pass (chunked path; monolithic fwd+bwd = backward)
    backward   backward chunks / monolithic loss and gradient
    encode     per-bucket sketch encode (+ readiness instants)
    comm       per-bucket sketch all-reduce / per-tree-round sends
    recover    per-bucket decode + heavymix recovery
    optimizer  the segment-wise optimizer sweep
    runtime    watchdog, elastic-replan and straggler-drop instants
    stall      sim-only (``from_sim``: the barrier wait and detection)
    detail     the port's own spans inside a phase, which the reference
               has not: ``model/forward/w{w}``, ``model/backward/w{w}``,
               ``model/pack``, ``params/views``, ``remat/recompute``,
               ``ef/add``, ``ef/residual``, ``values/round`` and, at the
               driver, ``step/input``. A category of its own, so every
               reader of the categories above reads what it did; opened
               on autograd's thread (``remat/recompute``) a span does not
               ``sync``

``from_sim`` renders the simulator's event-loop result
(``sim/cluster.SimResult``) in the same schema, on the simulated clock.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Callable

import torch
from torch.profiler import record_function

TRACE_SCHEMA = "repro.obs/trace@1"

# Phase categories shared by the train probe and the sim export.
PHASES = ("forward", "backward", "encode", "comm", "recover")


def _cuda_devices(x, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


def sync(x):
    """Wait until the kernels producing ``x``'s CUDA tensors are done
    (``torch.cuda.synchronize`` on each of their devices); the identity
    for CPU tensors and non-tensors. Returns ``x``."""
    for dev in sorted(_cuda_devices(x, set()), key=str):
        torch.cuda.synchronize(dev)
    return x


# ---------------------------------------------------------------------------
# The disabled path: a profiler range, nothing recorded, no sync
# ---------------------------------------------------------------------------


class _NullSpan:
    """``NULL.span(...)`` while a profiler records: a ``record_function``
    range and nothing else."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False

    def sync(self, x):
        return x


class _InertSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def sync(self, x):
        return x


_INERT_SPAN = _InertSpan()


class _NullTracer:
    """``current()`` when no tracer is active. Records nothing."""

    enabled = False
    __slots__ = ()

    def span(self, name, *, cat="", track="main", args=None):
        if torch.autograd._profiler_enabled():
            return _NullSpan(name)
        return _INERT_SPAN

    def begin(self, name, *, cat="", track="main", args=None):
        return _INERT_SPAN

    def end(self, span):
        return None

    def instant(self, name, *, cat="", track="main", args=None, ts=None):
        return None


NULL = _NullTracer()

_CURRENT: "Tracer | None" = None


def current() -> "Tracer | _NullTracer":
    """The ambient tracer — ``NULL`` unless one is active."""
    return _CURRENT if _CURRENT is not None else NULL


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------


class Span:
    """One open span; close with ``tracer.end(span)`` or the with-block."""

    __slots__ = ("_tr", "name", "cat", "track", "args", "t0", "_rf")

    def __init__(self, tr: "Tracer", name: str, cat: str, track: str,
                 args: dict | None):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self._rf = record_function(name)

    def sync(self, x):
        """Block until ``x``'s CUDA tensors are computed, then return it
        (module-level ``sync``)."""
        return sync(x)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tr.end(self)
        return False


class Tracer:
    """Collects spans/instants; clock-injectable for tests.

    Raw events keep times in SECONDS relative to ``epoch``;
    ``to_chrome``/``save`` convert to the trace-event µs convention.
    """

    enabled = True

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 epoch: float | None = None, pid: int = 0):
        self._clock = clock
        self.pid = pid
        self.epoch = clock() if epoch is None else epoch
        # the epoch's Unix time, where the epoch is this process's
        # perf_counter (module docstring)
        self.epoch_unix_ns = (time.time_ns() if epoch is None
                              and clock is time.perf_counter else None)
        self.events: list[dict] = []
        self._stacks: dict[str, list[Span]] = {}

    # -- recording ----------------------------------------------------------

    def begin(self, name: str, *, cat: str = "", track: str = "main",
              args: dict | None = None) -> Span:
        sp = Span(self, name, cat, track, args)
        sp._rf.__enter__()
        sp.t0 = self._clock() - self.epoch
        self._stacks.setdefault(track, []).append(sp)
        return sp

    def end(self, span: Span) -> None:
        t1 = self._clock() - self.epoch
        stack = self._stacks.get(span.track, [])
        if not stack or stack[-1] is not span:
            open_names = [s.name for s in stack]
            raise ValueError(
                f"span end out of order on track {span.track!r}: closing "
                f"{span.name!r} but the open stack is {open_names}")
        stack.pop()
        span._rf.__exit__(None, None, None)
        self.events.append({"ph": "X", "name": span.name, "cat": span.cat,
                            "track": span.track, "ts": span.t0,
                            "dur": t1 - span.t0, "args": span.args})

    def span(self, name: str, *, cat: str = "", track: str = "main",
             args: dict | None = None) -> Span:
        """``with tracer.span('encode/b0', cat='encode') as sp: ...``"""
        return self.begin(name, cat=cat, track=track, args=args)

    def instant(self, name: str, *, cat: str = "", track: str = "main",
                args: dict | None = None, ts: float | None = None) -> None:
        t = (self._clock() - self.epoch) if ts is None else ts
        self.events.append({"ph": "i", "name": name, "cat": cat,
                            "track": track, "ts": t, "args": args})

    def add_span(self, name: str, t0: float, t1: float, *, cat: str = "",
                 track: str = "main", args: dict | None = None) -> None:
        """Record a closed span directly (times in tracer-relative
        seconds)."""
        self.events.append({"ph": "X", "name": name, "cat": cat,
                            "track": track, "ts": t0, "dur": t1 - t0,
                            "args": args})

    def open_spans(self) -> list[str]:
        return [s.name for st in self._stacks.values() for s in st]

    # -- ambient activation -------------------------------------------------

    @contextlib.contextmanager
    def activate(self):
        """Install as the ambient ``current()`` tracer for the block."""
        global _CURRENT
        prev = _CURRENT
        _CURRENT = self
        try:
            yield self
        finally:
            _CURRENT = prev

    # -- export -------------------------------------------------------------

    def to_chrome(self, *, spec=None, provenance: dict | None = None,
                  source: str = "train") -> dict:
        """Chrome/Perfetto trace-event JSON with the run's identity
        embedded (schema / source / resolved spec / provenance)."""
        if self.open_spans():
            raise ValueError(
                f"cannot export with open spans: {self.open_spans()}")
        tids: dict[str, int] = {}
        out: list[dict] = []
        for e in sorted(self.events, key=lambda e: e["ts"]):
            track = e["track"]
            if track not in tids:
                tids[track] = len(tids)
                out.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                            "tid": tids[track],
                            "args": {"name": track}})
            ev = {"name": e["name"], "cat": e["cat"] or "default",
                  "ph": e["ph"], "ts": e["ts"] * 1e6, "pid": self.pid,
                  "tid": tids[track], "args": e.get("args") or {}}
            if e["ph"] == "X":
                ev["dur"] = e["dur"] * 1e6
            else:
                ev["s"] = "t"
            out.append(ev)
        spec_doc = (spec.to_json() if hasattr(spec, "to_json") else spec)
        doc = {"schema": TRACE_SCHEMA, "source": source,
               "spec": spec_doc, "provenance": provenance,
               "displayTimeUnit": "ms", "traceEvents": out}
        if self.epoch_unix_ns is not None:
            doc["epoch_unix_ns"] = self.epoch_unix_ns
        return doc

    def save(self, path: str, *, spec=None, provenance: dict | None = None,
             source: str = "train") -> dict:
        doc = self.to_chrome(spec=spec, provenance=provenance, source=source)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc


# ---------------------------------------------------------------------------
# Validation + chrome-doc helpers
# ---------------------------------------------------------------------------


def load(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"not a {TRACE_SCHEMA} document: "
                         f"schema={doc.get('schema')!r}")
    return doc


def _norm_events(doc_or_events) -> list[dict]:
    if isinstance(doc_or_events, Tracer):
        return doc_or_events.events
    if isinstance(doc_or_events, dict):
        return doc_or_events["traceEvents"]
    return list(doc_or_events)


def validate(doc_or_events) -> int:
    """Check span well-formedness; returns the number of spans checked.

    Within each track, "X" spans must be properly nested: any two either
    disjoint or one inside the other (a small relative epsilon absorbs
    float µs rounding). Raises ValueError on overlap.
    """
    by_track: dict[Any, list[tuple[float, float, str]]] = {}
    for e in _norm_events(doc_or_events):
        if e.get("ph") != "X":
            continue
        key = (e.get("pid"), e["tid"]) if "tid" in e else e.get("track")
        by_track.setdefault(key, []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    n = 0
    for key, spans_ in by_track.items():
        spans_.sort(key=lambda s: (s[0], -(s[1] - s[0])))
        stack: list[tuple[float, float, str]] = []
        for t0, t1, name in spans_:
            eps = 1e-6 * max(1.0, abs(t1))
            while stack and stack[-1][1] <= t0 + eps:
                stack.pop()
            if stack and t1 > stack[-1][1] + eps:
                raise ValueError(
                    f"track {key!r}: span {name!r} [{t0}, {t1}] overlaps "
                    f"{stack[-1][2]!r} [{stack[-1][0]}, {stack[-1][1]}] "
                    "without nesting")
            stack.append((t0, t1, name))
            n += 1
    return n


def spans(doc: dict, cat: str | None = None,
          name_prefix: str | None = None) -> list[dict]:
    """"X" events of a chrome doc, ts/dur converted back to seconds."""
    out = []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            continue
        if cat is not None and e.get("cat") != cat:
            continue
        if name_prefix is not None and not e["name"].startswith(name_prefix):
            continue
        out.append({**e, "ts": e["ts"] / 1e6, "dur": e["dur"] / 1e6})
    return out


def instants(doc: dict, name: str | None = None) -> list[dict]:
    return [{**e, "ts": e["ts"] / 1e6} for e in doc["traceEvents"]
            if e.get("ph") == "i"
            and (name is None or e["name"] == name)]


def phase_totals(doc: dict) -> dict[str, float]:
    """Total seconds per span category."""
    out: dict[str, float] = {}
    for e in spans(doc):
        out[e["cat"]] = out.get(e["cat"], 0.0) + e["dur"]
    return out


def bucket_durations(doc: dict, cat: str, prefix: str) -> list[float]:
    """Per-bucket stage durations from '<prefix>{i}'-named spans, in
    bucket order (e.g. cat='comm', prefix='allreduce/b')."""
    got: dict[int, float] = {}
    for e in spans(doc, cat=cat, name_prefix=prefix):
        try:
            i = int(e["name"][len(prefix):])
        except ValueError:
            continue
        got[i] = got.get(i, 0.0) + e["dur"]
    return [got[i] for i in sorted(got)]


def from_sim(result) -> Tracer:
    """Render a ``sim.cluster.SimResult`` into a Tracer.

    Each ``StepRecord`` becomes a cat='step' umbrella span with
    sequential forward / backward / stall / encode / comm / recover
    children (compute split by the config's ``bwd_frac``); replans and
    straggler drops become cat='runtime' instants — the shape the train
    driver emits, so sim and measured traces diff structurally. Times are
    the simulated clock's. Duck-typed on the result object: no sim
    import, no cycle.
    """
    cfg = result.config
    tr = Tracer(epoch=0.0)
    track = "cluster"
    for r in result.records:
        t0 = r.t_start
        tr.add_span(f"step{r.step}", t0, t0 + r.total, cat="step",
                    track=track,
                    args={"step": r.step, "warmup": False, "p": r.p,
                          "generation": r.generation, "t_step": r.total})
        cur = t0
        parts = (("forward", "forward", r.compute * (1.0 - cfg.bwd_frac)),
                 ("backward", "backward", r.compute * cfg.bwd_frac),
                 ("stall", "stall", r.stall),
                 ("encode", "encode", r.encode),
                 ("comm", "comm", r.comm),
                 ("recover", "recover", r.recover))
        for name, cat, dur in parts:
            if dur > 0.0:
                tr.add_span(name, cur, cur + dur, cat=cat, track=track,
                            args={"step": r.step})
            cur += dur
        for w in r.dropped:
            tr.instant("straggler.drop", cat="runtime", track=track,
                       ts=t0 + r.compute + r.stall,
                       args={"worker": int(w), "step": r.step})
    for rp in result.replans:
        tr.instant("elastic.replan", cat="runtime", track=track,
                   ts=rp["time"],
                   args={k: rp.get(k) for k in
                         ("step", "generation", "p", "failed", "joined",
                          "lr_scale")})
    for w in getattr(result, "watch", None) or []:
        tr.instant(w.get("kind", "watch"), cat="runtime", track=track,
                   ts=w.get("time") or 0.0,
                   args={k: v for k, v in w.items()
                         if k not in ("kind", "time")})
    return tr
