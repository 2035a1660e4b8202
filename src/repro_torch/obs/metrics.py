"""Counters / gauges / histograms + the ``repro.tune/trace@2`` schema.

Port of ``repro/obs/metrics.py`` (pure Python; the same schema string,
instruments and document layout).

``Metrics`` is a tiny in-process registry the train driver feeds per
step: wire bytes per bucket, compression ratio, EF residual norm,
exposed-vs-hidden comm time, and a step-time histogram. ``snapshot()``
serializes every instrument into the trace@2 document's ``metrics``
block.

trace@2 is a STRICT SUPERSET of trace@1 (DESIGN.md §8/§10): the
``records`` rows keep the exact trace@1 keys (step / t_step / rounds /
bytes / loss) and add warmup tags + quality metrics, and the document
adds ``provenance`` / ``metrics`` / ``predicted`` blocks —
``tune/calibrate.py`` consumes either schema unchanged (it reads only the
shared record keys, and drops rows tagged ``warmup``). A ``.jsonl``
path writes the streaming layout: header line (everything but records),
then one record per line — appendable mid-run, same document after
``load_jsonl``.
"""

from __future__ import annotations

import dataclasses
import json
import math

TRACE2_SCHEMA = "repro.tune/trace@2"


@dataclasses.dataclass
class Counter:
    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def to_json(self):
        return self.value


@dataclasses.dataclass
class Gauge:
    name: str
    value: float | None = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_json(self):
        return self.value


class Histogram:
    """Keeps raw observations (runs are short); summarizes on export."""

    def __init__(self, name: str):
        self.name = name
        self.values: list[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def summary(self) -> dict:
        v = sorted(self.values)
        if not v:
            # full key set, all null: exported JSON stays schema-stable and
            # NaN/ZeroDivision-free when an instrument never observed
            return {"count": 0, "mean": None, "min": None, "max": None,
                    "p50": None, "p90": None, "p95": None, "p99": None}
        q = lambda p: v[min(len(v) - 1, int(math.ceil(p * len(v))) - 1)]  # noqa: E731
        return {"count": len(v), "mean": sum(v) / len(v),
                "min": v[0], "max": v[-1],
                "p50": q(0.50), "p90": q(0.90), "p95": q(0.95),
                "p99": q(0.99)}

    def to_json(self):
        return self.summary()


class Metrics:
    """Get-or-create instrument registry; one per capture run."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge(name))

    def histogram(self, name: str) -> Histogram:
        return self._hists.setdefault(name, Histogram(name))

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.to_json()
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.to_json()
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.to_json()
                           for k, h in sorted(self._hists.items())},
        }


# ---------------------------------------------------------------------------
# trace@2 document
# ---------------------------------------------------------------------------


def trace2_doc(*, model: dict, records: list[dict],
               metrics: "Metrics | dict | None" = None,
               provenance: dict | None = None,
               predicted: dict | None = None) -> dict:
    """Assemble a trace@2 document. ``records`` rows must carry at least
    the trace@1 keys (step/t_step/rounds/bytes); extra keys ride along."""
    met = metrics.snapshot() if isinstance(metrics, Metrics) else metrics
    return {"schema": TRACE2_SCHEMA, "model": dict(model),
            "provenance": provenance, "metrics": met,
            "predicted": predicted, "records": list(records)}


def dump(doc: dict, path: str) -> None:
    """Write a trace document; ``.jsonl`` selects the streaming layout."""
    if path.endswith(".jsonl"):
        head = {k: v for k, v in doc.items() if k != "records"}
        with open(path, "w") as f:
            f.write(json.dumps(head) + "\n")
            for r in doc.get("records", []):
                f.write(json.dumps(r) + "\n")
    else:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)


def load_jsonl(path: str) -> dict:
    """Reassemble a ``dump``-ed .jsonl trace into one document."""
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if not lines:
        raise ValueError(f"empty trace file: {path}")
    doc = dict(lines[0])
    doc["records"] = lines[1:]
    return doc
