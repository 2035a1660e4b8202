"""Fault traces: scripted failure / rejoin / straggle / congest scenarios.

Port of ``repro/sim/traces.py`` (NumPy; the same draws in the same
order, so a seeded ``synthetic`` scenario is the reference's).

A trace is an ordered list of step-indexed events the cluster sim injects:

    {"step": 40, "kind": "fail",     "worker": 3}
    {"step": 90, "kind": "join",     "worker": 3}
    {"step": 20, "kind": "straggle", "worker": 7, "factor": 12.0,
     "duration": 5}
    {"step": 10, "kind": "congest", "factor": 6.0, "duration": 20}

``fail`` silences the worker's heartbeat (detection happens through the
simulated ``HeartbeatMonitor``, not by fiat — the sim only learns of the
death when the timeout expires, exactly like the runtime layer).
``join`` hands a new/returning worker to ``elastic.replan(joined=...)``.
``straggle`` multiplies the worker's compute time by ``factor`` for
``duration`` steps (1 = a single spike) — the input ``DeadlinePolicy``
turns into drop masks. ``congest`` is cluster-wide (``worker`` is
ignored; -1 by convention): every collective's comm time is multiplied
by ``factor`` for ``duration`` steps — mid-run link congestion, the
scenario the drift watchdog is bounded against.

Traces are plain JSON so scenarios can be version-controlled and shared
between the CLI and the tests; ``synthetic`` generates
seeded random scenarios for sweeps at large P.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

KINDS = ("fail", "join", "straggle", "congest")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    step: int
    kind: str
    worker: int = -1        # -1 = cluster-wide (congest)
    factor: float = 1.0     # straggle/congest slowdown
    duration: int = 1       # straggle/congest length in steps

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown trace event kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    events: tuple[TraceEvent, ...] = ()

    def at(self, step: int) -> list[TraceEvent]:
        """Events for one step, in insertion order. O(1) per lookup: the
        per-step index is built lazily once (stashed in ``__dict__``,
        which a frozen dataclass's eq/hash ignore) — a heavy-churn trace
        at P=100k holds tens of thousands of events, and the seed's
        linear scan per step made trace application quadratic."""
        idx = self.__dict__.get("_by_step")
        if idx is None:
            idx = {}
            for e in self.events:
                idx.setdefault(e.step, []).append(e)
            self.__dict__["_by_step"] = idx
        return list(idx.get(step, ()))

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(e) for e in self.events],
                          indent=2)

    @staticmethod
    def from_json(text: str) -> "FaultTrace":
        evs = tuple(TraceEvent(**e) for e in json.loads(text))
        return FaultTrace(tuple(sorted(evs, key=lambda e: e.step)))

    @staticmethod
    def load(path: str) -> "FaultTrace":
        with open(path) as f:
            return FaultTrace.from_json(f.read())


def synthetic(p: int, steps: int, *, seed: int = 0,
              fail_rate: float = 0.0, straggle_rate: float = 0.0,
              straggle_factor: float = 10.0, rejoin_after: int | None = None
              ) -> FaultTrace:
    """Seeded random scenario: per-step Bernoulli failures/straggles.

    fail_rate / straggle_rate are per-step cluster-wide probabilities
    (not per worker), so scenarios stay sparse as P grows. Failed workers
    optionally rejoin ``rejoin_after`` steps later.
    """
    rng = np.random.default_rng(seed)
    alive = set(range(p))
    rejoins: dict[int, list[int]] = {}
    events: list[TraceEvent] = []
    for s in range(steps):
        alive.update(rejoins.pop(s, []))
        if alive and rng.random() < fail_rate:
            w = int(rng.choice(sorted(alive)))
            alive.discard(w)
            events.append(TraceEvent(s, "fail", w))
            if rejoin_after is not None and s + rejoin_after < steps:
                events.append(TraceEvent(s + rejoin_after, "join", w))
                rejoins.setdefault(s + rejoin_after, []).append(w)
        if alive and rng.random() < straggle_rate:
            w = int(rng.choice(sorted(alive)))
            events.append(TraceEvent(s, "straggle", w,
                                     factor=straggle_factor,
                                     duration=int(rng.integers(1, 4))))
    return FaultTrace(tuple(sorted(events, key=lambda e: e.step)))
