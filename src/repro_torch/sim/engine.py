"""Deterministic discrete-event loop — the substrate of the cluster sim.

Port of ``repro/sim/engine.py`` (pure Python and NumPy, unchanged).

Minimal on purpose: a time-ordered heap of (time, seq, fn) events. ``seq``
is a monotone insertion counter, so events at equal timestamps fire in the
order they were scheduled — the whole simulation is a pure function of the
config and the seed, never of heap-internal tie-breaking. All randomness
is injected through ``numpy.random.Generator`` objects owned by the
callers (see ``workers.py``); the loop itself is RNG-free.

Processes are plain callbacks that schedule further events; there is no
coroutine machinery because the cluster sim's control flow (step barrier →
exchange → heartbeat sweep) is naturally expressed as a chain of
callbacks, and a flat heap keeps the P=4096 sweeps allocation-light.
"""

from __future__ import annotations

import heapq
from typing import Callable

import numpy as np

Callback = Callable[["EventLoop"], None]


class EventLoop:
    """Time-ordered executor: ``at``/``after`` schedule, ``run`` drains."""

    def __init__(self) -> None:
        self.now: float = 0.0
        self._heap: list[tuple[float, int, Callback]] = []
        self._seq = 0
        self._events_run = 0

    def at(self, time: float, fn: Callback) -> None:
        if time < self.now:
            raise ValueError(f"cannot schedule into the past: {time} < {self.now}")
        heapq.heappush(self._heap, (float(time), self._seq, fn))
        self._seq += 1

    def after(self, delay: float, fn: Callback) -> None:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        self.at(self.now + delay, fn)

    @property
    def events_run(self) -> int:
        return self._events_run

    def run(self, until: float | None = None) -> float:
        """Drain the heap (up to ``until``); returns the final clock."""
        while self._heap:
            if until is not None and self._heap[0][0] > until:
                break
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            self._events_run += 1
            fn(self)
        if until is not None:
            self.now = max(self.now, until)
        return self.now


class BatchedEventLoop(EventLoop):
    """``EventLoop`` + ``at_array``: an array of deadlines becomes one heap
    entry per UNIQUE timestamp instead of one per element — the batched
    event queue the vectorized cluster engine schedules detection sweeps
    on. Same clock, same insertion-order tie-breaking, so a batched
    timeline and a per-event timeline replay identically when their event
    times coincide."""

    def at_array(self, times, fn: Callable[["EventLoop", np.ndarray], None]
                 ) -> None:
        """Schedule ``fn(loop, idx)`` once per unique timestamp in
        ``times`` (ascending); ``idx`` holds the positions in ``times``
        that share the firing timestamp. Callbacks are expected to
        validate against current state — a batch scheduled for a deadline
        that a replan already resolved must no-op, not re-fire."""
        times = np.asarray(times, dtype=np.float64)
        if times.size == 0:
            return
        order = np.argsort(times, kind="stable")
        st = times[order]
        starts = np.flatnonzero(np.r_[True, st[1:] != st[:-1]])
        bounds = np.r_[starts, st.size]
        for a, b in zip(bounds[:-1], bounds[1:]):
            idx = order[a:b]
            self.at(float(st[a]),
                    (lambda group: lambda lp: fn(lp, group))(idx))
