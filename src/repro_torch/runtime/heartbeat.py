"""Heartbeat-based failure detection (host-side, framework-agnostic).

Port of ``repro/runtime/heartbeat.py`` (pure Python and NumPy; the same
code, over the port's ``obs.trace``).

Each worker process calls ``beat(worker_id)`` on a cadence (e.g. every
step); the coordinator calls ``dead(timeout)`` between steps and feeds the
result to ``runtime.elastic.replan``. Pure-python & clock-injectable so the
tests can simulate failures without real processes; on a real cluster the
beats would ride the existing coordination channel (e.g. the
``torch.distributed`` store).

Storage is structure-of-arrays: a dense NumPy last-beat vector plus an
id→slot map (swap-with-last compaction on ``remove``), so the cluster
simulator's whole-membership ``beat_many`` and the per-sweep ``dead`` scan
are single vectorized ops at P=100k instead of per-worker dict walks. The
scalar ``beat``/``add``/``remove`` API is unchanged.

Detections are observable: the first ``dead()`` call that sees a worker
cross the timeout emits a ``heartbeat.dead`` instant (worker id, silence
duration, detection latency past the deadline) through the ambient
``repro_torch.obs`` tracer — a no-op when no tracer is active.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from repro_torch.obs import trace as obtrace


class HeartbeatMonitor:
    def __init__(self, worker_ids, *, clock: Callable[[], float] = time.time):
        self._clock = clock
        ids = list(dict.fromkeys(worker_ids))   # unique, insertion order
        n = len(ids)
        cap = max(8, n)
        self._ids: list = ids + [None] * (cap - n)
        self._n = n
        self._last = np.full(cap, clock(), dtype=np.float64)
        self._slot: dict = {w: i for i, w in enumerate(ids)}
        self._reported: set = set()
        # dense id→slot lookup for the vectorized fast path; only valid
        # while every id is a non-negative integer
        self._int_ok = all(
            isinstance(w, (int, np.integer)) and w >= 0 for w in ids)
        self._pos: np.ndarray | None = None

    # -- scalar API (unchanged contract) ------------------------------------

    def beat(self, worker_id) -> None:
        i = self._slot.get(worker_id)
        if i is None:
            self._insert(worker_id)             # upsert, like the dict form
        else:
            self._last[i] = self._clock()
        self._reported.discard(worker_id)

    def dead(self, timeout: float) -> set:
        now = self._clock()
        last = self._last[:self._n]
        idx = np.flatnonzero((now - last) > timeout)
        out = {self._ids[i] for i in idx.tolist()}
        fresh = out - self._reported
        if fresh:
            tr = obtrace.current()
            for w in sorted(fresh, key=repr):
                silence = float(now - self._last[self._slot[w]])
                tr.instant("heartbeat.dead", cat="runtime",
                           args={"worker": w, "silence": silence,
                                 "detection_latency": silence - timeout})
            self._reported |= fresh
        return out

    def remove(self, worker_id) -> None:
        i = self._slot.pop(worker_id, None)
        self._reported.discard(worker_id)
        if i is None:
            return
        tail = self._n - 1
        if i != tail:                            # swap-with-last compaction
            moved = self._ids[tail]
            self._ids[i] = moved
            self._last[i] = self._last[tail]
            self._slot[moved] = i
        self._ids[tail] = None
        self._n = tail
        self._pos = None

    def add(self, worker_id) -> None:
        if worker_id in self._slot:
            self._last[self._slot[worker_id]] = self._clock()
        else:
            self._insert(worker_id)
        self._reported.discard(worker_id)

    # -- vectorized API ------------------------------------------------------

    def beat_many(self, worker_ids) -> None:
        """One clock read + one fancy-indexed store for a whole membership.
        Unlike scalar ``beat``, every id must already be monitored."""
        ws = np.asarray(worker_ids)
        if ws.size == 0:
            return
        self._last[self._lookup(ws)] = self._clock()
        if self._reported:
            self._reported.difference_update(ws.tolist())

    def last_of(self, worker_ids) -> np.ndarray:
        """Last-beat times for monitored ids (the sim's deadline vector)."""
        ws = np.asarray(worker_ids)
        if ws.size == 0:
            return np.empty(0, dtype=np.float64)
        return self._last[self._lookup(ws)]

    # -- internals -----------------------------------------------------------

    def _insert(self, worker_id) -> None:
        if self._n == len(self._ids):
            grow = len(self._ids)
            self._ids.extend([None] * grow)
            self._last = np.concatenate(
                [self._last, np.empty(grow, dtype=np.float64)])
        i = self._n
        self._ids[i] = worker_id
        self._last[i] = self._clock()
        self._slot[worker_id] = i
        self._n = i + 1
        self._pos = None
        if self._int_ok and not (isinstance(worker_id, (int, np.integer))
                                 and worker_id >= 0):
            self._int_ok = False

    def _lookup(self, ws: np.ndarray) -> np.ndarray:
        if self._int_ok and ws.dtype.kind in "iu":
            if self._pos is None:
                hi = 1 + max((int(w) for w in self._slot), default=-1)
                pos = np.full(hi, -1, dtype=np.int64)
                for w, i in self._slot.items():
                    pos[int(w)] = i
                self._pos = pos
            if ws.size and int(ws.max()) < self._pos.size:
                out = self._pos[ws]
                if not np.any(out < 0):
                    return out
            bad = [int(w) for w in ws.tolist() if w not in self._slot]
            raise KeyError(f"unmonitored worker id(s): {bad[:5]}")
        try:
            return np.array([self._slot[w] for w in ws.tolist()],
                            dtype=np.int64)
        except KeyError as e:
            raise KeyError(f"unmonitored worker id: {e.args[0]!r}") from None
