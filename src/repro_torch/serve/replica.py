"""Multi-replica serving with heartbeat-driven failover.

Port of ``repro/serve/replica.py`` over the port's ``runtime``.

A ``ReplicaSet`` fronts N independent ``ServeEngine`` replicas (same
weights, separate caches). New requests route round-robin over the live
membership; each ``step_round`` steps every live replica once and beats
its heartbeat. A replica that stops beating (``kill`` in tests; a hung
process in life) is detected by ``runtime.heartbeat.HeartbeatMonitor``,
removed from the membership via ``runtime.elastic.replan`` (same
generation-bumped plan the trainer uses), and its in-flight + queued
requests re-route to survivors — each replays from prompt + the tokens
it already emitted, so under greedy decode the client-visible sequence
is identical to an uninterrupted run.
A replayed request past its deadline is dropped loudly instead.

The monitor runs on the replica set's own round clock (one tick per
``step_round``), so failover tests are deterministic — no wall-clock
sleeps.
"""

from __future__ import annotations

import sys

from repro_torch.runtime import elastic
from repro_torch.runtime.heartbeat import HeartbeatMonitor
from repro_torch.serve.scheduler import Completion, Request, ServeEngine


class ReplicaSet:
    def __init__(self, engines: list[ServeEngine], *,
                 heartbeat_timeout: float = 2.0):
        if not engines:
            raise ValueError("need at least one replica")
        self.engines = dict(enumerate(engines))
        self.plan = elastic.initial_plan(len(engines))
        self.timeout = heartbeat_timeout
        self.round = 0
        self._killed: set[int] = set()
        self._rr = 0
        self.monitor = HeartbeatMonitor(
            list(self.engines), clock=lambda: float(self.round))
        # completions owned by no live engine: work finished on a now-dead
        # replica, plus failover deadline drops
        self._retired: dict[int, Completion] = {}

    # -- routing -----------------------------------------------------------

    def live(self) -> list[int]:
        return [r for r in self.plan.survivor_ids if r not in self._killed]

    def submit(self, req: Request) -> None:
        ids = self.live()
        rep = ids[self._rr % len(ids)]
        self._rr += 1
        self.engines[rep].submit(req)

    # -- failure injection / detection --------------------------------------

    def kill(self, rep: int) -> None:
        """Stop a replica's heartbeat (the test's failure injection)."""
        self._killed.add(rep)

    def _failover(self, dead: set[int]) -> None:
        self.plan = elastic.replan(self.plan, dead)
        for rep in sorted(dead):
            self.monitor.remove(rep)
            eng = self.engines.pop(rep)
            strays = eng.in_flight() + list(eng.queue)
            print(f"[serve] replica {rep} dead at round {self.round}: "
                  f"re-routing {len(strays)} request(s)", file=sys.stderr)
            for req in strays:
                if req.deadline is not None and \
                        min(e.now for e in self.engines.values()) \
                        > req.deadline:
                    print(f"[serve] DROP rid={req.rid} (deadline, "
                          f"failover)", file=sys.stderr)
                    self._retired[req.rid] = Completion(
                        rid=req.rid, tokens=list(req.prior),
                        finish="dropped", t_arrival=req.arrival,
                        t_first=None, t_done=float(self.round),
                        replays=req.replays, reason="deadline")
                    continue
                self.submit(req)
            # work that finished on the dead replica already streamed out
            self._retired.update(eng.completions)

    # -- driving -----------------------------------------------------------

    def step_round(self) -> None:
        """Step every live replica once, beat, then sweep for deaths."""
        self.round += 1
        for rep in self.live():
            self.engines[rep].step()
            self.monitor.beat(rep)
        dead = {r for r in self.monitor.dead(self.timeout)
                if r in self.engines}
        if dead:
            self._failover(dead)

    def pending(self) -> bool:
        return any(self.engines[r].pending() for r in self.live())

    def run(self, max_rounds: int = 100_000) -> list[Completion]:
        for _ in range(max_rounds):
            if not self.pending():
                break
            self.step_round()
        else:  # pragma: no cover
            raise RuntimeError(f"replica set did not drain in "
                               f"{max_rounds} rounds")
        out: dict[int, Completion] = dict(self._retired)
        for rep in self.live():
            for c in self.engines[rep].completions.values():
                out[c.rid] = c
        return sorted(out.values(), key=lambda c: c.rid)
