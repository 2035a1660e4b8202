"""Cluster simulation: gs-SGD steps on a modeled network with real policies.

Port of ``repro/sim/cluster.py`` (NumPy, no torch): both engines drive the
port's own ``runtime`` (``HeartbeatMonitor``, ``ElasticPlan`` /
``replan``, ``DeadlinePolicy``), ``sim/replay.ExchangeReplay`` and
``sim/workers.ComputeModel``, and their ``SimResult.to_json()`` equals the
reference's for the same config and trace (tests/test_torch_sim.py). Every
time here is the model's simulated clock, never a device time.

``simulate`` runs a synchronous training timeline for ``steps`` iterations
at any P on the discrete-event loop. Per step:

  1. fault-trace events apply (``fail`` silences a worker's heartbeat and
     its compute; ``straggle`` stretches its compute; ``join`` hands a
     worker to ``elastic.replan(joined=...)``),
  2. per-worker compute durations are drawn from the ``ComputeModel``,
  3. the REAL ``runtime.straggler.DeadlinePolicy`` — fed with the
     *simulated* step durations — produces the drop mask; dropped workers
     join the collective immediately with a zeroed sketch (the
     ``include=`` semantics of ``GsSGD.stage_reduce``), so the barrier
     waits only for included workers,
  4. the exchange is priced by ``replay.ExchangeReplay`` on the live
     membership (real schedules, real bucket pipeline),
  5. every live worker beats the REAL ``runtime.heartbeat.HeartbeatMonitor``
     (clock = the simulated event-loop clock) at step end.

Failure detection is not scripted: a silenced worker blocks the barrier,
and the coordinator only learns of the death when the heartbeat has been
quiet for ``timeout`` on the simulated clock — the replan time is
``last_beat + timeout``, exactly the runtime layer's contract. The step
then re-executes on the survivors under the regenerated
``elastic.ElasticPlan`` (whose ``schedule`` property is the real
``allreduce.reduce_schedule``), with the detection wait recorded as stall.

Two engines produce the SAME timeline (pinned identical in
tests/test_torch_sim.py, as the reference's in
tests/test_sim_equivalence.py):

* ``engine='batched'`` (default) — vectorized membership/straggle/beat
  bookkeeping on a ``BatchedEventLoop`` (array-of-deadlines detection,
  ``HeartbeatMonitor.beat_many``), the P=100k path.
* ``engine='loop'``    — the per-worker python callback chain, kept as the
  readable compat/reference implementation and the benchmark baseline.

``participation`` samples a per-step cohort — partial
client participation, the federated churn workload — counter-based per
(seed, step) so replays and replans resample identically. Silenced
workers OUTSIDE the cohort are noticed by an age sweep at the next step
boundary (no barrier, no stall); inside the cohort they hang the barrier
exactly like the full-participation path.

Everything is deterministic given (config, trace): the event loop breaks
ties by insertion order and all sampling is counter-based per (seed, step,
worker).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.runtime.elastic import ElasticPlan, initial_plan, replan
from repro_torch.runtime.heartbeat import HeartbeatMonitor
from repro_torch.runtime.straggler import DeadlinePolicy
from repro_torch.sim.engine import BatchedEventLoop, EventLoop
from repro_torch.sim.network import NetworkModel, make_network
from repro_torch.sim.replay import ExchangeReplay
from repro_torch.sim.traces import FaultTrace
from repro_torch.sim.workers import ComputeModel

_EPS = 1e-9
_COHORT_TAG = 0x5EED     # stream tag separating cohort draws from compute
_EMPTY_IDS = np.empty(0, dtype=np.int64)


@dataclasses.dataclass
class SimConfig:
    p: int
    d: int = 1_000_000
    method: str = "gs-sgd"
    buckets: int = 1
    steps: int = 100
    k: int | None = None
    rows: int | str = 5
    width: int | None = None
    shape: str | None = None          # collective shape (None = per-method)
    wire_dtype_bytes: int = 4         # sketch wire bytes/elt (bf16 = 2)
    topology: str = "flat"            # 'flat' | 'hier' network
    link: str = "1gbe"
    intra_link: str = "ici"
    group_size: int = 8
    overlap: bool = True
    bwd_chunks: int = 1               # backward-interleaved readiness chunks
    fuse_encode: bool = False         # fragment-wise encode in the interleave
    bwd_frac: float = 2 / 3           # backward share of a step's compute
    compute: ComputeModel = dataclasses.field(default_factory=ComputeModel)
    heartbeat_timeout: float = 1.0    # seconds of silence before dead
    drop_stragglers: bool = True
    deadline_factor: float = 3.0
    max_drop_frac: float = 0.25
    participation: float | None = None  # per-step cohort fraction (None=all)
    rescale_lr: bool = True
    slow_workers: dict[int, float] = dataclasses.field(default_factory=dict)
    seed: int = 0


@dataclasses.dataclass
class StepRecord:
    step: int
    t_start: float
    p: int
    generation: int
    compute: float
    stall: float
    encode: float
    comm: float
    recover: float
    bytes_wire: float
    bytes_critical: float
    rounds: int
    dropped: tuple[int, ...] = ()
    sampled: int = 0                  # cohort size (= p without sampling)

    @property
    def total(self) -> float:
        return self.compute + self.stall + self.encode + self.comm + self.recover


@dataclasses.dataclass
class SimResult:
    config: SimConfig
    records: list[StepRecord]
    replans: list[dict]
    makespan: float
    events_run: int
    watch: list = dataclasses.field(default_factory=list)  # watchdog log

    def phase_totals(self) -> dict[str, float]:
        keys = ("compute", "stall", "encode", "comm", "recover")
        return {k: sum(getattr(r, k) for r in self.records) for k in keys}

    def totals(self) -> dict:
        ph = self.phase_totals()
        return {
            **ph,
            "makespan": self.makespan,
            "steps": len(self.records),
            "bytes_wire": sum(r.bytes_wire for r in self.records),
            "bytes_critical": sum(r.bytes_critical for r in self.records),
            "rounds": sum(r.rounds for r in self.records),
            "replans": len(self.replans),
            "steps_per_s": (len(self.records) / self.makespan
                            if self.makespan > 0 else float("inf")),
        }

    def to_json(self) -> dict:
        return {
            # asdict flattens the nested ComputeModel too — everything in
            # the config is JSON-serializable provenance
            "config": dataclasses.asdict(self.config),
            "totals": self.totals(),
            "replans": self.replans,
            "watch": list(self.watch),
            "steps": [dataclasses.asdict(r) for r in self.records],
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    def to_tracer(self):
        """Render the timeline as a ``repro_torch.obs`` Tracer emitting the
        SAME span schema as an instrumented train run — export with
        ``.save(path, source='sim')``."""
        from repro_torch.obs import trace as obtrace
        return obtrace.from_sim(self)


def sample_cohort(seed: int, step: int, members, fraction: float) -> np.ndarray:
    """The step's participation cohort: ``max(1, round(f·n))`` members.

    Counter-based — the Generator depends only on (seed, step), never on
    membership history — so a step that re-executes after a mid-step
    replan resamples deterministically from the new membership, and two
    runs with the same seed sample the same cohorts. Survivor ORDER is
    preserved (rank order is the collective replay's rank→id map), which
    is why positions are sorted, not ids.
    """
    arr = np.asarray(members, dtype=np.int64)
    n = int(arr.size)
    m = max(1, int(round(fraction * n)))
    if m >= n:
        return arr
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), int(step), _COHORT_TAG]))
    pos = np.sort(rng.choice(n, size=m, replace=False))
    return arr[pos]


def _aged_silenced(hb: HeartbeatMonitor, silenced: set, now: float,
                   timeout: float) -> set:
    """Silenced workers whose heartbeat age crossed the timeout — the
    between-steps sweep that notices non-cohort deaths under partial
    participation. Only silenced ids are tested: the sim models beats at
    step boundaries, so testing responsive members against the timeout
    would mislabel them whenever a step outlasts it."""
    if not silenced:
        return set()
    sil = sorted(silenced)
    last = hb.last_of(np.asarray(sil, dtype=np.int64))
    aged = (now - last) > timeout
    return {sil[i] for i in np.flatnonzero(aged).tolist()}


def simulate(cfg: SimConfig, trace: FaultTrace | None = None,
             net: NetworkModel | None = None, *,
             engine: str = "batched", watcher=None) -> SimResult:
    """``watcher``: a ``tune.watch.SimWatcher`` — fed every StepRecord at
    its (simulated) completion time; when it returns a new ``SimConfig``
    the exchange geometry/schedule is swapped at the next step boundary
    (membership, compute model, and step budget stay the run's own)."""
    trace = trace or FaultTrace()
    net = net or make_network(cfg.topology, link=cfg.link,
                              group_size=cfg.group_size,
                              intra=cfg.intra_link,
                              slow_workers=cfg.slow_workers)
    rep = ExchangeReplay(cfg.method, cfg.d, buckets=cfg.buckets, k=cfg.k,
                         rows=cfg.rows, width=cfg.width, shape=cfg.shape,
                         group_size=cfg.group_size,
                         wire_dtype_bytes=cfg.wire_dtype_bytes)
    compute = (cfg.compute if cfg.compute.seed is not None
               else dataclasses.replace(cfg.compute, seed=cfg.seed))
    if engine == "batched":
        return _simulate_batched(cfg, trace, net, rep, compute, watcher)
    if engine == "loop":
        return _simulate_loop(cfg, trace, net, rep, compute, watcher)
    raise ValueError(f"unknown engine {engine!r}; choose 'batched' or 'loop'")


# ---------------------------------------------------------------------------
# exchange state shared by both engines: the live replay + schedule knobs
# (swappable mid-run by the watchdog) and any active congestion stretch
# ---------------------------------------------------------------------------


def _exchange_state(cfg: SimConfig, rep: ExchangeReplay) -> dict:
    return {"rep": rep, "overlap": cfg.overlap, "bwd_chunks": cfg.bwd_chunks,
            "fuse": cfg.fuse_encode, "congest_f": 1.0, "congest_until": -1}


def _congested(stages, s: int, ex: dict):
    """Stretch the per-bucket comm times by any active congest event.

    Applied AFTER cache retrieval: the generation-keyed stage cache holds
    UNSCALED times (membership-pure), so cached entries stay valid across
    the congestion window's edges."""
    if ex["congest_f"] != 1.0 and s < ex["congest_until"]:
        return dataclasses.replace(
            stages,
            t_comm=tuple(t * ex["congest_f"] for t in stages.t_comm))
    return stages


def _apply_watch(ex: dict, cost_cache: dict, newcfg: SimConfig) -> None:
    """Swap in a re-planned exchange at a step boundary: new replay
    geometry + schedule knobs; the stage cache is invalidated (generation
    is unchanged but the geometry under it is not)."""
    ex["rep"] = ExchangeReplay(
        newcfg.method, newcfg.d, buckets=newcfg.buckets, k=newcfg.k,
        rows=newcfg.rows, width=newcfg.width, shape=newcfg.shape,
        group_size=newcfg.group_size,
        wire_dtype_bytes=newcfg.wire_dtype_bytes)
    ex["overlap"] = newcfg.overlap
    ex["bwd_chunks"] = newcfg.bwd_chunks
    ex["fuse"] = newcfg.fuse_encode
    cost_cache.clear()


# ---------------------------------------------------------------------------
# loop engine — the per-worker python callback chain (compat/reference)
# ---------------------------------------------------------------------------


def _simulate_loop(cfg: SimConfig, trace: FaultTrace, net: NetworkModel,
                   rep: ExchangeReplay, compute: ComputeModel,
                   watcher=None) -> SimResult:
    loop = EventLoop()
    hb = HeartbeatMonitor(range(cfg.p), clock=lambda: loop.now)
    policy = DeadlinePolicy(factor=cfg.deadline_factor,
                            max_drop_frac=cfg.max_drop_frac)

    ex = _exchange_state(cfg, rep)
    st: dict = {"plan": initial_plan(cfg.p), "step": 0, "silenced": set(),
                "straggle": {}, "pending_stall": 0.0, "applied": -1}
    cost_cache: dict[int, object] = {}     # keyed by plan.generation
    records: list[StepRecord] = []
    replans: list[dict] = []

    def do_replan(failed: set[int], joined: tuple[int, ...], step: int) -> None:
        plan: ElasticPlan = st["plan"]
        new = replan(plan, failed=failed, joined=joined,
                     rescale_lr=cfg.rescale_lr)
        for w in failed:
            hb.remove(w)
        for w in joined:
            hb.add(w)
        st["plan"] = new
        replans.append({"time": loop.now, "step": step,
                        "generation": new.generation, "p": new.n_workers,
                        "failed": sorted(failed), "joined": list(joined),
                        "lr_scale": new.lr_scale})

    def cluster_failed(failed: set[int], step: int, gen: int) -> None:
        # whole cluster dead: end the run gracefully with the records
        # computed so far instead of raising mid-event
        replans.append({"time": loop.now, "step": step,
                        "generation": gen + 1, "p": 0,
                        "failed": sorted(failed), "joined": [],
                        "lr_scale": 0.0, "cluster_failed": True})

    def run_step(loop: EventLoop) -> None:
        s = st["step"]
        if s >= cfg.steps:
            return
        plan: ElasticPlan = st["plan"]
        if st["applied"] < s:  # trace events apply once per step index
            st["applied"] = s
            evs = trace.at(s)
            # joins first, so a same-step fail of the joiner isn't lost
            joined = []
            for ev in evs:
                if ev.kind == "join" and ev.worker not in plan.survivor_ids:
                    st["silenced"].discard(ev.worker)
                    joined.append(ev.worker)
            if joined:
                do_replan(set(), tuple(joined), s)
                plan = st["plan"]
            for ev in evs:
                if ev.kind == "fail" and ev.worker in plan.survivor_ids:
                    st["silenced"].add(ev.worker)
                elif ev.kind == "straggle":
                    st["straggle"][ev.worker] = (ev.factor, s + ev.duration)
                elif ev.kind == "congest":
                    ex["congest_f"] = ev.factor
                    ex["congest_until"] = s + ev.duration

        members = plan.survivor_ids
        if cfg.participation is not None:
            # non-cohort silenced workers are noticed between steps, off
            # the barrier's critical path — replan without stall
            swept = _aged_silenced(hb, st["silenced"], loop.now,
                                   cfg.heartbeat_timeout)
            if swept:
                st["silenced"] -= swept
                if len(swept) >= plan.n_workers:
                    cluster_failed(swept, s, plan.generation)
                    return
                do_replan(swept, (), s)
                plan = st["plan"]
                members = plan.survivor_ids
            cohort = tuple(int(w) for w in sample_cohort(
                cfg.seed, s, members, cfg.participation))
        else:
            cohort = members

        silent = [w for w in cohort if w in st["silenced"]]
        if silent:
            # The barrier hangs on the dead worker(s); the coordinator
            # learns of the death only when the heartbeat goes quiet for
            # ``timeout`` on the simulated clock.
            t_start = loop.now

            def detect(loop: EventLoop) -> None:
                # responsive workers kept beating while blocked at the
                # barrier (beats ride the coordination channel, not step
                # completion) — only the silenced ones have gone quiet
                for w in members:
                    if w not in st["silenced"]:
                        hb.beat(w)
                failed = hb.dead(cfg.heartbeat_timeout) & set(members)
                if not failed:
                    raise RuntimeError(
                        f"detection event fired with no dead worker at "
                        f"t={loop.now:.9f} (step {s}, generation "
                        f"{plan.generation}, p={plan.n_workers}, "
                        f"silenced={sorted(st['silenced'])})")
                st["silenced"] -= failed
                if len(failed) >= plan.n_workers:
                    cluster_failed(failed, s, plan.generation)
                    return
                do_replan(failed, (), s)
                st["pending_stall"] += loop.now - t_start
                run_step(loop)

            # the earliest deadline: the blocked worker whose last beat is
            # oldest (== this step's start under full participation)
            t_fire = float(np.min(hb.last_of(
                np.asarray(silent, dtype=np.int64))))
            loop.at(t_fire + cfg.heartbeat_timeout + _EPS, detect)
            return

        # transient straggle factors: evict expired entries (a heavy-churn
        # trace at large P would otherwise grow the dict unboundedly)
        expired = [w for w, (f, until) in st["straggle"].items()
                   if s >= until]
        for w in expired:
            del st["straggle"][w]
        factors = {w: f for w, (f, until) in st["straggle"].items()}
        durs = compute.durations(s, cohort, factors)
        if cfg.drop_stragglers and len(cohort) > 1:
            include = policy.mask(durs)
        else:
            include = np.ones(len(durs), bool)
        policy.observe(durs)
        dropped = tuple(w for w, inc in zip(cohort, include) if not inc)
        barrier = float(np.max(durs[include]))
        t_compute = float(np.mean(durs[include]))
        # dropped stragglers join the collective at the deadline with a
        # zeroed sketch (include-mask semantics) — comm runs over all live.
        # The expensive schedule walk (stage_times) is pure in the
        # membership, which only changes at replans — cache it by plan
        # GENERATION (1:1 with membership, O(1) key vs the O(P) members
        # tuple hash) so steady-state steps stay O(buckets) even when
        # compute jitter varies the backward duration every step.
        # Readiness is clocked off the BARRIER (slowest included worker):
        # a bucket's all-reduce completes no earlier than the last
        # worker's emission.
        interleave = ex["bwd_chunks"] > 1 and ex["overlap"]
        t_bwd = barrier * cfg.bwd_frac if interleave else 0.0
        if cfg.participation is not None:
            stages = ex["rep"].stage_times(net, cohort)  # varies per step
        else:
            stages = cost_cache.get(plan.generation)
            if stages is None:
                stages = cost_cache[plan.generation] = \
                    ex["rep"].stage_times(net, members)
        pc = ex["rep"].step_cost(net, cohort, overlap=ex["overlap"],
                                 t_backward=t_bwd,
                                 bwd_chunks=ex["bwd_chunks"],
                                 fuse_encode=ex["fuse"],
                                 stages=_congested(stages, s, ex))
        records.append(StepRecord(
            step=s, t_start=loop.now, p=plan.n_workers,
            generation=plan.generation, compute=t_compute,
            stall=st["pending_stall"] + (barrier - t_compute),
            encode=pc.encode, comm=pc.comm, recover=pc.recover,
            bytes_wire=pc.bytes_wire, bytes_critical=pc.bytes_critical,
            rounds=pc.rounds, dropped=dropped, sampled=len(cohort)))
        st["pending_stall"] = 0.0
        step_wall = barrier + pc.encode + pc.comm + pc.recover
        if watcher is not None:
            newcfg = watcher.on_record(records[-1],
                                       now=loop.now + step_wall)
            if newcfg is not None:
                _apply_watch(ex, cost_cache, newcfg)

        def finish(loop: EventLoop) -> None:
            for w in st["plan"].survivor_ids:
                if w not in st["silenced"]:
                    hb.beat(w)
            st["step"] += 1
            run_step(loop)

        loop.after(step_wall, finish)

    loop.after(0.0, run_step)
    makespan = loop.run()
    return SimResult(config=cfg, records=records, replans=replans,
                     makespan=makespan, events_run=loop.events_run,
                     watch=list(watcher.log) if watcher is not None else [])


# ---------------------------------------------------------------------------
# batched engine — vectorized memberships on the batched event queue
# ---------------------------------------------------------------------------


def _simulate_batched(cfg: SimConfig, trace: FaultTrace, net: NetworkModel,
                      rep: ExchangeReplay, compute: ComputeModel,
                      watcher=None) -> SimResult:
    loop = BatchedEventLoop()
    hb = HeartbeatMonitor(range(cfg.p), clock=lambda: loop.now)
    policy = DeadlinePolicy(factor=cfg.deadline_factor,
                            max_drop_frac=cfg.max_drop_frac)

    ex = _exchange_state(cfg, rep)
    st: dict = {"plan": initial_plan(cfg.p), "step": 0, "silenced": set(),
                "straggle": {}, "pending_stall": 0.0, "applied": -1,
                # per-generation membership caches: survivor-ORDER array
                # (rank→id map for the collective replay — NOT sorted) and
                # an O(1) membership set
                "members": np.arange(cfg.p, dtype=np.int64),
                "member_set": set(range(cfg.p)),
                # barrier epoch: invalidates coalesced detection deadlines
                # that a replan already resolved
                "epoch": 0}
    cost_cache: dict[int, object] = {}     # keyed by plan.generation
    records: list[StepRecord] = []
    replans: list[dict] = []

    def silenced_arr() -> np.ndarray:
        return np.fromiter(st["silenced"], dtype=np.int64,
                           count=len(st["silenced"]))

    def live_members() -> np.ndarray:
        m = st["members"]
        if not st["silenced"]:
            return m
        return m[~np.isin(m, silenced_arr())]

    def do_replan(failed: set[int], joined: tuple[int, ...], step: int) -> None:
        plan: ElasticPlan = st["plan"]
        new = replan(plan, failed=failed, joined=joined,
                     rescale_lr=cfg.rescale_lr)
        for w in failed:
            hb.remove(w)
        for w in joined:
            hb.add(w)
        st["plan"] = new
        st["members"] = np.asarray(new.survivor_ids, dtype=np.int64)
        st["member_set"] = set(new.survivor_ids)
        replans.append({"time": loop.now, "step": step,
                        "generation": new.generation, "p": new.n_workers,
                        "failed": sorted(failed), "joined": list(joined),
                        "lr_scale": new.lr_scale})

    def cluster_failed(failed: set[int], step: int, gen: int) -> None:
        replans.append({"time": loop.now, "step": step,
                        "generation": gen + 1, "p": 0,
                        "failed": sorted(failed), "joined": [],
                        "lr_scale": 0.0, "cluster_failed": True})

    def run_step(lp: EventLoop) -> None:
        s = st["step"]
        if s >= cfg.steps:
            return
        plan: ElasticPlan = st["plan"]
        if st["applied"] < s:  # trace events apply once per step index
            st["applied"] = s
            evs = trace.at(s)
            joined = []
            for ev in evs:
                if ev.kind == "join" and ev.worker not in st["member_set"]:
                    st["silenced"].discard(ev.worker)
                    joined.append(ev.worker)
            if joined:
                do_replan(set(), tuple(joined), s)
                plan = st["plan"]
            for ev in evs:
                if ev.kind == "fail" and ev.worker in st["member_set"]:
                    st["silenced"].add(ev.worker)
                elif ev.kind == "straggle":
                    st["straggle"][ev.worker] = (ev.factor, s + ev.duration)
                elif ev.kind == "congest":
                    ex["congest_f"] = ev.factor
                    ex["congest_until"] = s + ev.duration

        members = st["members"]
        if cfg.participation is not None:
            swept = _aged_silenced(hb, st["silenced"], lp.now,
                                   cfg.heartbeat_timeout)
            if swept:
                st["silenced"] -= swept
                if len(swept) >= plan.n_workers:
                    cluster_failed(swept, s, plan.generation)
                    return
                do_replan(swept, (), s)
                plan = st["plan"]
                members = st["members"]
            cohort = sample_cohort(cfg.seed, s, members, cfg.participation)
        else:
            cohort = members

        blocked = (cohort[np.isin(cohort, silenced_arr())]
                   if st["silenced"] else _EMPTY_IDS)
        if blocked.size:
            t_start = lp.now
            st["epoch"] += 1
            epoch = st["epoch"]

            def detect(lp: EventLoop, _group: np.ndarray) -> None:
                if st["epoch"] != epoch:
                    return      # a replan already resolved this barrier
                st["epoch"] += 1
                # responsive members kept beating while blocked at the
                # barrier — one vectorized beat for the whole membership
                hb.beat_many(live_members())
                failed = hb.dead(cfg.heartbeat_timeout) & st["member_set"]
                if not failed:
                    raise RuntimeError(
                        f"detection event fired with no dead worker at "
                        f"t={lp.now:.9f} (step {s}, generation "
                        f"{st['plan'].generation}, p={st['plan'].n_workers}, "
                        f"silenced={sorted(st['silenced'])})")
                st["silenced"] -= failed
                if len(failed) >= st["plan"].n_workers:
                    cluster_failed(failed, s, st["plan"].generation)
                    return
                do_replan(failed, (), s)
                st["pending_stall"] += lp.now - t_start
                run_step(lp)

            # array-of-deadlines: one coalesced event per unique last-beat
            # (under full participation every blocked worker last beat at
            # this step's start, so this is a single event)
            lp.at_array(hb.last_of(blocked) + cfg.heartbeat_timeout + _EPS,
                        detect)
            return

        sf = None
        if st["straggle"]:
            expired = [w for w, (f, until) in st["straggle"].items()
                       if s >= until]
            for w in expired:
                del st["straggle"][w]
            if st["straggle"]:
                sf = np.ones(cohort.size, dtype=np.float64)
                for w, (f, until) in st["straggle"].items():
                    sf[cohort == w] = f
        durs = compute.durations(s, cohort, sf)
        if cfg.drop_stragglers and cohort.size > 1:
            include = policy.mask(durs)
        else:
            include = np.ones(durs.size, bool)
        policy.observe(durs)
        dropped = (() if include.all()
                   else tuple(int(w) for w in cohort[~include]))
        barrier = float(np.max(durs[include]))
        t_compute = float(np.mean(durs[include]))
        interleave = ex["bwd_chunks"] > 1 and ex["overlap"]
        t_bwd = barrier * cfg.bwd_frac if interleave else 0.0
        if cfg.participation is not None:
            stages = ex["rep"].stage_times(net, cohort)  # varies per step
        else:
            stages = cost_cache.get(plan.generation)
            if stages is None:
                stages = cost_cache[plan.generation] = \
                    ex["rep"].stage_times(net, members)
        pc = ex["rep"].step_cost(net, cohort, overlap=ex["overlap"],
                                 t_backward=t_bwd,
                                 bwd_chunks=ex["bwd_chunks"],
                                 fuse_encode=ex["fuse"],
                                 stages=_congested(stages, s, ex))
        records.append(StepRecord(
            step=s, t_start=lp.now, p=plan.n_workers,
            generation=plan.generation, compute=t_compute,
            stall=st["pending_stall"] + (barrier - t_compute),
            encode=pc.encode, comm=pc.comm, recover=pc.recover,
            bytes_wire=pc.bytes_wire, bytes_critical=pc.bytes_critical,
            rounds=pc.rounds, dropped=dropped, sampled=int(cohort.size)))
        st["pending_stall"] = 0.0
        step_wall = barrier + pc.encode + pc.comm + pc.recover
        if watcher is not None:
            newcfg = watcher.on_record(records[-1], now=lp.now + step_wall)
            if newcfg is not None:
                _apply_watch(ex, cost_cache, newcfg)

        def finish(lp: EventLoop) -> None:
            hb.beat_many(live_members())
            st["step"] += 1
            run_step(lp)

        loop.after(step_wall, finish)

    loop.after(0.0, run_step)
    makespan = loop.run()
    return SimResult(config=cfg, records=records, replans=replans,
                     makespan=makespan, events_run=loop.events_run,
                     watch=list(watcher.log) if watcher is not None else [])
