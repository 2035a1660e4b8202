"""Pluggable network models + collective cost replay on REAL schedules.

Port of ``repro/sim/network.py`` (numpy; the tree walks the port's
``core/allreduce.reduce_schedule_arrays``, the schedule its
``tree_allreduce`` runs).

A ``NetworkModel`` prices a point-to-point transfer with the paper's Eq. 1
alpha-beta model per link: ``t = alpha + nbytes * beta``. Three shapes:

* ``Homogeneous``     — one (alpha, beta) for every pair (the paper's 1 GbE
                        testbed; presets below).
* ``Hierarchical``    — two-level clusters: fast intra-group links (ICI /
                        NVLink-ish), slow inter-group links (DCN / 1 GbE).
* ``Heterogeneous``   — per-worker degradation factors on top of any base
                        model (a "slow NIC" worker stretches every link it
                        touches — the straggler regime DeadlinePolicy
                        targets).

Collective replay is the core invariant of the simulator (DESIGN.md §6):
the tree costs are computed by walking the *same* ``(src, dst)`` pair
lists that ``core/allreduce.tree_allreduce`` executes as ppermutes —
``reduce_schedule(p)`` forward for the reduce wave, reversed/transposed
for the broadcast wave — so the simulated round structure (including the
non-power-of-two parking rule) cannot drift from the train path. Ring and
parameter-server shapes replay the byte/round models the analytical
``CommStats`` in ``core/compression.py`` use, so simulator and closed-form
benchmarks agree exactly where they overlap.

Every collective returns a list of ``RoundCost``:

    duration       — critical-path time of the round (slowest pair)
    bytes_wire     — total bytes injected into the fabric by all senders
    bytes_critical — the per-worker Eq. 1 payload term (what CommStats
                     calls ``bytes_out``; the quantity the O(log d log P)
                     claim is about)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import allreduce as ar


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Eq. 1 alpha-beta link: startup latency (s) + inverse bandwidth (s/B)."""

    alpha: float
    beta: float

    def time(self, nbytes: float) -> float:
        return self.alpha + nbytes * self.beta


# The paper's testbed regimes (shared constants with time_breakdown.py).
LINK_1GBE = LinkSpec(alpha=5e-4, beta=8e-9)
LINK_10GBE = LinkSpec(alpha=2e-4, beta=8e-10)
LINK_ICI = LinkSpec(alpha=1e-6, beta=1e-11)

PRESETS = {"1gbe": LINK_1GBE, "10gbe": LINK_10GBE, "ici": LINK_ICI}


class NetworkModel:
    """Base: price a transfer between two worker ids.

    Subclasses override the vectorized ``pair_specs`` (per-pair alpha/beta
    arrays) so whole collective rounds are priced with array ops; the base
    class falls back to the per-pair ``link`` loop — the seed-fidelity
    path ``benchmarks/sim_scale.py`` uses as its baseline cost model.
    """

    def link(self, src: int, dst: int) -> LinkSpec:
        raise NotImplementedError

    def transfer(self, src: int, dst: int, nbytes: float) -> float:
        return self.link(src, dst).time(nbytes)

    def pair_specs(self, src: np.ndarray, dst: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """(alpha, beta) arrays for the pairwise links src[i] -> dst[i]."""
        alphas = np.empty(len(src), dtype=np.float64)
        betas = np.empty(len(src), dtype=np.float64)
        for i, (s, d) in enumerate(zip(src, dst)):
            ln = self.link(s, d)
            alphas[i] = ln.alpha
            betas[i] = ln.beta
        return alphas, betas

    def pair_times(self, src: np.ndarray, dst: np.ndarray,
                   nbytes: float) -> np.ndarray:
        """Eq. 1 times of the pairwise transfers src[i] -> dst[i] — the
        same per-element ``alpha + nbytes * beta`` as ``LinkSpec.time``."""
        a, b = self.pair_specs(src, dst)
        return a + nbytes * b

    def pair_times_max(self, src: np.ndarray, dst: np.ndarray,
                       nbytes: float) -> float:
        """Slowest pairwise transfer (a concurrent round's duration).
        Subclasses with few link classes answer in O(1)."""
        if len(src) == 0:
            return 0.0
        return float(np.max(self.pair_times(src, dst, nbytes)))

    def worst_link(self, ids: Sequence[int], nbytes: float = 0.0) -> LinkSpec:
        """Slowest link among the given workers for an ``nbytes`` payload
        (alpha-bound when 0). O(n^2) generic fallback; subclasses override
        with O(1)/O(n) answers — this sits inside the per-step replay loop
        at P=100k."""
        worst = LinkSpec(0.0, 0.0)
        for s in ids:
            for d in ids:
                if s == d:
                    continue
                ln = self.link(s, d)
                if ln.time(nbytes) > worst.time(nbytes):
                    worst = ln
        return worst


@dataclasses.dataclass(frozen=True)
class Homogeneous(NetworkModel):
    spec: LinkSpec = LINK_1GBE

    def link(self, src: int, dst: int) -> LinkSpec:
        return self.spec

    def pair_specs(self, src: np.ndarray, dst: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        n = len(src)
        return (np.full(n, self.spec.alpha), np.full(n, self.spec.beta))

    def pair_times_max(self, src: np.ndarray, dst: np.ndarray,
                       nbytes: float) -> float:
        # every pair rides the same link — O(1) regardless of round width
        return self.spec.time(nbytes) if len(src) else 0.0

    def worst_link(self, ids: Sequence[int], nbytes: float = 0.0) -> LinkSpec:
        return self.spec


@dataclasses.dataclass(frozen=True)
class Hierarchical(NetworkModel):
    """Two-level: workers in groups of ``group_size``; crossing is slow."""

    group_size: int = 8
    intra: LinkSpec = LINK_ICI
    inter: LinkSpec = LINK_1GBE

    def link(self, src: int, dst: int) -> LinkSpec:
        if src // self.group_size == dst // self.group_size:
            return self.intra
        return self.inter

    def pair_specs(self, src: np.ndarray, dst: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        same = (np.asarray(src) // self.group_size
                == np.asarray(dst) // self.group_size)
        return (np.where(same, self.intra.alpha, self.inter.alpha),
                np.where(same, self.intra.beta, self.inter.beta))

    def pair_times_max(self, src: np.ndarray, dst: np.ndarray,
                       nbytes: float) -> float:
        if len(src) == 0:
            return 0.0
        same = (np.asarray(src) // self.group_size
                == np.asarray(dst) // self.group_size)
        # max over the (at most two) link classes present in the round —
        # identical to the per-pair max since pairs within a class tie
        times = []
        if bool(same.any()):
            times.append(self.intra.time(nbytes))
        if not bool(same.all()):
            times.append(self.inter.time(nbytes))
        return max(times)

    def worst_link(self, ids: Sequence[int], nbytes: float = 0.0) -> LinkSpec:
        ids = np.asarray(ids)
        groups = ids // self.group_size
        multi = ids.size > 0 and bool(np.any(groups != groups.flat[0]))
        return self.inter if multi else self.intra


@dataclasses.dataclass(frozen=True)
class Heterogeneous(NetworkModel):
    """Per-worker multiplicative slowdowns over a base model.

    ``factors[w]`` > 1 stretches alpha and beta of every link touching w
    (both directions take the worst endpoint's factor).
    """

    base: NetworkModel
    factors: dict[int, float] = dataclasses.field(default_factory=dict)

    def link(self, src: int, dst: int) -> LinkSpec:
        f = max(self.factors.get(src, 1.0), self.factors.get(dst, 1.0))
        ln = self.base.link(src, dst)
        return LinkSpec(ln.alpha * f, ln.beta * f) if f != 1.0 else ln

    def _factors_of(self, ids: np.ndarray) -> np.ndarray:
        # factor maps are sparse (a handful of slow workers): one
        # vectorized mask assignment per entry beats a per-id dict walk
        out = np.ones(len(ids), dtype=np.float64)
        for w, f in self.factors.items():
            out[np.asarray(ids) == w] = f
        return out

    def pair_specs(self, src: np.ndarray, dst: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        f = np.maximum(self._factors_of(src), self._factors_of(dst))
        a, b = self.base.pair_specs(src, dst)
        # stretch alpha and beta separately — (a*f) + n*(b*f) is what
        # ``link().time()`` computes; (a + n*b)*f rounds differently
        return a * f, b * f

    def worst_link(self, ids: Sequence[int], nbytes: float = 0.0) -> LinkSpec:
        # upper bound: worst base link stretched by the worst factor present
        ids = np.asarray(ids)
        f = float(np.max(self._factors_of(ids))) if ids.size else 1.0
        ln = self.base.worst_link(ids, nbytes)
        return LinkSpec(ln.alpha * f, ln.beta * f)


def make_network(topology: str, *, link: str | LinkSpec = "1gbe",
                 group_size: int = 8, intra: str | LinkSpec = "ici",
                 slow_workers: dict[int, float] | None = None) -> NetworkModel:
    """Factory for the CLI: topology in {'flat', 'hier'} + slow-worker map."""
    spec = PRESETS[link] if isinstance(link, str) else link
    ispec = PRESETS[intra] if isinstance(intra, str) else intra
    net: NetworkModel
    if topology == "hier":
        net = Hierarchical(group_size=group_size, intra=ispec, inter=spec)
    elif topology == "flat":
        net = Homogeneous(spec)
    else:
        raise ValueError(f"unknown topology {topology!r}")
    if slow_workers:
        net = Heterogeneous(net, dict(slow_workers))
    return net


# ---------------------------------------------------------------------------
# Collective cost replay
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundCost:
    duration: float
    bytes_wire: float
    bytes_critical: float


def total(rounds: Sequence[RoundCost]) -> tuple[float, float, float]:
    """(duration, bytes_wire, bytes_critical) summed over the rounds."""
    return (sum(r.duration for r in rounds),
            sum(r.bytes_wire for r in rounds),
            sum(r.bytes_critical for r in rounds))


def pairwise_rounds(net: NetworkModel, ids: Sequence[int],
                    rounds_pairs: Sequence[Sequence[tuple[int, int]]],
                    nbytes: float) -> list[RoundCost]:
    """Replay rank-level (src, dst) rounds over the worker-id map ``ids``.

    Pairs within a round run concurrently (the ppermute semantics); the
    round's duration is its slowest pair on this network.
    """
    out = []
    for pairs in rounds_pairs:
        if not pairs:
            continue
        dur = max(net.transfer(ids[s], ids[d], nbytes) for s, d in pairs)
        out.append(RoundCost(dur, nbytes * len(pairs), nbytes))
    return out


def tree_allreduce_cost(net: NetworkModel, ids: Sequence[int],
                        nbytes: float) -> list[RoundCost]:
    """Paper Alg. 1 all-reduce: the REAL ``reduce_schedule`` + its mirror.

    Round count is ``len(sched) * 2`` = ``ar.tree_allreduce_rounds(p)`` =
    2⌈log2 p⌉ for any p (parking included) — asserted in tests/test_sim.py.
    Walks ``reduce_schedule_arrays`` (pinned identical to the pair-list
    form) so each round prices as one vectorized ``pair_times_max``.
    """
    p = len(ids)
    if p <= 1:
        return []
    ids_arr = np.asarray(ids, dtype=np.int64)
    sched = ar.reduce_schedule_arrays(p)
    out = []
    for src, dst in sched:                       # reduce wave
        out.append(RoundCost(net.pair_times_max(ids_arr[src], ids_arr[dst],
                                                nbytes),
                             nbytes * int(src.size), nbytes))
    for src, dst in reversed(sched):             # broadcast: transposed
        out.append(RoundCost(net.pair_times_max(ids_arr[dst], ids_arr[src],
                                                nbytes),
                             nbytes * int(src.size), nbytes))
    return out


def ring_allreduce_cost(net: NetworkModel, ids: Sequence[int],
                        nbytes: float) -> list[RoundCost]:
    """Bandwidth-optimal ring: 2(P-1) rounds of an nbytes/P chunk to the
    next rank — per-worker critical bytes 2(P-1)/P · nbytes, matching
    ``compression._ring_allreduce_bytes`` exactly."""
    p = len(ids)
    if p <= 1:
        return []
    chunk = nbytes / p
    ids_arr = np.asarray(ids, dtype=np.int64)
    # every round walks the same ring: one vectorized max over neighbors
    dur = net.pair_times_max(ids_arr, np.roll(ids_arr, -1), chunk)
    return [RoundCost(dur, chunk * p, chunk)] * (2 * (p - 1))


def ps_gather_cost(net: NetworkModel, ids: Sequence[int], nbytes: float,
                   server_rank: int = 0) -> list[RoundCost]:
    """Parameter-server inbox: every worker's payload lands on ONE node.

    The server NIC serializes the P-1 inbound transfers — one round each,
    which is exactly the O(P) rounds/bytes hotspot ``SketchedSGD``'s
    CommStats charges (rounds = P) and the paper's Sec. III-B contrasts
    with the tree."""
    ids_arr = np.asarray(ids, dtype=np.int64)
    srv = ids_arr[server_rank]
    others = ids_arr[ids_arr != srv]
    times = net.pair_times(others, np.full(others.size, srv), nbytes)
    return [RoundCost(float(t), nbytes, nbytes) for t in times]


def hierarchical_allreduce_cost(net: NetworkModel, ids: Sequence[int],
                                nbytes: float,
                                group_size: int) -> list[RoundCost]:
    """Two-level composite: per-group Alg. 1 reduce (groups concurrent),
    Alg. 1 all-reduce over group leaders, per-group broadcast back.

    Concurrent same-depth group rounds merge into one ``RoundCost`` (max
    duration / summed fabric bytes / max critical bytes). All full groups
    share one ``reduce_schedule_arrays(group_size)``, so a whole wave
    round is a single vectorized ``pair_times`` over an (n_groups, q)
    id matrix instead of a python walk per group.
    """
    p = len(ids)
    if p <= 1:
        return []
    ids_arr = np.asarray(ids, dtype=np.int64)
    gs = int(group_size)
    n_full, rem = p // gs, p % gs
    full = ids_arr[:n_full * gs].reshape(n_full, gs)
    rem_ids = ids_arr[n_full * gs:]
    leaders = ids_arr[::gs]
    sched_full = ar.reduce_schedule_arrays(gs) if n_full else ()
    sched_rem = ar.reduce_schedule_arrays(rem) if rem > 1 else ()
    depth = max(len(sched_full) if n_full else 0, len(sched_rem))

    def wave(forward: bool) -> list[RoundCost]:
        # broadcast rounds are each group's reversed/transposed schedule;
        # shorter (remainder-group) waves align at the FRONT of the merged
        # wave, exactly like the per-group list merge they replace
        out = []
        for i in range(depth):
            durs = []
            wire = 0.0
            crit = 0.0
            if n_full and i < len(sched_full):
                s, d = (sched_full[i] if forward
                        else sched_full[len(sched_full) - 1 - i])
                src, dst = (s, d) if forward else (d, s)
                t = net.pair_times(full[:, src].ravel(),
                                   full[:, dst].ravel(), nbytes)
                durs.append(float(np.max(t)))
                wire += nbytes * int(src.size) * n_full
                crit = nbytes
            if i < len(sched_rem):
                s, d = (sched_rem[i] if forward
                        else sched_rem[len(sched_rem) - 1 - i])
                src, dst = (s, d) if forward else (d, s)
                durs.append(net.pair_times_max(rem_ids[src], rem_ids[dst],
                                               nbytes))
                wire += nbytes * int(src.size)
                crit = nbytes
            out.append(RoundCost(max(durs), wire, crit))
        return out

    return (wave(forward=True)
            + tree_allreduce_cost(net, leaders, nbytes)
            + wave(forward=False))


def allreduce_cost(net: NetworkModel, ids: Sequence[int], nbytes: float, *,
                   shape: str = "tree", group_size: int = 8,
                   server_rank: int = 0) -> list[RoundCost]:
    """Dispatch: shape in {'tree', 'ring', 'hier', 'ps'}."""
    if shape == "tree":
        return tree_allreduce_cost(net, ids, nbytes)
    if shape == "ring":
        return ring_allreduce_cost(net, ids, nbytes)
    if shape == "hier":
        return hierarchical_allreduce_cost(net, ids, nbytes, group_size)
    if shape == "ps":
        return ps_gather_cost(net, ids, nbytes, server_rank)
    raise ValueError(f"unknown collective shape {shape!r}")
