"""Continuous-batching scheduler: admit/evict requests mid-generation.

Port of ``repro/serve/scheduler.py``. The prefill and decode functions
are plain partials of ``models.model.prefill_fn`` / ``decode_fn``
(eager PyTorch; nothing is compiled), run on the device the params lie
on; the engine's caches are built there too. Each decode step reads its
tokens back to the host (one sync), as the reference's ``np.asarray``.

The engine owns a fixed set of batch *slots* (``ServeSpec.batch``). Each
``step()`` (1) admits arrived requests into free slots — one B=1 prefill
per admission, written into the slot's cache pages — and (2) runs ONE
batched decode position across every active slot, so new prompts prefill
while co-resident requests keep decoding (continuous batching). The
``static`` policy is the baseline foil: gang admission only when ALL
slots are free, freed slots stay idle until the whole batch drains.

Two clocks:

* **virtual** (``self.now``, seconds) — advanced by the ``predict_admission``
  cost hook (ClusterSpec compute + link params, the ``tune/cost.py``
  pricing pattern). Poisson arrivals, deadlines and the CB-vs-static
  makespan comparison all live on this clock, so load tests are
  deterministic on any machine.
* **wall** (``time.perf_counter``) — measured per emission for the real
  latency histograms; never used for control decisions.

Admission is FIFO refined by deadline (earliest absolute deadline first
among arrived requests); a request whose predicted completion misses its
deadline — or whose sequence cannot fit the cache — is dropped LOUDLY
(stderr + ``serve.drop`` trace instant + a ``finish='dropped'``
completion). When the paged pool runs dry mid-decode, the youngest
active request is preempted: its blocks return to the free list and it
re-queues to replay from prompt + emitted tokens.

The prefill/decode convention (the reference's, kept as it is): prefill
runs on ``prefix[:-1]`` padded up to a whole number of blocks,
and ``prefix[-1]`` becomes the slot's *pending* token — the first decode
step consumes it at position ``len(prefix)-1`` through the same masked
decode path as every later token. The pad tokens (id 0) also run
through the recurrent blocks' prefill (rwkv, mamba), as in the
reference.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.common import ArchConfig
from repro_torch.models.flatten import FlatSpec
from repro_torch.obs import trace
from repro_torch.serve.kvcache import (ContiguousKVCache, OutOfBlocks,
                                       PagedKVCache)
from repro_torch.serve.streaming import stop_reason


@dataclasses.dataclass
class Request:
    """One generation request. ``prior`` carries tokens already emitted
    before a replay (failover / preemption) — the engine re-prefills
    ``prompt + prior`` and only generates the remaining budget."""

    rid: int
    prompt: tuple[int, ...]
    max_new: int
    arrival: float = 0.0                 # virtual seconds
    deadline: float | None = None        # absolute virtual completion bound
    stop_token: int | None = None
    prior: tuple[int, ...] = ()
    replays: int = 0

    def prefix(self) -> tuple[int, ...]:
        return tuple(self.prompt) + tuple(self.prior)


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list[int]                    # prior + newly generated
    finish: str                          # 'stop' | 'length' | 'dropped'
    t_arrival: float
    t_first: float | None                # virtual TTFT timestamp
    t_done: float
    replays: int = 0
    reason: str = ""                     # drop cause when finish='dropped'


def predict_admission(spec, prompt_tokens: int, gen_tokens: int) -> dict:
    """Default admission pricing from ClusterSpec compute/link params.

    Forward seconds per token position derive from the training step
    model (``compute_mean`` covers fwd+bwd of ``spec.seq`` positions;
    the forward share is ``1 - bwd_frac``); each generated token also
    pays the wire price of streaming its id over the cluster link
    (``LinkSpec.time`` — the same alpha+beta Eq. 1 pricing the tuner's
    CostModel charges). Returns ``{'t_prefill', 't_decode', 't_total'}``
    in virtual seconds.
    """
    cl = spec.cluster
    t_tok = cl.compute_mean * (1.0 - cl.bwd_frac) / max(1, spec.seq)
    t_dec = t_tok + cl.link_spec().time(4)  # one int32 id on the wire
    t_pre = prompt_tokens * t_tok
    return {"t_prefill": t_pre, "t_decode": t_dec,
            "t_total": t_pre + gen_tokens * t_dec}


def serve_fns(cfg: ArchConfig, fs: FlatSpec) -> tuple:
    """One (prefill, decode) pair for the arch, computing in f32 (the
    reference's ``build`` context): plain partials, eager (the
    reference's are jitted)."""
    return (functools.partial(M.prefill_fn, cfg, fs),
            functools.partial(M.decode_fn, cfg, fs))


@dataclasses.dataclass
class _Slot:
    req: Request
    pos: int                             # valid cache length
    pending: int                         # next token to feed to decode
    emitted: list[int]
    t_first: float | None = None


class ServeEngine:
    """Continuous-batching engine over one model replica."""

    def __init__(self, cfg: ArchConfig, fs: FlatSpec, segs: dict, spec, *,
                 dtype: torch.dtype = torch.float32,
                 predict: Callable = predict_admission,
                 cache: Any = None, fns: tuple | None = None):
        sv = spec.serve
        if cfg.family == "vlm":
            raise NotImplementedError(
                "continuous batching does not support static cross-KV "
                "(vlm) models")
        self.cfg, self.fs, self.segs = cfg, fs, segs
        self.spec, self.sv = spec, sv
        self.dtype = dtype
        self.device = segs["top_s"].device
        self.now = 0.0
        self.wall0 = time.perf_counter()
        self.n_steps = 0
        self.predict = predict
        self.t_decode = predict(spec, 0, 1)["t_decode"]
        self.max_len = sv.resolved_max_len()
        if cache is None:
            cache = (PagedKVCache.from_cluster(cfg, spec.cluster, sv, dtype,
                                               self.device)
                     if sv.paged else
                     ContiguousKVCache(cfg, slots=sv.batch,
                                       block_size=sv.block_size,
                                       max_len=self.max_len, dtype=dtype,
                                       device=self.device))
        self.cache = cache
        self.slots: list[_Slot | None] = [None] * sv.batch
        self.queue: collections.deque[Request] = collections.deque()
        self.completions: dict[int, Completion] = {}
        self.emissions: list[tuple[int, int, float, float]] = []
        # one ``serve_fns`` pair may serve several engines (warmup, CB,
        # static baseline), as the reference shares its jitted pair
        self._prefill, self._decode = fns or serve_fns(cfg, fs)

    # -- introspection -----------------------------------------------------

    def pending(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def completion(self, rid: int) -> Completion | None:
        return self.completions.get(rid)

    def _wall(self) -> float:
        return time.perf_counter() - self.wall0

    # -- lifecycle ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _finish(self, slot_i: int, finish: str) -> None:
        s = self.slots[slot_i]
        self.cache.free(slot_i)
        self.slots[slot_i] = None
        self.completions[s.req.rid] = Completion(
            rid=s.req.rid, tokens=list(s.req.prior) + s.emitted,
            finish=finish, t_arrival=s.req.arrival, t_first=s.t_first,
            t_done=self.now, replays=s.req.replays)
        trace.current().instant("serve.finish", cat="serve",
                                args={"rid": s.req.rid, "finish": finish})

    def _drop(self, req: Request, reason: str) -> None:
        print(f"[serve] DROP rid={req.rid} ({reason}) at t={self.now:.3f}",
              file=sys.stderr)
        trace.current().instant("serve.drop", cat="serve",
                                args={"rid": req.rid, "reason": reason})
        self.completions[req.rid] = Completion(
            rid=req.rid, tokens=list(req.prior), finish="dropped",
            t_arrival=req.arrival, t_first=None, t_done=self.now,
            replays=req.replays, reason=reason)

    def _preempt_youngest(self) -> bool:
        """Evict the most recently arrived active request back to the
        queue (replaying later from prompt + emitted); False if no
        active request exists to evict."""
        cand = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        if not cand:
            return False
        i, s = max(cand, key=lambda t: (t[1].req.arrival, t[1].req.rid))
        req = dataclasses.replace(
            s.req, prior=tuple(s.req.prior) + tuple(s.emitted),
            replays=s.req.replays + 1)
        self.cache.free(i)
        self.slots[i] = None
        self.queue.appendleft(req)
        trace.current().instant("serve.evict", cat="serve",
                                args={"rid": req.rid, "pos": s.pos})
        return True

    # -- admission ---------------------------------------------------------

    def _admission_order(self) -> list[Request]:
        """Arrived requests, earliest-deadline-first then FIFO."""
        arrived = [r for r in self.queue if r.arrival <= self.now]
        inf = float("inf")
        return sorted(arrived, key=lambda r: (
            inf if r.deadline is None else r.deadline, r.arrival, r.rid))

    def in_flight(self) -> list[Request]:
        """Replay-ready snapshots of the active requests (for failover)."""
        return [dataclasses.replace(
                    s.req, prior=tuple(s.req.prior) + tuple(s.emitted),
                    replays=s.req.replays + 1)
                for s in self.slots if s is not None]

    def _admit_one(self, req: Request, slot_i: int) -> bool:
        prefix = req.prefix()
        remaining = req.max_new - len(req.prior)
        if remaining <= 0:  # replay arrived with its budget already spent
            self.queue.remove(req)
            self.completions[req.rid] = Completion(
                rid=req.rid, tokens=list(req.prior), finish="length",
                t_arrival=req.arrival, t_first=None, t_done=self.now,
                replays=req.replays)
            return False
        if len(prefix) - 1 + remaining > self.max_len:
            self.queue.remove(req)
            self._drop(req, "too_long")
            return False
        est = self.predict(self.spec, len(prefix) - 1, remaining)
        if req.deadline is not None and \
                self.now + est["t_total"] > req.deadline:
            self.queue.remove(req)
            self._drop(req, "deadline")
            return False
        bs = self.sv.block_size
        P = len(prefix) - 1
        P_pad = -(-P // bs) * bs
        try:
            self.cache.ensure(slot_i, max(P_pad, 1))
        except OutOfBlocks:
            if not self.active():  # nothing running will ever free blocks
                self.queue.remove(req)
                self._drop(req, "oom")
            return False  # else stays queued; decode will free blocks
        self.queue.remove(req)
        if P:
            tokens = torch.zeros((1, P_pad), dtype=torch.int64)
            tokens[0, :P] = torch.tensor(prefix[:P], dtype=torch.int64)
            pre_cache = M.init_cache(self.cfg, 1, P_pad, self.dtype,
                                     device=self.device)
            with trace.current().span("serve.prefill", cat="serve",
                                      args={"rid": req.rid, "P": P}) as sp:
                _, pre_cache = self._prefill(
                    self.segs, {"tokens": tokens.to(self.device)},
                    pre_cache)
                sp.sync(pre_cache)
            self.cache.write_prefill(slot_i, pre_cache, P)
        else:
            self.cache.write_prefill(
                slot_i, M.init_cache(self.cfg, 1, bs, self.dtype,
                                     device=self.device), 0)
        self.now += est["t_prefill"]
        self.slots[slot_i] = _Slot(req=req, pos=P, pending=prefix[-1],
                                   emitted=[])
        trace.current().instant("serve.admit", cat="serve",
                                args={"rid": req.rid, "slot": slot_i,
                                      "replays": req.replays})
        return True

    def _admit(self) -> None:
        if self.sv.policy == "static" and self.active():
            return  # gang scheduling: wait for the whole batch to drain
        for req in self._admission_order():
            if req.rid not in {r.rid for r in self.queue}:
                continue  # dropped/finished by an earlier admission pass
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                break
            self._admit_one(req, free[0])

    # -- decode ------------------------------------------------------------

    def _ensure_decode_capacity(self) -> None:
        """Every active slot can place its next token; preempt the
        youngest active request (requeue-with-replay) while the pool is
        short. A single request larger than the whole pool is dropped."""
        while True:
            try:
                for i, s in enumerate(self.slots):
                    if s is not None:
                        self.cache.ensure(i, s.pos + 1)
                return
            except OutOfBlocks:
                if not self._preempt_youngest():
                    raise

    def step(self) -> list[tuple[int, int]]:
        """One engine step: admit, then one decode position across the
        active slots. Returns this step's ``(rid, token)`` emissions."""
        if not self.active() and self.queue and \
                not any(r.arrival <= self.now for r in self.queue):
            self.now = min(r.arrival for r in self.queue)  # fast-forward
        self._admit()
        if not self.active():
            return []
        self._ensure_decode_capacity()
        B = len(self.slots)
        toks = np.zeros((B, 1), np.int64)
        lens = np.zeros(B, np.int64)
        act = np.zeros(B, bool)
        for i, s in enumerate(self.slots):
            if s is not None:
                toks[i, 0], lens[i], act[i] = s.pending, s.pos, True
        with trace.current().span("serve.decode", cat="serve",
                                  args={"active": int(act.sum())}):
            out, new_cache = self._decode(
                self.segs, torch.from_numpy(toks).to(self.device),
                torch.from_numpy(lens).to(self.device),
                self.cache.gather())
            out = out.cpu().numpy()
        self.cache.scatter(new_cache, lens, act)
        self.now += self.t_decode
        self.n_steps += 1
        wall = self._wall()
        emitted: list[tuple[int, int]] = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            tok = int(out[i])
            s.emitted.append(tok)
            s.pending, s.pos = tok, s.pos + 1
            if s.t_first is None:
                s.t_first = self.now
            self.emissions.append((s.req.rid, tok, self.now, wall))
            emitted.append((s.req.rid, tok))
            why = stop_reason(len(s.emitted), len(s.req.prior),
                              s.req.max_new, s.req.stop_token, tok,
                              s.pos, self.max_len)
            if why is not None:
                self._finish(i, why)
        return emitted

    def run(self, max_steps: int = 100_000) -> list[Completion]:
        """Drive ``step`` until every submitted request completes."""
        for _ in range(max_steps):
            if not self.pending():
                break
            self.step()
        else:  # pragma: no cover
            raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return sorted(self.completions.values(), key=lambda c: c.rid)
