"""Synthetic load test: Poisson arrivals replayed through the engine.

Port of ``repro/serve/loadtest.py`` over the port's ``obs`` (the same
trace, histograms and report; the warmup pass pays the first eager
calls' set-up on the card instead of XLA compilation).

``make_trace`` draws a seeded arrival trace (exponential interarrivals at
``ServeSpec.rate`` req/s on the VIRTUAL clock, prompt/gen lengths mixed
uniformly in [len/2, len]); ``run_load_test`` replays it through

  1. a discarded warmup pass (pays the first calls' set-up: cold and
     steady wall numbers are reported separately, control metrics never
     include it),
  2. the continuous-batching engine,
  3. the static-batch baseline (gang admission) on the SAME trace with
     the SAME prefill / decode functions,

and reports TTFT / per-token latency histograms (``obs.Histogram``
p50/p95/p99) plus throughput on both clocks. Virtual-clock numbers are
deterministic in (spec, seed) — the tests assert on those; wall-clock numbers
describe the machine the test ran on and are reported, never asserted.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.obs.metrics import Histogram
from repro_torch.obs.provenance import provenance
from repro_torch.serve.scheduler import Request, ServeEngine, serve_fns


def make_trace(sv, vocab_size: int, seed: int = 0) -> list[Request]:
    """Seeded Poisson arrival trace with mixed prompt/gen lengths."""
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for i in range(sv.n_requests):
        t += float(rng.exponential(1.0 / sv.rate))
        plen = int(rng.integers(max(1, sv.prompt_len // 2),
                                sv.prompt_len + 1))
        gen = int(rng.integers(max(1, sv.gen // 2), sv.gen + 1))
        reqs.append(Request(
            rid=i,
            prompt=tuple(int(x) for x in
                         rng.integers(1, vocab_size, plen)),
            max_new=gen, arrival=t,
            deadline=None if sv.deadline is None else t + sv.deadline,
            stop_token=sv.stop_token))
    return reqs


def _latency_report(engine: ServeEngine,
                    completions) -> dict:
    """Histograms + throughput for one finished engine run."""
    ttft = Histogram("ttft")
    per_tok = Histogram("per_token")
    per_tok_wall = Histogram("per_token_wall")
    last: dict[int, tuple[float, float]] = {}
    for rid, _tok, tv, tw in engine.emissions:
        if rid in last:
            per_tok.observe(tv - last[rid][0])
            per_tok_wall.observe(tw - last[rid][1])
        last[rid] = (tv, tw)
    n_tok = n_drop = n_replay = 0
    for c in completions:
        if c.finish == "dropped":
            n_drop += 1
            continue
        n_tok += len(c.tokens)
        n_replay += c.replays
        if c.t_first is not None:
            ttft.observe(c.t_first - c.t_arrival)
    makespan = engine.now
    return {
        "ttft": ttft.summary(),                 # virtual seconds
        "per_token": per_tok.summary(),         # virtual seconds
        "per_token_wall": per_tok_wall.summary(),
        "tokens": n_tok,
        "dropped": n_drop,
        "replays": n_replay,
        "decode_steps": engine.n_steps,
        "makespan": makespan,                   # virtual seconds
        "throughput_tok_per_s": n_tok / makespan if makespan > 0 else None,
    }


def run_load_test(cfg, fs, segs, spec, *, dtype=None,
                  seed: int | None = None) -> dict:
    """Replay one trace through CB and the static baseline; see module
    docstring. Returns the load-test report, stamped with the provenance
    of the params' device."""
    dtype = torch.float32 if dtype is None else dtype
    sv = spec.serve
    seed = spec.seed if seed is None else seed
    fns = serve_fns(cfg, fs)

    def engine(policy):
        sp = dataclasses.replace(
            spec, serve=dataclasses.replace(sv, policy=policy))
        return ServeEngine(cfg, fs, segs, sp, dtype=dtype, fns=fns)

    def replay(eng):
        for r in make_trace(sv, cfg.vocab_size, seed):
            eng.submit(r)
        t0 = time.perf_counter()
        comps = eng.run()
        return comps, time.perf_counter() - t0

    # 1. warmup (discarded): pays the first calls' set-up, so the
    #    measured runs below are steady-state
    warm = engine("continuous")
    _, wall_cold = replay(warm)
    cold = _latency_report(warm, warm.completions.values())

    # 2. continuous batching, steady-state
    cb = engine("continuous")
    cb_comps, wall_cb = replay(cb)
    cont = _latency_report(cb, cb_comps)
    cont["wall_s"] = wall_cb

    # 3. static-batch baseline, same trace, same compiled fns
    st = engine("static")
    st_comps, wall_st = replay(st)
    static = _latency_report(st, st_comps)
    static["wall_s"] = wall_st

    tokens = {c.rid: c.tokens for c in cb_comps if c.finish != "dropped"}
    st_tokens = {c.rid: c.tokens for c in st_comps
                 if c.finish != "dropped"}
    both = set(tokens) & set(st_tokens)
    return {
        "provenance": provenance(spec, segs["top_s"].device),
        "trace": {"n_requests": sv.n_requests, "rate": sv.rate,
                  "seed": seed, "prompt_len": sv.prompt_len,
                  "gen": sv.gen, "deadline": sv.deadline},
        "continuous": cont,
        "static": static,
        # CB and static must emit identical sequences per request under
        # greedy decode — scheduling cannot change tokens (compared over
        # requests neither policy dropped)
        "tokens_match_static": all(tokens[r] == st_tokens[r]
                                   for r in both),
        "speedup_vs_static": (static["makespan"] / cont["makespan"]
                              if cont["makespan"] > 0 else None),
        "wall": {"cold_s": wall_cold,
                 "steady_s": wall_cb,
                 "tok_per_s_cold": (cold["tokens"] / wall_cold
                                    if wall_cold > 0 else None),
                 "tok_per_s_steady": (cont["tokens"] / wall_cb
                                      if wall_cb > 0 else None)},
    }
