"""Serving driver: spec-first (``repro_torch.api.ServeSpec``), engine-backed.

Port of ``repro/launch/serve.py``. Every knob (slots, prompt/gen lengths,
paging, policy, load-test shape) lives in ``RunSpec.serve`` with
generated CLI flags, so ``--dump-spec`` / ``--spec`` round-trips carry
the whole serving config. The run goes on the CUDA card unless
``--device cpu`` is given; with no card and no ``--device`` it stops
with an error. A discarded warmup pass runs first, and the cold (first
pass) and steady tok/s are printed separately.

Modes:

  demo (default)   — submit a batch of identical-shape requests through
                     the continuous-batching ``ServeEngine`` and print
                     the generations + both tok/s numbers.
  --load-test      — replay a seeded Poisson arrival trace (mixed
                     prompt/gen lengths) through CB and the static-batch
                     baseline; write TTFT / per-token latency histograms
                     (p50/p95/p99) + throughput to ``--json`` (default
                     BENCH_serve.json) with provenance stamping.

The weights are random, drawn from ``--seed`` on the run's device
(``torch.Generator``), so the tokens differ from the reference CLI's
(``jax.random``); the tests carry the reference's weights across.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --smoke \\
      --batch 4 --prompt-len 32 --gen 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --load-test \\
      --requests 24 --rate 100 --json /tmp/serve.json --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.flatten import init_flat_params, make_flat_spec
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.loadtest import run_load_test
from repro_torch.serve.scheduler import serve_fns


def build(spec, device=None):
    """(cfg, fs, segs): the f32 params drawn from ``spec.seed`` on the
    device (None means the card, and raises without one)."""
    device = resolve_device(device)
    cfg = spec.arch_config()
    fs = make_flat_spec(cfg, 1)
    gen = torch.Generator(device=device).manual_seed(spec.seed)
    segs = init_flat_params(cfg, gen, 1, fs, device=device)
    return cfg, fs, segs


def _demo(cfg, fs, segs, spec) -> dict:
    sv = spec.serve
    rng = np.random.default_rng(spec.seed + 1)
    prompts = [tuple(int(x) for x in
                     rng.integers(1, cfg.vocab_size, sv.prompt_len))
               for _ in range(sv.batch)]
    fns = serve_fns(cfg, fs)

    def gen_all():
        eng = ServeEngine(cfg, fs, segs, spec, fns=fns)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=sv.gen))
        t0 = time.perf_counter()
        comps = eng.run()
        return comps, time.perf_counter() - t0

    # the warmup pass's timing is reported as "cold" and its outputs
    # discarded; the measured pass is steady-state only
    comps, dt_cold = gen_all()
    comps, dt = gen_all()
    n_tok = sum(len(c.tokens) for c in comps)
    tps, tps_cold = n_tok / dt, n_tok / dt_cold
    print(f"generated {len(comps)}x{sv.gen} tokens: "
          f"steady {dt:.2f}s ({tps:.1f} tok/s), "
          f"cold {dt_cold:.2f}s ({tps_cold:.1f} tok/s, first pass)")
    for c in comps[:2]:
        print(f"  sample {c.rid}: {c.tokens}")
    return {"tokens": [c.tokens for c in comps], "tok_per_s": tps,
            "tok_per_s_cold": tps_cold}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="serving driver")
    api.add_spec_args(ap, "serve")     # every config flag: repro_torch.api
    ap.add_argument("--spec", default=None, metavar="SPEC.json",
                    help="load a RunSpec as the base config (explicit "
                         "flags still override)")
    ap.add_argument("--dump-spec", default=None, metavar="PATH",
                    help="write the fully-resolved RunSpec JSON and "
                         "continue")
    ap.add_argument("--load-test", action="store_true",
                    help="replay a Poisson arrival trace through CB + "
                         "static baseline and write latency histograms")
    ap.add_argument("--json", default="BENCH_serve.json", metavar="PATH",
                    help="load-test report path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain path on the CPU)")
    args = ap.parse_args(argv)

    base = api.RunSpec.load(args.spec) if args.spec \
        else api.RunSpec(smoke=True)
    spec = api.apply_args(base, args, "serve")
    spec.validate()
    if args.dump_spec:
        spec.save(args.dump_spec)
        print(f"wrote resolved spec to {args.dump_spec}")

    cfg, fs, segs = build(spec, args.device)
    sv = spec.serve
    print(f"arch {cfg.name}: slots={sv.batch} block_size={sv.block_size} "
          f"max_len={sv.resolved_max_len()} "
          f"cache={'paged' if sv.paged else 'contiguous'} "
          f"policy={sv.policy} device={segs['top_s'].device}")

    if not args.load_test:
        return _demo(cfg, fs, segs, spec)

    report = run_load_test(cfg, fs, segs, spec)
    with open(args.json, "w") as f:
        json.dump(report, f, indent=1)
    c, s = report["continuous"], report["static"]
    print(f"wrote {args.json}")
    print(f"  continuous: {c['tokens']} tok in {c['makespan']:.3f}s "
          f"virtual ({c['throughput_tok_per_s']:.1f} tok/s), "
          f"TTFT p99 {c['ttft']['p99']:.4f}s, dropped {c['dropped']}")
    print(f"  static    : {s['tokens']} tok in {s['makespan']:.3f}s "
          f"virtual ({s['throughput_tok_per_s']:.1f} tok/s)")
    print(f"  speedup vs static: {report['speedup_vs_static']:.2f}x, "
          f"tokens match: {report['tokens_match_static']}")
    print(f"  wall: steady {report['wall']['tok_per_s_steady']:.1f} tok/s, "
          f"cold {report['wall']['tok_per_s_cold']:.1f} tok/s "
          f"(first pass)")
    return report


if __name__ == "__main__":
    main()
