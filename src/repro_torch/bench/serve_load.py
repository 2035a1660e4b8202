"""Serving load-test audit: CB vs static batching on one Poisson trace.

Port of ``benchmarks/serve_load.py``. Replays the seeded arrival trace
of ``repro_torch.serve.loadtest`` through the continuous-batching engine
and the static-batch baseline (the same functions, the same trace) and
gates on the serving acceptance criteria:

  1. zero dropped requests on the clean trace (no deadlines set),
  2. p99 TTFT under a generous virtual-clock bound,
  3. continuous batching strictly beats static batching on makespan
     (speedup > 1.0 on the same trace),
  4. greedy tokens identical between the two policies (scheduling must
     not change what the model says).

Writes the report (schema ``repro.serve/bench_serve@1``, stamped with
``obs.provenance``): TTFT + per-token latency histograms (p50/p95/p99,
virtual clock), throughput on both policies, and the cold vs steady
wall-clock numbers (reported, never asserted). Exits 1 if any check
fails. Runs on the card unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.bench.serve_load [--fast] \\
      [--device cpu] [--out experiments/bench_torch/BENCH_serve.json]
"""

from __future__ import annotations

import argparse
import json
import os

SCHEMA = "repro.serve/bench_serve@1"

# generous virtual-clock ceiling: the smoke ClusterSpec prices a decode
# step in O(ms) and TTFT spans at most a few queued prefills, so a clean
# trace sits far below this; only gross scheduler regressions cross it
TTFT_P99_BOUND_S = 2.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="shorter trace (CI profile)")
    ap.add_argument("--requests", type=int, default=None,
                    help="override trace length (default 32, 16 --fast)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate, virtual req/s")
    ap.add_argument("--ttft-bound", type=float, default=TTFT_P99_BOUND_S,
                    help="p99 TTFT ceiling, virtual seconds")
    ap.add_argument("--out",
                    default="experiments/bench_torch/BENCH_serve.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.launch import serve as launch_serve

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_req = args.requests or (16 if args.fast else 32)
    argv_serve = ["--smoke", "--load-test", "--requests", str(n_req),
                  "--rate", str(args.rate), "--json", args.out]
    if args.device is not None:
        argv_serve += ["--device", args.device]
    report = launch_serve.main(argv_serve)
    report["schema"] = SCHEMA

    cont = report["continuous"]
    checks = {
        "zero_dropped_on_clean_trace": cont["dropped"] == 0,
        "ttft_p99_under_bound":
            cont["ttft"]["p99"] is not None
            and cont["ttft"]["p99"] < args.ttft_bound,
        "cb_beats_static":
            report["speedup_vs_static"] is not None
            and report["speedup_vs_static"] > 1.0,
        "tokens_match_static": bool(report["tokens_match_static"]),
    }
    report["checks"] = checks
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)

    print(f"serve_load: ttft p99 {cont['ttft']['p99']:.4f}s "
          f"(bound {args.ttft_bound}s), dropped {cont['dropped']}, "
          f"speedup vs static {report['speedup_vs_static']:.2f}x")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        print(f"serve_load: FAILED checks: {bad}")
        return 1
    print("serve_load: all checks ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
