"""Benchmark entry point: one bench per paper table/figure + roofline.

Port of ``benchmarks/run.py``: the same benches in the same order, over
the port's modules.

    python -m repro_torch.bench.run [--fast] [--device cpu]

Order: static/cheap first (comm complexity, roofline), then the audits,
then the measured CNN benches (breakdown, throughput, convergence,
k-sensitivity). ``--device`` goes to the benches that run tensors
(serve_load and the CNN benches; the card when it is not given). Every
bench writes JSON under experiments/bench_torch/ (the roofline under
experiments/roofline_torch/) and prints its paper-claim check inline.
Exits 1 when a bench fails.
"""

from __future__ import annotations

import argparse
import time
import traceback


def _check(rc):
    """Surface status-code benches (exit-1 style) as failures."""
    if rc:
        raise RuntimeError(f"bench exited with status {rc}")


def benches(fast: bool = False, device: str | None = None) -> list:
    """(name, callable) of every bench, in the order they run."""
    from repro_torch.bench import (comm_complexity, convergence,
                                   drift_audit, k_sensitivity, roofline,
                                   serve_load, throughput, time_breakdown)
    steps = 15 if fast else 60
    quick = ["--fast"] if fast else []
    dev = ["--device", device] if device else []
    return [
        ("comm_complexity (Eq. 1)", lambda: comm_complexity.main()),
        ("roofline single-pod", lambda: roofline.main(["--mesh", "single"])),
        ("roofline multi-pod", lambda: roofline.main(["--mesh", "multi"])),
        ("drift_audit (watchdog detect/re-plan)",
         lambda: _check(drift_audit.main(quick))),
        ("serve_load (CB vs static on one trace)",
         lambda: _check(serve_load.main(quick + dev))),
        ("time_breakdown (Figs. 4-5)",
         lambda: time_breakdown.main(device=device)),
        ("throughput (Table II)", lambda: throughput.main(device=device)),
        ("convergence (Figs. 2-3)",
         lambda: convergence.main(steps=steps, device=device)),
        ("k_sensitivity (Figs. 6-7)",
         lambda: k_sensitivity.main(steps=steps, device=device)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="fewer steps for the CNN benches")
    ap.add_argument("--device", default=None,
                    help="torch device of the benches that run tensors "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)

    failures = []
    for name, fn in benches(args.fast, args.device):
        print(f"\n=== {name} ===")
        t0 = time.time()
        try:
            fn()
            print(f"--- {name}: ok in {time.time() - t0:.1f}s")
        except Exception:
            failures.append(name)
            print(f"--- {name}: FAILED\n{traceback.format_exc()}")
    if failures:
        print(f"\n{len(failures)} benches failed: {failures}")
        return 1
    print("\nall benches ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
