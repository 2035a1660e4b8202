"""The benchmark of ``repro_torch`` (gs-SGD training on the H100).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. One run is one process: set-up, the
measured window (``--trace 0``: the cell's end-to-end metrics; with
``--trace 1`` profiled steps follow it, and the metrics are the cell's
per-layer ones), then the check that decides ``correct``. The last line of standard output is the
result, one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key.

Exits 2, printing no result, without CUDA or with fewer cards than the
cell asks for, and 3 when the JAX package or JAX itself is loaded once
the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(ROOT, "src")]
# every build and kernel cache inside the checkout, at fixed paths
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(ROOT, "build", "perfbench", _dir)
os.environ["USE_FLAX"] = "0"

BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in BANNED})


def fail(msg: str, code: int):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from pbench import cells, harness

    cell = cells.cell(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card", 2)
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} visible", 2)
    torch.backends.cuda.matmul.allow_tf32 = False   # float32, as stated
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.run_single(cell, args.seed, args.seconds, bool(args.trace),
                             device, T_START)
    found = banned_modules()
    if found:
        fail("the run loaded " + ", ".join(found), 3)
    print(window_summary(out), file=sys.stderr)
    return result(cell, out, bool(args.trace),
                  torch.cuda.get_device_name(device))


def result(cell: dict, out: dict, trace: bool, kind: str) -> dict:
    """The result line's object from a run's readings (the last key is
    the numbers compared, each with its limit)."""
    from pbench import cells, compare
    correct, checks = compare.judge(out["numbers"], cell["limits"])
    metrics = {}
    if trace:
        rec = {"conf": cell["conf"], "traffic": cell["traffic"],
               "chips": cell["chips"], "ranks": out["ranks"]}
        for m in cell["per_layer"]:
            v = cells.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        have = {"tokens_per_s": out["tokens_per_s"],
                "peak_mem_gib": out["memory_peak_bytes"] / 2 ** 30,
                "setup_s": out["setup_s"]}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": have[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    res = {"correct": correct, "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        ranks = out["ranks"]
        device["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        device["window_s"] = sum(r["window_s"] for r in ranks) / len(ranks)
        res["breakdown"] = {"device_ops": ranks[0]["device_ops"],
                            "idle_gaps": ranks[0]["idle_gaps"]}
    res["checks"] = checks
    return res


def window_summary(out: dict) -> str:
    """A line on the window's steps (and the profiled ones') for
    standard error."""
    t = sorted(out["step_s"])
    line = (f"window: {len(t)} steps in {out['window_s']:.3f} s; step s "
            f"min {t[0]:.4f} median {t[len(t) // 2]:.4f} max {t[-1]:.4f}")
    for r in out.get("ranks", ()):
        line += (f"; profiled: {r['steps']} steps, wall "
                 f"{r['window_s'] / r['steps']:.4f} s and device busy "
                 f"{r['busy_s'] / r['steps']:.4f} s a step")
    return line


if __name__ == "__main__":
    res = main()
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
