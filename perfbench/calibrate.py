"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out FILE]

For each seed of ``--seeds``: the program's three checked steps (the
timed step, at the cell's sizes) against the reference's, the numbers
``correct`` compares (the lower readings). For each of
``--control-seeds``: the control, the reference in TF32 put in the
program's place, and each planted fault of the reference
(``reference.FAULTS``), against the float32 reference (the upper
readings). One JSON line a reading, on standard output and in ``--out``.
No window is measured: training's readings need none. Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def program(cell: dict, seeds, device):
    """Each seed's program readings, one at a time: (seed, readings,
    seconds)."""
    import torch
    from pbench import harness, inputs, layout, port
    conf, traffic = cell["conf"], cell["traffic"]
    lay = layout.layout(layout.Shape.of(conf))
    ts = port.build_step(conf, traffic, device)
    for seed in seeds:
        t0 = time.time()
        flat = inputs.initial_params(lay, seed, device)
        state = ts.state_from(inputs.segments_of(flat, lay),
                              port.optimizer(conf))
        del flat
        state, prog = harness.program_readings(
            ts, state, lay, conf, seed, device,
            lambda t, s=seed: inputs.batch(lay.shape, traffic, s, t, device))
        del state
        gc.collect()
        torch.cuda.empty_cache()
        yield seed, prog, time.time() - t0


def readings(cell: dict, seeds, control_seeds, device, emit) -> None:
    from pbench import compare, harness, reference
    conf, traffic = cell["conf"], cell["traffic"]
    refs = {}
    for seed, prog, t_prog in program(cell, seeds, device):
        t1 = time.time()
        ref = harness.reference_readings(conf, traffic, seed, device)
        emit({"seed": seed, "kind": "program", "loss_p": prog["loss"],
              "loss_r": ref["loss"], "program_s": t_prog,
              "reference_s": time.time() - t1,
              **compare.numbers(prog, ref),
              "worst": compare.worst_leaves(prog, ref)})
        if seed in control_seeds:
            refs[seed] = ref
    for seed in control_seeds:
        ref = refs.pop(seed, None) or harness.reference_readings(
            conf, traffic, seed, device)
        for kind, kw in [("tf32", {"tf32": True})] + [
                (f, {"fault": f}) for f in reference.FAULTS]:
            bad = harness.reference_readings(conf, traffic, seed, device,
                                             **kw)
            emit({"seed": seed, "kind": kind, **compare.numbers(bad, ref),
                  "worst": compare.worst_leaves(bad, ref)})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from pbench import cells
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = {"workload": args.workload, **rec}
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()

    try:
        readings(cells.cell(args.workload), seeds, control,
                 torch.device("cuda", 0), emit)
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
