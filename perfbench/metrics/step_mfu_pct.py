"""step_mfu_pct: the model's training FLOPs of a step's tokens
(``counts.model_flops``: no recompute, causal attention) over the
step's wall in the untraced window of the run (the slowest rank's; the
profiler's host cost stretches the profiled steps) times the float32
peak of every chip the cell uses, in %."""

from counts import model_flops, peaks
from pbench import layout


def read(rec: dict):
    t = rec["traffic"]
    shape = layout.Shape.of(rec["conf"])
    flops = model_flops.train_flops(
        shape, int(t["workers"]) * int(t["seqs_per_worker"]),
        int(t["seq_len"]))
    wall = max(r["untraced_step_s"] for r in rec["ranks"])
    return 100.0 * flops / (wall * rec["chips"] * peaks.FLOPS["float32"])
