"""recover_roofline_pct: the least time of every worker's recovery of
every bucket (``counts.sketch_work.recover``) over the device time under
recover/b*, in %; on a mesh the mean over the ranks."""

from pbench.readers import share
from counts import sketch_work


def read(rec: dict):
    return share(rec, "recover", lambda b, rows: sketch_work.recover(
        b["d"], rows, b["width"], b["k"]))
