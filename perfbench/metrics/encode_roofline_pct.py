"""encode_roofline_pct: the least time of every worker's encode of every
bucket (``counts.sketch_work.encode``: bytes bind) over the device time
under encode/b*, in %; on a mesh the mean over the ranks."""

from pbench.readers import share
from counts import sketch_work


def read(rec: dict):
    return share(rec, "encode", lambda b, rows: sketch_work.encode(
        b["d"], rows, b["width"]))
