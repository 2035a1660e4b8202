"""Helpers of the per-layer metric readers (``perfbench/metrics/<name>.py``)."""

from counts import peaks, sketch_work


def per_step_ms(rec: dict, family: str):
    """A layer's device milliseconds per profiled step, the mean over the
    ranks; None where no device time fell under it."""
    vals = [r["family_ms"].get(family, 0.0) / r["steps"]
            for r in rec["ranks"]]
    if not any(vals):
        return None
    return sum(vals) / len(vals)


def share(rec: dict, family: str, work) -> float | None:
    """A stage's roofline share in %: the least time of every local
    worker's ``work(bucket, rows) -> (operations, bytes)`` over every
    bucket, over the device time under its spans; the mean over the
    ranks; None where a rank saw no device time under them."""
    ex = rec["conf"]["exchange"]
    least = sum(sketch_work.least_seconds(
        *work(b, ex["rows"]), peaks.FLOPS["float32"],
        peaks.HBM_BYTES_PER_S) for b in ex["buckets"])
    shares = []
    for r in rec["ranks"]:
        ms = r["family_ms"].get(family, 0.0)
        if ms <= 0:
            return None
        shares.append(100.0 * least * r["workers"] * r["steps"]
                      / (ms / 1e3))
    return sum(shares) / len(shares)
