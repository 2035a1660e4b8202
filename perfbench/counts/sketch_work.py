"""Operations and bytes of the exchange's two device stages, per worker
and bucket, from the algorithm's shapes (d, R, W, k): each input byte
counted once, each output byte once, whatever a kernel reads again.

Encode (a worker's bucket of d coordinates): the error-feedback add
reads the residual and the gradient (2 * 4d B) and writes the corrected
gradient u (4d B); the sketch is written once (4RW B). Operations: the
add (d) and R signed adds (2Rd).

Recovery (a worker's copy of the summed sketch): the sketch is read once
(4RW B); the median estimate of every coordinate (R sign products and
the comparisons of a median of R: 3, 6, 10 for R = 3, 5, 7) and one
comparison against the k-th value are operations; the exact values'
round reads k values of u (4k B), writes the k indices and values of
the update (8k B) and zeroes k residual coordinates (4k B).
"""

from __future__ import annotations

MEDIAN_COMPARISONS = {1: 0, 3: 3, 5: 6, 7: 10, 9: 14}


def encode(d: int, rows: int, width: int) -> tuple[float, float]:
    """(operations, bytes) of one worker's encode of one bucket."""
    return float(d + 2 * rows * d), float(3 * 4 * d + 4 * rows * width)


def recover(d: int, rows: int, width: int, k: int) -> tuple[float, float]:
    """(operations, bytes) of one worker's recovery of one bucket."""
    ops = d * (rows + MEDIAN_COMPARISONS[rows] + 1)
    return float(ops), float(4 * rows * width + 4 * k + 8 * k + 4 * k)


def least_seconds(ops: float, nbytes: float, flops: float,
                  bandwidth: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(ops / flops, nbytes / bandwidth)
