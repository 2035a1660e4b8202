"""optimizer_ms: device milliseconds per step under the optimizer (span optimizer), the mean over the ranks."""

from pbench.readers import per_step_ms


def read(rec: dict):
    return per_step_ms(rec, "optimizer")
