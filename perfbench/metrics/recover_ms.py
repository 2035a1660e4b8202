"""recover_ms: device milliseconds per step under HEAVYMIX recovery, the top-k and the exact values' round (spans recover/b*), the mean over the ranks."""

from pbench.readers import per_step_ms


def read(rec: dict):
    return per_step_ms(rec, "recover")
