"""encode_ms: device milliseconds per step under the error-feedback add and Count-Sketch encode (spans encode/b*), the mean over the ranks."""

from pbench.readers import per_step_ms


def read(rec: dict):
    return per_step_ms(rec, "encode")
