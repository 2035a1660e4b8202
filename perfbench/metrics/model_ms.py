"""model_ms: device milliseconds per step under the model's forward and backward (spans loss_and_grad, or forward and backward*), the mean over the ranks."""

from pbench.readers import per_step_ms


def read(rec: dict):
    return per_step_ms(rec, "model")
