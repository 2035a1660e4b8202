from repro_torch.data.pipeline import LMStream

__all__ = ["LMStream"]
