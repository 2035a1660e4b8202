from repro_torch.data.pipeline import ImageStream, LMStream

__all__ = ["ImageStream", "LMStream"]
