from repro_torch.optim.optimizers import Optimizer, adamw, make, sgdm

__all__ = ["Optimizer", "adamw", "make", "sgdm"]
