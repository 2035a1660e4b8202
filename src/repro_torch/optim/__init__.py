from repro_torch.optim import schedule
from repro_torch.optim.optimizers import Optimizer, adamw, make, sgdm
from repro_torch.optim.schedule import (PAPER_WARMUP_DENSITIES,
                                        PAPER_WARMUP_LRS, SCHEDULES,
                                        constant, warmup_cosine,
                                        warmup_density, wsd)

__all__ = ["schedule", "Optimizer", "adamw", "make", "sgdm",
           "PAPER_WARMUP_DENSITIES", "PAPER_WARMUP_LRS", "SCHEDULES",
           "constant", "warmup_cosine", "warmup_density", "wsd"]
