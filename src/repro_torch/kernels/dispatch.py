"""Kernel dispatch policy — ONE table for every Count-Sketch kernel wrapper.

Port of ``repro/kernels/dispatch.py``. The reference resolves by JAX
backend; the port resolves per tensor device:

    device  -> runs
    ------  ------------------------------------------------------
    cpu     plain PyTorch version
    other   hand-written CUDA kernel (raises if unbuilt or not CUDA)

A tensor that is not on the CPU never quietly takes the plain path: the
wrapper launches the kernel or raises. Tests and ``chip_smoke.py`` call a
kernel's plain version by its own name to compare the two.

``LAUNCHES`` counts kernel launches by wrapper name; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import collections
import functools

import torch

LAUNCHES: collections.Counter = collections.Counter()


def resolve_dispatch(device_type: str) -> bool:
    """True -> launch the CUDA kernel, False -> run the plain version."""
    return device_type != "cpu"


def resolve_device(device: str | torch.device | None) -> torch.device:
    """Entry-point device: CUDA unless the caller asks for the CPU.

    ``None`` means the card; with no card it raises instead of running on
    the CPU behind the caller's back.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, for the kernels' launch planners."""
    return torch.cuda.get_device_properties(device).multi_processor_count
