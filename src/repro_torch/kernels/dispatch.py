"""Kernel dispatch policy — ONE table for every Count-Sketch kernel wrapper.

Port of ``repro/kernels/dispatch.py``. The reference resolves by JAX
backend; the port resolves per tensor device:

    device  -> runs
    ------  ------------------------------------------------------
    cpu     plain PyTorch version
    meta    inside ``meta_shapes()``: the wrapper's shape function, empty
            outputs of the kernel's shapes and dtypes, no launch
            (``launch/dryrun.py --device meta`` runs a production rank's
            step on meta tensors); outside it, as any other device
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
import contextlib
import functools

import torch

LAUNCHES: collections.Counter = collections.Counter()


def resolve_dispatch(device_type: str) -> bool:
    """True -> launch the CUDA kernel, False -> run the plain version."""
    return device_type != "cpu"


_META_SHAPES = [False]


@contextlib.contextmanager
def meta_shapes():
    """While open, a wrapper given a meta tensor returns its shape
    function's outputs (module docstring)."""
    outer, _META_SHAPES[0] = _META_SHAPES[0], True
    try:
        yield
    finally:
        _META_SHAPES[0] = outer


def on_meta(t: torch.Tensor) -> bool:
    """True for a meta tensor inside ``meta_shapes()``: the wrapper
    returns its shape function's outputs."""
    return _META_SHAPES[0] and t.device.type == "meta"


def meta_empty(shape, dtype=torch.float32) -> torch.Tensor:
    """A meta tensor of ``shape`` (a kernel output's shape function)."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


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
