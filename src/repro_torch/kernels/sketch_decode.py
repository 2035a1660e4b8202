"""Count-Sketch decode: CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/sketch_decode.py:sketch_decode``
(Pallas body ``_decode_kernel``: signed one-hot tiles contracted against
the sketch on the MXU, the width padded to a block multiple). The Hopper
kernel (``csrc/sketch_decode.cu``) gives each coordinate one thread: R
gathers from the L2-resident sketch and the register median network it
shares with the HEAVYMIX scores kernel (``csrc/sketch_common.cuh``):

    est[j] = median_r sign_r(i) * S[r, h_r(i)],  i = (offset + j) mod 2^32

Bound on the H100: writing ``est`` (4 * d bytes) plus one read of the
(R, W) sketch, over 3.35 TB/s; the random L2 gathers hold it far above
that, and holding the sketch in cluster shared memory instead was
measured slower (see the source note). The kernel gathers and sorts the
same values as the plain version, so ``est`` is bit-equal to it.

In the loop that writes ``est`` each CTA also counts key bits 30..20 of
|est| (the first digit of the HEAVYMIX top-k's radix select,
``kernels/topk_select.py``) in shared memory and adds them into one
(2048,) int32 histogram, so the select reads ``est`` once less.
``sketch_decode_hist`` returns it; ``sketch_decode`` (the reference's
API) launches the same kernel and drops it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import count_sketch as cs
from repro_torch.core.count_sketch import SketchConfig
from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES, resolve_dispatch
from repro_torch.kernels.sketch_encode import hash_on_device
from repro_torch.kernels.topk_select import RADIX_BINS, radix_hist_plain


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("sketch_decode")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sketch_decode_launch.argtypes = [p, i64, p, i32, i32, i64, i64, p, p,
                                         p]
    lib.sketch_decode_launch.restype = i32
    return lib


def sketch_decode_plain(cfg: SketchConfig, sketch: torch.Tensor, d: int,
                        index_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch decode (the oracle), chunked over coordinates."""
    return cs.decode(cfg, sketch, d, offset=index_offset)


def sketch_decode(cfg: SketchConfig, sketch: torch.Tensor, d: int, *,
                  index_offset: int = 0) -> torch.Tensor:
    """Estimate coordinates [index_offset, index_offset + d) -> (d,) f32.

    CPU tensors run the plain version; other devices launch the kernel
    (see ``kernels.dispatch``).
    """
    d = int(d)
    if not resolve_dispatch(sketch.device.type):
        return sketch_decode_plain(cfg, sketch, d, int(index_offset))
    return _launch(cfg, sketch, d, int(index_offset))[0]


def sketch_decode_hist(cfg: SketchConfig, sketch: torch.Tensor, d: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(est (d,) f32, the (2048,) int32 histogram of key bits 30..20 of
    |est|) for ``kernels.topk_select``; one kernel launch on the card."""
    d = int(d)
    if not resolve_dispatch(sketch.device.type):
        est = sketch_decode_plain(cfg, sketch, d)
        return est, radix_hist_plain(est)
    return _launch(cfg, sketch, d, 0)


def _launch(cfg: SketchConfig, sketch: torch.Tensor, d: int, offset: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    lib = _lib()
    if sketch.device.type != "cuda":
        raise ValueError(f"sketch_decode kernel needs a CUDA tensor, got "
                         f"{sketch.device}")
    if tuple(sketch.shape) != (cfg.rows, cfg.width):
        raise ValueError(f"sketch shape {tuple(sketch.shape)} != "
                         f"{(cfg.rows, cfg.width)}")
    sk = sketch.to(torch.float32).contiguous()
    est = torch.empty((d,), dtype=torch.float32, device=sk.device)
    hist = torch.zeros(RADIX_BINS, dtype=torch.int32, device=sk.device)
    if d == 0:
        return est, hist
    hp = hash_on_device(cfg, str(sk.device))
    stream = torch.cuda.current_stream(sk.device).cuda_stream
    rc = lib.sketch_decode_launch(
        sk.data_ptr(), cfg.width, hp.data_ptr(), cfg.rows,
        32 - cfg.log2_width, offset, d, est.data_ptr(), hist.data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError(f"sketch_decode launch failed: cudaError {rc}")
    LAUNCHES["sketch_decode"] += 1
    return est, hist


def sketch_decode_bucketed(cfgs, sketches, sizes) -> torch.Tensor:
    """Per-bucket decode back to one flat estimate vector: bucket i's
    coordinates from bucket i's sketch and geometry, in bucket order."""
    return torch.cat([sketch_decode(cfg, sk, int(s))
                      for cfg, sk, s in zip(cfgs, sketches, sizes)])
