"""TS-sketch encode: CUDA kernel wrappers and their plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/ts_encode.py:ts_encode`` (Pallas
body ``_kernel``: W-sized blocks walked in order, group-summed, placed at
stride n_r, rotated and accumulated into a VMEM tile). ``csrc/ts_encode.cu``
has two Hopper kernels; ``ts_encode_plan`` picks one from the geometry
alone:

- ``onepass`` reads ``g`` once for all rows. Element i = j W + t has the
  same column t in every row, and for n_r <= W its bucket is
  (t mod W/n_r) * n_r + (the run of m_r / W blocks that holds block j in
  row r's rotation). A CTA owns 8 consecutive columns at every multiple of
  G_min = W / n_max, so it holds every contributor of its buckets; it walks
  the blocks once and reduces each bucket's columns in a fixed order where
  a run ends (shuffles, then per-warp partials in shared memory).
- ``rows`` (the R-pass kernel): one thread a (row, bucket) sums all of the
  bucket's contributors itself, reading ``g`` once per row. It takes the
  geometries ``onepass`` does not: G_min < 8 (small widths such as the
  CLI's default 16,384 at d ~ 4e8, and rows with n_r > W), more than 6 rows,
  n_max outside 16..512, or fewer one-pass CTAs than the card has SMs.

Neither uses atomics, so the sketch is bit-reproducible run to run. ``g``
is not padded to ``d_pad`` in memory: coordinates i >= d count as zero.

Bound on the H100: one read of ``g`` (d * itemsize bytes) and one write of
the (R, W) sketch, over 3.35 TB/s.

Tolerance: the kernel adds in another order than the plain version
(``core.ts_sketch.encode``, ``index_add_`` per row), so the two are held
to each other at 1e-4 * max|S| (see ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import ts_sketch as ts
from repro_torch.core.ts_sketch import TSketchConfig
from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES, resolve_dispatch, sm_count
from repro_torch.kernels.sketch_encode import DTYPE_CODES

# Mirrors csrc/ts_encode.cu.
ONEPASS_COLS = 8                  # consecutive columns a CTA owns per y
ONEPASS_ROWS = (2, 6)             # rows the one-pass kernel is built for
ONEPASS_NMAX_LOG = (4, 9)         # log2 n_max: 2 n_max threads a CTA
ROWS_THREADS = 256                # the R-pass kernel's CTA


@dataclasses.dataclass(frozen=True)
class TsEncodePlan:
    """Geometry of one TS encode launch (``ts_encode_plan``)."""

    kernel: str        # "onepass" | "rows"
    ctas: int
    threads: int
    smem: int          # dynamic shared memory of a CTA, bytes
    nmax_log: int      # log2 of the largest n_r of the rows


def _nmax_log(cfg: TSketchConfig) -> int:
    return max(cfg.bits - a for a in cfg.log_m)


def onepass_plan(cfg: TSketchConfig) -> TsEncodePlan | None:
    """The one-pass kernel's launch at this geometry, or None where it
    cannot run: CTAs own 8 columns at each multiple of G_min = W / n_max
    (so G_min >= 8), 2 n_max threads (16 <= n_max <= 512), 2..6 rows."""
    nl = _nmax_log(cfg)
    gmin_log = cfg.log2_width - nl
    if not (ONEPASS_ROWS[0] <= cfg.rows <= ONEPASS_ROWS[1]
            and ONEPASS_NMAX_LOG[0] <= nl <= ONEPASS_NMAX_LOG[1]
            and gmin_log >= 3 and cfg.bits <= 32):
        return None
    return TsEncodePlan(
        "onepass", ctas=(1 << gmin_log) // ONEPASS_COLS, threads=2 << nl,
        smem=4 * (ONEPASS_COLS * cfg.rows + 16) << nl, nmax_log=nl)


def rows_plan(cfg: TSketchConfig) -> TsEncodePlan:
    """The R-pass kernel's launch: one thread a (row, bucket)."""
    threads = min(cfg.width, ROWS_THREADS)
    return TsEncodePlan("rows", ctas=cfg.rows * (cfg.width // threads),
                        threads=threads, smem=0, nmax_log=_nmax_log(cfg))


def ts_encode_plan(cfg: TSketchConfig, sms: int) -> TsEncodePlan:
    """The kernel for this geometry on a card of ``sms`` SMs: the one-pass
    kernel where it runs and its grid fills the card (at least one CTA an
    SM), else the R-pass kernel."""
    plan = onepass_plan(cfg)
    if plan is not None and plan.ctas >= sms:
        return plan
    return rows_plan(cfg)


@functools.lru_cache(maxsize=64)
def row_params_on_device(cfg: TSketchConfig, device: str) -> torch.Tensor:
    """(R, 4) uint32 [log2 m, offset, sign c, sign d] as int32 on device."""
    p = np.stack([np.asarray(cfg.log_m, np.uint64),
                  np.asarray(cfg.offsets, np.uint64),
                  cfg.sign_params[:, 0].astype(np.uint64),
                  cfg.sign_params[:, 1].astype(np.uint64)], axis=1)
    return torch.from_numpy(
        np.ascontiguousarray(p.astype(np.uint32)).view(np.int32)).to(device)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("ts_encode")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ts_encode_launch.argtypes = [p, i64, i32, p, i32, i32, i32, p, p]
    lib.ts_encode_launch.restype = i32
    lib.ts_encode_onepass_launch.argtypes = [p, i64, i32, p, i32, i32, i32,
                                             i32, p, p]
    lib.ts_encode_onepass_launch.restype = i32
    return lib


def ts_encode_plain(cfg: TSketchConfig, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch TS encode (the oracle): ``core.ts_sketch.encode``."""
    return ts.encode(cfg, g)


def ts_encode(cfg: TSketchConfig, g: torch.Tensor,
              plan: TsEncodePlan | None = None) -> torch.Tensor:
    """TS-sketch encode ``g`` (any shape, at most ``d_pad`` elements) ->
    (rows, width) f32. CPU tensors run the plain version; other devices
    launch the kernel ``plan`` names (default ``ts_encode_plan``'s; see
    ``kernels.dispatch``)."""
    g = g.reshape(-1)
    if plan is not None and plan.kernel == "onepass" and (
            plan != onepass_plan(cfg)):
        raise ValueError(f"{plan} is not the one-pass plan of {cfg}")
    if not resolve_dispatch(g.device.type):
        return ts_encode_plain(cfg, g)
    lib = _lib()
    if g.device.type != "cuda":
        raise ValueError(f"ts_encode kernel needs a CUDA tensor, got "
                         f"{g.device}")
    if g.dtype not in DTYPE_CODES:
        raise TypeError(f"ts_encode takes f32/bf16/f16, got {g.dtype}")
    d = g.shape[0]
    if d > cfg.d_pad:
        raise ValueError(f"g has {d} coordinates; the config covers "
                         f"d_pad = {cfg.d_pad}")
    g = g.contiguous()
    out = torch.empty((cfg.rows, cfg.width), dtype=torch.float32,
                      device=g.device)
    if d == 0:
        return out.zero_()
    if plan is None:
        plan = ts_encode_plan(cfg, sm_count(g.device))
    rp = row_params_on_device(cfg, str(g.device))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    if plan.kernel == "onepass":
        rc = lib.ts_encode_onepass_launch(
            g.data_ptr(), d, DTYPE_CODES[g.dtype], rp.data_ptr(), cfg.rows,
            cfg.bits, cfg.log2_width, plan.nmax_log, out.data_ptr(), stream)
    else:
        rc = lib.ts_encode_launch(
            g.data_ptr(), d, DTYPE_CODES[g.dtype], rp.data_ptr(), cfg.rows,
            cfg.bits, cfg.log2_width, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ts_encode launch failed: cudaError {rc}")
    LAUNCHES["ts_encode"] += 1
    return out
