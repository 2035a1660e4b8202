"""HEAVYMIX decode + scores: CUDA kernel wrapper and its plain version.

Replaces the TPU kernel ``repro/kernels/heavymix_topk.py:heavymix_scores``
(Pallas body ``_scores_kernel``). For every coordinate i < d:

    est_i   = median_r sign_r(i) * S[r, h_r(i)]   (even R: mean of middles)
    heavy_i = est_i^2 >= thr                      (thr = ||U||^2 / k)
    score_i = |est_i| + 1e30 * heavy_i

or, with ``filler`` (HEAVYMIX's faithful fill: ``(d,)`` f32 priorities,
uniform in [0, 1)), ``score_i = filler[i]`` for a coordinate that is not
heavy, as the reference's ``jnp.where(heavy, |est| + 1e30, filler)``.

The Hopper kernel (``csrc/heavymix_scores.cu``) gives each coordinate one
thread: R gathers from the L2-resident sketch, a sort network in
registers over 8 or 32 slots (R up to 32), then both outputs. Bound on the
H100: writing ``scores`` and ``est`` (8 * d bytes) plus one read of the
(R, W) sketch, over 3.35 TB/s.

``thresh`` is a one-element f32 tensor on the sketch's device
(``l2sq_estimate(S) / k`` computed in torch), so no host sync reads it.
The top-k over the scores runs after the kernel, as in the reference
(``kernels/ops.py`` ``heavymix_recover``), so each CTA of the kernel also
counts key bits 30..20 of the scores (the first digit of
``kernels/topk_select.py``'s radix select) into one (2048,) int32
histogram. ``heavymix_scores_hist`` returns it; ``heavymix_scores`` (the
reference's API) launches the same kernel and drops it.

``heavymix_scores_ts_hist`` is the same kernel with the TS-sketch's bucket
and sign map in place of the multiply-shift hashes: the TS route's recovery
(the reference's ``ts.decode`` followed by ``heavymix(..., estimates=)``,
which boosts and ranks at every d). Its plain version is
``core.ts_sketch.decode`` and the reference's ``torch.where``; it counts as
``LAUNCHES["heavymix_scores_ts"]``. Row r of a TS sketch, seen as a
(P_r, n_r) matrix (P_r = W / n_r, n_r = d_pad / m_r), is read a column at
a time: coordinate i reads element (i mod P_r, q_r(i)), and q_r changes
once in m_r coordinates. So on the card ``ts_transpose`` first writes the
row-transposed copy (rows with 1 < n_r < W as (n_r, P_r); its own kernel,
``LAUNCHES["ts_transpose"]``, into a ``torch.empty`` scratch), and the
scores kernel reads it through ``TsMapT`` (``csrc/ts_map.cuh``), where
neighbouring coordinates read neighbouring floats of every row. The row
parameters are ``kernels/ts_encode.row_params_on_device``'s.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import count_sketch as cs
from repro_torch.core import ts_sketch as ts
from repro_torch.core.count_sketch import SketchConfig
from repro_torch.core.heavymix import _BIG, _CHUNK
from repro_torch.core.ts_sketch import TSketchConfig
from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES, resolve_dispatch, sm_count
from repro_torch.kernels.sketch_encode import hash_on_device
from repro_torch.kernels.topk_select import RADIX_BINS, radix_hist_plain
from repro_torch.kernels.ts_encode import row_params_on_device


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("heavymix_scores")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.heavymix_scores_launch.argtypes = [p, i64, p, i32, i32, p, p, i64,
                                           p, p, p, i32, p]
    lib.heavymix_scores_launch.restype = i32
    lib.heavymix_scores_ts_launch.argtypes = [p, i32, p, i32, i32, p, p,
                                              i64, p, p, p, i32, p]
    lib.heavymix_scores_ts_launch.restype = i32
    return lib


def _fill(scores: torch.Tensor, est: torch.Tensor, thr: torch.Tensor,
          filler: torch.Tensor | None) -> torch.Tensor:
    """The faithful fill's scores: ``filler`` where not heavy."""
    if filler is None:
        return scores
    return torch.where(est * est >= thr, scores, filler.to(torch.float32))


def heavymix_scores_plain(cfg: SketchConfig, sketch: torch.Tensor,
                          thresh: torch.Tensor, d: int,
                          filler: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (the oracle), chunked over coordinates."""
    sk = sketch.to(torch.float32)
    thr = thresh.reshape(()).to(torch.float32)
    scores = torch.empty((d,), dtype=torch.float32, device=sk.device)
    est = torch.empty((d,), dtype=torch.float32, device=sk.device)
    for lo in range(0, d, _CHUNK):
        hi = min(d, lo + _CHUNK)
        e = cs.decode_at(cfg, sk, torch.arange(lo, hi, device=sk.device))
        est[lo:hi] = e
        heavy = (e * e >= thr).to(torch.float32)
        scores[lo:hi] = _fill(torch.abs(e) + _BIG * heavy, e, thr,
                              None if filler is None else filler[lo:hi])
    return scores, est


def heavymix_scores(cfg: SketchConfig, sketch: torch.Tensor,
                    thresh: torch.Tensor, d: int,
                    filler: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores (d,), estimates (d,)) for HEAVYMIX selection (greedy, or
    faithful with ``filler``)."""
    if not resolve_dispatch(sketch.device.type):
        return heavymix_scores_plain(cfg, sketch, thresh, d, filler)
    return _launch(cfg, sketch, thresh, int(d), filler=filler)[:2]


def heavymix_scores_hist(cfg: SketchConfig, sketch: torch.Tensor,
                         thresh: torch.Tensor, d: int,
                         filler: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores, estimates, the (2048,) int32 histogram of key bits 30..20
    of the scores) for ``kernels.topk_select``; one launch on the card."""
    if not resolve_dispatch(sketch.device.type):
        scores, est = heavymix_scores_plain(cfg, sketch, thresh, d, filler)
        return scores, est, radix_hist_plain(scores)
    return _launch(cfg, sketch, thresh, int(d), filler=filler)


def heavymix_scores_ts_plain(tcfg: TSketchConfig, sketch: torch.Tensor,
                             thresh: torch.Tensor, d: int,
                             filler: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the TS-map scores: ``ts.decode``, then the
    reference's boost (``core.heavymix.heavymix(..., estimates=)``)."""
    est = ts.decode(tcfg, sketch, d)
    thr = thresh.reshape(()).to(torch.float32)
    heavy = est * est >= thr
    scores = torch.where(heavy, torch.abs(est) + _BIG, torch.abs(est))
    return _fill(scores, est, thr, filler), est


def _row_shape(tcfg: TSketchConfig, r: int) -> tuple[int, int] | None:
    """(P_r, n_r) of row r where 1 < n_r < W (the rows ``ts_transpose``
    transposes), else None."""
    n = 1 << (tcfg.bits - tcfg.log_m[r])
    return (tcfg.width // n, n) if 1 < n < tcfg.width else None


def ts_transpose_plain(tcfg: TSketchConfig, sketch: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of the transpose: row r as ``view(P_r, n_r).T`` where
    1 < n_r < W, the other rows as they are; (R, W) f32."""
    sk = sketch.to(torch.float32)
    rows = []
    for r in range(tcfg.rows):
        shape = _row_shape(tcfg, r)
        rows.append(sk[r] if shape is None
                    else sk[r].view(shape).T.reshape(-1))
    return torch.stack(rows)


def ts_transpose(tcfg: TSketchConfig, sketch: torch.Tensor) -> torch.Tensor:
    """The row-transposed copy of a TS sketch that the TS-map scores kernel
    reads; one launch on the card."""
    if not resolve_dispatch(sketch.device.type):
        return ts_transpose_plain(tcfg, sketch)
    lib = _lib()
    if sketch.device.type != "cuda":
        raise ValueError(f"ts_transpose kernel needs a CUDA tensor, got "
                         f"{sketch.device}")
    if tuple(sketch.shape) != (tcfg.rows, tcfg.width):
        raise ValueError(f"sketch shape {tuple(sketch.shape)} != "
                         f"{(tcfg.rows, tcfg.width)}")
    sk = sketch.to(torch.float32).contiguous()
    out = torch.empty_like(sk)
    rp = row_params_on_device(tcfg, str(sk.device))
    launch = lib.ts_transpose_launch
    p, i32 = ctypes.c_void_p, ctypes.c_int
    launch.argtypes = [p, i32, p, i32, i32, p, p]
    launch.restype = i32
    rc = launch(
        sk.data_ptr(), tcfg.log2_width, rp.data_ptr(), tcfg.rows, tcfg.bits,
        out.data_ptr(), torch.cuda.current_stream(sk.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ts_transpose launch failed: cudaError {rc}")
    LAUNCHES["ts_transpose"] += 1
    return out


def heavymix_scores_ts_hist(tcfg: TSketchConfig, sketch: torch.Tensor,
                            thresh: torch.Tensor, d: int,
                            filler: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(scores, estimates, histogram of key bits 30..20 of the scores) of
    the coordinates [0, d) of a TS sketch; on the card two launches, the
    transpose and the scores kernel."""
    if not resolve_dispatch(sketch.device.type):
        scores, est = heavymix_scores_ts_plain(tcfg, sketch, thresh, d,
                                               filler)
        return scores, est, radix_hist_plain(scores)
    if tcfg.bits > 32 or d > tcfg.d_pad:
        raise ValueError(f"heavymix_scores_ts: d = {d} with d_pad = "
                         f"{tcfg.d_pad} (at most 2^32)")
    return _launch(tcfg, ts_transpose(tcfg, sketch), thresh, int(d),
                   ts_map=True, filler=filler)


def _launch(cfg, sketch: torch.Tensor, thresh: torch.Tensor, d: int, *,
            ts_map: bool = False, filler: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    lib = _lib()
    if sketch.device.type != "cuda":
        raise ValueError(f"heavymix_scores kernel needs a CUDA tensor, got "
                         f"{sketch.device}")
    if tuple(sketch.shape) != (cfg.rows, cfg.width):
        raise ValueError(f"sketch shape {tuple(sketch.shape)} != "
                         f"{(cfg.rows, cfg.width)}")
    sk = sketch.to(torch.float32).contiguous()
    thr = thresh.to(device=sk.device, dtype=torch.float32).reshape(1)
    thr = thr.contiguous()
    if filler is not None:
        if (filler.dtype != torch.float32 or tuple(filler.shape) != (d,)
                or filler.device != sk.device):
            raise ValueError(f"filler must be ({d},) float32 on {sk.device}, "
                             f"got {filler.dtype} {tuple(filler.shape)} on "
                             f"{filler.device}")
        filler = filler.contiguous()
    fl = None if filler is None else filler.data_ptr()
    scores = torch.empty((d,), dtype=torch.float32, device=sk.device)
    est = torch.empty((d,), dtype=torch.float32, device=sk.device)
    hist = torch.zeros(RADIX_BINS, dtype=torch.int32, device=sk.device)
    if d == 0:
        return scores, est, hist
    stream = torch.cuda.current_stream(sk.device).cuda_stream
    sms = sm_count(sk.device)
    if ts_map:
        rp = row_params_on_device(cfg, str(sk.device))
        rc = lib.heavymix_scores_ts_launch(
            sk.data_ptr(), cfg.log2_width, rp.data_ptr(), cfg.rows, cfg.bits,
            thr.data_ptr(), fl, d, scores.data_ptr(), est.data_ptr(),
            hist.data_ptr(), sms, stream)
    else:
        hp = hash_on_device(cfg, str(sk.device))
        rc = lib.heavymix_scores_launch(
            sk.data_ptr(), cfg.width, hp.data_ptr(), cfg.rows,
            32 - cfg.log2_width, thr.data_ptr(), fl, d, scores.data_ptr(),
            est.data_ptr(), hist.data_ptr(), sms, stream)
    if rc != 0:
        raise RuntimeError(f"heavymix_scores launch failed: cudaError {rc}")
    LAUNCHES["heavymix_scores_ts" if ts_map else "heavymix_scores"] += 1
    return scores, est, hist
