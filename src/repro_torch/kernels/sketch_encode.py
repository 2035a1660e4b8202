"""Count-Sketch encode: CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/sketch_encode.py:sketch_encode``
(Pallas body ``_encode_kernel``, blocked signed one-hot matmuls — a design
forced by the TPU's lack of atomics and fast scatter). The Hopper kernel
(``csrc/sketch_encode.cu``) partitions the (element, row) pairs by sketch
tile (2^13 flat buckets, 32 KB) through device memory in coalesced runs,
then accumulates each tile in one CTA's shared memory and writes it once
(a sketch of few tiles splits each over several CTAs that add into the
same accumulator): random shared-memory atomics instead of random L2
atomics.

Exact: every value is added as a three-limb fixed-point integer
(``core/count_sketch.py``, ``ExactSketch``), so the sums do not depend on
the order of the adds; one finish kernel (``sketch_encode_finish``)
rounds each cell to f32 once. The kernel is bit-equal to its plain
version (``cs.encode``) for any launch geometry, and the accumulators of
offset fragments sum to the whole vector's, bit for bit.

Bound on the H100: device memory sees one read of ``g`` (d * itemsize
bytes) and one write of the sketch, so the least time is those bytes over
3.35 TB/s; the kernel also writes and reads 6 bytes per (element, row),
makes up to 3 u64 shared-memory atomics per (element, row), and writes and
reads the 28-byte accumulator a cell.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core import count_sketch as cs
from repro_torch.core.count_sketch import SketchConfig
from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES, resolve_dispatch, sm_count

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Mirrors csrc/sketch_encode.cu.
TILE_LOG = 13               # a tile: 2^13 flat buckets (32 KB) of the sketch
MAX_ROWS = 64
SMEM_PER_SM = 232_448       # the H100's shared memory a block can use
CHUNK = 1 << 25             # elements binned per pass, at most
SCRATCH_BYTES = 1 << 30     # off/val/descriptor scratch of a pass, at most
MAX_BLOCK = 2048            # elements a binning CTA takes
MAX_TILES = 1 << 14         # R * W <= 2^27
REG_ROWS = 8                # up to 8 rows the binning ranks stay in registers
ACC_WARPS = 16              # warps a team of an accumulating CTA (1,024
#                             threads: 32 warps) takes at most
ACC_CTAS_PER_SM = 3         # accumulating CTAs the splits give an SM (one
#                             resident at a time: 128 KB of 128-bit sums)
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class EncodePlan:
    """Geometry of one encode launch (``encode_plan``)."""

    rows: int
    ntiles: int        # ceil(R * W / 2^13) tiles
    block: int         # elements per binning CTA
    chunk: int         # elements per bin + accumulate pass
    nblocks: int       # binning CTAs in the largest pass
    bin_smem: int      # dynamic shared memory of a binning CTA, bytes
    splits: int        # accumulating CTAs a tile (each a share of the blocks)
    group_warps: int   # warps that share a group of 32 blocks' runs

    @property
    def entries(self) -> int:
        """Staging entries of a binning CTA: one per (element, row)."""
        return self.block * self.rows

    @property
    def scratch_bytes(self) -> int:
        """Device scratch of a pass: 2 + 4 bytes an entry, 4 a descriptor."""
        return self.nblocks * (6 * self.entries + 4 * self.ntiles)


def encode_plan(rows: int, log2_width: int, d: int,
                sms: int = H100_SMS, *, splits: int | None = None,
                chunk: int | None = None) -> EncodePlan:
    """The kernel's tiles, block size, chunk and splits for an (R, 2^w)
    sketch of d elements on a card of ``sms`` SMs. Two binning CTAs fit an
    SM; the ranks and run starts are 16-bit, so a CTA stages at most
    65,535 entries. A pass takes at most CHUNK elements and SCRATCH_BYTES
    of scratch. A sketch of fewer tiles than the card holds accumulating
    CTAs gives each tile several CTAs, each with a share of the blocks. A
    (tile, block) run holds block * R / ntiles entries on average; a group
    of 32 runs is shared by one warp per 32 entries a run (up to 16
    warps), so long runs keep every warp busy. ``splits`` and ``chunk``
    override the plan's (the exact sums do not depend on either)."""
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"sketch_encode kernel takes 1..{MAX_ROWS} rows, "
                         f"got {rows}")
    ntiles = -(-(rows << log2_width) // (1 << TILE_LOG))
    fixed = 4 * (ntiles + 4 * rows + 32)
    # a staged pair: an 8-byte (offset, value), and a 2-byte rank when the
    # ranks do not fit in registers
    stage = 8 if rows <= REG_ROWS else 10
    room = min(65_535, (SMEM_PER_SM // 2 - fixed) // stage) // rows
    if ntiles > MAX_TILES or room < 1:
        raise ValueError(f"sketch of {rows} x 2^{log2_width} buckets has "
                         f"{ntiles} tiles: too many for the kernel")
    block = min(MAX_BLOCK, 1 << (room.bit_length() - 1))
    per_block = 6 * block * rows + 4 * ntiles
    limit = min(CHUNK, SCRATCH_BYTES // per_block * block)
    if chunk is not None:
        if not 1 <= chunk <= limit or chunk % block:
            raise ValueError(f"chunk {chunk} must be a multiple of the "
                             f"block {block} in [1, {limit}]")
    chunk = min(limit, max(1, d)) if chunk is None else chunk
    nblocks = -(-chunk // block)
    run = block * rows // ntiles
    if splits is None:
        splits = max(1, min(nblocks, sms * ACC_CTAS_PER_SM // ntiles))
    return EncodePlan(rows=rows, ntiles=ntiles,
                      block=block, chunk=chunk, nblocks=nblocks,
                      bin_smem=fixed + stage * block * rows,
                      splits=int(splits),
                      group_warps=min(ACC_WARPS, 1 << max(
                          0, (run // 32).bit_length() - 1)))


@functools.lru_cache(maxsize=64)
def hash_on_device(cfg: SketchConfig, device: str) -> torch.Tensor:
    """``cfg.hash_params`` (uint32 bits, as int32) on ``device``."""
    return torch.from_numpy(
        np.ascontiguousarray(cfg.hash_params).view(np.int32)).to(device)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("sketch_encode")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sketch_encode_launch.argtypes = [p, i64, i32, p, i32, i32, i64, p,
                                         p, i32, i32, i64, i32, i32, i32, p,
                                         p, p, p]
    lib.sketch_encode_launch.restype = i32
    lib.sketch_encode_finish_launch.argtypes = [p, p, i64, i64, p, i32, p]
    lib.sketch_encode_finish_launch.restype = i32
    return lib


def sketch_encode_plain(cfg: SketchConfig, g: torch.Tensor,
                        index_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch encode (the oracle): ``cs.encode``, exact."""
    return cs.encode(cfg, g, offset=index_offset)


def sketch_encode_into_plain(cfg: SketchConfig, g: torch.Tensor,
                             acc: cs.ExactSketch,
                             index_offset: int = 0) -> cs.ExactSketch:
    """Plain version of ``sketch_encode_into``: ``cs.encode_into``."""
    return cs.encode_into(cfg, g, acc, offset=index_offset)


def sketch_encode_finish_plain(acc: cs.ExactSketch) -> torch.Tensor:
    """Plain version of ``sketch_encode_finish``: ``cs.finish``."""
    return cs.finish(acc)


def sketch_encode(cfg: SketchConfig, g: torch.Tensor, *,
                  index_offset: int = 0,
                  plan: EncodePlan | None = None) -> torch.Tensor:
    """Count-Sketch encode ``g`` (any shape) -> (rows, width) f32 sketch.

    ``index_offset``: hash element j as coordinate index_offset + j.
    CPU tensors run the plain version; other devices launch the kernel
    (see ``kernels.dispatch``): the accumulate, counted as
    ``sketch_encode``, then the finish, a launch of its own counted as
    ``sketch_encode_finish``. ``plan`` overrides the launch geometry
    (tests).
    """
    g = g.reshape(-1)
    if not resolve_dispatch(g.device.type):
        return sketch_encode_plain(cfg, g, index_offset)
    acc = cs.exact_zeros(cfg, device=g.device)
    _accumulate(cfg, g, acc, int(index_offset), plan)
    LAUNCHES["sketch_encode"] += 1
    return sketch_encode_finish(acc)


def sketch_encode_into(cfg: SketchConfig, g: torch.Tensor,
                       acc: cs.ExactSketch, *, index_offset: int = 0,
                       plan: EncodePlan | None = None) -> cs.ExactSketch:
    """Add the exact encode of ``g`` into one worker's exact sketch
    ``acc`` (limbs (3, R, W), flags (R, W)), in place; returns ``acc``.
    The fused interleave's partial encode: the finish comes once, after
    the bucket's fragments (``sketch_encode_finish``)."""
    g = g.reshape(-1)
    if not resolve_dispatch(g.device.type):
        return sketch_encode_into_plain(cfg, g, acc, index_offset)
    _accumulate(cfg, g, acc, int(index_offset), plan)
    LAUNCHES["sketch_encode"] += 1
    return acc


def sketch_encode_finish(acc: cs.ExactSketch) -> torch.Tensor:
    """The f32 sketch(es) of an exact sketch with any leading dims: one
    launch of the finish kernel on the card."""
    if not resolve_dispatch(acc.device.type):
        return sketch_encode_finish_plain(acc)
    out = _finish(acc)
    LAUNCHES["sketch_encode_finish"] += 1
    return out


def _check_acc(acc: cs.ExactSketch, lead: tuple, rows: int, width: int):
    if (acc.limbs.dtype != torch.int64 or acc.flags.dtype != torch.int32
            or tuple(acc.limbs.shape) != lead + (3, rows, width)
            or tuple(acc.flags.shape) != lead + (rows, width)
            or not acc.limbs.is_contiguous()
            or not acc.flags.is_contiguous()):
        raise ValueError(
            f"exact sketch must be contiguous int64 limbs "
            f"{lead + (3, rows, width)} and int32 flags "
            f"{lead + (rows, width)}; got {acc.limbs.dtype} "
            f"{tuple(acc.limbs.shape)}, "
            f"{acc.flags.dtype} {tuple(acc.flags.shape)}")


def _accumulate(cfg: SketchConfig, g: torch.Tensor, acc: cs.ExactSketch,
                index_offset: int, plan: EncodePlan | None) -> None:
    lib = _lib()
    if g.device.type != "cuda":
        raise ValueError(f"sketch_encode kernel needs a CUDA tensor, got "
                         f"{g.device}")
    if acc.device != g.device:
        raise ValueError(f"exact sketch on {acc.device}, g on {g.device}")
    if g.dtype not in DTYPE_CODES:
        raise TypeError(f"sketch_encode takes f32/bf16/f16, got {g.dtype}")
    _check_acc(acc, (), cfg.rows, cfg.width)
    g = g.contiguous()
    d = g.shape[0]
    if d == 0:
        return
    if plan is None:
        plan = encode_plan(cfg.rows, cfg.log2_width, d, sm_count(g.device))
    n_entries = plan.nblocks * plan.entries
    off_s = torch.empty(n_entries, dtype=torch.int16, device=g.device)
    val_s = torch.empty(n_entries, dtype=torch.float32, device=g.device)
    desc_s = torch.empty(plan.nblocks * plan.ntiles, dtype=torch.int32,
                         device=g.device)
    hp = hash_on_device(cfg, str(g.device))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = lib.sketch_encode_launch(
        g.data_ptr(), d, DTYPE_CODES[g.dtype], hp.data_ptr(), cfg.rows,
        cfg.log2_width, index_offset, acc.limbs.data_ptr(),
        acc.flags.data_ptr(), plan.ntiles, plan.block, plan.chunk,
        plan.splits, plan.group_warps, plan.bin_smem, off_s.data_ptr(),
        val_s.data_ptr(), desc_s.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sketch_encode launch failed: cudaError {rc}")


def _finish(acc: cs.ExactSketch) -> torch.Tensor:
    lib = _lib()
    if acc.device.type != "cuda":
        raise ValueError(f"sketch_encode_finish kernel needs a CUDA tensor, "
                         f"got {acc.device}")
    lead = tuple(acc.limbs.shape[:-3])
    rows, width = acc.limbs.shape[-2:]
    _check_acc(acc, lead, rows, width)
    out = torch.empty(lead + (rows, width), dtype=torch.float32,
                      device=acc.device)
    rc = lib.sketch_encode_finish_launch(
        acc.limbs.data_ptr(), acc.flags.data_ptr(), rows * width,
        math.prod(lead), out.data_ptr(), sm_count(acc.device),
        torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sketch_encode_finish launch failed: "
                           f"cudaError {rc}")
    return out


def sketch_encode_bucketed(cfgs, g: torch.Tensor, sizes) -> tuple:
    """Per-bucket encode of a flat vector: one launch per bucket."""
    g = g.reshape(-1)
    sizes = tuple(int(s) for s in sizes)
    if sum(sizes) != g.shape[0]:
        raise ValueError(
            f"bucket sizes {sizes} must sum to the flat gradient "
            f"dimension {g.shape[0]}")
    out, off = [], 0
    for cfg, s in zip(cfgs, sizes):
        out.append(sketch_encode(cfg, g[off:off + s]))
        off += s
    return tuple(out)
