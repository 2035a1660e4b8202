"""Count-Sketch encode: CUDA kernel wrapper and its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/sketch_encode.py:sketch_encode``
(Pallas body ``_encode_kernel``, blocked signed one-hot matmuls — a design
forced by the TPU's lack of atomics and fast scatter). The Hopper kernel
(``csrc/sketch_encode.cu``) partitions the (element, row) pairs by sketch
tile (2^13 flat buckets, 32 KB) through device memory in coalesced runs,
then accumulates each tile in one CTA's shared memory and writes it once
(a sketch of few tiles splits each over several CTAs that add into a
zeroed output): random shared-memory atomics instead of random L2
atomics.

Bound on the H100: device memory sees one read of ``g`` (d * itemsize
bytes) and one write of the sketch, so the least time is those bytes over
3.35 TB/s; the kernel also writes and reads 6 bytes per (element, row)
and makes d * R shared-memory atomics.

Determinism: ranks and shared-memory adds land in a run-dependent order,
so on the card the sketch is not bit-reproducible. It is held to the
plain version within a tolerance relative to max|S| (see
``chip_smoke.py``). The plain version (``index_add_`` per row) is
deterministic and is what CPU tensors run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

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
ACC_WARPS = 16              # warps of an accumulating CTA (512 threads)
ACC_CTAS_PER_SM = 3         # accumulating CTAs an SM holds (512 threads, 40
#                             registers each on sm_90a)
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
                sms: int = H100_SMS) -> EncodePlan:
    """The kernel's tiles, block size, chunk and splits for an (R, 2^w)
    sketch of d elements on a card of ``sms`` SMs. Two binning CTAs fit an
    SM; the ranks and run starts are 16-bit, so a CTA stages at most
    65,535 entries. A pass takes at most CHUNK elements and SCRATCH_BYTES
    of scratch. A sketch of fewer tiles than the card holds accumulating
    CTAs gives each tile several CTAs, each with a share of the blocks. A
    (tile, block) run holds block * R / ntiles entries on average; a group
    of 32 runs is shared by one warp per 32 entries a run (up to the CTA's
    16 warps), so long runs keep every warp busy."""
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
    chunk = min(CHUNK, SCRATCH_BYTES // per_block * block, max(1, d))
    nblocks = -(-chunk // block)
    run = block * rows // ntiles
    return EncodePlan(rows=rows, ntiles=ntiles,
                      block=block, chunk=chunk, nblocks=nblocks,
                      bin_smem=fixed + stage * block * rows,
                      splits=max(1, min(nblocks,
                                        sms * ACC_CTAS_PER_SM // ntiles)),
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
                                         i32, i32, i64, i32, i32, i32, p, p, p,
                                         p]
    lib.sketch_encode_launch.restype = i32
    return lib


def sketch_encode_plain(cfg: SketchConfig, g: torch.Tensor,
                        index_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch encode (the oracle): ``index_add_`` per row."""
    return cs.encode(cfg, g, offset=index_offset)


def sketch_encode(cfg: SketchConfig, g: torch.Tensor, *,
                  index_offset: int = 0) -> torch.Tensor:
    """Count-Sketch encode ``g`` (any shape) -> (rows, width) f32 sketch.

    ``index_offset``: hash element j as coordinate index_offset + j.
    CPU tensors run the plain version; other devices launch the kernel
    (see ``kernels.dispatch``).
    """
    g = g.reshape(-1)
    if not resolve_dispatch(g.device.type):
        return sketch_encode_plain(cfg, g, index_offset)
    lib = _lib()
    if g.device.type != "cuda":
        raise ValueError(f"sketch_encode kernel needs a CUDA tensor, got "
                         f"{g.device}")
    if g.dtype not in DTYPE_CODES:
        raise TypeError(f"sketch_encode takes f32/bf16/f16, got {g.dtype}")
    g = g.contiguous()
    d = g.shape[0]
    if d == 0:
        return torch.zeros((cfg.rows, cfg.width), dtype=torch.float32,
                           device=g.device)
    plan = encode_plan(cfg.rows, cfg.log2_width, d, sm_count(g.device))
    # one accumulating CTA a tile writes each bucket once; several add
    # into zeros
    alloc = torch.zeros if plan.splits > 1 else torch.empty
    out = alloc((cfg.rows, cfg.width), dtype=torch.float32, device=g.device)
    n_entries = plan.nblocks * plan.entries
    off_s = torch.empty(n_entries, dtype=torch.int16, device=g.device)
    val_s = torch.empty(n_entries, dtype=torch.float32, device=g.device)
    desc_s = torch.empty(plan.nblocks * plan.ntiles, dtype=torch.int32,
                         device=g.device)
    hp = hash_on_device(cfg, str(g.device))
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = lib.sketch_encode_launch(
        g.data_ptr(), d, DTYPE_CODES[g.dtype], hp.data_ptr(), cfg.rows,
        cfg.log2_width, int(index_offset), out.data_ptr(), plan.ntiles,
        plan.block, plan.chunk, plan.splits, plan.group_warps, plan.bin_smem,
        off_s.data_ptr(), val_s.data_ptr(), desc_s.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sketch_encode launch failed: cudaError {rc}")
    LAUNCHES["sketch_encode"] += 1
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
