"""Exact top-k of |x| with ``jax.lax.top_k``'s tie order: CUDA radix
select and its plain PyTorch version.

Replaces ``jax.lax.top_k`` where the reference's HEAVYMIX takes it after
its kernels (``repro/core/heavymix.py:65, :88, :93``).
``topk_select(x, k, hist)`` returns what
``core.heavymix.topk_lower_index(x.abs(), k)`` returns: the k
largest |x|, values descending, ties broken by the lower index (for
non-negative keys, such as HEAVYMIX scores, |x| is x).

The ranking key is the bits of |x| (bit 31 cleared): for non-negative
floats, +0, subnormals and +inf included, integer order is value order,
and a NaN key ranks above +inf, as ``jax.lax.top_k`` ranks |NaN|.
Both versions run an MSD radix select over the 31 key bits in digits of
11, 11 and 9 bits (``csrc/radix_select.cuh``):

1. the histogram of digit 1 (bits 30..20), from the kernel that wrote the
   keys (``sketch_decode_hist``, ``heavymix_scores_hist``);
2. the bin that holds the k-th key, and how many keys equal to the prefix
   are still needed; digits 2 and 3 each count only the keys that match the
   prefix so far, so after digit 3 the k-th key v is exact;
3. every key above v wins, and the lowest-index keys equal to v fill the
   rest;
4. one sort of the k composites ``(0x7FFFFFFF - key) << 32 | index`` orders
   the winners as ``jax.lax.top_k`` returns them.

The CUDA kernels (``csrc/topk_select.cu``) do 2 and 3 on the card with no
host sync: the search results stay in a small device state, scratch is
sized from (n, grid) alone, and the output is always k composites. One pass
reads all n keys: after the digit-1 search it writes the keys above the
digit-1 bin, counts digit 2, and compacts the composites of each CTA's keys
in that bin, in index order, into the CTA's slab of ``slab_capacity``
slots (``torch.empty``, 8 bytes a slot): each of its 8 warps takes an
eighth of the chunk and an eighth of the slab, a segment, with no CTA
barrier. Digit 3, the keys above the k-th key and the ties then read only
the slabs. A segment whose bin keys outnumber its slots is read from x in
those passes instead, and each CTA with such a segment adds one to a
device counter (``slab_overflows`` reads it, with a host sync, after the
timed work). Where the bin holds more keys than all the slabs together
(decided on the card from the first digit's histogram), the slabs are off
and every CTA reads x in those passes, as the three full passes of the
first design did; the counter then counts every CTA. Bound on the H100: one read of x plus k composites written,
over 3.35 TB/s. A caller with keys but no histogram (the compressor
baselines) would need the select to count digit 1 itself; none calls it
yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dispatch import LAUNCHES, resolve_dispatch, sm_count

RADIX_BINS = 2048   # digit 1: key bits 30..20
RADIX_SHIFT = 20
_DIGITS = ((11, 2048), (9, 512))  # digits 2 and 3: (bits, bins)
_KEY_MASK = 0x7FFFFFFF
_TILE = 1024        # elements a CTA takes a step (csrc kTile)
_CTAS_PER_SM = 8
_SLAB_SHARE = 2     # a CTA's slab holds 1/2 of its chunk
_SEGMENTS = 8       # a CTA's segments, one a warp (csrc kWarps)

_OVERFLOWS: dict[torch.device, torch.Tensor] = {}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("topk_select")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.topk_select_launch.argtypes = [p, i64, i64, p, i32, i64, p, p, i64,
                                       p, p, p]
    lib.topk_select_launch.restype = i32
    lib.topk_select_scratch_words.argtypes = []
    lib.topk_select_scratch_words.restype = i32
    return lib


def key_bits(x: torch.Tensor) -> torch.Tensor:
    """The ranking key of every element of f32 ``x``: the bits of |x| as
    int32 (non-negative)."""
    return x.reshape(-1).contiguous().view(torch.int32) & _KEY_MASK


def radix_hist_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused kernels' histogram: (2048,) int32 counts
    of key bits 30..20 of ``x``."""
    return torch.bincount(key_bits(x) >> RADIX_SHIFT,
                          minlength=RADIX_BINS).to(torch.int32)


def select_plan(n: int, sms: int) -> tuple[int, int]:
    """(CTAs, elements a CTA) of the select's passes over n keys on a card
    of ``sms`` SMs: at most 8 CTAs an SM, each a contiguous chunk, a
    multiple of 1024."""
    tiles = max(1, -(-int(n) // _TILE))
    chunk = -(-tiles // min(tiles, _CTAS_PER_SM * sms)) * _TILE
    return max(1, -(-int(n) // chunk)), chunk


def slab_capacity(chunk: int) -> int:
    """Slots of a CTA's slab: half its chunk, a multiple of 32 (each of its
    8 segments gets a multiple of 4). On the TS route's real scores the
    heavy keys (all in the first digit's bin) bunch up: with an eighth of
    the chunk, 6,234 CTAs overflowed over the 12 selects of
    ``chip_smoke.py``'s ``train_ts`` (NVIDIA H100 80GB HBM3, 700 W). The
    slots cost 4 bytes a key, freed after the call; the optimizer, not the
    recovery, sets the step's peak memory."""
    return int(chunk) // _SLAB_SHARE // (4 * _SEGMENTS) * (4 * _SEGMENTS)


def _overflow_counter(device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counter = _OVERFLOWS.get(device)
    if counter is None:
        counter = _OVERFLOWS[device] = torch.zeros(1, dtype=torch.int32,
                                                   device=device)
    return counter


def slab_overflows(device: torch.device, reset: bool = False) -> int:
    """The select's CTAs on ``device`` with an overflowed segment since the
    last reset (a host sync: read it after the timed work); ``reset`` zeroes
    the count after reading it."""
    counter = _overflow_counter(torch.device(device))
    n = int(counter.item())
    if reset:
        counter.zero_()
    return n


def _unpack(comp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted composites -> (values f32, indices int64)."""
    vals = (_KEY_MASK - (comp >> 32)).to(torch.int32).view(torch.float32)
    return vals, comp & 0xFFFFFFFF


def _order(keys: torch.Tensor, idx: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selected (key bits, index) pairs in ``jax.lax.top_k``'s order."""
    comp = ((_KEY_MASK - keys.to(torch.int64)) << 32) | idx
    return _unpack(torch.sort(comp).values)


def _search(hist: torch.Tensor, need: int) -> tuple[int, int]:
    """The bin, counted from the top, that holds the need-th largest key,
    and how many of its keys are needed."""
    above = torch.flip(hist.to(torch.int64), [0]).cumsum(0)
    j = int(torch.searchsorted(above, need))
    return hist.shape[0] - 1 - j, need - (int(above[j - 1]) if j else 0)


def topk_select_plain(x: torch.Tensor, k: int, hist: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch radix select (the oracle): the same digit passes as
    the kernels, from digit 1's histogram ``hist``, with torch ops and
    host reads."""
    x = x.reshape(-1)
    n, k = x.shape[0], int(k)
    u = key_bits(x)
    if k >= n:
        return _order(u, torch.arange(n, device=x.device))
    if k <= 0:
        return _unpack(torch.empty(0, dtype=torch.int64, device=x.device))
    prefix, need = _search(hist, k)
    shift = RADIX_SHIFT
    for bits, bins in _DIGITS:
        shift -= bits
        sub = u[(u >> (shift + bits)) == prefix]
        b, need = _search(torch.bincount((sub >> shift) & (bins - 1),
                                         minlength=bins), need)
        prefix = (prefix << bits) | b
    above = torch.nonzero(u > prefix).reshape(-1)
    ties = torch.nonzero(u == prefix).reshape(-1)[:need]
    sel = torch.cat([above, ties])
    return _order(u[sel], sel)


def topk_select(x: torch.Tensor, k: int, hist: torch.Tensor,
                capacity: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(|x|, k)``: (values (k,) f32 descending, indices (k,)
    int64), ties to the lower index, NaN first. ``x``: (n,) f32. ``hist``:
    the (2048,) int32 histogram of key bits 30..20 from the kernel that
    wrote ``x`` (``sketch_decode_hist``, ``heavymix_scores_hist``).
    ``capacity``: slots of a CTA's slab (a multiple of 32; default
    ``slab_capacity`` of the plan's chunk); smaller ones make segments
    overflow and read their keys in x, and select the same.

    CPU tensors run the plain version; other devices launch the kernels,
    with no host sync (see ``kernels.dispatch``). k >= n selects
    everything and launches nothing.
    """
    if capacity is not None and (capacity < 0
                                 or capacity % (4 * _SEGMENTS)):
        raise ValueError(f"topk_select: capacity {capacity} is not a "
                         f"non-negative multiple of {4 * _SEGMENTS}")
    if not resolve_dispatch(x.device.type):
        return topk_select_plain(x, k, hist)
    if x.device.type != "cuda":
        raise ValueError(f"topk_select kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"topk_select takes a 1-d f32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, k = x.shape[0], int(k)
    if n >= 1 << 32:
        raise ValueError(f"topk_select: n = {n} needs 32-bit indices")
    if k >= n:
        return _order(key_bits(x), torch.arange(n, device=x.device))
    if k <= 0:
        return _unpack(torch.empty(0, dtype=torch.int64, device=x.device))
    if (hist.dtype != torch.int32 or tuple(hist.shape) != (RADIX_BINS,)
            or hist.device != x.device):
        raise ValueError("topk_select: hist must be (2048,) int32 on the "
                         "keys' device")
    lib = _lib()
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()   # the kernels load 16 bytes a thread
    grid, chunk = select_plan(n, sm_count(x.device))
    cap = slab_capacity(chunk) if capacity is None else int(capacity)
    scratch = torch.zeros(lib.topk_select_scratch_words()
                          + (1 + _SEGMENTS) * grid,
                          dtype=torch.int32, device=x.device)
    slabs = torch.empty(grid * cap, dtype=torch.int64, device=x.device)
    comp = torch.empty(k, dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.topk_select_launch(
        x.data_ptr(), n, k, hist.data_ptr(), grid, chunk, scratch.data_ptr(),
        slabs.data_ptr(), cap, _overflow_counter(x.device).data_ptr(),
        comp.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"topk_select launch failed: cudaError {rc}")
    LAUNCHES["topk_select"] += 1
    return _unpack(torch.sort(comp).values)
