// Exact top-k selection for Hopper (sm_90a): the k largest |x| of a float
// vector, ties to the lower index, with no host round trip.
//
// Replaces jax.lax.top_k where the reference's HEAVYMIX takes it after its
// kernels (src/repro/core/heavymix.py:65, :88, :93). It selects what
// jax.lax.top_k selects; the caller orders the k winners as it returns
// them with one sort of (~key << 32 | index) composites, which this kernel
// writes (kernels/topk_select.py).
//
// Design: MSD radix select over the 31 key bits (radix_select.cuh) in
// digits of 11, 11 and 9 bits. The first digit's histogram comes from the
// kernel that wrote the keys (sketch_decode.cu, heavymix_scores.cu). Each
// digit then has a 1-CTA search from the top bin, which keeps the prefix
// found so far and how many keys equal to it are still needed in a 4-word
// device state. Every CTA owns one contiguous chunk of x.
//
// One pass reads all n keys: the first pass, after the digit-1 search.
// Each warp takes an eighth of its CTA's chunk (a segment) on its own: it
// writes every key above the digit-1 bin b1 (fewer than k) to the output
// through one global cursor, counts digit 2 of the keys in b1 and compacts
// their composites, in index order, into the segment's slab (cap / 8 of
// the CTA's cap slots at a fixed offset; a key's slot from its warp's
// running count and a ballot, with no barrier). After it, only the slabs
// are read: the digit-3 count, the output of the keys above the k-th key
// v (all in b1) and the tie pass, which lets only the CTAs whose ties at v
// rank below `need` (by the sum of the lower CTAs' counts) write those
// ties, segment by segment in index order: the lowest-index ties win, as
// in jax.lax.top_k. A segment whose b1 keys outnumber its slots marks it
// (its count stays above them; each CTA with such a segment adds one to a
// device counter the caller reads later) and is read from x in those
// three passes instead, as the full passes did. Where b1 holds more keys
// than all the slabs together (the TS route's scores at W = 16,384, where
// most keys tie at 1e30), the slabs are off: the first pass only counts
// digit 2 and the later passes read x, the output pass writing every key
// above v, as the parent's three full passes did (filling slabs that
// overflow anyway cost more than the passes they save). Scratch and slabs are fixed by (n, grid,
// cap): nothing is sized from device data.
// Bound: one read of x (4n bytes) and k 8-byte composites written; the
// kernel reads x once, plus the keys of overflowed segments three more
// times, and writes and reads back the b1 keys' composites (8 bytes each);
// its 1-CTA searches and 7 launches add a few microseconds each.

#include "radix_select.cuh"

namespace {

using radix_select::key_bits;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // a CTA's segments: one a warp
constexpr int kTile = 4 * kThreads;    // keys a CTA takes a step
constexpr int kSub = 4;                // runs of 32 keys a warp loads at once
constexpr int kStage = 2 * kTile;      // composites staged a CTA
constexpr int kWarpStage = kStage / kWarps;  // ... a warp (first pass)
constexpr int kDepth = 8;              // tiles a tie CTA loads at once

// Scratch words (u32): the digit-2 and digit-3 histograms, the state, then
// one tie count a CTA and one slab count a segment.
constexpr int kHist2 = 0;
constexpr int kHist3 = kHist2 + radix_select::kBins2;
constexpr int kState = kHist3 + radix_select::kBins3;
constexpr int kPerCta = kState + 4;
constexpr uint32_t kSlabsOff = 0xFFFFFFFFu;
// state: [0] the key prefix found so far, [1] how many keys equal to it
// are still needed, [2] the output cursor, [3] the slots a segment may
// fill (cap / kWarps), or kSlabsOff (see first_pass_kernel).

__device__ __forceinline__ uint64_t composite(uint32_t u, uint32_t i) {
  return ((uint64_t)(0x7FFFFFFFu - u) << 32) | (uint64_t)i;
}

__device__ __forceinline__ uint32_t composite_key(uint64_t c) {
  return 0x7FFFFFFFu - (uint32_t)(c >> 32);
}

// The four keys at e..e+3 of [., hi) (x is 16-byte aligned, e a multiple
// of 4), or the four composites at slab[e..e+3] of [., hi) (slab 16-byte
// aligned): their keys, indices, and which exist.
__device__ __forceinline__ void load4(const float* __restrict__ x,
                                      const uint64_t* __restrict__ slab,
                                      int64_t e, int64_t hi, uint32_t u[4],
                                      uint32_t ix[4], bool ok[4]) {
  if (slab) {
    if (e + 4 <= hi) {
      const ulonglong2 a = *reinterpret_cast<const ulonglong2*>(slab + e);
      const ulonglong2 b = *reinterpret_cast<const ulonglong2*>(slab + e + 2);
      const uint64_t c[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ok[q] = true;
        u[q] = composite_key(c[q]);
        ix[q] = (uint32_t)c[q];
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ok[q] = e + q < hi;
        const uint64_t c = ok[q] ? slab[e + q] : 0x7FFFFFFFull << 32;
        u[q] = composite_key(c);
        ix[q] = (uint32_t)c;
      }
    }
    return;
  }
  if (e + 4 <= hi) {
    const float4 v = *reinterpret_cast<const float4*>(x + e);
    u[0] = key_bits(v.x);
    u[1] = key_bits(v.y);
    u[2] = key_bits(v.z);
    u[3] = key_bits(v.w);
#pragma unroll
    for (int q = 0; q < 4; ++q) ok[q] = true;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ok[q] = e + q < hi;
      u[q] = ok[q] ? key_bits(x[e + q]) : 0u;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) ix[q] = (uint32_t)(e + q);
}

// What a CTA reads of its segment s after the first pass: the segment's
// slab [0, count), or, where that overflowed (count > st[3]) or the slabs
// are off, the segment's keys in x (a kWarps-th of the CTA's chunk).
struct Source {
  const float* x;
  const uint64_t* slab;  // null: the keys in x
  int64_t lo, hi;
};

__device__ __forceinline__ Source source(const float* __restrict__ x,
                                         int64_t n, int64_t chunk,
                                         const uint64_t* slabs, int64_t cap,
                                         const uint32_t* counts,
                                         const uint32_t* st, int s) {
  const uint32_t c = counts[blockIdx.x * kWarps + s];
  if (st[3] != kSlabsOff && c <= st[3]) {
    return {x, slabs + blockIdx.x * cap + s * (cap / kWarps), 0,
            (int64_t)c};
  }
  const int64_t lo = (int64_t)blockIdx.x * chunk + s * (chunk / kWarps);
  return {x, nullptr, lo, min(n, lo + chunk / kWarps)};
}

// Exclusive prefix sum of v over the CTA's threads (in thread order); the
// CTA's total in *total. Every thread calls it; sm holds 32 words.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* sm,
                                               uint32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sm[w] = x;
  __syncthreads();
  if (w == 0) {
    uint32_t s = lane < nw ? sm[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    sm[lane] = s;
  }
  __syncthreads();
  const uint32_t r = (w ? sm[w - 1] : 0u) + x - v;
  *total = sm[nw - 1];
  __syncthreads();
  return r;
}

// One CTA: the bin of hist (nbins, searched from the top) that holds the
// need-th largest key; appends it to the prefix and subtracts the keys of
// the bins above from need. first: start from prefix 0 and need k.
__global__ void __launch_bounds__(kThreads)
search_kernel(const uint32_t* __restrict__ hist, int nbins, int bits,
              uint32_t* st, int first, uint32_t k) {
  __shared__ uint32_t sm[32];
  const uint32_t need = first ? k : st[1];
  const uint32_t prefix = first ? 0u : st[0];
  const int per = nbins / kThreads;
  const int top = nbins - 1 - threadIdx.x * per;  // this thread's bins:
  uint32_t mine = 0;                              // top, top-1, ...
  for (int q = 0; q < per; ++q) mine += hist[top - q];
  uint32_t total;
  uint32_t above = block_scan(mine, sm, &total);
  if (above < need && need <= above + mine) {
    for (int q = 0; q < per; ++q) {
      const uint32_t c = hist[top - q];
      if (need <= above + c) {
        st[0] = (prefix << bits) | (uint32_t)(top - q);
        st[1] = need - above;
        break;
      }
      above += c;
    }
  }
}

// Writes the staged composites stage[0, c) to out[cursor...] (at most k
// in all). Every thread calls it with the same c; the stage is free again
// when it returns.
__device__ __forceinline__ void flush_stage(const uint64_t* stage, uint32_t c,
                                            uint32_t* cursor, uint32_t k,
                                            uint32_t* base,
                                            uint64_t* __restrict__ out) {
  __syncthreads();  // the stage is written
  if (threadIdx.x == 0) *base = atomicAdd(cursor, c);
  __syncthreads();
  const uint32_t b = *base;
  for (uint32_t i = threadIdx.x; i < c; i += kThreads) {
    if (b + i < k) out[b + i] = stage[i];
  }
  __syncthreads();  // the stage and base are free again
}

// The only pass over all n keys, after the digit-1 search (b1 = st[0]).
// Warp w of CTA b takes segment w of the CTA's chunk (chunk / kWarps
// consecutive keys) on its own: every key above bin b1 to out, the digit-2
// histogram of the keys in b1 (one shared histogram a CTA), and their
// composites in index order into the segment's slab (cap / kWarps slots
// at slabs + b * cap + w * cap / kWarps). counts[b * kWarps + w]: the
// segment's keys in b1 (above its slots: it overflowed); *overflows gets
// one for each CTA with an overflowed segment. A warp loads kSub runs of
// 32 consecutive keys (one a lane) before it looks at any; in a run, a
// key's slot is its warp's running count plus the keys before it in the
// run's ballot, so nothing waits for a CTA barrier or a warp scan, and a
// run with no key in or above b1 costs two ballots. (Counting a run's
// keys in b1 that share one digit-2 bin with one shared atomic, as every
// key in b1 does on the TS route, measured slower: its shuffle and ballot
// a run cost more than the atomics.) Keys above b1 go
// through the warp's stage, flushed to out with one atomic on the global
// cursor when the next run might not fit. (A CTA-wide scan a tile of 1024
// keys, with its barrier, took ~0.8 ms for the 1.56 GB of the main cell's
// bucket 0 on an H100, and a warp-wide scan a float4 a lane ~0.65 ms.)
__global__ void __launch_bounds__(kThreads, 8)
first_pass_kernel(const float* __restrict__ x, int64_t n, int64_t chunk,
                  const uint32_t* __restrict__ hist1, uint32_t* st,
                  uint32_t k, uint64_t* __restrict__ slabs,
                  int64_t cap, uint32_t* __restrict__ counts,
                  uint32_t* __restrict__ overflows,
                  uint32_t* __restrict__ hist2,
                  uint64_t* __restrict__ out) {
  __shared__ uint32_t h[radix_select::kBins2];
  __shared__ uint64_t stage[kWarps][kWarpStage];
  __shared__ uint32_t over;
  radix_select::hist_zero(h, radix_select::kBins2);
  if (threadIdx.x == 0) over = 0;
  __syncthreads();
  const uint32_t b1 = st[0];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const uint32_t lower = (1u << lane) - 1u;  // the lanes below this one
  // the slabs are off where b1 holds more keys than all of them together
  const bool off = (int64_t)hist1[b1] > (int64_t)gridDim.x * cap;
  const uint32_t capw = (uint32_t)(cap / kWarps);
  if (blockIdx.x == 0 && threadIdx.x == 0) st[3] = off ? kSlabsOff : capw;
  const int64_t lo = (int64_t)blockIdx.x * chunk + w * (chunk / kWarps);
  const int64_t hi = min(n, lo + chunk / kWarps);
  uint64_t* slab = slabs + blockIdx.x * cap + w * (cap / kWarps);
  uint64_t* wstage = stage[w];
  uint32_t in_bin = 0, staged = 0;
  for (int64_t e0 = lo; e0 < hi; e0 += kSub * 32) {
    uint32_t u[kSub];
    bool ok[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      const int64_t i = e0 + t * 32 + lane;
      ok[t] = i < hi;
      u[t] = ok[t] ? key_bits(x[i]) : 0u;
    }
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      const uint32_t d1 = u[t] >> radix_select::kShift1;
      const bool inb = ok[t] && d1 == b1, up = ok[t] && d1 > b1;
      if (off) {  // only the digit-2 count; the later passes read x
        if (inb) {
          radix_select::hist_add(h, (u[t] >> radix_select::kShift2) &
                                        (radix_select::kBins2 - 1));
        }
        continue;
      }
      const uint32_t mb = __ballot_sync(0xFFFFFFFFu, inb);
      const uint32_t mu = __ballot_sync(0xFFFFFFFFu, up);
      if (!(mb | mu)) continue;
      const uint32_t i = (uint32_t)(e0 + t * 32 + lane);
      if (inb) {
        radix_select::hist_add(
            h, (u[t] >> radix_select::kShift2) & (radix_select::kBins2 - 1));
        const uint32_t at = in_bin + __popc(mb & lower);
        if (at < capw) slab[at] = composite(u[t], i);
      } else if (up) {
        wstage[staged + __popc(mu & lower)] = composite(u[t], i);
      }
      in_bin += __popc(mb);
      staged += __popc(mu);
      if (staged > kWarpStage - 32) {
        __syncwarp();
        uint32_t base = 0;
        if (lane == 0) base = atomicAdd(&st[2], staged);
        base = __shfl_sync(0xFFFFFFFFu, base, 0);
        for (uint32_t j = lane; j < staged; j += 32) {
          if (base + j < k) out[base + j] = wstage[j];
        }
        __syncwarp();
        staged = 0;
      }
    }
  }
  if (staged) {
    __syncwarp();
    uint32_t base = 0;
    if (lane == 0) base = atomicAdd(&st[2], staged);
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    for (uint32_t j = lane; j < staged; j += 32) {
      if (base + j < k) out[base + j] = wstage[j];
    }
  }
  if (lane == 0) {
    counts[blockIdx.x * kWarps + w] = in_bin;
    if (off || in_bin > capw) over = 1;
  }
  radix_select::hist_flush(h, hist2, radix_select::kBins2);  // syncs
  if (threadIdx.x == 0 && over) atomicAdd(overflows, 1u);
}

// Histogram of the digit-3 bits (u & 511) of the CTA's keys with
// u >> 9 == st[0] (digits 1 and 2), segment by segment from its slab or
// its keys in x.
__global__ void __launch_bounds__(kThreads)
count3_kernel(const float* __restrict__ x, int64_t n, int64_t chunk,
              const uint64_t* __restrict__ slabs, int64_t cap,
              const uint32_t* __restrict__ counts, const uint32_t* st,
              uint32_t* __restrict__ hist3) {
  __shared__ uint32_t h[radix_select::kBins3];
  radix_select::hist_zero(h, radix_select::kBins3);
  __syncthreads();
  const uint32_t prefix = st[0];
  for (int sg = 0; sg < kWarps; ++sg) {
    const Source src = source(x, n, chunk, slabs, cap, counts, st, sg);
    for (int64_t t0 = src.lo; t0 < src.hi; t0 += kTile) {
      uint32_t u[4], ix[4];
      bool ok[4];
      load4(src.x, src.slab, t0 + 4 * threadIdx.x, src.hi, u, ix, ok);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (ok[q] && (u[q] >> radix_select::kShift2) == prefix) {
          radix_select::hist_add(h, u[q] & (radix_select::kBins3 - 1));
        }
      }
    }
  }
  radix_select::hist_flush(h, hist3, radix_select::kBins3);
}

// Writes the composite of every key of bin b1 (of any bin, when the slabs
// are off) above v = st[0] to out[cursor++], staged in shared memory with one global atomic a flush,
// and the CTA's count of keys equal to v to ties[blockIdx.x]; segment by
// segment from its slab or its keys in x (the keys above b1 went out in
// the first pass).
__global__ void __launch_bounds__(kThreads)
output_kernel(const float* __restrict__ x, int64_t n, int64_t chunk,
              const uint64_t* __restrict__ slabs, int64_t cap,
              const uint32_t* __restrict__ counts, uint32_t* st, uint32_t k,
              uint32_t* __restrict__ ties, uint64_t* __restrict__ out) {
  __shared__ uint64_t stage[kStage];
  __shared__ uint32_t nstage, base;
  __shared__ uint32_t sm[32];
  if (threadIdx.x == 0) nstage = 0;
  __syncthreads();
  const uint32_t v = st[0];
  const uint32_t b1 = v >> radix_select::kShift1;
  const bool off = st[3] == kSlabsOff;  // then the keys above b1 too
  const int lane = threadIdx.x & 31;
  uint32_t my_ties = 0;
  for (int sg = 0; sg < kWarps; ++sg) {
    const Source src = source(x, n, chunk, slabs, cap, counts, st, sg);
    for (int64_t t0 = src.lo; t0 < src.hi; t0 += kTile) {
      uint32_t u[4], ix[4];
      bool ok[4];
      load4(src.x, src.slab, t0 + 4 * threadIdx.x, src.hi, u, ix, ok);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool win = ok[q] && u[q] > v &&
                         (off || (u[q] >> radix_select::kShift1) == b1);
        my_ties += (ok[q] && u[q] == v) ? 1u : 0u;
        const unsigned m = __ballot_sync(0xFFFFFFFFu, win);
        if (m) {
          uint32_t at = 0;
          if (lane == __ffs(m) - 1) {
            at = atomicAdd(&nstage, (uint32_t)__popc(m));
          }
          at = __shfl_sync(0xFFFFFFFFu, at, __ffs(m) - 1);
          if (win) {
            stage[at + __popc(m & ((1u << lane) - 1u))] =
                composite(u[q], ix[q]);
          }
        }
      }
      __syncthreads();
      const uint32_t c = nstage;
      const bool flush = c > kStage - kTile || t0 + kTile >= src.hi;
      __syncthreads();  // every thread has read nstage
      if (flush) {
        if (threadIdx.x == 0) nstage = 0;
        flush_stage(stage, c, &st[2], k, &base, out);
      }
    }
  }
  uint32_t total;
  block_scan(my_ties, sm, &total);
  if (threadIdx.x == 0) ties[blockIdx.x] = total;
}

// Writes the ties at v of the CTA's segments (slabs or keys in x, in
// order) whose rank (the lower CTAs' ties, then index order) is below
// need, to out[k - need + rank].
// CTAs with no tie to write return after one look at the counts. It loads
// kDepth tiles before it looks at any (one tile at a time, a chunk's loads
// were latency-bound) and skips the ranking where none of them holds a
// tie.
__global__ void __launch_bounds__(kThreads)
tie_kernel(const float* __restrict__ x, int64_t n, int64_t chunk,
           const uint64_t* __restrict__ slabs, int64_t cap,
           const uint32_t* __restrict__ counts, const uint32_t* st,
           uint32_t k, const uint32_t* __restrict__ ties,
           uint64_t* __restrict__ out) {
  __shared__ uint32_t sm[32];
  if (ties[blockIdx.x] == 0) return;
  const uint32_t v = st[0], need = st[1];
  uint32_t lower = 0;
  for (uint32_t b = threadIdx.x; b < blockIdx.x; b += kThreads) {
    lower += ties[b];
  }
  uint32_t rank;
  block_scan(lower, sm, &rank);  // rank: the ties of the lower CTAs
  if (rank >= need) return;
  const uint64_t* end = out + k;
  uint64_t* dst = out + (k - need);
  for (int sg = 0; sg < kWarps && rank < need; ++sg) {
    const Source src = source(x, n, chunk, slabs, cap, counts, st, sg);
    for (int64_t g0 = src.lo; g0 < src.hi && rank < need;
         g0 += kDepth * kTile) {
      uint32_t u[kDepth][4], ix[kDepth][4];
      bool ok[kDepth][4];
      int mine = 0;
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        load4(src.x, src.slab, g0 + t * kTile + 4 * threadIdx.x, src.hi, u[t],
              ix[t], ok[t]);
      }
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
#pragma unroll
        for (int q = 0; q < 4; ++q) mine |= ok[t][q] && u[t][q] == v;
      }
      if (!__syncthreads_or(mine)) continue;
#pragma unroll
      for (int t = 0; t < kDepth; ++t) {
        uint32_t c = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) c += (ok[t][q] && u[t][q] == v) ? 1u : 0u;
        uint32_t tile;
        uint32_t r = rank + block_scan(c, sm, &tile);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (ok[t][q] && u[t][q] == v) {
            if (r < need && dst + r < end) dst[r] = composite(v, ix[t][q]);
            ++r;
          }
        }
        rank += tile;
      }
    }
  }
}

}  // namespace

// x: n f32 keys (16-byte aligned); ranks |x|. hist1: the histogram of bits
// 30..20 of |x| (2048 u32, as the fused decode or scores kernel counts
// it). scratch: (kPerCta + (1 + kWarps) * grid) zeroed u32. slabs: grid *
// cap u64 (16-byte aligned, cap a multiple of 4 * kWarps; need not be
// zeroed). overflows: one u32 that gets one for each CTA with an
// overflowed segment. out: k u64
// composites (0x7FFFFFFF - key) << 32 | index, unordered. Needs 0 < k < n
// < 2^32 and grid * chunk >= n, chunk a multiple of 1024. Returns
// cudaGetLastError() after the last launch.
extern "C" int topk_select_launch(const void* x, int64_t n, int64_t k,
                                  const void* hist1, int grid, int64_t chunk,
                                  void* scratch, void* slabs, int64_t cap,
                                  void* overflows, void* out, void* stream) {
  if (!hist1 || !overflows || k <= 0 || k >= n || n >= (1ll << 32) ||
      grid < 1 || chunk % kTile != 0 || (int64_t)grid * chunk < n ||
      cap < 0 || cap % (4 * kWarps) != 0 || (cap > 0 && !slabs)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  uint32_t* w = static_cast<uint32_t*>(scratch);
  uint32_t* st = w + kState;
  uint32_t* ties = w + kPerCta;
  uint32_t* counts = ties + grid;
  uint64_t* sl = static_cast<uint64_t*>(slabs);
  uint32_t* ov = static_cast<uint32_t*>(overflows);
  uint64_t* o = static_cast<uint64_t*>(out);
  const uint32_t* h1 = static_cast<const uint32_t*>(hist1);
  const uint32_t kk = (uint32_t)k;
  search_kernel<<<1, kThreads, 0, s>>>(h1, radix_select::kBins1, 11, st, 1,
                                       kk);
  first_pass_kernel<<<grid, kThreads, 0, s>>>(xs, n, chunk, h1, st, kk, sl,
                                              cap, counts, ov, w + kHist2, o);
  search_kernel<<<1, kThreads, 0, s>>>(w + kHist2, radix_select::kBins2, 11,
                                       st, 0, kk);
  count3_kernel<<<grid, kThreads, 0, s>>>(xs, n, chunk, sl, cap, counts, st,
                                          w + kHist3);
  search_kernel<<<1, kThreads, 0, s>>>(w + kHist3, radix_select::kBins3, 9,
                                       st, 0, kk);
  output_kernel<<<grid, kThreads, 0, s>>>(xs, n, chunk, sl, cap, counts, st,
                                          kk, ties, o);
  tie_kernel<<<grid, kThreads, 0, s>>>(xs, n, chunk, sl, cap, counts, st, kk,
                                       ties, o);
  return (int)cudaGetLastError();
}

// The scratch words topk_select_launch needs besides 1 + kWarps a CTA.
extern "C" int topk_select_scratch_words() { return kPerCta; }
