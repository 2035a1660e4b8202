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
// digit then has a 1-CTA search from the top
// bin, which keeps the prefix found so far and how many keys equal to it
// are still needed in a 4-word device state; the next digit's histogram
// counts only the keys that match that prefix. After digit 3 the k-th key
// v and the number of ties to take are exact. Every CTA owns one
// contiguous chunk of x. The output pass stages the keys above v in shared
// memory and writes them through one global cursor (one atomic a flush);
// it counts each CTA's ties at v. The tie pass lets only the CTAs whose
// ties rank below `need` (by the sum of the lower CTAs' counts) read their
// chunk again, and writes those ties in index order: the lowest-index ties
// win, as in jax.lax.top_k.
// Scratch is fixed by (n, grid): nothing is sized from device data.
// Bound: one read of x (4n bytes) and k 8-byte composites written; the
// kernel reads x three times (digits 2 and 3, output) plus the tie CTAs'
// chunks, and its 1-CTA searches and launches add a few microseconds each.

#include "radix_select.cuh"

namespace {

using radix_select::key_bits;

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;  // elements a CTA takes a step
constexpr int kStage = 2 * kTile;    // composites staged a CTA
constexpr int kDepth = 8;            // tiles a tie CTA loads at once

// Scratch words (u32): the digit-2 and digit-3 histograms, the state, then
// one tie count a CTA.
constexpr int kHist2 = 0;
constexpr int kHist3 = kHist2 + radix_select::kBins2;
constexpr int kState = kHist3 + radix_select::kBins3;
constexpr int kTies = kState + 4;
// state: [0] the key prefix found so far, [1] how many keys equal to it
// are still needed, [2] the output cursor.

// The four keys at e..e+3 of [., hi), and which exist; e is a multiple of
// 4 and x is 16-byte aligned.
__device__ __forceinline__ void load4(const float* __restrict__ x, int64_t e,
                                      int64_t hi, uint32_t u[4],
                                      bool ok[4]) {
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
}

__device__ __forceinline__ uint64_t composite(uint32_t u, int64_t i) {
  return ((uint64_t)(0x7FFFFFFFu - u) << 32) | (uint64_t)(uint32_t)i;
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

// Histogram of digit (u >> bin_shift) & (BINS - 1) over the keys with
// u >> match_shift == st[0]. The CTA takes x[b * chunk, (b + 1) * chunk).
template <int BINS>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ x, int64_t n, int64_t chunk,
             const uint32_t* st, int match_shift, int bin_shift,
             uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[BINS];
  radix_select::hist_zero(h, BINS);
  __syncthreads();
  const uint32_t prefix = st[0];
  const int64_t lo = (int64_t)blockIdx.x * chunk;
  const int64_t hi = min(n, lo + chunk);
  for (int64_t t0 = lo; t0 < hi; t0 += kTile) {
    uint32_t u[4];
    bool ok[4];
    load4(x, t0 + 4 * threadIdx.x, hi, u, ok);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (ok[q] && (u[q] >> match_shift) == prefix) {
        radix_select::hist_add(h, (u[q] >> bin_shift) & (BINS - 1));
      }
    }
  }
  radix_select::hist_flush(h, hist, BINS);
}

// Writes the composite of every key above v = st[0] (there are k - need)
// to out[cursor++], staged in shared memory with one global atomic a
// flush, and the CTA's count of keys equal to v to ties[blockIdx.x].
__global__ void __launch_bounds__(kThreads)
output_kernel(const float* __restrict__ x, int64_t n, int64_t chunk,
              uint32_t* st, uint32_t k, uint32_t* __restrict__ ties,
              uint64_t* __restrict__ out) {
  __shared__ uint64_t stage[kStage];
  __shared__ uint32_t nstage, base;
  __shared__ uint32_t sm[32];
  if (threadIdx.x == 0) nstage = 0;
  __syncthreads();
  const uint32_t v = st[0];
  const int64_t lo = (int64_t)blockIdx.x * chunk;
  const int64_t hi = min(n, lo + chunk);
  const int lane = threadIdx.x & 31;
  uint32_t my_ties = 0;
  for (int64_t t0 = lo; t0 < hi; t0 += kTile) {
    const int64_t e = t0 + 4 * threadIdx.x;
    uint32_t u[4];
    bool ok[4];
    load4(x, e, hi, u, ok);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool win = ok[q] && u[q] > v;
      my_ties += (ok[q] && u[q] == v) ? 1u : 0u;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, win);
      if (m) {
        uint32_t at = 0;
        if (lane == __ffs(m) - 1) at = atomicAdd(&nstage, (uint32_t)__popc(m));
        at = __shfl_sync(0xFFFFFFFFu, at, __ffs(m) - 1);
        if (win) {
          stage[at + __popc(m & ((1u << lane) - 1u))] = composite(u[q], e + q);
        }
      }
    }
    __syncthreads();
    const uint32_t c = nstage;
    const bool flush = c > kStage - kTile || t0 + kTile >= hi;
    __syncthreads();  // every thread has read nstage
    if (flush) {
      if (threadIdx.x == 0) {
        base = atomicAdd(&st[2], c);
        nstage = 0;
      }
      __syncthreads();
      for (uint32_t i = threadIdx.x; i < c; i += kThreads) {
        if (base + i < k) out[base + i] = stage[i];
      }
      __syncthreads();  // the stage is free again
    }
  }
  uint32_t total;
  block_scan(my_ties, sm, &total);
  if (threadIdx.x == 0) ties[blockIdx.x] = total;
}

// Writes the ties at v of the CTA's chunk whose rank (the lower CTAs'
// ties, then index order in the chunk) is below need, to out[k - need +
// rank]. CTAs with no tie to write return after one look at the counts.
// One CTA reads its chunk alone, so it loads kDepth tiles before it looks
// at any (one tile at a time, the chunk's loads were latency-bound) and
// skips the ranking where none of them holds a tie.
__global__ void __launch_bounds__(kThreads)
tie_kernel(const float* __restrict__ x, int64_t n, int64_t chunk,
           const uint32_t* st, uint32_t k, const uint32_t* __restrict__ ties,
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
  const int64_t lo = (int64_t)blockIdx.x * chunk;
  const int64_t hi = min(n, lo + chunk);
  for (int64_t g0 = lo; g0 < hi && rank < need; g0 += kDepth * kTile) {
    uint32_t u[kDepth][4];
    bool ok[kDepth][4];
    int mine = 0;
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
      load4(x, g0 + t * kTile + 4 * threadIdx.x, hi, u[t], ok[t]);
    }
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) mine |= ok[t][q] && u[t][q] == v;
    }
    if (!__syncthreads_or(mine)) continue;
#pragma unroll
    for (int t = 0; t < kDepth; ++t) {
      const int64_t e = g0 + t * kTile + 4 * threadIdx.x;
      uint32_t c = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) c += (ok[t][q] && u[t][q] == v) ? 1u : 0u;
      uint32_t tile;
      uint32_t r = rank + block_scan(c, sm, &tile);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (ok[t][q] && u[t][q] == v) {
          if (r < need && dst + r < end) dst[r] = composite(v, e + q);
          ++r;
        }
      }
      rank += tile;
    }
  }
}

}  // namespace

// x: n f32 keys (16-byte aligned); ranks |x|. hist1: the histogram of bits
// 30..20 of |x| (2048 u32, as the fused decode or scores kernel counts it). scratch: (kTies + grid) zeroed u32. out: k u64
// composites (0x7FFFFFFF - key) << 32 | index, unordered. Needs 0 < k < n
// < 2^32 and grid * chunk >= n, chunk a multiple of 1024. Returns
// cudaGetLastError() after the last launch.
extern "C" int topk_select_launch(const void* x, int64_t n, int64_t k,
                                  const void* hist1, int grid, int64_t chunk,
                                  void* scratch, void* out, void* stream) {
  if (!hist1 || k <= 0 || k >= n || n >= (1ll << 32) || grid < 1 ||
      chunk % kTile != 0 || (int64_t)grid * chunk < n) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  uint32_t* w = static_cast<uint32_t*>(scratch);
  uint32_t* st = w + kState;
  uint64_t* o = static_cast<uint64_t*>(out);
  const uint32_t* h1 = static_cast<const uint32_t*>(hist1);
  const uint32_t kk = (uint32_t)k;
  search_kernel<<<1, kThreads, 0, s>>>(h1, radix_select::kBins1, 11, st, 1,
                                       kk);
  count_kernel<radix_select::kBins2><<<grid, kThreads, 0, s>>>(
      xs, n, chunk, st, radix_select::kShift1, radix_select::kShift2,
      w + kHist2);
  search_kernel<<<1, kThreads, 0, s>>>(w + kHist2, radix_select::kBins2, 11,
                                       st, 0, kk);
  count_kernel<radix_select::kBins3><<<grid, kThreads, 0, s>>>(
      xs, n, chunk, st, radix_select::kShift2, 0, w + kHist3);
  search_kernel<<<1, kThreads, 0, s>>>(w + kHist3, radix_select::kBins3, 9,
                                       st, 0, kk);
  output_kernel<<<grid, kThreads, 0, s>>>(xs, n, chunk, st, kk, w + kTies,
                                          o);
  tie_kernel<<<grid, kThreads, 0, s>>>(xs, n, chunk, st, kk, w + kTies, o);
  return (int)cudaGetLastError();
}

// The scratch words topk_select_launch needs besides one a CTA.
extern "C" int topk_select_scratch_words() { return kTies; }
