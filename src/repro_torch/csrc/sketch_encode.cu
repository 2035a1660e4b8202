// Count-Sketch encode for Hopper (sm_90a): bin by sketch tile through
// device memory, then accumulate each tile in one CTA's shared memory.
//
// Replaces the TPU kernel repro/kernels/sketch_encode.py:sketch_encode
// (body _encode_kernel), which sketches through blocked signed one-hot
// matmuls because a TPU has neither atomics nor a fast data-dependent
// scatter. It computes, for every j < d,
//
//   out[r, h_r(off + j)] += sign_r(off + j) * g[j]
//
// with the multiply-shift hashes of repro/core/count_sketch.py in uint32
// arithmetic (wrap-around mod 2^32, exactly as the reference).
//
// Why this design. The hash scatters neighbouring coordinates over the
// whole (R, W) table, so a direct scatter makes d * R random 4-byte adds.
// Rates on one H100 (src/repro_torch/bench/sketch_memory_probe.cu,
// PERF.md): random red.global.add.f32 into a 20 MiB table 91 G/s (what a
// direct scatter makes), random red.shared::cluster.add.f32 into another
// CTA of an 8-CTA cluster 41 G/s and ld.shared::cluster 84 G/s (so a
// sketch spread over cluster shared memory loses), random f32 atomicAdd
// into a CTA's own shared memory 491 G/s, u32 atomicAdd 1,690 G/s. So each
// add goes to the shared memory of the CTA that owns its bucket, and the
// (element, row) pairs reach that CTA through a partition written and read
// in runs:
//
//   pass 1 (bin_kernel): a CTA takes a block of B <= 2048 elements, each
//     thread four of them, held in registers; for each non-zero element
//     and row it finds the flat bucket f = r * W + h_r, its tile f >> 13
//     (tiles of 2^13 floats, 32 KB) and a rank in that tile (shared-memory
//     u32 atomics, one a warp for the lanes of one tile when there are at
//     most 64 tiles; the ranks stay in registers up to 8 rows); after a
//     scan of the tile counts it stages (f & (2^13 - 1), sign * g) at its
//     tile's run in shared memory, then writes the staging area in
//     coalesced stores (2 + 4 bytes a pair) and one descriptor per tile
//     (run start | run length << 16), tile-major.
//   pass 2 (accum_kernel): a CTA owns one tile in shared memory, walks its
//     tile's run in each of its blocks (a warp flattens 32 runs at a time),
//     and adds each value to its cell exactly (below), then adds the tile
//     into the int64 accumulator in device memory once a pass. A sketch of few
//     tiles (the CLI's default 5 x 16,384 has 10) would leave most SMs
//     idle, so each tile is split over up to `splits` CTAs, each with a
//     share of the blocks, that flush with red.global.add.u64; the wrapper
//     picks splits so that all tiles together fill the card.
//   finish (finish_kernel): one thread a cell converts the accumulator to
//     the f32 sketch.
//
// Exactness. A value v = sign_r * g[j] with |v| < 2^31 is the fixed-point
// integer X = sign(v) * floor(|v| * 2^64), from the limbs a = floor(|v|),
// b = floor(frac(|v|) * 2^32), c = floor(frac(frac(|v|) * 2^32) * 2^32)
// computed exactly in f64. In the tile a cell holds its sum as a 128-bit
// two's-complement integer in four u32 words, each taking X's word plus
// the carry out of the word below, read from the old value atomicAdd
// returns (u32 shared atomics: 2,368 G/s on the H100 against 324 G/s for
// u64, probe k of bench/sketch_memory_probe.cu); a word whose addend is 0
// takes no atomic, so |v| < 1 costs two or three. The flush adds the
// cell's (high 64 bits, word 1, word 0) into the int64 accumulator's
// three limbs (red.global.add.u64 across split CTAs). Integer adds are
// associative, so the sums, and the sketch, are a function of the
// multiset of (cell, value) contributions alone: the same bits in every
// run, for any splits, pass size or grid, and for any cutting of g into
// offset fragments whose accumulators are summed before the finish. The
// finish normalizes the limb sums (carries propagated) and rounds
// f32((f64(A) + f64(b) * 2^-32) + f64(c) * 2^-64) once, the order the
// plain version (repro_torch/core/count_sketch.py: finish) repeats, so the
// kernel is bit-equal to it. Non-finite elements set flag bits in a
// per-cell u32 word (atomicOr in device memory: rare): NaN, or both
// infinities, gives NaN; one infinity gives it; otherwise an element with
// |v| >= 2^31 gives NaN (where the reference would sum it).
//
// The wrapper hands g over in passes of at most 2^25 elements and at most
// 1 GiB of scratch (off, val and descriptors: 6 * R bytes an element plus
// 4 * ntiles a block), so large R takes shorter passes. The tile's 128-bit
// sums take 128 KB of shared memory: one accumulating CTA of 1,024 threads
// an SM.
// Bound on this card: the least time is one read of g and one write of the
// sketch over 3.35 TB/s (0.47 ms at the main cell's bucket 0). The design
// moves 6 more bytes a pair each way (25 GB at bucket 0: ~8 ms at the
// measured 3.1 TB/s), makes two to four dependent u32 shared atomics a
// pair, and adds each tile into the 28-byte accumulator a cell once a
// pass. Measured on an H100 at 700 W: 21.3 ms at bucket 0 (bin 8.5,
// accumulate 12.7; the f32 accumulate it replaced took 7.5); three u64
// limbs a cell in shared memory and a (u64, s64) pair were slower. Times
// in PERF.md.

#include "sketch_common.cuh"

namespace {

using sketch_common::to_f32;

constexpr int kMaxRows = 64;
constexpr int kTileLog = 13;
constexpr int kTile = 1 << kTileLog;
constexpr int kBinThreads = 512;
constexpr int kPerThread = 4;  // elements a binning thread; block <= 2048
constexpr int kAccThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kRegRows = 8;  // up to 8 rows the binning ranks stay in registers
constexpr int kMaxTiles = 16384;  // R * W <= 2^27
constexpr int kAggTiles = 64;  // at most this many tiles: warp-aggregated ranks
constexpr int kAccSmem = 4 * kTile * 4;  // a tile's 128-bit sums, 128 KB

// Flag bits of a cell (repro_torch/core/count_sketch.py FLAG_*).
constexpr uint32_t kFlagNan = 1, kFlagPosInf = 2, kFlagNegInf = 4,
                   kFlagBig = 8;

// Flat bucket r * W + h_r(i) and the signed value.
__device__ __forceinline__ uint32_t flat_bucket(const uint32_t* sh, int r,
                                                uint32_t i, int log2w) {
  const uint32_t hb = sh[4 * r] * i + sh[4 * r + 1];
  const uint32_t bucket = log2w == 0 ? 0u : (hb >> (32 - log2w));
  return ((uint32_t)r << log2w) + bucket;
}
__device__ __forceinline__ float signed_value(const uint32_t* sh, int r,
                                              uint32_t i, float v) {
  const uint32_t hs = sh[4 * r + 2] * i + sh[4 * r + 3];
  return (hs >> 31) ? -v : v;
}

// Rank of this (element, row) pair in its tile. With few tiles (kAgg) most
// lanes of a warp hit the same few counters, and same-address shared
// atomics serialize; then the lanes of one tile take one atomic for the
// warp (match.any) and rank themselves by lane, and every lane of the warp
// calls this (`live` is false for a zero element, which takes no rank).
// Otherwise only live lanes call it.
template <bool kAgg>
__device__ __forceinline__ uint32_t tile_rank(uint32_t* hist, uint32_t tile,
                                              bool live) {
  if constexpr (!kAgg) {
    return atomicAdd(&hist[tile], 1u);
  } else {
    const int lane = threadIdx.x & 31;
    const uint32_t peers = __match_any_sync(0xffffffffu, live ? tile : ~0u);
    const int leader = __ffs(peers) - 1;
    uint32_t base = 0;
    if (live && lane == leader) {
      base = atomicAdd(&hist[tile], (uint32_t)__popc(peers));
    }
    base = __shfl_sync(0xffffffffu, base, leader);
    return base + __popc(peers & ((1u << lane) - 1u));
  }
}

// Exclusive scan of a[0, n) in place by the whole block; returns the total.
__device__ uint32_t block_exclusive_scan(uint32_t* a, int n,
                                         uint32_t* warp_sums) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per, hi = min(n, lo + per);
  uint32_t s = 0;
  for (int t = lo; t < hi; ++t) s += a[t];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = s;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    uint32_t w = lane < nw ? warp_sums[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  uint32_t run = incl - s + (warp > 0 ? warp_sums[warp - 1] : 0u);
  for (int t = lo; t < hi; ++t) {
    const uint32_t c = a[t];
    a[t] = run;
    run += c;
  }
  const uint32_t total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();
  return total;
}

// Pass 1. Shared memory: staging (offset, value bits) uint2[E],
// hist[ntiles] u32, hash params, warp sums and, unless the ranks stay in
// registers (kRankRegs > 0: rows <= kRankRegs), ranks u16[E]
// (E = block * rows entries).
template <typename T, int kRankRegs, bool kAgg>
__global__ void __launch_bounds__(kBinThreads)
bin_kernel(const T* __restrict__ g, int64_t n, int64_t offset,
           const uint32_t* __restrict__ hp, int rows, int log2w, int ntiles,
           int block, uint16_t* __restrict__ off_out,
           float* __restrict__ val_out, uint32_t* __restrict__ desc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = block * rows;
  uint2* stg = reinterpret_cast<uint2*>(smem);
  uint32_t* hist = reinterpret_cast<uint32_t*>(stg + E);
  uint32_t* sh = hist + ntiles;
  uint32_t* warp_sums = sh + 4 * rows;
  uint16_t* rank = reinterpret_cast<uint16_t*>(warp_sums + 32);
  uint32_t rk[kPerThread][kRankRegs > 0 ? kRankRegs : 1];

  // each thread's elements are loaded up front and kept in registers
  const int64_t j0 = (int64_t)blockIdx.x * block;
  const int nb = (int)min((int64_t)block, n - j0);
  float v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = k * kBinThreads + threadIdx.x;
    v[k] = e < nb ? to_f32(g[j0 + e]) : 0.0f;
  }
  for (int t = threadIdx.x; t < rows * 4; t += blockDim.x) sh[t] = hp[t];
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) hist[t] = 0u;
  __syncthreads();

  // a zero element adds nothing (flat padding is zero) and takes no rank;
  // with kAgg the loops stay warp-uniform for tile_rank's warp collectives
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const bool live = v[k] != 0.0f;
    if (!kAgg && !live) continue;
    const int e = k * kBinThreads + threadIdx.x;
    const uint32_t i = (uint32_t)(offset + j0 + e);
    if constexpr (kRankRegs > 0) {
#pragma unroll
      for (int r = 0; r < kRankRegs; ++r) {
        if (r < rows) {
          rk[k][r] = tile_rank<kAgg>(
              hist, flat_bucket(sh, r, i, log2w) >> kTileLog, live);
        }
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        const uint32_t q = tile_rank<kAgg>(
            hist, flat_bucket(sh, r, i, log2w) >> kTileLog, live);
        if (live) rank[e * rows + r] = (uint16_t)q;
      }
    }
  }
  __syncthreads();

  // tile counts -> run starts; one descriptor per (tile, block), tile-major
  // so that pass 2 reads a tile's descriptors in coalesced loads
  const uint32_t total = block_exclusive_scan(hist, ntiles, warp_sums);
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
    const uint32_t next = t + 1 < ntiles ? hist[t + 1] : total;
    desc[(int64_t)t * gridDim.x + blockIdx.x] =
        hist[t] | ((next - hist[t]) << 16);
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (v[k] == 0.0f) continue;
    const int e = k * kBinThreads + threadIdx.x;
    const uint32_t i = (uint32_t)(offset + j0 + e);
    if constexpr (kRankRegs > 0) {
#pragma unroll
      for (int r = 0; r < kRankRegs; ++r) {
        if (r < rows) {
          const uint32_t f = flat_bucket(sh, r, i, log2w);
          stg[hist[f >> kTileLog] + rk[k][r]] = make_uint2(
              f & (kTile - 1), __float_as_uint(signed_value(sh, r, i, v[k])));
        }
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        const uint32_t f = flat_bucket(sh, r, i, log2w);
        const uint32_t p = hist[f >> kTileLog] + rank[e * rows + r];
        stg[p] = make_uint2(f & (kTile - 1),
                            __float_as_uint(signed_value(sh, r, i, v[k])));
      }
    }
  }
  __syncthreads();

  const int64_t base = (int64_t)blockIdx.x * E;
  for (uint32_t q = threadIdx.x; q < total; q += blockDim.x) {
    const uint2 x = stg[q];
    off_out[base + q] = (uint16_t)x.x;
    val_out[base + q] = __uint_as_float(x.y);
  }
}

// Adds one value to its cell's 128-bit two's-complement sum, held as four
// u32 words w_k[o] = acc32[k * kTile + o] (w_0 lowest). A word takes the
// value's word plus the carry out of the word below, read from the old
// value that atomicAdd returns: every wrap of a word is one carry into the
// next, so the four words hold the exact sum mod 2^128 in any order of the
// adds. A word whose addend is 0 (or 2^32: a carry through 0xffffffff)
// takes no atomic.
__device__ __forceinline__ void add_exact(unsigned long long* acc64,
                                          uint32_t o, float v,
                                          uint32_t* __restrict__ flags,
                                          int64_t cell) {
  const float av = fabsf(v);
  if (!(av < 2147483648.0f)) {
    atomicOr(flags + cell, isnan(v) ? kFlagNan
                           : isinf(v) ? (v > 0.0f ? kFlagPosInf : kFlagNegInf)
                                      : kFlagBig);
    return;
  }
  uint32_t* acc = reinterpret_cast<uint32_t*>(acc64);
  const double x = (double)av;
  const double a = floor(x);
  const double r1 = __dmul_rn(__dsub_rn(x, a), 4294967296.0);
  const double b = floor(r1);
  const double c = floor(__dmul_rn(__dsub_rn(r1, b), 4294967296.0));
  unsigned long long lo = ((unsigned long long)__double2ll_rz(b) << 32) |
                          (unsigned long long)__double2ll_rz(c);
  unsigned long long hi = (unsigned long long)__double2ll_rz(a);
  if (signbit(v)) {
    hi = 0ull - hi - (lo != 0ull ? 1ull : 0ull);
    lo = 0ull - lo;
  }
  const uint32_t w[4] = {(uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                         (uint32_t)(hi >> 32)};
  uint32_t cy = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t y = w[k] + cy;      // wraps to 0 only for 0xffffffff + 1
    if (y == 0u) {
      cy = (w[k] != 0u) ? 1u : 0u;     // a carry passes through
      continue;
    }
    const uint32_t old = atomicAdd(acc + k * kTile + o, y);
    cy = (old + y < old) ? 1u : 0u;
  }
}

// Pass 2: CTA (t, s) owns flat buckets [t * kTile, t * kTile + kTile) and
// the s-th of `splits` equal shares of the binning blocks. Its warps form
// teams of `group_warps`: a team takes 32 blocks at a time and flattens
// their runs, its warps taking turns at 32 * kUnroll entries (short runs:
// one warp a team; long runs, as in a sketch of few tiles: the whole CTA
// shares each group, so no warp idles while another walks it). Flush into
// the int64 accumulator out[3][size] (limb 0: the sum's high 64 bits,
// limb 1: word 1, limb 2: word 0): a plain add where one CTA owns the tile
// (splits = 1), red.global.add.u64 where several share it.
__global__ void __launch_bounds__(kAccThreads)
accum_kernel(const uint16_t* __restrict__ off_in,
             const float* __restrict__ val_in,
             const uint32_t* __restrict__ desc, int nblocks, int splits,
             int group_warps, int entries, int64_t size,
             unsigned long long* __restrict__ out,
             uint32_t* __restrict__ flags) {
  extern __shared__ __align__(16) unsigned long long acc[];
  const int t = blockIdx.x / splits, s = blockIdx.x % splits;
  const int b_lo = (int)((int64_t)s * nblocks / splits);
  const int b_hi = (int)((int64_t)(s + 1) * nblocks / splits);
  const int64_t t0 = (int64_t)t * kTile;
  const int nt = (int)min((int64_t)kTile, size - t0);
  for (int q = threadIdx.x; q < 2 * kTile; q += blockDim.x) acc[q] = 0ull;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / group_warps, tw = warp % group_warps;
  const int nteams = (blockDim.x >> 5) / group_warps;
  const uint32_t* tdesc = desc + (int64_t)t * nblocks;
  const int bw = b_lo + team * 32 + lane;
  uint32_t next = bw < b_hi ? tdesc[bw] : 0u;
  for (int b0 = b_lo + team * 32; b0 < b_hi; b0 += nteams * 32) {
    const int b = b0 + lane;
    const uint32_t dsc = next;  // this group's descriptors; fetch the next
    const int bn = b + nteams * 32;
    next = bn < b_hi ? tdesc[bn] : 0u;
    const uint32_t cnt = dsc >> 16;
    uint32_t incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const uint32_t excl = incl - cnt;
    const uint32_t total = __shfl_sync(0xffffffffu, incl, 31);
    const int64_t src = (int64_t)b * entries + (dsc & 0xffffu);
    for (uint32_t q0 = tw * 32 * kUnroll; q0 < total;
         q0 += group_warps * 32 * kUnroll) {
      int64_t pos[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t q = q0 + u * 32 + lane;
        // the run holding flat entry q: the last lane k with excl_k <= q
        int k = 0;
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) {
          if (__shfl_sync(0xffffffffu, excl, k + s) <= q) k += s;
        }
        const int64_t sk = __shfl_sync(0xffffffffu, src, k);
        const uint32_t ek = __shfl_sync(0xffffffffu, excl, k);
        pos[u] = q < total ? sk + (q - ek) : -1;
      }
      uint16_t o[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (pos[u] >= 0) {
          o[u] = off_in[pos[u]];
          v[u] = val_in[pos[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (pos[u] >= 0) add_exact(acc, o[u], v[u], flags, t0 + o[u]);
      }
    }
  }
  __syncthreads();
  const uint32_t* w = reinterpret_cast<const uint32_t*>(acc);
  for (int q = threadIdx.x; q < nt; q += blockDim.x) {
    const unsigned long long x[3] = {
        ((unsigned long long)w[3 * kTile + q] << 32) | w[2 * kTile + q],
        w[kTile + q], w[q]};
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      if (x[l] == 0ull) continue;
      unsigned long long* dst = out + l * size + t0 + q;
      if (splits > 1) {
        atomicAdd(dst, x[l]);
      } else {
        *dst += x[l];
      }
    }
  }
}

// Finish: cell i of `lead` stacked accumulators (limbs [lead][3][size],
// flags [lead][size]) -> out[i] f32: normalized limb sums rounded once,
// then the flag rules (see Exactness above).
__global__ void __launch_bounds__(256)
finish_kernel(const long long* __restrict__ limbs,
              const uint32_t* __restrict__ flags, int64_t size, int64_t n,
              float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t lead = i / size, cell = i - lead * size;
    const long long* l = limbs + lead * 3 * size + cell;
    long long a = l[0], b = l[size], c = l[2 * size];
    b += c >> 32;
    c &= 0xffffffffll;
    a += b >> 32;
    b &= 0xffffffffll;
    const double v = __dadd_rn(
        __dadd_rn(__ll2double_rn(a), __dmul_rn(__ll2double_rn(b), 0x1p-32)),
        __dmul_rn(__ll2double_rn(c), 0x1p-64));
    float r = __double2float_rn(v);
    const uint32_t f = flags[i];
    if (f) {
      const bool pos = f & kFlagPosInf, neg = f & kFlagNegInf;
      if ((f & kFlagNan) || (pos && neg) || ((f & kFlagBig) && !pos && !neg)) {
        r = __uint_as_float(0x7fc00000u);
      } else if (pos) {
        r = __uint_as_float(0x7f800000u);
      } else if (neg) {
        r = __uint_as_float(0xff800000u);
      }
    }
    out[i] = r;
  }
}

template <typename T>
int launch(const void* g, int64_t d, const void* hp, int rows, int log2w,
           int64_t offset, void* limbs, void* flags, int ntiles, int block,
           int64_t chunk, int splits, int group_warps, int bin_smem,
           void* off_scratch, void* val_scratch, void* desc_scratch,
           cudaStream_t stream) {
  const int E = block * rows;
  const bool agg = ntiles <= kAggTiles;
  auto bin = rows <= kRegRows
                 ? (agg ? bin_kernel<T, kRegRows, true>
                        : bin_kernel<T, kRegRows, false>)
                 : (agg ? bin_kernel<T, 0, true> : bin_kernel<T, 0, false>);
  cudaError_t e = cudaFuncSetAttribute(
      bin, cudaFuncAttributeMaxDynamicSharedMemorySize, bin_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(accum_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kAccSmem);
  if (e != cudaSuccess) return (int)e;
  const int64_t size = (int64_t)rows << log2w;
  for (int64_t c0 = 0; c0 < d; c0 += chunk) {
    const int64_t n = d - c0 < chunk ? d - c0 : chunk;
    const int nblocks = (int)((n + block - 1) / block);
    bin<<<nblocks, kBinThreads, bin_smem, stream>>>(
        static_cast<const T*>(g) + c0, n, offset + c0,
        static_cast<const uint32_t*>(hp), rows, log2w, ntiles, block,
        static_cast<uint16_t*>(off_scratch), static_cast<float*>(val_scratch),
        static_cast<uint32_t*>(desc_scratch));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int sp = splits < nblocks ? splits : nblocks;
    accum_kernel<<<ntiles * sp, kAccThreads, kAccSmem, stream>>>(
        static_cast<const uint16_t*>(off_scratch),
        static_cast<const float*>(val_scratch),
        static_cast<const uint32_t*>(desc_scratch), nblocks, sp, group_warps,
        E, size, static_cast<unsigned long long*>(limbs),
        static_cast<uint32_t*>(flags));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Adds the contributions
// of g (element j hashed as coordinate offset + j) into an exact sketch:
// limbs [3][rows << log2w] int64 and flags [rows << log2w] u32, both
// initialized by the caller (zeros, or earlier contributions). The
// geometry (ntiles, block, chunk, splits, group_warps, bin_smem) and the
// scratch sizes come from the wrapper's plan (kernels/sketch_encode.py:
// encode_plan): off_scratch holds ceil(chunk / block) * block * rows
// uint16, val_scratch as many float32, desc_scratch ceil(chunk / block) *
// ntiles uint32. Returns the first cudaGetLastError() that is not
// cudaSuccess, else 0.
extern "C" int sketch_encode_launch(const void* g, int64_t d, int dtype,
                                    const void* hash_params, int rows,
                                    int log2w, int64_t offset, void* limbs,
                                    void* flags, int ntiles, int block,
                                    int64_t chunk, int splits,
                                    int group_warps, int bin_smem,
                                    void* off_scratch, void* val_scratch,
                                    void* desc_scratch, void* stream) {
  // the binning CTA's shared-memory layout must fit in bin_smem
  const int64_t need = 4 * ((int64_t)ntiles + 4 * rows + 32) +
                       (int64_t)(rows <= kRegRows ? 8 : 10) * block * rows;
  if (rows < 1 || rows > kMaxRows || log2w < 0 || log2w > 31 ||
      ntiles != (int)((((int64_t)rows << log2w) + kTile - 1) >> kTileLog) ||
      ntiles > kMaxTiles || block < 1 || block > kPerThread * kBinThreads ||
      (int64_t)block * rows > 65535 || chunk < 1 || splits < 1 ||
      group_warps < 1 || (kAccThreads / 32) % group_warps != 0 ||
      bin_smem < need) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(g, d, hash_params, rows, log2w, offset, limbs,
                           flags, ntiles, block, chunk, splits, group_warps,
                           bin_smem, off_scratch, val_scratch, desc_scratch,
                           s);
    case 1:
      return launch<__nv_bfloat16>(g, d, hash_params, rows, log2w, offset,
                                   limbs, flags, ntiles, block, chunk,
                                   splits, group_warps, bin_smem, off_scratch,
                                   val_scratch, desc_scratch, s);
    case 2:
      return launch<__half>(g, d, hash_params, rows, log2w, offset, limbs,
                            flags, ntiles, block, chunk, splits, group_warps,
                            bin_smem, off_scratch, val_scratch, desc_scratch,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The f32 sketch of `lead` stacked exact sketches (limbs [lead][3][size]
// int64, flags [lead][size] u32) into out [lead][size]; sms: the card's
// SM count (the grid). Returns cudaGetLastError() after the launch.
extern "C" int sketch_encode_finish_launch(const void* limbs,
                                           const void* flags, int64_t size,
                                           int64_t lead, void* out, int sms,
                                           void* stream) {
  if (size < 1 || lead < 1) return (int)cudaErrorInvalidValue;
  const int64_t n = size * lead;
  const unsigned grid = sketch_common::grid_for(n, 256, sms);
  finish_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(limbs),
      static_cast<const uint32_t*>(flags), size, n,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
