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
//     adds each value with a shared-memory atomic, and writes the tile
//     once. A sketch of few tiles (the CLI's default 5 x 16,384 has 10)
//     would leave most SMs idle, so each tile is split over up to `splits`
//     CTAs, each with a share of the blocks, that flush with red.global.add
//     into a zeroed output; the wrapper picks splits so that all tiles
//     together fill the card (3 CTAs an SM).
//
// The wrapper hands g over in passes of at most 2^25 elements and at most
// 1 GiB of scratch (off, val and descriptors: 6 * R bytes an element plus
// 4 * ntiles a block), so large R takes shorter passes. With one CTA a
// tile the first pass stores each tile and later passes add to it, so
// every bucket of the (R, W) output has exactly one writer and the output
// needs no zeroing.
// Bound on this card: the least time is one read of g and one write of the
// sketch over 3.35 TB/s (0.47 ms at the main cell's bucket 0). The design
// moves 6 more bytes a pair each way (25 GB at bucket 0: ~8 ms at the
// measured 3.1 TB/s) and makes d * R f32 shared atomics (a CAS loop: ~4 ms
// at 491 G/s). Measured on an H100 at 700 W: 15.96 ms at bucket 0 (pass
// 1 8.7, pass 2 7.5) and 8.03 ms at bucket 1, against 22.16 and 11.42 ms
// for a direct scatter with L2 atomics, timed in the same run; other
// widths in PERF.md.
// Determinism: the ranks and the shared-memory adds land in a run-dependent
// order, so the sketch is not bit-reproducible on the card; it matches the
// plain index_add_ version within f32 summation-order error.

#include "sketch_common.cuh"

namespace {

using sketch_common::to_f32;

constexpr int kMaxRows = 64;
constexpr int kTileLog = 13;
constexpr int kTile = 1 << kTileLog;
constexpr int kBinThreads = 512;
constexpr int kPerThread = 4;  // elements a binning thread; block <= 2048
constexpr int kAccThreads = 512;
constexpr int kUnroll = 4;
constexpr int kRegRows = 8;  // up to 8 rows the binning ranks stay in registers
constexpr int kMaxTiles = 16384;  // R * W <= 2^27
constexpr int kAggTiles = 64;  // at most this many tiles: warp-aggregated ranks

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

// Pass 2: CTA (t, s) owns flat buckets [t * kTile, t * kTile + kTile) and
// the s-th of `splits` equal shares of the binning blocks. Its warps form
// teams of `group_warps`: a team takes 32 blocks at a time and flattens
// their runs, its warps taking turns at 32 * kUnroll entries (short runs:
// one warp a team; long runs, as in a sketch of few tiles: the whole CTA
// shares each group, so no warp idles while another walks it). Flush: `store`
// (the first pass, one share), `add` (later passes, one share), or
// `atomic` red.global.add into a zeroed output (several shares).
enum Flush { kStore = 0, kAdd = 1, kAtomic = 2 };

__global__ void __launch_bounds__(kAccThreads)
accum_kernel(const uint16_t* __restrict__ off_in,
             const float* __restrict__ val_in,
             const uint32_t* __restrict__ desc, int nblocks, int splits,
             int group_warps, int entries, int64_t size,
             float* __restrict__ out, int flush) {
  __shared__ float acc[kTile];
  const int t = blockIdx.x / splits, s = blockIdx.x % splits;
  const int b_lo = (int)((int64_t)s * nblocks / splits);
  const int b_hi = (int)((int64_t)(s + 1) * nblocks / splits);
  const int64_t t0 = (int64_t)t * kTile;
  const int nt = (int)min((int64_t)kTile, size - t0);
  for (int q = threadIdx.x; q < nt; q += blockDim.x) acc[q] = 0.0f;
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
        if (pos[u] >= 0) atomicAdd(&acc[o[u]], v[u]);
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nt; q += blockDim.x) {
    if (flush == kAtomic) {
      atomicAdd(&out[t0 + q], acc[q]);
    } else {
      out[t0 + q] = flush == kAdd ? out[t0 + q] + acc[q] : acc[q];
    }
  }
}

template <typename T>
int launch(const void* g, int64_t d, const void* hp, int rows, int log2w,
           int64_t offset, void* out, int ntiles, int block, int64_t chunk,
           int splits, int group_warps, int bin_smem, void* off_scratch,
           void* val_scratch, void* desc_scratch, cudaStream_t stream) {
  const int E = block * rows;
  const bool agg = ntiles <= kAggTiles;
  auto bin = rows <= kRegRows
                 ? (agg ? bin_kernel<T, kRegRows, true>
                        : bin_kernel<T, kRegRows, false>)
                 : (agg ? bin_kernel<T, 0, true> : bin_kernel<T, 0, false>);
  cudaError_t e = cudaFuncSetAttribute(
      bin, cudaFuncAttributeMaxDynamicSharedMemorySize, bin_smem);
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
    const int flush = splits > 1 ? kAtomic : (c0 > 0 ? kAdd : kStore);
    accum_kernel<<<ntiles * sp, kAccThreads, 0, stream>>>(
        static_cast<const uint16_t*>(off_scratch),
        static_cast<const float*>(val_scratch),
        static_cast<const uint32_t*>(desc_scratch), nblocks, sp, group_warps,
        E, size, static_cast<float*>(out), flush);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The geometry (ntiles,
// block, chunk, splits, group_warps, bin_smem) and the scratch sizes come
// from the wrapper's plan (kernels/sketch_encode.py: encode_plan):
// off_scratch holds
// ceil(chunk / block) * block * rows uint16, val_scratch as many float32,
// desc_scratch ceil(chunk / block) * ntiles uint32. With splits > 1 the
// output must be zeroed. Returns the first cudaGetLastError() that is not
// cudaSuccess, else 0.
extern "C" int sketch_encode_launch(const void* g, int64_t d, int dtype,
                                    const void* hash_params, int rows,
                                    int log2w, int64_t offset, void* out,
                                    int ntiles, int block, int64_t chunk,
                                    int splits, int group_warps,
                                    int bin_smem, void* off_scratch,
                                    void* val_scratch, void* desc_scratch,
                                    void* stream) {
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
      return launch<float>(g, d, hash_params, rows, log2w, offset, out,
                           ntiles, block, chunk, splits, group_warps,
                           bin_smem, off_scratch, val_scratch, desc_scratch,
                           s);
    case 1:
      return launch<__nv_bfloat16>(g, d, hash_params, rows, log2w, offset,
                                   out, ntiles, block, chunk, splits,
                                   group_warps, bin_smem, off_scratch,
                                   val_scratch, desc_scratch, s);
    case 2:
      return launch<__half>(g, d, hash_params, rows, log2w, offset, out,
                            ntiles, block, chunk, splits, group_warps,
                            bin_smem, off_scratch, val_scratch, desc_scratch,
                            s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
