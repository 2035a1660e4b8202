// Memory-system probe for the Count-Sketch kernels on one Hopper card.
//
// Measures the access patterns a Count-Sketch encode or decode can be
// built from, at the main cell's bucket-0 sizes (R = 5, W = 2^20: a
// 20 MiB sketch; d = 388,956,160 f32 coordinates: 1.56 GB):
//
//   a  random red.global.add.f32 into the 20 MiB sketch (a direct scatter)
//   b  random f32 atomicAdd, u32 atomicAdd (its old value used, as a rank)
//      and red.shared.add.f32 into a CTA's own shared memory
//   c  random red.shared::cluster.add.f32 and ld.shared::cluster across a
//      cluster of 8 and of 16 CTAs (16 is a non-portable size)
//   d  cudaOccupancyMaxActiveClusters for cluster sizes and shared memory
//   e  clusters that each stream the same 1.56 GB array (float4 loads, and
//      1-D cp.async.bulk into a 4-stage ring of 8 KB), against one read
//   f  scattered 4-byte stores at the decode's density: 15 CTA groups
//      (row, third of the row) each writing vals[r, j] where row r's bucket
//      of j lies in its third
//   g  the decode design D2 (sketch slices in 8-CTA clusters' shared
//      memory, ld.shared::cluster into vals[r, j], then a median pass)
//      against the direct decode, both bucket shapes, est bit for bit
//   h  random 4-byte gathers from the L2-resident sketch (20 MiB at bucket
//      0, 10 MiB at bucket 1) with 1, 2 and 4 coordinates a thread in
//      flight (all their R gathers issued before any is used): the gathers
//      alone, and the whole direct decode (median, est written), est bit
//      for bit against one coordinate a thread
//   i  the TS encode's one-pass read pattern alone (csrc/ts_encode.cu): at
//      bucket 0 (W = 2^20, n_max = 256, G_min = 4096), 512 CTAs of 512
//      threads each read X consecutive floats at every multiple of G_min
//      in every block of W (X = 8 as the kernel, 16 and 32 with the blocks
//      split over 2 and 4 CTAs), with and without a barrier every 2
//      blocks; against one streaming read of the same 1.56 GB
//   k  the exact encode's integer adds (csrc/sketch_encode.cu): random u64
//      atomicAdd into a CTA's own shared memory (a 192 KB table of three
//      8192-cell limb arrays, one add a step, and two adds a step to two
//      limbs of one cell, the accumulate pass's pattern for |v| < 1;
//      against u32 and f32 atomicAdd into the same bytes), and random
//      red.global.add.u64 into a 3 x 5 x 2^20 u64 accumulator (against
//      red.global.add.f32 into a 5 x 2^20 f32 sketch)
//
// Build and run on the card (prints one JSON object a line):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/sketch_memory_probe src/repro_torch/bench/sketch_memory_probe.cu
//   build/sketch_memory_probe [PROBES]     (PROBES: letters, default abcdefghijk)
//
// Each rate is the mean over several timed launches (CUDA events) after a
// warm-up launch.

#include "../csrc/radix_select.cuh"
#include "../csrc/sketch_common.cuh"
#include "../csrc/ts_map.cuh"

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <array>
#include <string>

namespace cg = cooperative_groups;

#define CK(x)                                                              \
  do {                                                                     \
    cudaError_t e_ = (x);                                                  \
    if (e_ != cudaSuccess) {                                               \
      fprintf(stderr, "%s:%d %s: %s\n", __FILE__, __LINE__, #x,            \
              cudaGetErrorString(e_));                                     \
      exit(1);                                                             \
    }                                                                      \
  } while (0)

constexpr uint32_t kA = 0x9E3779B1u, kB = 0x7F4A7C15u;
constexpr uint32_t kC = 0x85EBCA6Bu, kD = 0xC2B2AE35u;

__host__ __device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= kC;
  x ^= x >> 13;
  x *= kD;
  x ^= x >> 16;
  return x;
}

// ---------------------------------------------------------------- a
__global__ void red_global(float* sk, int64_t d, int rows, int shift,
                           int64_t width) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const uint32_t i = (uint32_t)j;
    for (int r = 0; r < rows; ++r) {
      const uint32_t hb = (kA + 2u * r) * i + kB * (r + 1);
      atomicAdd(sk + r * width + (hb >> shift), 1.0f);
    }
  }
}

// ---------------------------------------------------------------- b
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// mode 0: f32 atomicAdd; 1: u32 atomicAdd whose old value is used (a
// rank); 2: red.shared.add.f32.
__global__ void red_local(float* out, int iters, uint32_t n, int mode) {
  extern __shared__ float sm[];
  for (uint32_t t = threadIdx.x; t < n; t += blockDim.x) sm[t] = 0.f;
  __syncthreads();
  uint32_t s = mix(blockIdx.x * blockDim.x + threadIdx.x), acc = 0;
  for (int it = 0; it < iters; ++it) {
    s = s * 1664525u + 1013904223u;
    float* a = sm + __umulhi(s, n);
    if (mode == 0) {
      atomicAdd(a, 1.0f);
    } else if (mode == 1) {
      acc += atomicAdd(reinterpret_cast<uint32_t*>(a), 1u);
    } else {
      asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(smem_u32(a)),
                   "f"(1.0f)
                   : "memory");
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = sm[blockIdx.x % n] + (float)acc;
}

// ---------------------------------------------------------------- k
// mode 0: u64 atomicAdd, one a step into n u64; 1: two u64 atomicAdds a
// step, to cell x of limb arrays 1 and 2 (n / 3 cells each); 2: u32
// atomicAdd into 2n u32; 3: f32 atomicAdd into 2n f32 (the same bytes).
__global__ void red_local_u64(float* out, int iters, uint32_t n, int mode) {
  extern __shared__ unsigned long long su[];
  for (uint32_t t = threadIdx.x; t < n; t += blockDim.x) su[t] = 0ull;
  __syncthreads();
  uint32_t s = mix(blockIdx.x * blockDim.x + threadIdx.x);
  const uint32_t third = n / 3;
  for (int it = 0; it < iters; ++it) {
    s = s * 1664525u + 1013904223u;
    if (mode == 0) {
      atomicAdd(su + __umulhi(s, n), (unsigned long long)(s | 1u));
    } else if (mode == 1) {
      const uint32_t x = __umulhi(s, third);
      atomicAdd(su + third + x, (unsigned long long)(s | 1u));
      atomicAdd(su + 2 * third + x, (unsigned long long)(s >> 3));
    } else if (mode == 2) {
      atomicAdd(reinterpret_cast<uint32_t*>(su) + __umulhi(s, 2 * n), 1u);
    } else {
      atomicAdd(reinterpret_cast<float*>(su) + __umulhi(s, 2 * n), 1.0f);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = (float)su[blockIdx.x % n];
}

__global__ void red_global_u64(unsigned long long* acc, int64_t d, int rows,
                               int shift, int64_t width) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const uint32_t i = (uint32_t)j;
    for (int r = 0; r < rows; ++r) {
      const uint32_t hb = (kA + 2u * r) * i + kB * (r + 1);
      atomicAdd(acc + (int64_t)(r % 3) * rows * width + r * width +
                    (hb >> shift),
                1ull);
    }
  }
}

// ---------------------------------------------------------------- c
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t o;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(o) : "r"(addr), "r"(rank));
  return o;
}

// mode 0: red.shared::cluster to a random CTA of the cluster;
// mode 1: ld.shared::cluster from a random CTA (summed);
// mode 2: red.shared::cluster to the CTA itself (the local path of 0).
__global__ void cluster_ops(float* out, int iters, uint32_t n, int mode) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const uint32_t cs = cl.num_blocks(), me = cl.block_rank();
  for (uint32_t t = threadIdx.x; t < n; t += blockDim.x) sm[t] = 1.f;
  cl.sync();
  const uint32_t base = smem_u32(sm);
  uint32_t s = mix(blockIdx.x * blockDim.x + threadIdx.x);
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    s = s * 1664525u + 1013904223u;
    const uint32_t rank = mode == 2 ? me : (s >> 8) % cs;
    const uint32_t a = mapa(base + 4u * __umulhi(s, n), rank);
    if (mode == 1) {
      float v;
      asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a));
      acc += v;
    } else {
      asm volatile("red.shared::cluster.add.f32 [%0], %1;" ::"r"(a),
                   "f"(1.0f)
                   : "memory");
    }
  }
  cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = acc + sm[me % n];
}

// ---------------------------------------------------------------- e
// Every cluster reads all n4 float4 of x; CTA k of a cluster reads tiles
// k, k + cs, ... of 2048 float4.
__global__ void stream_cluster(const float4* __restrict__ x, int64_t n4,
                               float* out, int cs) {
  const int k = blockIdx.x % cs;
  float acc = 0.f;
  constexpr int kTile = 2048;
  for (int64_t t0 = (int64_t)k * kTile; t0 < n4; t0 += (int64_t)cs * kTile) {
    for (int u = threadIdx.x; u < kTile && t0 + u < n4; u += blockDim.x) {
      const float4 v = x[t0 + u];
      acc += v.x + v.y + v.z + v.w;
    }
  }
  if (acc == 12345.f) out[blockIdx.x] = acc;
}

__device__ __forceinline__ void mbar_init(uint32_t a, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(a),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t a, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(a),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t a, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The same as stream_cluster through a ring of 4 x 8 KB stages filled by
// 1-D bulk copies (tile = 8 KB = 512 float4).
__global__ void stream_bulk(const float4* __restrict__ x, int64_t n4,
                            float* out, int cs) {
  constexpr int kStages = 4, kTile = 512;
  __shared__ __align__(128) float4 ring[kStages][kTile];
  __shared__ __align__(8) uint64_t full[kStages];
  const int k = blockIdx.x % cs;
  const int64_t ntiles = n4 / kTile;  // n4 is a multiple of kTile here
  int64_t mine = ntiles > k ? (ntiles - k + cs - 1) / cs : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int64_t t) {
    const int s = (int)(t % kStages);
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, kTile * 16);
    bulk_g2s(smem_u32(&ring[s][0]), x + (k + t * cs) * kTile, kTile * 16,
             bar);
  };
  if (threadIdx.x == 0)
    for (int64_t t = 0; t < kStages && t < mine; ++t) issue(t);
  float acc = 0.f;
  for (int64_t t = 0; t < mine; ++t) {
    const int s = (int)(t % kStages);
    mbar_wait(smem_u32(&full[s]), (uint32_t)((t / kStages) & 1));
    for (int u = threadIdx.x; u < kTile; u += blockDim.x) {
      const float4 v = ring[s][u];
      acc += v.x + v.y + v.z + v.w;
    }
    __syncthreads();
    if (threadIdx.x == 0 && t + kStages < mine) issue(t + kStages);
  }
  if (acc == 12345.f) out[blockIdx.x] = acc;
}

// ---------------------------------------------------------------- f
// 15 groups (5 rows x 3 thirds) of ctas_per_group CTAs; group (r, s)
// writes vals[r * chunk + j] for the j of the chunk whose row-r bucket
// lies in third s. dense = 1: group (r, s) writes the s-th third of row
// r contiguously (no test), for the dense-store rate.
__global__ void scatter_store(float* vals, int64_t chunk, int passes,
                              int ctas_per_group, int dense) {
  const int grp = blockIdx.x / ctas_per_group, c = blockIdx.x % ctas_per_group;
  const int r = grp / 3, third = grp % 3;
  const uint32_t a = kA + 2u * r, b = kB * (r + 1);
  const uint32_t lo = (uint32_t)(((uint64_t)third << 32) / 3);
  const uint32_t span = (uint32_t)((((uint64_t)(third + 1) << 32) / 3) - lo);
  for (int p = 0; p < passes; ++p) {
    const uint32_t base = (uint32_t)(p * chunk);
    for (int64_t j = (int64_t)c * blockDim.x + threadIdx.x; j < chunk;
         j += (int64_t)ctas_per_group * blockDim.x) {
      const uint32_t hb = a * (base + (uint32_t)j) + b;
      if (dense) {  // group (r, s) writes the s-th third of row r
        const int64_t jj = third * (chunk / 3) + j / 3;
        if (j % 3 == 0) vals[r * chunk + jj] = (float)hb;
      } else if (hb - lo < span) {
        vals[r * chunk + j] = (float)hb;
      }
    }
  }
}

// ---------------------------------------------------------------- g
// The decode design D2: the (R, W) sketch held in the shared memory of
// clusters of 8 CTAs (a cluster a slice: a third, or a half, of a row),
// read through distributed shared memory into vals[r, j]; then the median
// over R of each column. Checked bit for bit against the direct decode
// (one thread a coordinate, R gathers from L2: the algorithm of
// csrc/sketch_decode.cu), which it is timed against.
__device__ __forceinline__ float median8(float* v, int rows) {
#pragma unroll
  for (int a = 0; a < 7; ++a) {
#pragma unroll
    for (int b = 0; b < 7 - a; ++b) {
      const float x = fminf(v[b], v[b + 1]), y = fmaxf(v[b], v[b + 1]);
      v[b] = x;
      v[b + 1] = y;
    }
  }
  const int lo_at = (rows - 1) / 2, hi_at = rows / 2;
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t == lo_at) lo = v[t];
    if (t == hi_at) hi = v[t];
  }
  return (rows & 1) ? hi : 0.5f * (lo + hi);
}

__global__ void direct_decode(const float* __restrict__ sk, int64_t width,
                              const uint32_t* __restrict__ hp, int rows,
                              int shift, int64_t d, float* __restrict__ est) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const uint32_t i = (uint32_t)j;
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < rows) {
        const uint32_t hb = hp[4 * r] * i + hp[4 * r + 1];
        const uint32_t hs = hp[4 * r + 2] * i + hp[4 * r + 3];
        const float x = sk[r * width + (hb >> shift)];
        v[r] = (hs >> 31) ? -x : x;
      } else {
        v[r] = INFINITY;
      }
    }
    est[j] = median8(v, rows);
  }
}

// Cluster c holds slice s = c % spr of row r = c / spr: buckets
// [s * 8p, min(W, (s + 1) * 8p)), p floats a CTA. magic = ceil(2^40 / p).
__global__ void d2_vals(const float* __restrict__ sk, int64_t width,
                        const uint32_t* __restrict__ hp, int shift, int spr,
                        int p, uint64_t magic, int64_t j0, int64_t n,
                        float* __restrict__ vals) {
  extern __shared__ float slice[];
  cg::cluster_group cl = cg::this_cluster();
  const uint32_t k = cl.block_rank();
  const int c = blockIdx.x / 8, r = c / spr, s = c % spr;
  const int64_t lo = (int64_t)s * 8 * p;
  const int64_t hi = min(width, lo + 8 * (int64_t)p);
  const int64_t mine = lo + (int64_t)k * p;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    slice[q] = mine + q < hi ? sk[r * width + mine + q] : 0.f;
  }
  cl.sync();
  const uint32_t a = hp[4 * r], b = hp[4 * r + 1];
  const uint32_t cc = hp[4 * r + 2], dd = hp[4 * r + 3];
  const uint32_t span = (uint32_t)(hi - lo), base = smem_u32(slice);
  for (int64_t j = (int64_t)k * blockDim.x + threadIdx.x; j < n;
       j += 8 * (int64_t)blockDim.x) {
    const uint32_t i = (uint32_t)(j0 + j);
    const uint32_t rel = ((a * i + b) >> shift) - (uint32_t)lo;
    if (rel < span) {
      const uint32_t owner = (uint32_t)(((uint64_t)rel * magic) >> 40);
      const uint32_t addr = mapa(base + 4u * (rel - owner * p), owner);
      float v;
      asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr));
      vals[r * n + j] = ((cc * i + dd) >> 31) ? -v : v;
    }
  }
  cl.sync();  // no CTA leaves while its slice may still be read
}

__global__ void d2_median(const float* __restrict__ vals, int rows, int64_t n,
                          float* __restrict__ est) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = r < rows ? vals[r * n + j] : INFINITY;
    est[j] = median8(v, rows);
  }
}

// ---------------------------------------------------------------- h
// C coordinates a thread in flight: j0, j0 + stride, ... The C * R
// gathers are all issued before any is used. mode 0: the gathers alone
// (summed into one word a thread, so none is dropped); mode 1: the direct
// decode (the median of each coordinate written to est).
template <int C>
__global__ void gather_mlp(const float* __restrict__ sk, int64_t width,
                           const uint32_t* __restrict__ hp, int rows,
                           int shift, int64_t d, int mode,
                           float* __restrict__ est) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float acc = 0.0f;
  for (int64_t j0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j0 < d;
       j0 += stride * C) {
    float v[C][8];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t j = j0 + c * stride;
      const uint32_t i = (uint32_t)j;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r < rows && j < d) {
          const uint32_t hb = hp[4 * r] * i + hp[4 * r + 1];
          const uint32_t hs = hp[4 * r + 2] * i + hp[4 * r + 3];
          const float x = sk[r * width + (hb >> shift)];
          v[c][r] = (hs >> 31) ? -x : x;
        } else {
          v[c][r] = INFINITY;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int64_t j = j0 + c * stride;
      if (mode == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (r < rows && j < d) acc += v[c][r];
        }
      } else if (j < d) {
        est[j] = median8(v[c], rows);
      }
    }
  }
  if (mode == 0) est[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void count_unequal(const float* a, const float* b, int64_t n,
                              unsigned long long* bad) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    if (__float_as_uint(a[j]) != __float_as_uint(b[j])) atomicAdd(bad, 1ull);
  }
}

__global__ void fill_random(float* x, int64_t n, uint32_t seed) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    x[j] = (float)(int)mix((uint32_t)j ^ seed) * 4.656612873e-10f;
  }
}

// ----------------------------------------------------------------------
struct Timer {
  cudaEvent_t a, b;
  Timer() {
    CK(cudaEventCreate(&a));
    CK(cudaEventCreate(&b));
  }
  void start() { CK(cudaEventRecord(a)); }
  float stop_ms(int reps) {
    CK(cudaEventRecord(b));
    CK(cudaEventSynchronize(b));
    CK(cudaGetLastError());
    float ms;
    CK(cudaEventElapsedTime(&ms, a, b));
    return ms / reps;
  }
};

template <typename K, typename... Args>
float time_cluster(K kernel, int cs, int grid, int threads, size_t smem,
                   int reps, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  CK(cudaLaunchKernelEx(&cfg, kernel, args...));
  CK(cudaDeviceSynchronize());
  Timer t;
  t.start();
  for (int i = 0; i < reps; ++i) CK(cudaLaunchKernelEx(&cfg, kernel, args...));
  return t.stop_ms(reps);
}

template <typename K>
int active_clusters(K kernel, int cs, int threads, size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cs * 64);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return n;
}

// ---------------------------------------------------------------- i
// CTA (column set cs, block segment seg) reads the X floats at c0 + G_min y
// (c0 = X cs, y < n_max) of every block j of its segment, one float4 a
// thread and step; a barrier every sync_every blocks (0: none).
template <int X>
__global__ void onepass_read(const float* __restrict__ g, int64_t nblk,
                             int log2w, int gmin_log, int nmax, int segs,
                             int sync_every, float* out) {
  constexpr int kq = X / 4;
  const int colsets = gridDim.x / segs;
  const int cs = blockIdx.x % colsets, seg = blockIdx.x / colsets;
  const int64_t jlo = nblk * seg / segs, jhi = nblk * (seg + 1) / segs;
  const int64_t c0 = (int64_t)cs * X;
  float acc = 0.0f;
#pragma unroll 2
  for (int64_t j = jlo; j < jhi; ++j) {
    for (int k = threadIdx.x; k < nmax * kq; k += blockDim.x) {
      const int y = k / kq, c = k % kq;
      const float4 v = __ldcs(reinterpret_cast<const float4*>(
          g + (j << log2w) + c0 + 4 * c + ((int64_t)y << gmin_log)));
      acc += (v.x + v.y) + (v.z + v.w);
    }
    if (sync_every && j % sync_every == 0) __syncthreads();
  }
  out[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void stream_read(const float4* __restrict__ g, int64_t n4,
                            float* out) {
  float acc = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 v = __ldcs(g + i);
    acc += (v.x + v.y) + (v.z + v.w);
  }
  out[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// ---------------------------------------------------------------- j
// The TS-map scores loop of csrc/heavymix_scores.cu in variants: N median
// slots; HIST 0 none, 1 one shared atomic a key, 2 warp-aggregated adds;
// HOIST: each row's map constants in registers (needs rows == N); FOLD:
// every bucket folded into the row's first 4096 floats.
template <int N, int HIST, bool HOIST, bool FOLD>
__global__ void __launch_bounds__(256)
ts_scores_variant(const float* __restrict__ sk, int64_t width,
                  const uint32_t* __restrict__ hp, int rows,
                  ts_map::TsMapT map, float thr, int64_t d,
                  float* __restrict__ scores, float* __restrict__ est,
                  uint32_t* __restrict__ hist) {
  __shared__ uint32_t sh[N * 4];
  __shared__ uint32_t h[radix_select::kBins1];
  radix_select::hist_zero(h, radix_select::kBins1);
  sketch_common::load_hash(sh, hp, rows);
  uint32_t ra[N], rb[N], rc[N], rd[N], rq[N], rm[N];
  bool rt[N];
  if (HOIST) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int a = (int)sh[4 * r], nlog = map.bits - a;
      ra[r] = (uint32_t)a;
      rb[r] = sh[4 * r + 1];
      rc[r] = sh[4 * r + 2];
      rd[r] = sh[4 * r + 3];
      rt[r] = nlog < map.log2w;
      rq[r] = rt[r] ? (uint32_t)(map.log2w - nlog) : 0u;
      rm[r] = rt[r] ? ((1u << rq[r]) - 1u) : 0u;
    }
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const uint32_t i = (uint32_t)j;
    float e;
    if (HOIST || FOLD) {
      float v[N];
      bool any_nan = false;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        uint32_t bk, neg;
        if (HOIST) {
          const uint32_t q =
              (uint32_t)((uint64_t)((i + rb[r]) & map.dmask) >> ra[r]);
          bk = rt[r] ? ((q << rq[r]) | (i & rm[r])) : (q & map.wmask);
          neg = ts_map::sign_bit(rc[r], rd[r], i);
        } else {
          bk = map.bucket(sh + 4 * r, i);
          neg = map.sign_bit(sh + 4 * r, i);
        }
        if (FOLD) bk &= 4095u;
        const float x = r < rows ? sk[(int64_t)r * width + bk] : INFINITY;
        v[r] = (r < rows && neg) ? -x : x;
        any_nan |= isnan(v[r]);
      }
#pragma unroll
      for (int a = 0; a < N - 1; ++a) {
#pragma unroll
        for (int b = 0; b < N - 1 - a; ++b) {
          const float x = fminf(v[b], v[b + 1]);
          const float y = fmaxf(v[b], v[b + 1]);
          v[b] = x;
          v[b + 1] = y;
        }
      }
      const int lo_at = (rows - 1) / 2, hi_at = rows / 2;
      float lo = 0.0f, hi = 0.0f;
#pragma unroll
      for (int t = 0; t < N; ++t) {
        if (t == lo_at) lo = v[t];
        if (t == hi_at) hi = v[t];
      }
      e = any_nan ? __int_as_float(0x7FC00000)
                  : ((rows & 1) ? hi : 0.5f * (lo + hi));
    } else {
      e = sketch_common::median_estimate<N>(sk, sh, rows, i, map, width);
    }
    const float s = fabsf(e) + ((e * e >= thr) ? 1e30f : 0.0f);
    est[j] = e;
    scores[j] = s;
    const uint32_t bin = radix_select::key_bits(s) >> radix_select::kShift1;
    if (HIST == 1) radix_select::hist_add(h, bin);
    if (HIST == 2) {
      const unsigned peers = __match_any_sync(__activemask(), bin);
      if ((threadIdx.x & 31) == __ffs(peers) - 1) {
        atomicAdd(&h[bin], (uint32_t)__popc(peers));
      }
    }
  }
  radix_select::hist_flush(h, hist, radix_select::kBins1);
}

int main(int argc, char** argv) {
  // argv[1]: the probes to run (default all), e.g. "bc"
  const char* only = argc > 1 ? argv[1] : "abcdefghijk";
  auto want = [&](char c) { return strchr(only, c) != nullptr; };
  int dev = 0, sms = 0, clk_khz = 0;
  CK(cudaSetDevice(dev));
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  CK(cudaDeviceGetAttribute(&clk_khz, cudaDevAttrClockRate, dev));
  cudaDeviceProp prop;
  CK(cudaGetDeviceProperties(&prop, dev));
  printf("{\"probe\": \"device\", \"name\": \"%s\", \"sms\": %d, "
         "\"clock_khz\": %d, \"l2_bytes\": %d, \"smem_optin\": %zu}\n",
         prop.name, sms, clk_khz, prop.l2CacheSize,
         prop.sharedMemPerBlockOptin);
  const double clk_hz = clk_khz * 1e3;
  float* out;
  CK(cudaMalloc(&out, 1 << 20));

  const size_t smem_max = prop.sharedMemPerBlockOptin;
  CK(cudaFuncSetAttribute(red_local,
                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                          (int)smem_max));
  CK(cudaFuncSetAttribute(cluster_ops,
                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                          (int)smem_max));
  CK(cudaFuncSetAttribute(cluster_ops,
                          cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  CK(cudaFuncSetAttribute(stream_cluster,
                          cudaFuncAttributeNonPortableClusterSizeAllowed, 1));

  // d: active clusters
  if (want('d')) {
    const int sizes[][2] = {{2, 200 << 10}, {4, 200 << 10}, {8, 200 << 10},
                            {8, 175 << 10}, {8, 128 << 10}, {16, 200 << 10},
                            {16, 128 << 10}, {16, 64 << 10}};
    for (auto& s : sizes) {
      printf("{\"probe\": \"d_active_clusters\", \"cluster\": %d, "
             "\"smem_bytes\": %d, \"threads\": 1024, \"active\": %d}\n",
             s[0], s[1], active_clusters(cluster_ops, s[0], 1024, s[1]));
    }
  }

  // a: random global reds (a direct scatter's pattern)
  if (want('a')) {
    const int rows = 5, shift = 12;
    const int64_t width = 1 << 20, d = 1 << 27;
    float* sk;
    CK(cudaMalloc(&sk, rows * width * 4));
    CK(cudaMemset(sk, 0, rows * width * 4));
    const int grid = sms * 16, reps = 3;
    red_global<<<grid, 256>>>(sk, d, rows, shift, width);
    CK(cudaDeviceSynchronize());
    Timer t;
    t.start();
    for (int i = 0; i < reps; ++i)
      red_global<<<grid, 256>>>(sk, d, rows, shift, width);
    const float ms = t.stop_ms(reps);
    printf("{\"probe\": \"a_red_global\", \"ops\": %lld, \"ms\": %.4f, "
           "\"gops_per_s\": %.2f}\n",
           (long long)(d * rows), ms, d * rows / (ms * 1e6));
    CK(cudaFree(sk));
  }

  // b: local shared atomics, one CTA an SM
  if (want('b')) {
    const char* local_modes[] = {"atomicAdd_f32", "atomicAdd_u32_rank",
                                 "red_shared_f32"};
    for (int mode = 0; mode < 3; ++mode) {
      for (int threads : {512, 1024}) {
        for (uint32_t n : {43520u, 8192u}) {  // 170 KB, 32 KB of f32
          const int iters = 1 << 14, reps = 3;
          red_local<<<sms, threads, n * 4>>>(out, iters, n, mode);
          CK(cudaDeviceSynchronize());
          Timer t;
          t.start();
          for (int i = 0; i < reps; ++i)
            red_local<<<sms, threads, n * 4>>>(out, iters, n, mode);
          const float ms = t.stop_ms(reps);
          const double ops = (double)sms * threads * iters;
          printf("{\"probe\": \"b_atomic_shared_local\", \"op\": \"%s\", "
                 "\"threads\": %d, \"table_floats\": %u, \"ops\": %.0f, "
                 "\"ms\": %.4f, \"gops_per_s\": %.2f, \"per_sm_per_clk\": "
                 "%.3f}\n",
                 local_modes[mode], threads, n, ops, ms, ops / (ms * 1e6),
                 ops / (ms * 1e-3) / sms / clk_hz);
        }
      }
    }
  }

  // c: cluster reds and loads
  if (want('c')) {
    const char* modes[] = {"red_remote_random", "ld_remote_random",
                           "red_cluster_self"};
    for (int cs : {8, 16}) {
      const uint32_t n = cs == 8 ? 43520u : 32768u;
      const int act = active_clusters(cluster_ops, cs, 1024, n * 4);
      if (act <= 0) {
        printf("{\"probe\": \"c_cluster\", \"cluster\": %d, \"active\": %d}\n",
               cs, act);
        continue;
      }
      for (int mode = 0; mode < 3; ++mode) {
        for (int threads : {512, 1024}) {
          const int iters = 1 << 13, reps = 3;
          const float ms = time_cluster(cluster_ops, cs, act * cs, threads,
                                        n * 4, reps, out, iters, n, mode);
          const double ops = (double)act * cs * threads * iters;
          printf("{\"probe\": \"c_cluster\", \"mode\": \"%s\", \"cluster\": "
                 "%d, \"clusters\": %d, \"threads\": %d, \"ops\": %.0f, "
                 "\"ms\": %.4f, \"gops_per_s\": %.2f, \"per_sm_per_clk\": "
                 "%.3f}\n",
                 modes[mode], cs, act, threads, ops, ms, ops / (ms * 1e6),
                 ops / (ms * 1e-3) / (act * cs) / clk_hz);
        }
      }
    }
  }

  // e: clusters streaming the same 1.56 GB
  if (want('e')) {
    const int64_t n = 388956160, n4 = n / 4;  // multiple of 512 float4
    float* x;
    CK(cudaMalloc(&x, n * 4));
    CK(cudaMemset(x, 0, n * 4));
    const int reps = 3;
    // one read by the whole card
    {
      const float ms = time_cluster(stream_cluster, 1, sms * 4, 512, 0, reps,
                                    (const float4*)x, n4, out, sms * 4);
      printf("{\"probe\": \"e_stream_once\", \"bytes\": %lld, \"ms\": %.4f, "
             "\"gb_per_s\": %.1f}\n",
             (long long)(n * 4), ms, n * 4 / (ms * 1e6));
    }
    for (int cs : {8, 16}) {
      const int act = active_clusters(stream_cluster, cs, 512, 0);
      for (int nclusters : {act, 15, 8}) {
        if (nclusters > act || (cs == 16 && nclusters != act)) continue;
        const float ms =
            time_cluster(stream_cluster, cs, nclusters * cs, 512, 0, reps,
                         (const float4*)x, n4, out, cs);
        const double bytes = (double)n * 4 * nclusters;
        printf("{\"probe\": \"e_stream_clusters\", \"load\": \"float4\", "
               "\"cluster\": %d, \"clusters\": %d, \"bytes_to_sms\": %.0f, "
               "\"ms\": %.4f, \"gb_per_s_to_sms\": %.1f, "
               "\"ms_per_cluster_pass\": %.4f}\n",
               cs, nclusters, bytes, ms, bytes / (ms * 1e6), ms);
      }
    }
    {
      const int cs = 8, nclusters = 15;
      const float ms = time_cluster(stream_bulk, cs, nclusters * cs, 256, 0,
                                    reps, (const float4*)x, n4, out, cs);
      const double bytes = (double)n * 4 * nclusters;
      printf("{\"probe\": \"e_stream_clusters\", \"load\": \"cp.async.bulk "
             "4x8KB\", \"cluster\": %d, \"clusters\": %d, \"bytes_to_sms\": "
             "%.0f, \"ms\": %.4f, \"gb_per_s_to_sms\": %.1f}\n",
             cs, nclusters, bytes, ms, bytes / (ms * 1e6));
    }
    CK(cudaFree(x));
  }

  // f: the decode's scattered vals stores (5 rows x 2^24 per chunk)
  if (want('f')) {
    const int64_t chunk = 1 << 24;
    const int passes = 24, reps = 2;  // 24 chunks ~ d at bucket 0
    float* vals;
    CK(cudaMalloc(&vals, 5 * chunk * 4));
    for (int dense = 0; dense < 2; ++dense) {
      for (int per : {8, 16}) {
        const float ms = time_cluster(scatter_store, 1, 15 * per, 512, 0,
                                      reps, vals, chunk, passes, per, dense);
        const double stores = 5.0 * chunk * passes;
        printf("{\"probe\": \"f_vals_stores\", \"pattern\": \"%s\", "
               "\"ctas_per_group\": %d, \"stores\": %.0f, \"ms\": %.4f, "
               "\"gstores_per_s\": %.2f, \"gb_per_s\": %.1f}\n",
               dense ? "dense (a third of a row a group)"
                     : "third of a row a group",
               per, stores, ms, stores / (ms * 1e6), stores * 4 / (ms * 1e6));
      }
    }
    CK(cudaFree(vals));
  }
  // g: the decode design D2 against the direct decode, at the main cell's
  // two bucket shapes
  if (want('g')) {
    const int rows = 5;
    const int64_t chunk = 1 << 24;
    const struct { int64_t d; int log2w; int spr; } shapes[] = {
        {388956160, 20, 3}, {201864704, 19, 3}, {201864704, 19, 2}};
    uint32_t hp_h[4 * rows];
    uint32_t st = 12345u;
    for (int t = 0; t < 4 * rows; ++t) {
      st = st * 1664525u + 1013904223u;
      hp_h[t] = mix(st) | ((t % 2 == 0) ? 1u : 0u);
    }
    uint32_t* hp;
    CK(cudaMalloc(&hp, sizeof(hp_h)));
    CK(cudaMemcpy(hp, hp_h, sizeof(hp_h), cudaMemcpyHostToDevice));
    unsigned long long* bad;
    CK(cudaMalloc(&bad, 8));
    CK(cudaFuncSetAttribute(d2_vals,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem_max));
    for (auto& sh : shapes) {
      const int64_t width = 1ll << sh.log2w, d = sh.d;
      const int shift = 32 - sh.log2w;
      const int p = (int)((width / sh.spr + 8) / 8 + 1);
      const uint64_t magic = ((1ull << 40) + p - 1) / p;
      float *sk, *est, *ref, *vals;
      CK(cudaMalloc(&sk, rows * width * 4));
      CK(cudaMalloc(&est, d * 4));
      CK(cudaMalloc(&ref, d * 4));
      CK(cudaMalloc(&vals, rows * chunk * 4));
      fill_random<<<sms * 8, 256>>>(sk, rows * width, 7u);
      const int reps = 3;
      auto run_direct = [&]() {
        direct_decode<<<sms * 16, 256>>>(sk, width, hp, rows, shift, d, ref);
      };
      auto run_d2 = [&]() {
        for (int64_t j0 = 0; j0 < d; j0 += chunk) {
          const int64_t n = d - j0 < chunk ? d - j0 : chunk;
          cudaLaunchConfig_t cfg = {};
          cudaLaunchAttribute attr[1];
          attr[0].id = cudaLaunchAttributeClusterDimension;
          attr[0].val.clusterDim.x = 8;
          attr[0].val.clusterDim.y = 1;
          attr[0].val.clusterDim.z = 1;
          cfg.gridDim = dim3(rows * sh.spr * 8);
          cfg.blockDim = dim3(1024);
          cfg.dynamicSmemBytes = (size_t)p * 4;
          cfg.attrs = attr;
          cfg.numAttrs = 1;
          CK(cudaLaunchKernelEx(&cfg, d2_vals, (const float*)sk, width,
                                (const uint32_t*)hp, shift, sh.spr, p, magic,
                                j0, n, vals));
          d2_median<<<sms * 16, 256>>>(vals, rows, n, est + j0);
        }
      };
      run_direct();
      run_d2();
      CK(cudaDeviceSynchronize());
      CK(cudaMemset(bad, 0, 8));
      count_unequal<<<sms * 8, 256>>>(est, ref, d, bad);
      unsigned long long nbad = 0;
      CK(cudaMemcpy(&nbad, bad, 8, cudaMemcpyDeviceToHost));
      Timer t;
      float ms_direct[2], ms_d2[2];
      const int order[4] = {0, 1, 1, 0};  // direct, d2, d2, direct
      for (int q = 0; q < 4; ++q) {
        t.start();
        for (int i = 0; i < reps; ++i) {
          if (order[q]) {
            run_d2();
          } else {
            run_direct();
          }
        }
        (order[q] ? ms_d2 : ms_direct)[q / 2] = t.stop_ms(reps);
      }
      // the vals pass alone
      t.start();
      for (int64_t j0 = 0; j0 < d; j0 += chunk) {
        const int64_t n = d - j0 < chunk ? d - j0 : chunk;
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = 8;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(rows * sh.spr * 8);
        cfg.blockDim = dim3(1024);
        cfg.dynamicSmemBytes = (size_t)p * 4;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        CK(cudaLaunchKernelEx(&cfg, d2_vals, (const float*)sk, width,
                              (const uint32_t*)hp, shift, sh.spr, p, magic,
                              j0, n, vals));
      }
      const float ms_vals = t.stop_ms(1);
      printf("{\"probe\": \"g_decode_d2\", \"d\": %lld, \"rows\": %d, "
             "\"width\": %lld, \"slices_per_row\": %d, \"clusters\": %d, "
             "\"bytes_per_cta\": %d, \"chunk\": %lld, \"ms_direct\": "
             "[%.4f, %.4f], \"ms_d2\": [%.4f, %.4f], \"ms_d2_vals_pass\": "
             "%.4f, \"est_not_bit_equal\": %llu}\n",
             (long long)d, rows, (long long)width, sh.spr, rows * sh.spr,
             p * 4, (long long)chunk, ms_direct[0], ms_direct[1], ms_d2[0],
             ms_d2[1], ms_vals, nbad);
      CK(cudaFree(sk));
      CK(cudaFree(est));
      CK(cudaFree(ref));
      CK(cudaFree(vals));
    }
    CK(cudaFree(hp));
    CK(cudaFree(bad));
  }
  // h: the gathers' memory-level parallelism, both bucket shapes
  if (want('h')) {
    const int rows = 5;
    const struct { int64_t d; int log2w; } shapes[] = {{388956160, 20},
                                                       {201864704, 19}};
    uint32_t hp_h[4 * rows];
    uint32_t st = 12345u;
    for (int t = 0; t < 4 * rows; ++t) {
      st = st * 1664525u + 1013904223u;
      hp_h[t] = mix(st) | ((t % 2 == 0) ? 1u : 0u);
    }
    uint32_t* hp;
    CK(cudaMalloc(&hp, sizeof(hp_h)));
    CK(cudaMemcpy(hp, hp_h, sizeof(hp_h), cudaMemcpyHostToDevice));
    unsigned long long* bad;
    CK(cudaMalloc(&bad, 8));
    for (auto& sh : shapes) {
      const int64_t width = 1ll << sh.log2w, d = sh.d;
      const int shift = 32 - sh.log2w, grid = sms * 16, reps = 3;
      float *sk, *est, *ref;
      CK(cudaMalloc(&sk, rows * width * 4));
      CK(cudaMalloc(&est, d * 4));
      CK(cudaMalloc(&ref, d * 4));
      fill_random<<<sms * 8, 256>>>(sk, rows * width, 7u);
      direct_decode<<<grid, 256>>>(sk, width, hp, rows, shift, d, ref);
      CK(cudaDeviceSynchronize());
      for (int mode = 0; mode < 2; ++mode) {
        for (int c : {1, 2, 4}) {
          auto run = [&]() {
            if (c == 1) {
              gather_mlp<1><<<grid, 256>>>(sk, width, hp, rows, shift, d,
                                           mode, est);
            } else if (c == 2) {
              gather_mlp<2><<<grid, 256>>>(sk, width, hp, rows, shift, d,
                                           mode, est);
            } else {
              gather_mlp<4><<<grid, 256>>>(sk, width, hp, rows, shift, d,
                                           mode, est);
            }
          };
          run();
          CK(cudaDeviceSynchronize());
          unsigned long long nbad = 0;
          if (mode == 1) {
            CK(cudaMemset(bad, 0, 8));
            count_unequal<<<sms * 8, 256>>>(est, ref, d, bad);
            CK(cudaMemcpy(&nbad, bad, 8, cudaMemcpyDeviceToHost));
          }
          Timer t;
          t.start();
          for (int i = 0; i < reps; ++i) run();
          const float ms = t.stop_ms(reps);
          const double gathers = (double)d * rows;
          printf("{\"probe\": \"h_gather_mlp\", \"what\": \"%s\", "
                 "\"coords_per_thread\": %d, \"d\": %lld, \"rows\": %d, "
                 "\"table_bytes\": %lld, \"gathers\": %.0f, \"ms\": "
                 "%.4f, \"ggathers_per_s\": %.2f, \"est_not_bit_equal\": "
                 "%llu}\n",
                 mode ? "decode" : "gathers only", c, (long long)d, rows,
                 (long long)(rows * width * 4), gathers, ms,
                 gathers / (ms * 1e6), nbad);
        }
      }
      CK(cudaFree(sk));
      CK(cudaFree(est));
      CK(cudaFree(ref));
    }
    CK(cudaFree(hp));
    CK(cudaFree(bad));
  }
  // i: the TS encode's one-pass read pattern
  if (want('i')) {
    const int64_t d = 388956160;
    const int log2w = 20, nmax = 256, gmin_log = 12, reps = 5;
    const int64_t nblk = (d + (1 << log2w) - 1) >> log2w;
    float* g;
    CK(cudaMalloc(&g, nblk << log2w << 2));  // whole blocks: no tail mask
    fill_random<<<sms * 8, 256>>>(g, nblk << log2w, 3u);
    CK(cudaDeviceSynchronize());
    const double bytes = (double)(nblk << log2w) * 4;
    auto report = [&](const char* what, int x, int segs, int sync_every,
                      float ms) {
      printf("{\"probe\": \"i_onepass_read\", \"what\": \"%s\", "
             "\"cols\": %d, \"segments\": %d, \"sync_every\": %d, "
             "\"bytes\": %.0f, \"ms\": %.4f, \"tb_per_s\": %.3f}\n",
             what, x, segs, sync_every, bytes, ms, bytes / (ms * 1e9));
    };
    {
      const int grid = sms * 3;  // 512 threads each: out holds 2^18 floats
      stream_read<<<grid, 512>>>(reinterpret_cast<const float4*>(g),
                                 (nblk << log2w) / 4, out);
      CK(cudaDeviceSynchronize());
      Timer t;
      t.start();
      for (int i = 0; i < reps; ++i)
        stream_read<<<grid, 512>>>(reinterpret_cast<const float4*>(g),
                                   (nblk << log2w) / 4, out);
      report("stream", 0, 0, 0, t.stop_ms(reps));
    }
    for (int sync_every : {0, 2}) {
      for (int x : {8, 16, 32}) {
        const int segs = x / 8, grid = ((1 << gmin_log) / x) * segs;
        auto run = [&]() {
          if (x == 8) {
            onepass_read<8><<<grid, 512>>>(g, nblk, log2w, gmin_log, nmax,
                                           segs, sync_every, out);
          } else if (x == 16) {
            onepass_read<16><<<grid, 512>>>(g, nblk, log2w, gmin_log, nmax,
                                            segs, sync_every, out);
          } else {
            onepass_read<32><<<grid, 512>>>(g, nblk, log2w, gmin_log, nmax,
                                            segs, sync_every, out);
          }
        };
        run();
        CK(cudaDeviceSynchronize());
        Timer t;
        t.start();
        for (int i = 0; i < reps; ++i) run();
        report("onepass pattern", x, segs, sync_every, t.stop_ms(reps));
      }
    }
    CK(cudaFree(g));
  }
  // j: what sets the TS-map scores kernel's pace
  if (want('j')) {
    struct Geo {
      const char* what;
      int64_t d;
      int bits, log2w;
    };
    const Geo geos[] = {{"bucket 0", 388956160, 29, 20},
                        {"bucket 1", 201864704, 28, 19}};
    for (const Geo& g : geos) {
      const int rows = 5, reps = 10;
      const int64_t w = (int64_t)1 << g.log2w;
      // the TS rows' log2 m (ts_sketch.py log_m: bits .. log2w + 1), the
      // offsets and sign constants drawn from mix()
      uint32_t hp_h[rows * 4];
      for (int r = 0; r < rows; ++r) {
        const int lo = g.log2w + 1;
        hp_h[4 * r] = (uint32_t)(g.bits -
                                 (int)lrint(r * (g.bits - lo) / 4.0));
        hp_h[4 * r + 1] = (mix(17u + r) % (1u << (g.bits - g.log2w)))
                          << g.log2w;
        hp_h[4 * r + 2] = mix(101u + r) | 1u;
        hp_h[4 * r + 3] = mix(303u + r);
      }
      uint32_t* hp;
      float *sk, *sc, *es, *sc0, *es0;
      uint32_t *hist, *hist0;
      unsigned long long* bad;
      CK(cudaMalloc(&hp, sizeof(hp_h)));
      CK(cudaMemcpy(hp, hp_h, sizeof(hp_h), cudaMemcpyHostToDevice));
      CK(cudaMalloc(&sk, rows * w * 4));
      CK(cudaMalloc(&sc, g.d * 4));
      CK(cudaMalloc(&es, g.d * 4));
      CK(cudaMalloc(&sc0, g.d * 4));
      CK(cudaMalloc(&es0, g.d * 4));
      CK(cudaMalloc(&hist, 2048 * 4));
      CK(cudaMalloc(&hist0, 2048 * 4));
      CK(cudaMalloc(&bad, 8));
      fill_random<<<sms * 8, 256>>>(sk, rows * w, 11u);
      const ts_map::TsMapT map{(uint32_t)(((uint64_t)1 << g.bits) - 1),
                               (uint32_t)(w - 1), g.bits, g.log2w};
      const float thr = 0.49f;  // |est| >= 0.7: ~5% of the medians of 5
                                // cells uniform on [-1, 1), as the TS
                                // route's 4.7% heavy
      const unsigned grid = sketch_common::grid_for(g.d, 256, sms);
      auto check = [&](const char* what, bool exact) {
        uint32_t nb[3] = {0, 0, 0};
        if (exact) {
          unsigned long long nbad = 0;
          CK(cudaMemset(bad, 0, 8));
          count_unequal<<<sms * 8, 256>>>(es, es0, g.d, bad);
          CK(cudaMemcpy(&nbad, bad, 8, cudaMemcpyDeviceToHost));
          nb[0] = (uint32_t)nbad;
          CK(cudaMemset(bad, 0, 8));
          count_unequal<<<sms * 8, 256>>>(sc, sc0, g.d, bad);
          CK(cudaMemcpy(&nbad, bad, 8, cudaMemcpyDeviceToHost));
          nb[1] = (uint32_t)nbad;
          uint32_t a[2048], b[2048];
          CK(cudaMemcpy(a, hist, sizeof(a), cudaMemcpyDeviceToHost));
          CK(cudaMemcpy(b, hist0, sizeof(b), cudaMemcpyDeviceToHost));
          for (int t = 0; t < 2048; ++t) nb[2] += a[t] != b[t];
        }
        (void)what;
        return std::array<uint32_t, 3>{nb[0], nb[1], nb[2]};
      };
      auto run = [&](const char* what, auto kernel, bool into0, bool exact,
                     bool has_hist) {
        float* s_out = into0 ? sc0 : sc;
        float* e_out = into0 ? es0 : es;
        uint32_t* h_out = into0 ? hist0 : hist;
        CK(cudaMemset(h_out, 0, 2048 * 4));
        kernel<<<grid, 256>>>(sk, w, hp, rows, map, thr, g.d, s_out, e_out,
                              h_out);
        CK(cudaDeviceSynchronize());
        const auto nb = into0 ? std::array<uint32_t, 3>{0, 0, 0}
                              : check(what, exact);
        Timer t;
        t.start();
        for (int i = 0; i < reps; ++i) {
          kernel<<<grid, 256>>>(sk, w, hp, rows, map, thr, g.d, s_out, e_out,
                                h_out);
        }
        const float ms = t.stop_ms(reps);
        if (into0) {  // the reference histogram of one launch again
          CK(cudaMemset(h_out, 0, 2048 * 4));
          kernel<<<grid, 256>>>(sk, w, hp, rows, map, thr, g.d, s_out, e_out,
                                h_out);
          CK(cudaDeviceSynchronize());
        }
        printf("{\"probe\": \"j_ts_scores\", \"shape\": \"%s\", \"d\": %lld, "
               "\"width\": %lld, \"what\": \"%s\", \"ms\": %.4f, "
               "\"est_unequal\": %u, \"scores_unequal\": %u, "
               "\"hist_bins_unequal\": %s}\n",
               g.what, (long long)g.d, (long long)w, what, ms,
               exact ? nb[0] : 0u, exact ? nb[1] : 0u,
               !exact ? "null" : (has_hist ? std::to_string(nb[2]).c_str()
                                           : "null"));
      };
      run("as the kernel: 8 slots, shared atomic a key",
          ts_scores_variant<8, 1, false, false>, true, true, true);
      run("as the kernel again", ts_scores_variant<8, 1, false, false>,
          false, true, true);
      run("no histogram", ts_scores_variant<8, 0, false, false>, false,
          true, false);
      run("warp-aggregated histogram", ts_scores_variant<8, 2, false, false>,
          false, true, true);
      run("5 slots", ts_scores_variant<5, 1, false, false>, false, true,
          true);
      run("5 slots, row constants in registers",
          ts_scores_variant<5, 1, true, false>, false, true, true);
      run("5 slots, row constants in registers, no histogram",
          ts_scores_variant<5, 0, true, false>, false, true, false);
      run("5 slots, row constants in registers, warp-aggregated histogram",
          ts_scores_variant<5, 2, true, false>, false, true, true);
      run("as the kernel, gathers folded into 16 KB a row",
          ts_scores_variant<8, 1, false, true>, false, false, true);
      for (void* p : {(void*)hp, (void*)sk, (void*)sc, (void*)es, (void*)sc0,
                      (void*)es0, (void*)hist, (void*)hist0, (void*)bad}) {
        CK(cudaFree(p));
      }
    }
  }
  // k: the exact encode's integer adds
  if (want('k')) {
    CK(cudaFuncSetAttribute(red_local_u64,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            3 * 8192 * 8));
    const char* modes[] = {"atomicAdd_u64", "atomicAdd_u64_two_limbs",
                           "atomicAdd_u32", "atomicAdd_f32"};
    for (int mode = 0; mode < 4; ++mode) {
      for (int threads : {512, 1024}) {
        const uint32_t n = 3 * 8192;  // 192 KB of u64
        const int iters = 1 << 14, reps = 3;
        red_local_u64<<<sms, threads, n * 8>>>(out, iters, n, mode);
        CK(cudaDeviceSynchronize());
        Timer t;
        t.start();
        for (int i = 0; i < reps; ++i)
          red_local_u64<<<sms, threads, n * 8>>>(out, iters, n, mode);
        const float ms = t.stop_ms(reps);
        const double ops = (double)sms * threads * iters * (mode == 1 ? 2 : 1);
        printf("{\"probe\": \"k_atomic_shared_int\", \"op\": \"%s\", "
               "\"threads\": %d, \"table_bytes\": %u, \"ops\": %.0f, "
               "\"ms\": %.4f, \"gops_per_s\": %.2f, \"per_sm_per_clk\": "
               "%.3f}\n",
               modes[mode], threads, n * 8, ops, ms, ops / (ms * 1e6),
               ops / (ms * 1e-3) / sms / clk_hz);
      }
    }
    const int rows = 5, shift = 12;
    const int64_t width = 1 << 20, d = 1 << 27;
    unsigned long long* acc;
    CK(cudaMalloc(&acc, 3 * rows * width * 8));
    CK(cudaMemset(acc, 0, 3 * rows * width * 8));
    const int grid = sms * 16, reps = 3;
    red_global_u64<<<grid, 256>>>(acc, d, rows, shift, width);
    CK(cudaDeviceSynchronize());
    Timer t;
    t.start();
    for (int i = 0; i < reps; ++i)
      red_global_u64<<<grid, 256>>>(acc, d, rows, shift, width);
    const float ms = t.stop_ms(reps);
    printf("{\"probe\": \"k_red_global_u64\", \"ops\": %lld, \"ms\": %.4f, "
           "\"gops_per_s\": %.2f}\n",
           (long long)(d * rows), ms, d * rows / (ms * 1e6));
    CK(cudaFree(acc));
  }

  CK(cudaFree(out));
  return 0;
}
