// Device helpers of the HEAVYMIX top-k radix select, shared by the kernels
// that count its first digit while they write the keys (sketch_decode.cu,
// heavymix_scores.cu) and by the select itself (topk_select.cu).
//
// The ranking key of a float x is the bits of |x|: bit 31 cleared, so -0
// ranks as +0. For non-negative floats (+0, subnormals, normals, +inf)
// uint order is value order, and a NaN key (above 0x7F800000) ranks above
// +inf, as jax.lax.top_k ranks |NaN|. The select
// takes the 31 key bits as three MSD digits of 11, 11 and 9 bits:
//
//   digit 1 = bits 30..20 (2048 bins)   digit 2 = bits 19..9 (2048 bins)
//   digit 3 = bits 8..0 (512 bins)
//
// A CTA counts into its own shared-memory histogram, one shared atomic a
// key, and flushes each non-empty bin with one global atomic at its end.
// |est| spans a few octaves, so a few dozen of the 2048 first-digit bins
// take nearly every key; adding the lanes of a bin together first
// (__match_any_sync, one atomic per distinct bin a warp) was measured
// slower on an H100 (PERF.md): 15.19 against 15.01 ms for the main cell's
// bucket-0 decode with its histogram, 14.80 against 13.09 ms at
// W = 16,384.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix_select {

constexpr int kBins1 = 2048;  // digit 1: key bits 30..20
constexpr int kShift1 = 20;
constexpr int kBins2 = 2048;  // digit 2: key bits 19..9
constexpr int kShift2 = 9;
constexpr int kBins3 = 512;   // digit 3: key bits 8..0

__device__ __forceinline__ uint32_t key_bits(float x) {
  return __float_as_uint(x) & 0x7FFFFFFFu;
}

// Zeroes a CTA's n-bin shared histogram; the caller syncs before use.
__device__ __forceinline__ void hist_zero(uint32_t* h, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) h[t] = 0;
}

// Adds one to bin b of the shared histogram h.
__device__ __forceinline__ void hist_add(uint32_t* h, uint32_t b) {
  atomicAdd(&h[b], 1u);
}

// Adds the CTA's non-empty bins into the global histogram g. Every thread
// of the CTA calls it.
__device__ __forceinline__ void hist_flush(const uint32_t* h,
                                           uint32_t* __restrict__ g, int n) {
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const uint32_t c = h[t];
    if (c) atomicAdd(&g[t], c);
  }
}

}  // namespace radix_select
