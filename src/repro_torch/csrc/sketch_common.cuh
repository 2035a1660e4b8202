// Device helpers shared by the port's kernels: the gather and median-of-R
// of the decode and HEAVYMIX scores kernels (sketch_decode.cu,
// heavymix_scores.cu), the input conversion of the encoders
// (sketch_encode.cu, ts_encode.cu), and the grid of a grid-stride loop.
//
// est(i) = median_r sign_r(i) * S[r, bucket_r(i)]   (even R: mean of the
//                                                   two middle values)
// The bucket and sign map is a template parameter: ExactMap, the
// multiply-shift hashes of repro/core/count_sketch.py in uint32 arithmetic
// (wrap-around mod 2^32, as the reference), or TsMap (ts_map.cuh), the
// TS-sketch's digit transpose of repro/core/ts_sketch.py.
//
// The R gathered values fill N slots (N = 8 or 32, a compile-time
// constant) padded with +inf. A compare-exchange network with
// compile-time indices sorts them, and the middle values are read at
// compile-time indices too, so the slots stay in registers. A
// runtime-indexed array would live in local memory: at R = 5 an insertion
// sort in such an array took 1.43x as long on an H100 (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sketch_common {

constexpr int kMaxRows = 32;  // rows='log' gives ceil(log2 d) <= 32

// Input element -> f32 (the encoders read f32, bf16 or f16).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Copies a map's (rows, 4) row parameters into shared memory.
__device__ __forceinline__ void load_hash(uint32_t* sh,
                                          const uint32_t* __restrict__ hp,
                                          int rows) {
  for (int t = threadIdx.x; t < rows * 4; t += blockDim.x) sh[t] = hp[t];
  __syncthreads();
}

// The exact sketch's map: multiply-shift hashes of the coordinate. p: the
// row's (a, b, c, d); bucket = (a * i + b) >> (32 - log2 W), sign = the top
// bit of c * i + d.
struct ExactMap {
  int shift;  // 32 - log2(W)
  __device__ __forceinline__ uint32_t bucket(const uint32_t* p,
                                             uint32_t i) const {
    const uint32_t hb = p[0] * i + p[1];
    return shift >= 32 ? 0u : (hb >> shift);
  }
  __device__ __forceinline__ uint32_t sign_bit(const uint32_t* p,
                                               uint32_t i) const {
    return (p[2] * i + p[3]) & 0x80000000u;
  }
};

template <class Map>
__device__ __forceinline__ float gather(const float* __restrict__ sk,
                                        const uint32_t* sh, int r,
                                        uint32_t i, const Map& map,
                                        int64_t width) {
  const uint32_t* p = sh + 4 * r;
  const float v = sk[(int64_t)r * width + map.bucket(p, i)];
  return map.sign_bit(p, i) ? -v : v;
}

// Median over the rows of coordinate i's R signed bucket values.
template <int N, class Map>
__device__ __forceinline__ float median_estimate(const float* __restrict__ sk,
                                                 const uint32_t* sh,
                                                 int rows, uint32_t i,
                                                 const Map& map,
                                                 int64_t width) {
  float v[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    v[r] = r < rows ? gather(sk, sh, r, i, map, width) : INFINITY;
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
  return (rows & 1) ? hi : 0.5f * (lo + hi);
}

// Grid for a grid-stride loop over n items on a card of sms SMs: at most
// 16 blocks an SM.
inline unsigned grid_for(int64_t n, int threads, int sms) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = (int64_t)(sms > 0 ? sms : 1) * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

}  // namespace sketch_common
