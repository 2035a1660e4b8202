// HEAVYMIX decode + selection scores for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/heavymix_topk.py:heavymix_scores
// (body _scores_kernel), which gathers through signed one-hot matmuls on
// the MXU. Here each thread owns one coordinate i < d and gathers its R
// bucket values directly:
//
//   est_i   = median_r sign_r(i) * S[r, h_r(i)]   (even R: mean of the
//                                                  two middle values)
//   heavy_i = est_i^2 >= thr                      (thr = ||U||^2 / k)
//   score_i = |est_i| + 1e30 * heavy_i
//
// Both scores and est are written; the top-k over scores stays outside the
// kernel, as in the reference (kernels/ops.py heavymix_recover).
//
// Design: grid-stride loop over coordinates; hash parameters in shared
// memory. R is a runtime value up to 32 (rows='log' gives ceil(log2 d)).
// One kernel body, instantiated for a slot count N of 8 or 32: the R
// gathered values fill N slots padded with +inf, a compare-exchange
// network with compile-time indices sorts them, and the middle values are
// read with compile-time indices too, so the slots stay in registers. A
// runtime-indexed array would live in local memory: at R = 5 an insertion
// sort in such an array took 1.43x as long on an H100 (PERF.md).
// Bound: writing 2 * d * 4 bytes (scores and est) plus reading the
// L2-resident (R, W) sketch once; the R gathers per coordinate are random
// 4-byte L2 reads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float gather(const float* __restrict__ sk,
                                        const uint32_t* sh, int r,
                                        uint32_t i, int shift,
                                        int64_t width) {
  const uint32_t hb = sh[4 * r] * i + sh[4 * r + 1];
  const uint32_t hs = sh[4 * r + 2] * i + sh[4 * r + 3];
  const uint32_t bucket = shift >= 32 ? 0u : (hb >> shift);
  const float v = sk[(int64_t)r * width + bucket];
  return (hs >> 31) ? -v : v;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const float* __restrict__ sk, int64_t width,
              const uint32_t* __restrict__ hp, int rows, int shift,
              const float* __restrict__ thr_p, int64_t d,
              float* __restrict__ scores, float* __restrict__ est) {
  __shared__ uint32_t sh[N * 4];
  for (int t = threadIdx.x; t < rows * 4; t += blockDim.x) sh[t] = hp[t];
  __syncthreads();
  const float thr = *thr_p;
  const int lo_at = (rows - 1) / 2, hi_at = rows / 2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const uint32_t i = (uint32_t)j;
    float v[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      v[r] = r < rows ? gather(sk, sh, r, i, shift, width) : INFINITY;
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
    float lo = 0.0f, hi = 0.0f;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      if (t == lo_at) lo = v[t];
      if (t == hi_at) hi = v[t];
    }
    const float e = (rows & 1) ? hi : 0.5f * (lo + hi);
    est[j] = e;
    scores[j] = fabsf(e) + ((e * e >= thr) ? 1e30f : 0.0f);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int heavymix_scores_launch(const void* sketch, int64_t width,
                                      const void* hash_params, int rows,
                                      int shift, const void* thr, int64_t d,
                                      void* scores, void* est,
                                      void* stream) {
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  int64_t blocks = (d + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const unsigned g = (unsigned)blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sk = static_cast<const float*>(sketch);
  const uint32_t* hp = static_cast<const uint32_t*>(hash_params);
  const float* t = static_cast<const float*>(thr);
  float* sc = static_cast<float*>(scores);
  float* es = static_cast<float*>(est);
  if (rows <= 8) {
    scores_kernel<8><<<g, kThreads, 0, st>>>(sk, width, hp, rows, shift, t,
                                              d, sc, es);
  } else {
    scores_kernel<kMaxRows><<<g, kThreads, 0, st>>>(sk, width, hp, rows,
                                                     shift, t, d, sc, es);
  }
  return (int)cudaGetLastError();
}
