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
// The gather and the median network in registers are sketch_common.cuh's,
// shared with the decode kernel (sketch_decode.cu).
// Bound: writing 2 * d * 4 bytes (scores and est) plus reading the
// L2-resident (R, W) sketch once; the R gathers per coordinate are random
// 4-byte L2 reads.

#include "sketch_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const float* __restrict__ sk, int64_t width,
              const uint32_t* __restrict__ hp, int rows, int shift,
              const float* __restrict__ thr_p, int64_t d,
              float* __restrict__ scores, float* __restrict__ est) {
  __shared__ uint32_t sh[N * 4];
  sketch_common::load_hash(sh, hp, rows);
  const float thr = *thr_p;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const float e = sketch_common::median_estimate<N>(sk, sh, rows,
                                                      (uint32_t)j, shift,
                                                      width);
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
  if (rows < 1 || rows > sketch_common::kMaxRows) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned g = sketch_common::grid_for(d, kThreads);
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
    scores_kernel<sketch_common::kMaxRows><<<g, kThreads, 0, st>>>(
        sk, width, hp, rows, shift, t, d, sc, es);
  }
  return (int)cudaGetLastError();
}
