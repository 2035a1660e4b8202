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
// Both scores and est are written. The top-k over scores runs after it,
// as in the reference (kernels/ops.py heavymix_recover), as the radix
// select of topk_select.cu; this kernel also counts the select's first
// digit (bits 30..20 of the score) into 2048 shared bins per CTA and adds
// them into hist, a zeroed (2048,) u32 array (radix_select.cuh), so the
// select's first pass reads no scores.
//
// Design: grid-stride loop over coordinates; the map's row parameters in
// shared memory. R is a runtime value up to 32 (rows='log' gives
// ceil(log2 d)). The gather and the median network in registers are
// sketch_common.cuh's, shared with the decode kernel (sketch_decode.cu).
// Bound: writing 2 * d * 4 bytes (scores and est) plus reading the
// L2-resident (R, W) sketch once; the R gathers per coordinate are random
// 4-byte L2 reads.
//
// Two instances of one kernel, by bucket map: the exact sketch's
// multiply-shift hashes (heavymix_scores_launch), and the TS-sketch's map
// (heavymix_scores_ts_launch, ts_map.cuh). The second is the TS route's
// recovery (repro/core/compression.py: ts.decode, then heavymix(...,
// estimates=)), which the reference runs outside Pallas: the same est and
// boosted scores at every d, so its top-k is the same select. Under the TS
// map row 0 (m = d_pad) reads the sketch contiguously and row r at a
// stride of n_r floats, so neighbouring coordinates share L2 sectors in
// the low-n rows.

#include "radix_select.cuh"
#include "sketch_common.cuh"
#include "ts_map.cuh"

namespace {

constexpr int kThreads = 256;

template <int N, class Map>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const float* __restrict__ sk, int64_t width,
              const uint32_t* __restrict__ hp, int rows, Map map,
              const float* __restrict__ thr_p, int64_t d,
              float* __restrict__ scores, float* __restrict__ est,
              uint32_t* __restrict__ hist) {
  __shared__ uint32_t sh[N * 4];
  __shared__ uint32_t h[radix_select::kBins1];
  radix_select::hist_zero(h, radix_select::kBins1);
  sketch_common::load_hash(sh, hp, rows);  // syncs
  const float thr = *thr_p;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const float e = sketch_common::median_estimate<N>(sk, sh, rows,
                                                      (uint32_t)j, map,
                                                      width);
    const float s = fabsf(e) + ((e * e >= thr) ? 1e30f : 0.0f);
    est[j] = e;
    scores[j] = s;
    radix_select::hist_add(h,
                           radix_select::key_bits(s) >> radix_select::kShift1);
  }
  radix_select::hist_flush(h, hist, radix_select::kBins1);
}

template <class Map>
int launch(const void* sketch, int64_t width, const void* row_params,
           int rows, Map map, const void* thr, int64_t d, void* scores,
           void* est, void* hist, int sms, void* stream) {
  if (rows < 1 || rows > sketch_common::kMaxRows) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned g = sketch_common::grid_for(d, kThreads, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sk = static_cast<const float*>(sketch);
  const uint32_t* hp = static_cast<const uint32_t*>(row_params);
  const float* t = static_cast<const float*>(thr);
  float* sc = static_cast<float*>(scores);
  float* es = static_cast<float*>(est);
  uint32_t* hs = static_cast<uint32_t*>(hist);
  if (rows <= 8) {
    scores_kernel<8, Map><<<g, kThreads, 0, st>>>(sk, width, hp, rows, map,
                                                  t, d, sc, es, hs);
  } else {
    scores_kernel<sketch_common::kMaxRows, Map><<<g, kThreads, 0, st>>>(
        sk, width, hp, rows, map, t, d, sc, es, hs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The exact sketch: hash_params (rows, 4) uint32 [a, b, c, d], shift =
// 32 - log2 W. hist: a zeroed (2048,) u32 array that receives the
// histogram of bits 30..20 of the scores; sms: the card's SM count (the
// grid). Returns cudaGetLastError() after the launch.
extern "C" int heavymix_scores_launch(const void* sketch, int64_t width,
                                      const void* hash_params, int rows,
                                      int shift, const void* thr, int64_t d,
                                      void* scores, void* est, void* hist,
                                      int sms, void* stream) {
  return launch(sketch, width, hash_params, rows,
                sketch_common::ExactMap{shift}, thr, d, scores, est, hist,
                sms, stream);
}

// The TS sketch (ts_map.cuh): row_params (rows, 4) uint32 [log2 m, offset,
// c, d], bits = log2 d_pad (at most 32), W = 2^log2w. Otherwise as above.
extern "C" int heavymix_scores_ts_launch(const void* sketch, int log2w,
                                         const void* row_params, int rows,
                                         int bits, const void* thr, int64_t d,
                                         void* scores, void* est, void* hist,
                                         int sms, void* stream) {
  if (bits < 1 || bits > 32 || log2w < 1 || log2w >= bits ||
      d > ((int64_t)1 << bits)) {
    return (int)cudaErrorInvalidValue;
  }
  const ts_map::TsMap map{(uint32_t)(((uint64_t)1 << bits) - 1),
                          (uint32_t)((1u << log2w) - 1), bits};
  return launch(sketch, (int64_t)1 << log2w, row_params, rows, map, thr, d,
                scores, est, hist, sms, stream);
}
