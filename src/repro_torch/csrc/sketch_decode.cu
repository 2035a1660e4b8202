// Count-Sketch decode for Hopper (sm_90a): median-of-R estimates of the
// coordinates [offset, offset + d), and the first radix digit's histogram
// of |est| for the HEAVYMIX top-k (topk_select.cu).
//
// Replaces the TPU kernel repro/kernels/sketch_decode.py:sketch_decode
// (body _decode_kernel), which contracts signed one-hot tiles against the
// sketch on the MXU, block by block over the bucket axis (and so pads the
// width to a block multiple). Here each thread owns one coordinate j < d
// and gathers its R bucket values directly, so no width padding exists:
//
//   est[j] = median_r sign_r(i) * S[r, h_r(i)],   i = (uint32)(offset + j)
//
// (even R: mean of the two middle values). The index wraps mod 2^32 as the
// reference's uint32 cast does.
//
// Design: the scores kernel (heavymix_scores.cu) without the scoring step:
// the same grid-stride loop, hash parameters in shared memory, and
// sketch_common.cuh's gather and register median network over 8 or 32
// slots. It writes est, and each CTA counts bits 30..20 of |est| into 2048
// shared bins in the same loop (radix_select.cuh) and adds them into hist,
// a zeroed (2048,) u32 array: the select's first pass over |est| then
// costs no read of est.
// Bound: writing d * 4 bytes of est plus reading the (R, W) sketch once
// (0.47 ms at the main cell's bucket 0 on an H100). What holds it at
// ~14.7 ms there is the d * R random 4-byte gathers from the L2-resident
// sketch (~133 G/s). A redesign that holds the sketch in the shared memory
// of 8-CTA clusters (a slice of a row each), reads it through
// ld.shared::cluster into vals[r, j] and takes the median in a second pass
// was measured and lost (src/repro_torch/bench/sketch_memory_probe.cu,
// probe g; PERF.md): 28.7 ms against 14.7 ms at bucket 0, 14.7 against
// 7.6 ms at bucket 1, because a remote shared-memory load runs at 84 G/s
// and the scattered vals stores at ~118 G/s, both below the L2 gathers.

#include "radix_select.cuh"
#include "sketch_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ sk, int64_t width,
              const uint32_t* __restrict__ hp, int rows, int shift,
              int64_t offset, int64_t d, float* __restrict__ est,
              uint32_t* __restrict__ hist) {
  __shared__ uint32_t sh[N * 4];
  __shared__ uint32_t h[radix_select::kBins1];
  radix_select::hist_zero(h, radix_select::kBins1);
  sketch_common::load_hash(sh, hp, rows);  // syncs
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const float e = sketch_common::median_estimate<N>(
        sk, sh, rows, (uint32_t)(offset + j), shift, width);
    est[j] = e;
    radix_select::hist_add(h,
                           radix_select::key_bits(e) >> radix_select::kShift1);
  }
  radix_select::hist_flush(h, hist, radix_select::kBins1);
}

}  // namespace

// hist: a zeroed (2048,) u32 array that receives the histogram of bits
// 30..20 of |est|. Returns cudaGetLastError() after the launch.
extern "C" int sketch_decode_launch(const void* sketch, int64_t width,
                                    const void* hash_params, int rows,
                                    int shift, int64_t offset, int64_t d,
                                    void* est, void* hist, void* stream) {
  if (rows < 1 || rows > sketch_common::kMaxRows) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned g = sketch_common::grid_for(d, kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sk = static_cast<const float*>(sketch);
  const uint32_t* hp = static_cast<const uint32_t*>(hash_params);
  float* es = static_cast<float*>(est);
  uint32_t* hs = static_cast<uint32_t*>(hist);
  if (rows <= 8) {
    decode_kernel<8><<<g, kThreads, 0, st>>>(sk, width, hp, rows, shift,
                                             offset, d, es, hs);
  } else {
    decode_kernel<sketch_common::kMaxRows><<<g, kThreads, 0, st>>>(
        sk, width, hp, rows, shift, offset, d, es, hs);
  }
  return (int)cudaGetLastError();
}
