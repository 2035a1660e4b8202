// Count-Sketch decode for Hopper (sm_90a): median-of-R estimates of the
// coordinates [offset, offset + d).
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
// slots. It writes est only.
// Bound: writing d * 4 bytes of est plus reading the L2-resident (R, W)
// sketch once; the R gathers per coordinate are random 4-byte L2 reads.

#include "sketch_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ sk, int64_t width,
              const uint32_t* __restrict__ hp, int rows, int shift,
              int64_t offset, int64_t d, float* __restrict__ est) {
  __shared__ uint32_t sh[N * 4];
  sketch_common::load_hash(sh, hp, rows);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    est[j] = sketch_common::median_estimate<N>(
        sk, sh, rows, (uint32_t)(offset + j), shift, width);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int sketch_decode_launch(const void* sketch, int64_t width,
                                    const void* hash_params, int rows,
                                    int shift, int64_t offset, int64_t d,
                                    void* est, void* stream) {
  if (rows < 1 || rows > sketch_common::kMaxRows) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned g = sketch_common::grid_for(d, kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sk = static_cast<const float*>(sketch);
  const uint32_t* hp = static_cast<const uint32_t*>(hash_params);
  float* es = static_cast<float*>(est);
  if (rows <= 8) {
    decode_kernel<8><<<g, kThreads, 0, st>>>(sk, width, hp, rows, shift,
                                              offset, d, es);
  } else {
    decode_kernel<sketch_common::kMaxRows><<<g, kThreads, 0, st>>>(
        sk, width, hp, rows, shift, offset, d, es);
  }
  return (int)cudaGetLastError();
}
