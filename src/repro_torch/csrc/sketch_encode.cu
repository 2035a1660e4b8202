// Count-Sketch encode for Hopper (sm_90a): hashed scatter-add with atomics.
//
// Replaces the TPU kernel repro/kernels/sketch_encode.py:sketch_encode
// (body _encode_kernel), which sketches through blocked signed one-hot
// matmuls because a TPU has neither atomics nor a fast data-dependent
// scatter. Hopper has both, so each element is hashed and added straight
// into its R buckets:
//
//   out[r, h_r(off + j)] += sign_r(off + j) * g[j]       for every j < d
//
// with the multiply-shift hashes of repro/core/count_sketch.py in uint32
// arithmetic (wrap-around mod 2^32, exactly as the reference).
//
// Design: a grid-stride loop, one element per thread per iteration; the
// (R, 4) hash parameters sit in shared memory; each element issues R f32
// atomicAdds into the zeroed (R, W) output, which the caller allocates. At
// the gs-SGD widths (R*W*4 = 20 MiB at R=5, W=2^20) the sketch stays
// resident in the 50 MB L2, so the atomics resolve in L2.
// Bound: reading d elements once (d * sizeof(T) bytes) plus R * d L2
// atomics; the DRAM bound is the read of g.
// Determinism: atomics add in an order that changes from run to run, so
// the sketch is not bit-reproducible on the card; it matches the plain
// index_add_ version within f32 summation-order error.

#include "sketch_common.cuh"

namespace {

using sketch_common::to_f32;

constexpr int kMaxRows = 64;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ g, int64_t d,
              const uint32_t* __restrict__ hp, int rows, int shift,
              int64_t offset, float* __restrict__ out, int64_t width) {
  __shared__ uint32_t sh[kMaxRows * 4];
  for (int t = threadIdx.x; t < rows * 4; t += blockDim.x) sh[t] = hp[t];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    const float v = to_f32(g[j]);
    if (v == 0.0f) continue;  // adds nothing (flat padding is zero)
    const uint32_t i = (uint32_t)(offset + j);
    for (int r = 0; r < rows; ++r) {
      const uint32_t hb = sh[4 * r] * i + sh[4 * r + 1];
      const uint32_t hs = sh[4 * r + 2] * i + sh[4 * r + 3];
      const uint32_t bucket = shift >= 32 ? 0u : (hb >> shift);
      atomicAdd(out + (int64_t)r * width + bucket, (hs >> 31) ? -v : v);
    }
  }
}

template <typename T>
int launch(const void* g, int64_t d, const void* hp, int rows, int shift,
           int64_t offset, void* out, int64_t width, cudaStream_t stream) {
  encode_kernel<T><<<sketch_common::grid_for(d, kThreads), kThreads, 0,
                     stream>>>(
      static_cast<const T*>(g), d, static_cast<const uint32_t*>(hp), rows,
      shift, offset, static_cast<float*>(out), width);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns cudaGetLastError().
extern "C" int sketch_encode_launch(const void* g, int64_t d, int dtype,
                                    const void* hash_params, int rows,
                                    int shift, int64_t offset, void* out,
                                    int64_t width, void* stream) {
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(g, d, hash_params, rows, shift, offset, out,
                           width, s);
    case 1:
      return launch<__nv_bfloat16>(g, d, hash_params, rows, shift, offset,
                                   out, width, s);
    case 2:
      return launch<__half>(g, d, hash_params, rows, shift, offset, out,
                            width, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
