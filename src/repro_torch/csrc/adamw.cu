// AdamW in one pass for Hopper (sm_90a): for every coordinate of a
// segment, in f32,
//
//   m     = m * b1 + c1 * g
//   v     = v * b2 + (c2 * g) * g
//   u     = (m * r1) / (sqrt(v * r2) + eps)
//   u     = u + wd * p
//   p_out = p - lr * u
//
// with c1 = (float)(1 - b1), c2 = (float)(1 - b2) and r1, r2 the f32
// reciprocals of the step's bias corrections (kernels/adamw.py).
//
// Replaces no TPU kernel: the JAX package's AdamW
// (src/repro/optim/optimizers.py) is jnp ops that XLA fuses. The port ran
// it as sixteen torch ops over each (P, f) segment, each streaming whole
// segments: 38 full f32 passes where one is enough.
//
// Bound: 28 bytes a coordinate (read p, g, m and v, write p_out, m and v)
// over 3.35 TB/s. One launch a segment, grid-strided, on the caller's
// stream, with no sync and no temporary.
//
// Bit-equal to torch's op-by-op CUDA path: each step rounds once, in that
// path's order, by the _rn intrinsics, which nvcc never contracts into an
// FMA. torch divides by a CPU scalar as a multiplication by its f32
// reciprocal, so the wrapper passes r1 and r2, not the corrections.
//
// Layout: rows of n contiguous floats, row r of each tensor at r times
// that tensor's row stride, so a column slice of the wider (P, d) or
// (tp * P, d) mean gradient is read in place. A row whose five starts
// share their offset in 16 bytes takes 16-byte loads and stores after a
// scalar head, with a scalar tail; any other row takes 4-byte accesses
// (still coalesced across a warp).

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTensors = 5;  // p, g, m, v, out

struct RowStrides {
  int64_t s[kTensors];  // elements
};

struct Coeffs {
  float lr, b1, c1, b2, c2, eps, wd, r1, r2;
};

__device__ __forceinline__ float update(float p, float g, float& m, float& v,
                                        const Coeffs& c) {
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(g, c.c1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(g, c.c2), g));
  float u = __fdiv_rn(__fmul_rn(m, c.r1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, c.r2)), c.eps));
  u = __fadd_rn(u, __fmul_rn(p, c.wd));
  return __fsub_rn(p, __fmul_rn(u, c.lr));
}

__device__ __forceinline__ void one(const float* __restrict__ p,
                                    const float* __restrict__ g,
                                    float* __restrict__ m,
                                    float* __restrict__ v,
                                    float* __restrict__ out, int64_t j,
                                    const Coeffs& c) {
  float mj = __ldcs(m + j), vj = __ldcs(v + j);
  const float o = update(__ldcs(p + j), __ldcs(g + j), mj, vj, c);
  __stcs(m + j, mj);
  __stcs(v + j, vj);
  __stcs(out + j, o);
}

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const float* __restrict__ p, const float* __restrict__ g,
             float* __restrict__ m, float* __restrict__ v,
             float* __restrict__ out, RowStrides rs, int64_t rows,
             int64_t n, Coeffs c) {
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  for (int64_t r = 0; r < rows; ++r) {
    const float* pr = p + r * rs.s[0];
    const float* gr = g + r * rs.s[1];
    float* mr = m + r * rs.s[2];
    float* vr = v + r * rs.s[3];
    float* orow = out + r * rs.s[4];
    const uintptr_t a = reinterpret_cast<uintptr_t>(pr) & 15;
    const bool vec = (reinterpret_cast<uintptr_t>(gr) & 15) == a &&
                     (reinterpret_cast<uintptr_t>(mr) & 15) == a &&
                     (reinterpret_cast<uintptr_t>(vr) & 15) == a &&
                     (reinterpret_cast<uintptr_t>(orow) & 15) == a;
    if (!vec) {
      for (int64_t j = tid; j < n; j += nthreads) {
        one(pr, gr, mr, vr, orow, j, c);
      }
      continue;
    }
    const int64_t head = min(n, (int64_t)(((16 - a) & 15) >> 2));
    const int64_t nv = (n - head) >> 2;
    const int64_t tail = head + 4 * nv;
    if (tid < head + (n - tail)) {
      one(pr, gr, mr, vr, orow, tid < head ? tid : tail + (tid - head), c);
    }
    const float4* p4 = reinterpret_cast<const float4*>(pr + head);
    const float4* g4 = reinterpret_cast<const float4*>(gr + head);
    float4* m4 = reinterpret_cast<float4*>(mr + head);
    float4* v4 = reinterpret_cast<float4*>(vr + head);
    float4* o4 = reinterpret_cast<float4*>(orow + head);
    for (int64_t j = tid; j < nv; j += nthreads) {
      const float4 pj = __ldcs(p4 + j), gj = __ldcs(g4 + j);
      float4 mj = __ldcs(m4 + j), vj = __ldcs(v4 + j), oj;
      oj.x = update(pj.x, gj.x, mj.x, vj.x, c);
      oj.y = update(pj.y, gj.y, mj.y, vj.y, c);
      oj.z = update(pj.z, gj.z, mj.z, vj.z, c);
      oj.w = update(pj.w, gj.w, mj.w, vj.w, c);
      __stcs(m4 + j, mj);
      __stcs(v4 + j, vj);
      __stcs(o4 + j, oj);
    }
  }
}

}  // namespace

// strides: the row strides (elements) of p, g, m, v and out; coeffs: lr,
// b1, c1, b2, c2, eps, wd, r1, r2.
extern "C" int adamw_launch(const void* p, const void* g, void* m, void* v,
                            void* out, int64_t rows, const int64_t* strides,
                            int64_t n, const float* coeffs, int sms,
                            void* stream) {
  RowStrides rs;
  for (int t = 0; t < kTensors; ++t) {
    rs.s[t] = strides[t];
  }
  if (rows < 1 || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adamw_kernel, kThreads, 0);
    if (e != cudaSuccess) {
      return (int)e;
    }
  }
  const int64_t units = (n + 3) / 4;  // a row's float4s
  const int64_t want = (units + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)per_sm * sms;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  const Coeffs c{coeffs[0], coeffs[1], coeffs[2], coeffs[3], coeffs[4],
                 coeffs[5], coeffs[6], coeffs[7], coeffs[8]};
  adamw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<float*>(out), rs, rows, n, c);
  return (int)cudaGetLastError();
}
