// TS-sketch encode for Hopper (sm_90a): atomic-free, one thread a bucket.
//
// Replaces the TPU kernel repro/kernels/ts_encode.py:ts_encode (body
// _kernel), which walks W-sized blocks of g in order, group-sums each block
// per row, places the sums at stride n_r, rotates them and accumulates into
// a VMEM-resident (R, W) tile. On Hopper the blocks run in parallel, so
// instead of sharing the tile each thread OWNS one bucket of one row and
// sums all of its contributors itself, in a fixed order:
//
// Row r (m = 2^a, n = d_pad / m, b = the row offset, a multiple of W):
//   ib = (i + b) mod d_pad,  bucket = ((ib mod m) * n + ib div m) mod W.
// For n <= W, bucket beta = s * n + q (q < n, s < G = W / n) receives
//   ib = q * m + s + e * G,            e = 0 .. d_pad / W - 1,
// and for n > W, bucket beta receives
//   ib = (beta + t * W) * m + a',      t < n / W, a' < m.
// The sign is the multiply-shift top bit of the coordinate i itself.
// Coordinates i >= d are zero (g is not padded in memory) and are skipped.
//
// Threads are laid out so that neighbours (same q, consecutive s) read
// neighbouring coordinates: each warp load is 32 consecutive elements.
// Every bucket is written once by one thread, so there are no atomics and
// the sketch is bit-reproducible run to run; it differs from the plain
// index_add_ version only in the order of the f32 adds.
//
// Bound: reading g once (d * sizeof(T) bytes) and writing R * W * 4 bytes.
// This design reads g once per row (R passes, coalesced), so it sits about
// R times above that bound; the n > W case (rows with m < d_pad / W, only at
// small widths) reads with a stride of m and is slower still.

#include "sketch_common.cuh"

namespace {

using sketch_common::to_f32;

constexpr int kThreads = 256;

// rp: (rows, 4) uint32 per row [log2 m, offset b, sign c, sign d].
template <typename T>
__global__ void __launch_bounds__(kThreads)
ts_encode_kernel(const T* __restrict__ g, int64_t d,
                 const uint32_t* __restrict__ rp, int bits, int log2w,
                 float* __restrict__ out) {
  const int64_t width = (int64_t)1 << log2w;
  const int64_t tau = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tau >= width) return;
  const int r = blockIdx.y;
  const int a = (int)rp[4 * r];
  const uint64_t b = rp[4 * r + 1];
  const uint32_t c = rp[4 * r + 2], dd = rp[4 * r + 3];
  const int n_log = bits - a;
  const uint64_t dmask = ((uint64_t)1 << bits) - 1;
  const uint64_t ud = (uint64_t)d;
  const int64_t per_bucket = (int64_t)1 << (bits - log2w);  // contributors
  float acc = 0.0f;
  int64_t bucket;
  if (n_log <= log2w) {
    const int g_log = log2w - n_log;  // G = W / n contributors' stride
    const uint64_t q = (uint64_t)tau >> g_log;
    const uint64_t s = (uint64_t)tau & (((uint64_t)1 << g_log) - 1);
    bucket = (int64_t)((s << n_log) | q);
    const uint64_t step = (uint64_t)1 << g_log;
    uint64_t i = ((q << a) + s - b) & dmask;
#pragma unroll 8
    for (int64_t e = 0; e < per_bucket; ++e) {
      if (i < ud) {
        const float v = to_f32(g[i]);
        const uint32_t hs = c * (uint32_t)i + dd;
        acc += (hs >> 31) ? -v : v;
      }
      i = (i + step) & dmask;
    }
  } else {
    bucket = tau;
    const uint64_t mmask = ((uint64_t)1 << a) - 1;
    for (int64_t e = 0; e < per_bucket; ++e) {
      const uint64_t t = (uint64_t)e >> a;
      const uint64_t ib = (((uint64_t)tau + (t << log2w)) << a) +
                          ((uint64_t)e & mmask);
      const uint64_t i = (ib - b) & dmask;
      if (i < ud) {
        const float v = to_f32(g[i]);
        const uint32_t hs = c * (uint32_t)i + dd;
        acc += (hs >> 31) ? -v : v;
      }
    }
  }
  out[(int64_t)r * width + bucket] = acc;
}

template <typename T>
int launch(const void* g, int64_t d, const void* rp, int rows, int bits,
           int log2w, void* out, cudaStream_t stream) {
  const int64_t width = (int64_t)1 << log2w;
  const int threads = width < kThreads ? (int)width : kThreads;
  const dim3 grid((unsigned)((width + threads - 1) / threads),
                  (unsigned)rows);
  ts_encode_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(g), d, static_cast<const uint32_t*>(rp), bits,
      log2w, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns
// cudaGetLastError().
extern "C" int ts_encode_launch(const void* g, int64_t d, int dtype,
                                const void* row_params, int rows, int bits,
                                int log2w, void* out, void* stream) {
  if (rows < 1 || rows > 65535 || bits < 1 || bits > 32 || log2w < 1 ||
      log2w >= bits) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(g, d, row_params, rows, bits, log2w, out, s);
    case 1:
      return launch<__nv_bfloat16>(g, d, row_params, rows, bits, log2w,
                                   out, s);
    case 2:
      return launch<__half>(g, d, row_params, rows, bits, log2w, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
