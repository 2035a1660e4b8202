// TS-sketch encode for Hopper (sm_90a): atomic-free, bit-reproducible run
// to run, in two kernels picked from the geometry alone
// (kernels/ts_encode.py ts_encode_plan).
//
// Replaces the TPU kernel repro/kernels/ts_encode.py:ts_encode (body
// _kernel), which walks W-sized blocks of g in order, group-sums each block
// per row, places the sums at stride n_r, rotates them and accumulates into
// a VMEM-resident (R, W) tile. On Hopper the blocks run in parallel, so no
// CTA can carry the tile from block to block; instead each bucket has one
// owner that sums its contributors in a fixed order.
//
// Row r (m = 2^a, n = d_pad / m, b = the row offset, a multiple of W):
//   ib = (i + b) mod d_pad,  bucket = ((ib mod m) * n + ib div m) mod W.
// The sign is the multiply-shift top bit of the coordinate i itself
// (ts_map.cuh). Coordinates i >= d are zero (g is not padded in memory).
// Bound: reading g once (d * sizeof(T) bytes) and writing R * W * 4 bytes.
//
// 1. ts_encode_onepass_kernel: reads g once for all rows. Write i = j W + t
//    (block j, column t < W). Since b is a multiple of W, the column is the
//    same in every row and row r sees block j'_r = (j + b / W) mod (d_pad /
//    W). For n <= W, with G = W / n:
//      bucket_r(i) = (t mod G) * n + (j'_r >> (a - log2 W))
//    so bucket (s, q) of row r sums the columns t = s (mod G) over the q-th
//    run of m / W >= 2 consecutive blocks. Let G_min = W / n_max, the G of
//    the row with the most runs. A CTA owns the 8 consecutive columns at
//    c0 + G_min * y for every y < n_max (a set closed under + G_min), so
//    every bucket's columns lie in one CTA: G_min / 8 CTAs, 2 n_max threads
//    each, a thread four columns (lane pairs read a 32-byte sector). The
//    CTA walks the blocks once, in order, with each thread's run sums in
//    registers (R x 4); where a row's run ends (the same block for the whole
//    CTA) it reduces the sums of each bucket's n columns, first across the
//    lanes (xor shuffles), then across the warps (a fixed-order sum of
//    per-warp partials in shared memory), and adds the result to the
//    CTA's shared (R, 8 n_max) bucket sums, written once at the end. No
//    atomics and no device scratch. Each row flushes d / m + 1 times at
//    most, so the flushes of the rows with short runs (2 blocks at the main
//    cell) set the CTA's pace between loads.
// 2. ts_encode_kernel (the R-pass kernel): one thread a (row, bucket), which
//    reads its contributors itself: g is read once per row (R passes,
//    coalesced). It serves the geometries the one-pass kernel does not
//    take: small widths, where G_min < 8 (or n_r > W) leaves too few
//    columns to give every CTA a whole bucket set, and sketches whose
//    one-pass grid would not fill the card.
//
// Both sum in another order than the plain index_add_ version (tolerance
// 1e-4 * max|S|).

#include "sketch_common.cuh"
#include "ts_map.cuh"

namespace {

using sketch_common::to_f32;

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// 1. The one-pass kernel.

constexpr int kCols = 8;             // consecutive columns a CTA owns per y
constexpr int kOnePassMaxThreads = 1024;

// Four consecutive elements of g from element i on, as f32; those at or
// past d are zero. vec: g's base is aligned for one vector load of four.
__device__ __forceinline__ void load4v(const float* p, float v[4]) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4v(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xFFFF0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load4v(const __half* p, float v[4]) {
  const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
  v[0] = __half2float(__ushort_as_half((unsigned short)(x.x & 0xFFFFu)));
  v[1] = __half2float(__ushort_as_half((unsigned short)(x.x >> 16)));
  v[2] = __half2float(__ushort_as_half((unsigned short)(x.y & 0xFFFFu)));
  v[3] = __half2float(__ushort_as_half((unsigned short)(x.y >> 16)));
}

template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ g, int64_t i,
                                      int64_t d, bool vec, float v[4]) {
  if (vec && i + 4 <= d) {
    load4v(g + i, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = i + e < d ? to_f32(g[i + e]) : 0.0f;
  }
}

// Grid: G_min / 8 CTAs of 2 n_max threads; dynamic shared memory
// (8 R + 16) n_max floats: the CTA's (R, 8 n_max) bucket sums and two
// (threads, 4) flush buffers. rp: (R, 4) uint32 [log2 m, offset, c, d].
// Each thread loads two blocks ahead. On an H100 (PERF.md) the kernel
// takes 2.7x its byte bound at the main cell, and neither a ring of four
// blocks in flight nor sign hashes by increments moved it; the read
// pattern alone (32-byte runs 16 KB apart) streams at 2.2 TB/s, so most of
// the rest is the per-block work and the flushes' barriers.
template <typename T, int R>
__global__ void __launch_bounds__(kOnePassMaxThreads)
ts_encode_onepass_kernel(const T* __restrict__ g, int64_t d, bool vec,
                         const uint32_t* __restrict__ rp, int bits,
                         int log2w, int nmax_log, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int n_log[R], run_log[R];
  __shared__ uint32_t oblk[R];
  const int nthreads = blockDim.x;            // 2 n_max
  const int ncols = kCols << nmax_log;        // buckets a row, per CTA
  float* sb = smem;                            // (R, ncols) bucket sums
  float* part = smem + R * ncols;              // 2 x (nthreads, 4)
  const int tid = threadIdx.x;
  const int h = tid & 1, y = tid >> 1;         // lane bits 1..4: y bits 0..3
  const int nwarps = nthreads >> 5;
  const int gmin_log = log2w - nmax_log;
  const int64_t width = (int64_t)1 << log2w;
  const uint32_t nb_mask = (1u << (bits - log2w)) - 1u;  // blocks of d_pad
  const uint32_t c0 = (uint32_t)blockIdx.x * kCols;
  const uint32_t t0 = c0 + 4 * h + ((uint32_t)y << gmin_log);

  for (int k = tid; k < R * ncols; k += nthreads) sb[k] = 0.0f;
  if (tid < R) {
    const int a = (int)rp[4 * tid];
    n_log[tid] = bits - a;
    run_log[tid] = a - log2w;
    oblk[tid] = rp[4 * tid + 1] >> log2w;
  }
  uint32_t cm[R], cd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cm[r] = rp[4 * r + 2];
    cd[r] = rp[4 * r + 3];
  }
  __syncthreads();

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
  }
  const int64_t nblk = (d + width - 1) >> log2w;  // blocks that hold data
  float nx0[4], nx1[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the next two blocks
  load4(g, t0, d, vec, nx0);
  if (nblk > 1) load4(g, width + t0, d, vec, nx1);
  int flushes = 0;
  for (int64_t j = 0; j < nblk; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = nx0[e];
      nx0[e] = nx1[e];
    }
    if (j + 2 < nblk) load4(g, ((j + 2) << log2w) + t0, d, vec, nx1);
    const uint32_t i0 = (uint32_t)((j << log2w) + t0);  // i < d_pad <= 2^32
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t neg = ts_map::sign_bit(cm[r], cd[r], i0 + e);
        acc[r][e] += __uint_as_float(__float_as_uint(v[e]) ^ neg);
      }
    }
    const bool last = j + 1 == nblk;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int nl = n_log[r], rl = run_log[r];
      const uint32_t jp = ((uint32_t)j + oblk[r]) & nb_mask;
      // a run ends after this block (rows of one run never change bucket)
      const bool ends = nl > 0 && ((jp + 1) & ((1u << rl) - 1u)) == 0;
      if (!(ends || last)) continue;
      const uint32_t q = jp >> rl;
      const int rb = nmax_log - nl;  // log2(n_max / n): y bits of a bucket
      float* row = sb + r * ncols;
      if (nl == 0) {
        // one contributor a bucket: the thread's own columns
#pragma unroll
        for (int e = 0; e < 4; ++e) row[y * kCols + 4 * h + e] += acc[r][e];
      } else {
        float w4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) w4[e] = acc[r][e];
        for (int b = rb; b < 4; ++b) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            w4[e] += __shfl_xor_sync(0xffffffffu, w4[e], 2 << b);
          }
        }
        float* pb = part + (flushes & 1) * nthreads * 4;
        *reinterpret_cast<float4*>(pb + 4 * tid) =
            make_float4(w4[0], w4[1], w4[2], w4[3]);
        __syncthreads();
        // bucket (x, y_lo): y_lo's bits 0..3 pick the lane, the rest the
        // low warp bits; the warps of the other y bits add in order
        const int wlo = rb > 4 ? rb - 4 : 0;
        const int nwhi = nwarps >> wlo;
        for (int kb = tid; kb < (kCols << rb); kb += nthreads) {
          const int x = kb & (kCols - 1), ylo = kb >> 3;
          const int lane = (x >> 2) + 2 * (ylo & 15);
          const float* src = pb + (((ylo >> 4) * 32 + lane) * 4 + (x & 3));
          float sum = src[0];
          for (int wh = 1; wh < nwhi; ++wh) sum += src[(wh << wlo) * 128];
          row[((ylo * kCols + x) << nl) + q] += sum;
        }
        ++flushes;  // the next flush writes the other buffer: no sync here
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
    }
  }
  __syncthreads();
  // sb[r][(y_lo * 8 + x) * n + q] is bucket (c0 + x + y_lo G_min) * n + q
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int nl = n_log[r];
    for (int k = tid; k < ncols; k += nthreads) {
      const int64_t ylo = k >> (nl + 3);
      out[r * width + (((int64_t)c0 + (ylo << gmin_log)) << nl) +
          (k & ((kCols << nl) - 1))] = sb[r * ncols + k];
    }
  }
}

template <typename T, int R>
int launch_onepass_rows(const T* g, int64_t d, const uint32_t* rp, int bits,
                        int log2w, int nmax_log, float* out,
                        cudaStream_t stream) {
  const int threads = 2 << nmax_log;
  const unsigned ctas = 1u << (log2w - nmax_log - 3);
  const size_t smem = (size_t)(kCols * R + 16) * 4 << nmax_log;
  const auto kernel = ts_encode_onepass_kernel<T, R>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) == 0;
  kernel<<<ctas, threads, smem, stream>>>(g, d, vec, rp, bits, log2w,
                                          nmax_log, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_onepass(const void* g, int64_t d, const void* rp, int rows,
                   int bits, int log2w, int nmax_log, void* out,
                   cudaStream_t s) {
  const T* gp = static_cast<const T*>(g);
  const uint32_t* p = static_cast<const uint32_t*>(rp);
  float* o = static_cast<float*>(out);
  switch (rows) {
    case 2: return launch_onepass_rows<T, 2>(gp, d, p, bits, log2w,
                                             nmax_log, o, s);
    case 3: return launch_onepass_rows<T, 3>(gp, d, p, bits, log2w,
                                             nmax_log, o, s);
    case 4: return launch_onepass_rows<T, 4>(gp, d, p, bits, log2w,
                                             nmax_log, o, s);
    case 5: return launch_onepass_rows<T, 5>(gp, d, p, bits, log2w,
                                             nmax_log, o, s);
    case 6: return launch_onepass_rows<T, 6>(gp, d, p, bits, log2w,
                                             nmax_log, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// 2. The R-pass kernel. For n <= W, bucket beta = s * n + q (q < n,
// s < G = W / n) receives
//   ib = q * m + s + e * G,            e = 0 .. d_pad / W - 1,
// and for n > W, bucket beta receives
//   ib = (beta + t * W) * m + a',      t < n / W, a' < m.
// Threads are laid out so that neighbours (same q, consecutive s) read
// neighbouring coordinates: each warp load is 32 consecutive elements. The
// n > W case (rows with m < d_pad / W, only at small widths) reads with a
// stride of m and is slower still.

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
        acc += ts_map::sign_bit(c, dd, (uint32_t)i) ? -v : v;
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
        acc += ts_map::sign_bit(c, dd, (uint32_t)i) ? -v : v;
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

// The R-pass kernel. dtype: 0 = float32, 1 = bfloat16, 2 = float16.
// Returns cudaGetLastError().
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

// The one-pass kernel (2 <= rows <= 6). nmax_log: log2 of the largest n_r
// of the rows (4..9), with G_min = W / n_max >= 8. out: (rows, W) f32,
// every bucket written. Returns cudaGetLastError().
extern "C" int ts_encode_onepass_launch(const void* g, int64_t d, int dtype,
                                        const void* row_params, int rows,
                                        int bits, int log2w, int nmax_log,
                                        void* out, void* stream) {
  if (bits < 1 || bits > 32 || nmax_log < 4 || nmax_log > 9 ||
      log2w - nmax_log < 3 || log2w >= bits || d < 1 ||
      d > ((int64_t)1 << bits)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_onepass<float>(g, d, row_params, rows, bits, log2w,
                                   nmax_log, out, s);
    case 1:
      return launch_onepass<__nv_bfloat16>(g, d, row_params, rows, bits,
                                           log2w, nmax_log, out, s);
    case 2:
      return launch_onepass<__half>(g, d, row_params, rows, bits, log2w,
                                    nmax_log, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
