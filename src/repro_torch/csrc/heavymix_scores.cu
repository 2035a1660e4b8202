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
// or, with a filler operand (HEAVYMIX's faithful fill, the reference's
// jnp.where(heavy, |est| + 1e30, filler)), score_i = filler[i] where the
// coordinate is not heavy: a uniform random priority in [0, 1), so the
// non-heavy part of the top-k is a uniform random sample. The filler is
// read once, coalesced (4 more bytes a coordinate); without it (a null
// pointer) nothing is read. Both scores and est are written. The top-k over scores runs after it,
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
// L2-resident (R, W) sketch once; under the exact map the R gathers per
// coordinate are random 4-byte L2 reads.
//
// Two instances of one kernel, by bucket map: the exact sketch's
// multiply-shift hashes (heavymix_scores_launch), and the TS-sketch's map
// (heavymix_scores_ts_launch, ts_map.cuh). The second is the TS route's
// recovery (repro/core/compression.py: ts.decode, then heavymix(...,
// estimates=)), which the reference runs outside Pallas: the same est and
// boosted scores at every d, so its top-k is the same select. Read in
// place, row r of a TS sketch is a (P_r, n_r) matrix that a run of
// coordinates reads down one column (a stride of n_r floats), so a warp's
// 32 coordinates touched up to 32 L2 sectors a row. ts_transpose_launch
// first writes each such row transposed (n_r, P_r) into a scratch copy
// S_T, a tiled transpose through shared memory in one launch; the scores
// kernel then reads S_T through TsMapT, where consecutive coordinates read
// consecutive floats of every row: one 128-byte line a warp a row. Once
// the gathers were coalesced, the 8-slot median network and one
// coordinate a thread in flight set the pace, not the gathers or the
// histogram (probe j of bench/sketch_memory_probe.cu), so up to 8 rows
// the TS map runs ts_scores_kernel: four coordinates a thread, each row
// read as one float4 (or float2, or one float) for all four, and a median
// network of exactly R slots. The same floats are gathered with the same
// signs, so est, scores and the histogram stay bit-equal to the plain
// version. Bound of the transpose: reading and writing the (R, W) sketch
// once.

#include "radix_select.cuh"
#include "sketch_common.cuh"
#include "ts_map.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTransposeLog = 10;  // a transpose tile: 2^10 elements
constexpr int kTransposeTile = 1 << kTransposeLog;

template <int N, class Map>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const float* __restrict__ sk, int64_t width,
              const uint32_t* __restrict__ hp, int rows, Map map,
              const float* __restrict__ thr_p,
              const float* __restrict__ filler, int64_t d,
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
    const bool heavy = e * e >= thr;
    const float s = (filler != nullptr && !heavy)
                        ? filler[j]
                        : fabsf(e) + (heavy ? 1e30f : 0.0f);
    est[j] = e;
    scores[j] = s;
    radix_select::hist_add(h,
                           radix_select::key_bits(s) >> radix_select::kShift1);
  }
  radix_select::hist_flush(h, hist, radix_select::kBins1);
}

template <class Map>
int launch(const void* sketch, int64_t width, const void* row_params,
           int rows, Map map, const void* thr, const void* filler, int64_t d,
           void* scores, void* est, void* hist, int sms, void* stream) {
  if (rows < 1 || rows > sketch_common::kMaxRows) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned g = sketch_common::grid_for(d, kThreads, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sk = static_cast<const float*>(sketch);
  const uint32_t* hp = static_cast<const uint32_t*>(row_params);
  const float* t = static_cast<const float*>(thr);
  const float* fl = static_cast<const float*>(filler);
  float* sc = static_cast<float*>(scores);
  float* es = static_cast<float*>(est);
  uint32_t* hs = static_cast<uint32_t*>(hist);
  if (rows <= 8) {
    scores_kernel<8, Map><<<g, kThreads, 0, st>>>(sk, width, hp, rows, map,
                                                  t, fl, d, sc, es, hs);
  } else {
    scores_kernel<sketch_common::kMaxRows, Map><<<g, kThreads, 0, st>>>(
        sk, width, hp, rows, map, t, fl, d, sc, es, hs);
  }
  return (int)cudaGetLastError();
}

// The TS-map scores on the row-transposed sketch, R = N rows exactly (no
// padded median slots), four consecutive coordinates i0..i0+3 a thread
// (i0 a multiple of 4). Needs W >= 4: then b_r is a multiple of 4, so
// ib_r(i0) is too, the four share q_r (m_r >= 8) and none crosses the
// d_pad wrap. Row r then reads, by its kind (fixed per row, so uniform
// across a warp): where P_r >= 4, one aligned float4 at
// q_r * P_r + (i0 mod P_r); where P_r = 2, the float2 at 2 q_r (values
// x, y, x, y); where n_r >= W, the one float at q_r mod W. Each row's map
// constants sit in registers. The signs and medians are per coordinate,
// as in scores_kernel: the same floats with the same signs, so the same
// est and scores, bit for bit. Coordinates of the last partial group take
// scores_kernel's per-coordinate path. At least 4 CTAs an SM (at most 64
// registers a thread; unbounded, R = 5 took 80 and fit 3): more
// coordinates in flight to hide the latency of the gathers.
template <int N>
__global__ void __launch_bounds__(kThreads, 4)
ts_scores_kernel(const float* __restrict__ sk,
                 const uint32_t* __restrict__ rp, ts_map::TsMapT map,
                 const float* __restrict__ thr_p,
                 const float* __restrict__ filler, int64_t d,
                 float* __restrict__ scores, float* __restrict__ est,
                 uint32_t* __restrict__ hist) {
  __shared__ uint32_t sh[N * 4];
  __shared__ uint32_t h[radix_select::kBins1];
  radix_select::hist_zero(h, radix_select::kBins1);
  sketch_common::load_hash(sh, rp, N);  // syncs
  const float thr = *thr_p;
  const int64_t width = (int64_t)map.wmask + 1;
  uint32_t rb[N], rc[N], rd[N], rmask[N];
  int ra[N], rplog[N], rkind[N];  // kind: 0 n_r >= W, 1 P_r = 2, 2 P_r >= 4
#pragma unroll
  for (int r = 0; r < N; ++r) {
    ra[r] = (int)sh[4 * r];
    rb[r] = sh[4 * r + 1];
    rc[r] = sh[4 * r + 2];
    rd[r] = sh[4 * r + 3];
    const int nlog = map.bits - ra[r];
    rplog[r] = nlog < map.log2w ? map.log2w - nlog : 0;
    rmask[r] = (1u << rplog[r]) - 1u;
    rkind[r] = nlog >= map.log2w ? 0 : (rplog[r] == 1 ? 1 : 2);
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * 4;
  for (int64_t j0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       j0 < d; j0 += stride) {
    float e[4];
    if (j0 + 4 <= d) {
      const uint32_t i0 = (uint32_t)j0;
      float v[4][N];
      bool nan[4] = {false, false, false, false};
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const uint32_t q = (uint32_t)((uint64_t)((i0 + rb[r]) & map.dmask) >>
                                      ra[r]);
        const float* row = sk + r * width;
        float x[4];
        if (rkind[r] == 2) {
          const float4 t = *reinterpret_cast<const float4*>(
              row + ((q << rplog[r]) | (i0 & rmask[r])));
          x[0] = t.x;
          x[1] = t.y;
          x[2] = t.z;
          x[3] = t.w;
        } else if (rkind[r] == 1) {
          const float2 t = *reinterpret_cast<const float2*>(row + (q << 1));
          x[0] = x[2] = t.x;
          x[1] = x[3] = t.y;
        } else {
          x[0] = x[1] = x[2] = x[3] = row[q & map.wmask];
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t neg = ts_map::sign_bit(rc[r], rd[r], i0 + t);
          v[t][r] = __uint_as_float(__float_as_uint(x[t]) ^ neg);
          nan[t] |= isnan(v[t][r]);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        e[t] = sketch_common::median_of<N>(v[t], N, nan[t]);
      }
      float s[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const bool heavy = e[t] * e[t] >= thr;
        s[t] = (filler != nullptr && !heavy)
                   ? filler[j0 + t]
                   : fabsf(e[t]) + (heavy ? 1e30f : 0.0f);
        radix_select::hist_add(
            h, radix_select::key_bits(s[t]) >> radix_select::kShift1);
      }
      *reinterpret_cast<float4*>(est + j0) = make_float4(e[0], e[1], e[2],
                                                         e[3]);
      *reinterpret_cast<float4*>(scores + j0) = make_float4(s[0], s[1], s[2],
                                                            s[3]);
    } else {
      for (int64_t j = j0; j < d; ++j) {
        const float ej = sketch_common::median_estimate<N>(
            sk, sh, N, (uint32_t)j, map, width);
        const bool heavy = ej * ej >= thr;
        const float sj = (filler != nullptr && !heavy)
                             ? filler[j]
                             : fabsf(ej) + (heavy ? 1e30f : 0.0f);
        est[j] = ej;
        scores[j] = sj;
        radix_select::hist_add(
            h, radix_select::key_bits(sj) >> radix_select::kShift1);
      }
    }
  }
  radix_select::hist_flush(h, hist, radix_select::kBins1);
}

// S_T = the TS sketch with row r transposed from (P_r, n_r) to (n_r, P_r)
// where 1 < n_r < W; the other rows copied. CTA (x, r) takes one tile of
// E = min(W, 1024) elements of row r: TC values of c by TQ of q (TQ =
// min(n_r, 32), or more where P_r < E / TQ), read along q and written
// along c through a padded shared tile.
__global__ void __launch_bounds__(kThreads)
ts_transpose_kernel(const float* __restrict__ sk,
                    const uint32_t* __restrict__ rp, int bits, int log2w,
                    float* __restrict__ out) {
  __shared__ float t[2 * kTransposeTile];
  const int r = blockIdx.y;
  const int elog = min(log2w, kTransposeLog);
  const int64_t w = (int64_t)1 << log2w;
  const float* src = sk + r * w;
  float* dst = out + r * w;
  const int nlog = bits - (int)rp[4 * r];
  const int64_t e0 = (int64_t)blockIdx.x << elog;
  if (nlog == 0 || nlog >= log2w) {
    for (int l = threadIdx.x; l < (1 << elog); l += blockDim.x) {
      dst[e0 + l] = src[e0 + l];
    }
    return;
  }
  const int plog = log2w - nlog;
  int tq = min(nlog, 5);
  int tc = elog - tq;
  if (tc > plog) {
    tc = plog;
    tq = elog - plog;
  }
  const int64_t ct = blockIdx.x & ((1 << (plog - tc)) - 1);
  const int64_t c0 = ct << tc;
  const int64_t q0 = ((int64_t)blockIdx.x >> (plog - tc)) << tq;
  const int pitch = (1 << tc) + 1;
  for (int l = threadIdx.x; l < (1 << elog); l += blockDim.x) {
    const int lc = l >> tq, lq = l & ((1 << tq) - 1);
    t[lq * pitch + lc] = src[((c0 + lc) << nlog) + q0 + lq];
  }
  __syncthreads();
  for (int l = threadIdx.x; l < (1 << elog); l += blockDim.x) {
    const int lq = l >> tc, lc = l & ((1 << tc) - 1);
    dst[((q0 + lq) << plog) + c0 + lc] = t[lq * pitch + lc];
  }
}

}  // namespace

// The exact sketch: hash_params (rows, 4) uint32 [a, b, c, d], shift =
// 32 - log2 W. filler: null, or (d,) f32 scores of the non-heavy
// coordinates (the faithful fill). hist: a zeroed (2048,) u32 array that
// receives the histogram of bits 30..20 of the scores; sms: the card's SM
// count (the grid). Returns cudaGetLastError() after the launch.
extern "C" int heavymix_scores_launch(const void* sketch, int64_t width,
                                      const void* hash_params, int rows,
                                      int shift, const void* thr,
                                      const void* filler, int64_t d,
                                      void* scores, void* est, void* hist,
                                      int sms, void* stream) {
  return launch(sketch, width, hash_params, rows,
                sketch_common::ExactMap{shift}, thr, filler, d, scores, est,
                hist, sms, stream);
}

// The TS sketch's row-transposed copy: sketch_t (rows, W) f32 as
// ts_transpose_launch writes it (16-byte aligned); row_params (rows, 4)
// uint32 [log2 m, offset, c, d], bits = log2 d_pad (at most 32), W =
// 2^log2w; scores and est 16-byte aligned; filler as above. Up to 8 rows and W >= 4 take
// ts_scores_kernel, the rest scores_kernel with TsMapT. Otherwise as
// above.
extern "C" int heavymix_scores_ts_launch(const void* sketch_t, int log2w,
                                         const void* row_params, int rows,
                                         int bits, const void* thr,
                                         const void* filler, int64_t d,
                                         void* scores, void* est, void* hist,
                                         int sms, void* stream) {
  if (bits < 1 || bits > 32 || log2w < 1 || log2w >= bits ||
      d > ((int64_t)1 << bits)) {
    return (int)cudaErrorInvalidValue;
  }
  const ts_map::TsMapT map{(uint32_t)(((uint64_t)1 << bits) - 1),
                           (uint32_t)((1u << log2w) - 1), bits, log2w};
  if (log2w < 2 || rows > 8) {
    return launch(sketch_t, (int64_t)1 << log2w, row_params, rows, map, thr,
                  filler, d, scores, est, hist, sms, stream);
  }
  const unsigned g = sketch_common::grid_for((d + 3) / 4, kThreads, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sk = static_cast<const float*>(sketch_t);
  const uint32_t* rp = static_cast<const uint32_t*>(row_params);
  const float* t = static_cast<const float*>(thr);
  const float* fl = static_cast<const float*>(filler);
  float* sc = static_cast<float*>(scores);
  float* es = static_cast<float*>(est);
  uint32_t* hs = static_cast<uint32_t*>(hist);
  switch (rows) {
#define TS_SCORES_CASE(R)                                                   \
  case R:                                                                   \
    ts_scores_kernel<R><<<g, kThreads, 0, st>>>(sk, rp, map, t, fl, d, sc, \
                                                es, hs);                    \
    break;
    TS_SCORES_CASE(1)
    TS_SCORES_CASE(2)
    TS_SCORES_CASE(3)
    TS_SCORES_CASE(4)
    TS_SCORES_CASE(5)
    TS_SCORES_CASE(6)
    TS_SCORES_CASE(7)
    TS_SCORES_CASE(8)
#undef TS_SCORES_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Writes the row-transposed copy of a TS sketch (rows, W = 2^log2w) f32
// into out (rows, W): row r as (n_r, P_r) where 1 < n_r < W, else as it
// is. Returns cudaGetLastError() after the launch.
extern "C" int ts_transpose_launch(const void* sketch, int log2w,
                                   const void* row_params, int rows, int bits,
                                   void* out, void* stream) {
  if (bits < 1 || bits > 32 || log2w < 1 || log2w >= bits || rows < 1 ||
      rows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int elog = log2w < kTransposeLog ? log2w : kTransposeLog;
  const dim3 grid((unsigned)(1u << (log2w - elog)), (unsigned)rows);
  ts_transpose_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sketch),
      static_cast<const uint32_t*>(row_params), bits, log2w,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
