// The TS-sketch's bucket and sign map (repro/core/ts_sketch.py), shared by
// the TS encode (ts_encode.cu) and the TS-map HEAVYMIX scores kernel
// (heavymix_scores.cu, which reads a row-transposed copy: TsMapT below).
//
// Row r has m_r = 2^a_r, n_r = d_pad / m_r and an offset b_r (a multiple
// of W); for a coordinate i < d_pad, in uint32 arithmetic:
//
//   ib     = (i + b_r) mod d_pad
//   bucket = ((ib mod m_r) * n_r + ib div m_r) mod W
//   sign   = the top bit of c_r * i + d_r  (set: -1)
//
// Row parameters: (rows, 4) uint32 [a_r, b_r, c_r, d_r]
// (kernels/ts_encode.py row_params_on_device).

#pragma once

#include <stdint.h>

namespace ts_map {

// The top bit of c * i + d (uint32): set where the sign is -1.
__device__ __forceinline__ uint32_t sign_bit(uint32_t c, uint32_t d,
                                             uint32_t i) {
  return (c * i + d) & 0x80000000u;
}

// The same map on the row-transposed sketch S_T that ts_transpose
// (heavymix_scores.cu) writes. Let n_r = 2^(bits - a_r) = d_pad / m_r and,
// where n_r < W, P_r = W / n_r. Then P_r divides W, hence b_r (a multiple
// of W) and d_pad, so t_r = ib mod P_r = i mod P_r, with no change at the
// wrap of ib past d_pad. P_r also divides m_r (m_r >= 2W), so
// ((ib mod m_r) * n_r) mod W = t_r * n_r, and q_r = ib div m_r < n_r adds
// no carry:
//
//   n_r <  W:  bucket = t_r * n_r + q_r, element (t_r, q_r) of row r seen
//              as a (P_r, n_r) matrix; S_T holds that row as (n_r, P_r),
//              so the value sits at q_r * P_r + t_r
//   n_r >= W:  bucket = q_r mod W (ib mod m_r times n_r is 0 mod W); the
//              row is not transposed (nor is it where n_r = 1: P_r = W)
//
// q_r changes once in m_r >= 2W consecutive coordinates, so consecutive
// coordinates read consecutive floats of every row of S_T. a_r = 32 (row
// 0 at d_pad = 2^32) gives q_r = 0, as a = bits does below 32.
struct TsMapT {
  uint32_t dmask;  // d_pad - 1
  uint32_t wmask;  // W - 1
  int bits;        // log2(d_pad), at most 32
  int log2w;       // log2(W) < bits

  __device__ __forceinline__ uint32_t bucket(const uint32_t* p,
                                             uint32_t i) const {
    const int a = (int)p[0];
    const uint32_t ib = (i + p[1]) & dmask;
    const uint32_t q = a >= 32 ? 0u : (ib >> a);
    const int nlog = bits - a;
    if (nlog >= log2w) return q & wmask;
    const int plog = log2w - nlog;
    return (q << plog) | (i & ((1u << plog) - 1u));
  }

  __device__ __forceinline__ uint32_t sign_bit(const uint32_t* p,
                                               uint32_t i) const {
    return ts_map::sign_bit(p[2], p[3], i);
  }
};

}  // namespace ts_map
