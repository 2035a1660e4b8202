// The TS-sketch's bucket and sign map (repro/core/ts_sketch.py), shared by
// the TS encode (ts_encode.cu) and the TS-map HEAVYMIX scores kernel
// (heavymix_scores.cu).
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

struct TsMap {
  uint32_t dmask;  // d_pad - 1
  uint32_t wmask;  // W - 1
  int bits;        // log2(d_pad), at most 32

  __device__ __forceinline__ uint32_t bucket(const uint32_t* p,
                                             uint32_t i) const {
    const int a = (int)p[0];
    const uint32_t ib = (i + p[1]) & dmask;
    // a <= bits <= 32; a shift by 32 is undefined, and a = 32 means m = 2^32
    const uint32_t lo = a >= 32 ? ib : (ib & ((1u << a) - 1u));
    const uint32_t hi = a >= 32 ? 0u : (ib >> a);
    return ((lo << (bits - a)) + hi) & wmask;
  }

  __device__ __forceinline__ uint32_t sign_bit(const uint32_t* p,
                                               uint32_t i) const {
    return ts_map::sign_bit(p[2], p[3], i);
  }
};

}  // namespace ts_map
