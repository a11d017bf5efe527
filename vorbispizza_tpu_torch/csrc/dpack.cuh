// Shared pieces of the dpack s16 wire kernels: K4's dpack mode (the
// select, ola_assemble.cu), K6 and K7 (dpack_pack.cu, dpack_unary.cu): the
// width table and the per-sample candidate zigzag, rebuilt from q.
//
// q is int16 [C, L] (already in the s16 range). A block row r covers
// channel c = r / NB, samples 128*(r % NB) ... +127; samples past L are
// zero in zigzag space (vorbispizza_tpu/ops/pcm_pack.py pads after the
// zigzag). Differences follow jnp.diff(prepend=0), i.e. q is read as 0
// before the channel's first sample:
//   d2[i] = q[i] - 2q[i-1] + q[i-2]
//   d3[i] = q[i] - 3q[i-1] + 3q[i-2] - q[i-3]
// Candidates (flag bits of the widx byte): d2, d3 (bit 5), i2 = d2 - d2 of
// the pair partner (bit 6), i3 = d3 - d3 of the partner (bits 5 and 6).
// |d3| <= 2^18 and |i3| <= 2^19, so every value and zigzag fits 32 bits.
#pragma once

#include "common.cuh"

#define VP_BLOCK 128
#define VP_NW 12
#define VP_MAX_W 18
// unary words a rice block can need (128 * 18 bits)
#define VP_UNARY_ROW_MAX 72

// pcm_pack.WIDTHS (must match vp_unpack_pcm's table in native/frontend.cpp)
static __constant__ int vp_widths[VP_NW] = {0, 1, 2, 3, 4, 5, 6, 8, 10, 12,
                                            15, 18};

__device__ __forceinline__ int32_t vp_q(const int16_t* __restrict__ q,
                                        int64_t L, int c, int64_t i) {
  return i >= 0 ? (int32_t)q[(int64_t)c * L + i] : 0;
}

__device__ __forceinline__ void vp_diffs(const int16_t* __restrict__ q,
                                         int64_t L, int c, int64_t i,
                                         int32_t& d2, int32_t& d3) {
  const int32_t a = vp_q(q, L, c, i), b = vp_q(q, L, c, i - 1);
  const int32_t e = vp_q(q, L, c, i - 2), f = vp_q(q, L, c, i - 3);
  d2 = a - 2 * b + e;
  d3 = a - 3 * b + 3 * e - f;
}

__device__ __forceinline__ uint32_t vp_zigzag(int32_t d) {
  return ((uint32_t)d << 1) ^ (uint32_t)(d >> 31);
}

// zigzag of candidate `cand` (bit 0 = third difference, bit 1 = inter) at
// sample i of channel c
__device__ __forceinline__ uint32_t vp_cand_z(const int16_t* __restrict__ q,
                                              const int32_t* __restrict__ partner,
                                              int64_t L, int c, int64_t i,
                                              int cand) {
  if (i >= L) return 0u;
  int32_t d2, d3;
  vp_diffs(q, L, c, i, d2, d3);
  int32_t v = (cand & 1) ? d3 : d2;
  if (cand & 2) {
    int32_t p2, p3;
    vp_diffs(q, L, partner[c], i, p2, p3);
    v -= (cand & 1) ? p3 : p2;
  }
  return vp_zigzag(v);
}

// candidate index of a widx|flags byte
__device__ __forceinline__ int vp_cand_of(uint8_t wb) {
  return ((wb >> 5) & 1) | (((wb >> 6) & 1) << 1);
}

// four little-endian bytes of a u32 word at any byte address (the payload
// starts at HDR + NBt, which need not be 4-byte aligned)
__device__ __forceinline__ void vp_store_word(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}
