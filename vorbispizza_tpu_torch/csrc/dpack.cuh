// Shared pieces of the dpack s16 wire kernels: K4's dpack mode (the
// select, ola_assemble.cu), K6 and K7 (dpack_pack.cu, dpack_unary.cu): the
// width table, the per-sample candidate zigzag, rebuilt from q, the layout
// of K6's scan, the payload's store mode, and the runs of 4 samples a lane
// and their windows' differences that K6 and K7 read q in.
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

// K6's scan scratch (pcm_pack.scan_fields), int32: [0] the plane groups G,
// [1] the unary words U, [2] 1 when a rice block's unary words overflow the
// deposit row, [3] 0; from VP_SCAN_HEAD the exclusive group offset of each
// tile (VP_TILE_ROWS consecutive block rows of one channel: a K6 pack CTA's
// rows), nt = C * vp_tiles(NB) of them, in row order; on a rice wire, from
// VP_SCAN_HEAD + vp_scan_pad(nt), each tile's exclusive unary-word offset,
// and from VP_SCAN_HEAD + 2 * vp_scan_pad(nt) each block row's (written by
// K6's pack kernel). K6 writes it, K7 reads it.
#define VP_SCAN_HEAD 4
#define VP_TILE_ROWS 32

__host__ __device__ __forceinline__ int vp_scan_pad(int n) {
  return (n + 3) & ~3;
}

__host__ __device__ __forceinline__ int vp_tiles(int NB) {
  return (NB + VP_TILE_ROWS - 1) / VP_TILE_ROWS;
}

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

// How K6 and K7 store into the payload of a 16-byte aligned wire: it starts
// at byte pay = HDR + NBt (the unary section a multiple of 16 bytes after
// it), so 16-byte stores where pay is 16-aligned, words where it is
// 4-aligned, bytes otherwise.
enum { VP_STORE_16 = 0, VP_STORE_4 = 1, VP_STORE_1 = 2 };

__host__ __device__ __forceinline__ int vp_store_mode(int64_t pay) {
  return pay % 16 == 0 ? VP_STORE_16 : pay % 4 == 0 ? VP_STORE_4 : VP_STORE_1;
}

// sample k (0..3) of a run of 4 int16 held as two 32-bit words
__device__ __forceinline__ int32_t run_sample(const uint2 r, int k) {
  const uint32_t h = k < 2 ? r.x : r.y;
  return (k & 1) ? (int32_t)h >> 16 : (int32_t)(int16_t)(h & 0xFFFFu);
}

// samples i0 .. i0+3 of one channel's q (0 at or past L), as two words
__device__ __forceinline__ uint2 load_run(const int16_t* __restrict__ qc,
                                          int i0, int L, bool vec) {
  if (vec) {  // L % 4 == 0, so the run lies wholly before L or past it
    return i0 < L ? *(const uint2*)(qc + i0) : make_uint2(0u, 0u);
  }
  uint32_t s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = i0 + k < L ? (uint32_t)(uint16_t)qc[i0 + k] : 0u;
  }
  return make_uint2(s[0] | s[1] << 16, s[2] | s[3] << 16);
}

// the candidate of a window x = q[i-3 .. i+3] at its 4 samples i .. i+3:
// the second difference, or (third) the third, by successive differences
__device__ __forceinline__ void window_diff(const int32_t x[7], bool third,
                                            int32_t v[4]) {
  int32_t d1[6], d2[5];
#pragma unroll
  for (int j = 0; j < 6; ++j) d1[j] = x[j + 1] - x[j];  // at i-2 .. i+3
#pragma unroll
  for (int j = 0; j < 5; ++j) d2[j] = d1[j + 1] - d1[j];  // at i-1 .. i+3
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = third ? d2[k + 1] - d2[k] : d2[k + 1];
}
