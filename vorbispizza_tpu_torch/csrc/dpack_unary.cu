// K7 dpack_unary: the unary section of a rice dpack wire.
//
// Replaces vorbispizza_tpu/ops/pcm_pack.py pack_unary (442-519) and its
// placement in pack_pcm (561-573). The reference avoids scatters (slow on
// the TPU): a python loop of masked lane reductions deposits each row word,
// and a marker/cumsum/take compacts the words.
//
// One 128-thread block per rice block row (width rows return at once):
// thread s rebuilds the winner's zigzag z of sample s from q and the
// widx|flags byte, its unary length is (z >> k) + 1 (k = the rung's width:
// z >> k zeros, then a 1 terminator). A block-local inclusive scan of the
// lengths (warp shuffles, then the four warp totals) gives each
// terminator's bit; it is ORed into a shared-memory row of cap_urow words
// (bits past the row are dropped; the reference then reports nbytes
// 0x7FFFFFF0, which K6's scan writes from its row-overflow flag). The row's
// ceil(bits/32) words go to word uoff (K6's scan: the exclusive unary-word
// offset of the row) of the unary section, words at or past cap_uwords
// dropped;
// the section starts at min(plane bytes, 16*cap_groups) of the payload,
// right after the true plane bytes as the reference places it.
//
// Bound: q reads and the section's byte stores; the deposit is one
// shared-memory atomic per sample.
#include "dpack.cuh"

__global__ void dpack_unary_kernel(const int16_t* __restrict__ q,
                                   const int32_t* __restrict__ partner,
                                   uint8_t* __restrict__ wire,
                                   const int32_t* __restrict__ scan, int64_t C,
                                   int64_t L, int64_t NB, int64_t HDR,
                                   int64_t cap_groups, int64_t cap_uwords,
                                   int cap_urow) {
  __shared__ uint32_t rowbuf[VP_UNARY_ROW_MAX];
  __shared__ int32_t warp_tot[VP_BLOCK / 32];
  const int64_t row = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int64_t NBt = C * NB;
  const uint8_t wb = wire[HDR + row];
  if (!(wb & 0x80)) return;  // width block: no unary part (uniform)
  const int w = vp_widths[wb & 31];
  const int c = (int)(row / NB);
  const int64_t i = (row - (int64_t)c * NB) * VP_BLOCK + t;
  const uint32_t z = vp_cand_z(q, partner, L, c, i, vp_cand_of(wb));
  const int32_t len = (int32_t)(z >> w) + 1;
  // inclusive scan: warp shuffles, then the warp totals
  int32_t end = len;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t o = __shfl_up_sync(0xffffffffu, end, d);
    if (lane >= d) end += o;
  }
  if (lane == 31) warp_tot[warp] = end;
  for (int k = t; k < VP_UNARY_ROW_MAX; k += VP_BLOCK) rowbuf[k] = 0u;
  __syncthreads();
  int32_t total = 0;
#pragma unroll
  for (int k = 0; k < VP_BLOCK / 32; ++k) {
    if (k < warp) end += warp_tot[k];
    total += warp_tot[k];
  }
  const int32_t pos = end - 1;
  if ((pos >> 5) < cap_urow) atomicOr(&rowbuf[pos >> 5], 1u << (pos & 31));
  __syncthreads();
  const int64_t uw = (total + 31) >> 5;
  const int64_t uoff =
      scan[VP_SCAN_HEAD + 2 * vp_scan_pad((int)C * vp_tiles((int)NB)) + row];
  const int64_t plane = 16 * (int64_t)scan[0];
  const int64_t start = plane < 16 * cap_groups ? plane : 16 * cap_groups;
  uint8_t* dst = wire + HDR + NBt + start;
  for (int64_t l = t; l < uw; l += VP_BLOCK) {
    if (uoff + l < cap_uwords) {
      vp_store_word(dst + 4 * (uoff + l), l < cap_urow ? rowbuf[l] : 0u);
    }
  }
}

// scan: K6's (dpack.cuh), made for this wire with rice on
VP_API int vp_dpack_unary(const void* q, const void* partner, void* wire,
                          const void* scan, int64_t C,
                          int64_t L, int64_t NB, int64_t HDR,
                          int64_t cap_groups, int64_t cap_uwords,
                          int64_t cap_urow, void* stream) {
  if (cap_urow < 1 || cap_urow > VP_UNARY_ROW_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = C * NB;
  if (rows > 0) {
    dpack_unary_kernel<<<(unsigned)rows, VP_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int16_t*)q, (const int32_t*)partner, (uint8_t*)wire,
        (const int32_t*)scan, C, L, NB, HDR, cap_groups,
        cap_uwords, (int)cap_urow);
  }
  return (int)cudaGetLastError();
}
