// K6 dpack_pack: the wire header and the plane section.
//
// Replaces vorbispizza_tpu/ops/pcm_pack.py words_matmul (321) and compact
// (387) plus the header of models/pipeline.py _fused_body (857-877). The
// reference packs bits on the TPU's matrix unit: a bf16 [NBt, 1152] bit-pair
// operand times a [1152, 672] selection matrix yields every width's packed
// words, and a row take per 16-byte group compacts the chosen ones.
//
// Here one 128-thread block per block row: thread s rebuilds the winner's
// zigzag of sample s from q and the widx|flags byte (K5's choice), keeps
// its low w bits and ORs them into shared-memory words at bit s*w (a value
// straddles at most two words). The block's 4w words then go out at byte
// 16*goff of the payload, where goff is the exclusive scan of groups (16
// bytes, = w per block) that torch computes between K5 and K6; groups at
// or past cap_groups are dropped (nbytes still reports the true size, as
// the reference's compact does). Block row 0 also writes the header:
// [i32 nbytes][u32 16*cap_groups][u32 ch_ubit[C]], with nbytes = plane +
// unary bytes, or 0x7FFFFFF0 when a rice block's unary words overflow the
// deposit row (the reference's row_over).
//
// Bound: memory -- q reads and the payload's byte stores (the payload
// starts at HDR + NBt, not always 4-byte aligned); the bit deposit is
// shared-memory atomics, at most two per sample.
#include "dpack.cuh"

__global__ void dpack_pack_kernel(const int16_t* __restrict__ q,
                                  const int32_t* __restrict__ partner,
                                  uint8_t* __restrict__ wire,
                                  const int64_t* __restrict__ gcum,
                                  const int64_t* __restrict__ ucum,
                                  const int32_t* __restrict__ over, int64_t C,
                                  int64_t L, int64_t NB, int64_t HDR,
                                  int64_t cap_groups, int rice) {
  __shared__ uint32_t words[4 * VP_MAX_W];
  const int64_t row = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t NBt = C * NB;
  if (row == 0 && t == 0) {
    int64_t nbytes = 16 * gcum[NBt - 1];
    if (rice) nbytes = over[0] ? 0x7FFFFFF0 : nbytes + 4 * ucum[NBt - 1];
    vp_store_word(wire, (uint32_t)nbytes);
    vp_store_word(wire + 4, (uint32_t)(16 * cap_groups));
    for (int64_t ch = 0; ch < C; ++ch) {
      const uint32_t cut = rice ? (uint32_t)(32 * ucum[(ch + 1) * NB - 1]) : 0u;
      vp_store_word(wire + 8 + 4 * ch, cut);
    }
  }
  const uint8_t wb = wire[HDR + row];
  const int w = vp_widths[wb & 31];
  if (w == 0) return;  // uniform per block
  const int nwords = 4 * w;
  for (int k = t; k < nwords; k += blockDim.x) words[k] = 0u;
  __syncthreads();
  const int c = (int)(row / NB);
  const int64_t i = (row - (int64_t)c * NB) * VP_BLOCK + t;
  const uint32_t v =
      vp_cand_z(q, partner, L, c, i, vp_cand_of(wb)) & ((1u << w) - 1u);
  const int bit = t * w;
  const int sh = bit & 31;
  if (v) {
    atomicOr(&words[bit >> 5], v << sh);
    if (sh + w > 32) atomicOr(&words[(bit >> 5) + 1], v >> (32 - sh));
  }
  __syncthreads();
  const int64_t goff = gcum[row] - w;
  uint8_t* payload = wire + HDR + NBt;
  for (int k = t; k < nwords; k += blockDim.x) {
    if (goff + k / 4 < cap_groups) {
      vp_store_word(payload + 16 * goff + 4 * k, words[k]);
    }
  }
}

VP_API int vp_dpack_pack(const void* q, const void* partner, void* wire,
                         const void* gcum, const void* ucum, const void* over,
                         int64_t C, int64_t L, int64_t NB, int64_t HDR,
                         int64_t cap_groups, int64_t rice, void* stream) {
  const int64_t rows = C * NB;
  if (rows > 0) {
    dpack_pack_kernel<<<(unsigned)rows, VP_BLOCK, 0, (cudaStream_t)stream>>>(
        (const int16_t*)q, (const int32_t*)partner, (uint8_t*)wire,
        (const int64_t*)gcum, (const int64_t*)ucum, (const int32_t*)over, C,
        L, NB, HDR, cap_groups, (int)rice);
  }
  return (int)cudaGetLastError();
}
