// K5 dpack_select: per 128-sample block, the dpack candidate and coding
// mode by exact bit cost.
//
// Replaces vorbispizza_tpu/ops/pcm_pack.py select_candidate (129-265): the
// reference builds every candidate as a [NBt, 128] tensor, reduces each
// (max, and one sum per rice rung), stacks the costs and selects the
// winner's plane and unary lengths with where-accumulations.
//
// One warp per block row; lane l holds samples l, l+32, l+64, l+96 of the
// block (coalesced int16 reads) and their zigzags for the 2 (mono) or 4
// candidates in registers. Per candidate: a warp max gives the width rung
// (INF = 1<<29 past 18 bits), and with rice on, 11 warp sums give
// sum(z >> k) per k rung, costed 128k + ((sum + 128 + 31) & ~31). Ties go
// as the reference sends them: the smallest k among rice rungs, width over
// rice, and the first of d2, d3, i2, i3 among candidates. Inter costs INF
// for a channel without a partner (partner[c] == c).
//
// It writes only the choice: the widx|flags byte (bits 0-4 rung, 5 third
// difference, 6 inter, 7 rice) straight into the wire's width table, and
// the block's unary bit count (sum of high part + 1 over its samples, 0 on
// width blocks) for the unary scan. K6 and K7 rebuild the winner's zigzag
// from q instead of reading a [NBt, 128] plane and unary-length tensor.
//
// Bound: q reads (2 or 4 int16 per sample with the partner, from L2 on
// repeats) and the 48 warp reductions per row; no intermediate tensor.
#include "dpack.cuh"

#define VP_INF (1 << 29)

__global__ void dpack_select_kernel(const int16_t* __restrict__ q,
                                    const int32_t* __restrict__ partner,
                                    uint8_t* __restrict__ wbyte,
                                    int32_t* __restrict__ ubits, int64_t C,
                                    int64_t L, int64_t NB, int rice) {
  const int64_t row = (int64_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  if (row >= C * NB) return;  // uniform per warp
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int c = (int)(row / NB);
  const int64_t i0 = (row - (int64_t)c * NB) * VP_BLOCK;
  const int ncand = C >= 2 ? 4 : 2;
  const bool inter_ok = C >= 2 && partner[c] != c;

  uint32_t z[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int64_t i = i0 + lane + 32 * s;
    z[0][s] = z[1][s] = z[2][s] = z[3][s] = 0u;
    if (i < L) {
      int32_t d2, d3;
      vp_diffs(q, L, c, i, d2, d3);
      z[0][s] = vp_zigzag(d2);
      z[1][s] = vp_zigzag(d3);
      if (ncand == 4) {
        int32_t p2, p3;
        vp_diffs(q, L, partner[c], i, p2, p3);
        z[2][s] = vp_zigzag(d2 - p2);
        z[3][s] = vp_zigzag(d3 - p3);
      }
    }
  }

  int best_cost = 0, best_byte = 0, best_ubits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= ncand) break;
    uint32_t m = max(max(z[k][0], z[k][1]), max(z[k][2], z[k][3]));
    m = __reduce_max_sync(FULL, m);
    int wi = 0;
#pragma unroll
    for (int r = 0; r < VP_NW - 1; ++r) wi += m > ((1u << vp_widths[r]) - 1u);
    const int wcost =
        m > ((1u << VP_MAX_W) - 1u) ? VP_INF : vp_widths[wi] * VP_BLOCK;
    int cost = wcost, rung = wi, is_rice = 0, ub = 0;
    if (rice) {
      int rcost = 0, rbest = 0, rsum = 0;
#pragma unroll
      for (int r = 0; r < VP_NW - 1; ++r) {  // rungs with w <= 15
        const int kw = vp_widths[r];
        uint32_t s = (z[k][0] >> kw) + (z[k][1] >> kw) + (z[k][2] >> kw) +
                     (z[k][3] >> kw);
        s = __reduce_add_sync(FULL, s);
        const int rc = VP_BLOCK * kw + (((int)s + VP_BLOCK + 31) & ~31);
        if (r == 0 || rc < rcost) {
          rcost = rc;
          rbest = r;
          rsum = (int)s;
        }
      }
      if (rcost < wcost) {
        cost = rcost;
        rung = rbest;
        is_rice = 1;
        ub = rsum + VP_BLOCK;
      }
    }
    if ((k & 2) && !inter_ok) cost = VP_INF;
    if (k == 0 || cost < best_cost) {
      best_cost = cost;
      best_byte = rung | ((k & 1) << 5) | ((k >> 1) << 6) | (is_rice << 7);
      best_ubits = ub;
    }
  }
  if (lane == 0) {
    wbyte[row] = (uint8_t)best_byte;
    ubits[row] = best_ubits;
  }
}

VP_API int vp_dpack_select(const void* q, const void* partner, void* wbyte,
                           void* ubits, int64_t C, int64_t L, int64_t NB,
                           int64_t rice, void* stream) {
  const int64_t rows = C * NB;
  if (rows > 0) {
    dpack_select_kernel<<<vp_blocks(rows, 4), 128, 0, (cudaStream_t)stream>>>(
        (const int16_t*)q, (const int32_t*)partner, (uint8_t*)wbyte,
        (int32_t*)ubits, C, L, NB, (int)rice);
  }
  return (int)cudaGetLastError();
}
