// K7 dpack_unary: the unary section of a rice dpack wire.
//
// Replaces vorbispizza_tpu/ops/pcm_pack.py pack_unary (442-519) and its
// placement in pack_pcm (561-573). The reference avoids scatters (slow on
// the TPU): a python loop of masked lane reductions deposits each row word,
// and a marker/cumsum/take compacts the words.
//
// K6's layout (dpack_pack.cu): a CTA takes one tile of K6's scan, 32
// consecutive block rows of one channel (the channel from the grid), 8
// warps each 4 consecutive rows, 4 consecutive samples a lane. A warp reads
// its rows' widx|flags bytes as one word where they are 4-byte aligned and
// skips its width rows without reading q (a warp of width rows returns at
// once). It first starts every load that waits on no other: its first
// row's unary-word offset (K6's scan: the exclusive offset of each row, in
// words), each rice row's run of q and the 3 samples before the row (lane
// 0), the partner channel's the same way where a row asks for an inter
// candidate. Then its 4 rows side by side, so that their chains overlap:
// - each lane rebuilds its 4 winners' zigzags z from its run and the 3
//   samples before it (from the lane before by __shfl_up_sync; lane 0's
//   from the row's halo), their unary lengths (z >> k) + 1 (k = the rung's
//   width: z >> k zeros, then a 1 terminator) and their lane-local
//   inclusive sums; warp shuffle scans of the lane totals, the 4 rows'
//   interleaved, place each terminator's bit in its row. Samples past L
//   are 0 in zigzag space.
// - Each lane ORs together its terminators that fall in one word and
//   issues one shared-memory atomicOr a word it touches, into its row's
//   slot of cap_urow words in the warp's shared memory (bits past the slot
//   are dropped; the reference then reports nbytes 0x7FFFFFF0, which K6's
//   scan writes from its row-overflow flag). __syncwarp only: no barrier
//   of the CTA.
// - The 4 rows' words lie back to back in the unary section from the first
//   row's offset, ceil(bits/32) a rice row and none a width row, so one
//   pass stores them all: words past a row's cap_urow as 0, words at or past
//   cap_uwords dropped, nothing past the rows' words written. The section
//   starts at min(plane bytes, 16*cap_groups) of the payload, right after
//   the true plane bytes as the reference places it, so it is aligned as
//   the payload (HDR + NBt) is: 16-byte stores where that is 16-aligned
//   (up to 3 words at each end as words), words where it is 4-aligned,
//   bytes otherwise.
//
// Bound: memory -- q of the rice rows read (the partner's again, from L2),
// the section written. The kernel is held back by the instructions it
// issues a row, not by its bytes: a row at a time, each with its own store
// pass, compiled to twice the code and ran slower.
#include "dpack.cuh"

#define VP_UNARY_WARPS 8  // warps a CTA
#define VP_UNARY_ROWS 4   // consecutive block rows a warp
#if VP_UNARY_WARPS * VP_UNARY_ROWS != VP_TILE_ROWS
#error "a unary CTA takes one tile of K6's scan"
#endif

// a warp's rows' widx|flags bytes as one little-endian word (0 past NB):
// one 4-byte load where the rows are whole and the address allows
__device__ __forceinline__ uint32_t warp_bytes(const uint8_t* __restrict__ p,
                                               int n) {
  if (n >= VP_UNARY_ROWS && ((uintptr_t)p & 3) == 0) {
    return *(const uint32_t*)p;
  }
  uint32_t v = 0u;
#pragma unroll
  for (int r = 0; r < VP_UNARY_ROWS; ++r) {
    if (r < n) v |= (uint32_t)p[r] << (8 * r);
  }
  return v;
}

// the 3 samples before block row b of one channel's q (0 before its first
// sample); lane 0 reads them, the other lanes take theirs by shuffles
__device__ __forceinline__ void load_halo(const int16_t* __restrict__ qc,
                                          int b, int lane, int32_t h[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = b * VP_BLOCK - 3 + k;
    h[k] = lane == 0 && i >= 0 ? (int32_t)qc[i] : 0;
  }
}

// x[0..6] = q[i-3 .. i+3] around a lane's run i .. i+3: its own 4 samples,
// the 3 before from the lane before by __shfl_up_sync, lane 0's the halo
__device__ __forceinline__ void rice_window(const uint2 run,
                                            const int32_t h[3], int lane,
                                            int32_t x[7]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) x[3 + k] = run_sample(run, k);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int32_t up = __shfl_up_sync(0xffffffffu, x[4 + k], 1);
    x[k] = lane > 0 ? up : h[k];
  }
}

// word o of a warp's rows, back to back from its first row's offset: row r
// holds words ends[r-1] .. ends[r]-1, its deposit slot up to cap_urow
// words, 0 past it
__device__ __forceinline__ uint32_t warp_word(
    const uint32_t* slot, const int32_t ends[VP_UNARY_ROWS], int o,
    int cap_urow) {
  int r = 0, b = 0;
#pragma unroll
  for (int k = 0; k < VP_UNARY_ROWS - 1; ++k) {
    if (o >= ends[k]) {
      r = k + 1;
      b = ends[k];
    }
  }
  const int l = o - b;
  return l < cap_urow ? slot[r * VP_UNARY_ROW_MAX + l] : 0u;
}

// a warp's rows' n words into section words uoff .., those at or past
// cap_uwords dropped
__device__ __forceinline__ void store_words(
    uint8_t* __restrict__ sec, const uint32_t* slot,
    const int32_t ends[VP_UNARY_ROWS], int uoff, int n, int cap_urow,
    int cap_uwords, int store, int lane) {
  const int64_t e64 = (int64_t)uoff + n;
  const int end = e64 < cap_uwords ? (int)e64 : cap_uwords;
  if (end <= uoff) return;
  uint32_t* sw = (uint32_t*)sec;
  if (store == VP_STORE_16) {
    // words uoff .. a-1 and b .. end-1 as words (up to 3 each, lanes 0-2
    // and 4-6), the 16-byte groups a .. b-1 as one store a lane
    const int up = (uoff + 3) & ~3, down = end & ~3;
    const int a = up < end ? up : end;
    const int b = down > a ? down : a;
    if (lane < a - uoff) {
      sw[uoff + lane] = warp_word(slot, ends, lane, cap_urow);
    } else if (lane >= 4 && lane - 4 < end - b) {
      sw[b + lane - 4] = warp_word(slot, ends, b + lane - 4 - uoff, cap_urow);
    }
    for (int g = a + 4 * lane; g < b; g += 4 * 32) {
      const int o = g - uoff;
      *(uint4*)(sw + g) = make_uint4(
          warp_word(slot, ends, o, cap_urow),
          warp_word(slot, ends, o + 1, cap_urow),
          warp_word(slot, ends, o + 2, cap_urow),
          warp_word(slot, ends, o + 3, cap_urow));
    }
    return;
  }
  for (int g = uoff + lane; g < end; g += 32) {
    const uint32_t v = warp_word(slot, ends, g - uoff, cap_urow);
    if (store == VP_STORE_4) {
      sw[g] = v;
    } else {
      vp_store_word(sec + 4 * (int64_t)g, v);
    }
  }
}

__global__ void __launch_bounds__(VP_UNARY_WARPS * 32)
    dpack_unary_kernel(const int16_t* __restrict__ q,
                       const int32_t* __restrict__ partner,
                       uint8_t* __restrict__ wire,
                       const int32_t* __restrict__ sc, int L, int NB, int hdr,
                       int nbt, int64_t cap_groups, int cap_uwords,
                       int cap_urow, int store) {
  __shared__ uint32_t s_row[VP_UNARY_WARPS][VP_UNARY_ROWS * VP_UNARY_ROW_MAX];
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.y;
  const int b0 = (blockIdx.x * VP_UNARY_WARPS + warp) * VP_UNARY_ROWS;
  if (b0 >= NB) return;
  const int row0 = c * NB + b0;
  const uint32_t wb4 = warp_bytes(wire + hdr + row0, NB - b0);
  if ((wb4 & 0x80808080u) == 0u) return;  // width rows only (uniform)
  // every load that waits on no other first: the first row's unary-word
  // offset, the rice rows' runs and halos, the partner's where a row asks
  const int nt = (int)(gridDim.x * gridDim.y);
  const int uoff = sc[VP_SCAN_HEAD + 2 * vp_scan_pad(nt) + row0];
  const int64_t plane = 16 * (int64_t)sc[0];
  const bool vec = (L & 3) == 0;
  const int16_t* qc = q + (int64_t)c * L;
  uint2 own[VP_UNARY_ROWS], par[VP_UNARY_ROWS];
  int32_t ho[VP_UNARY_ROWS][3], hp[VP_UNARY_ROWS][3];
  bool inter = false;
#pragma unroll
  for (int r = 0; r < VP_UNARY_ROWS; ++r) {
    const uint32_t wb = (wb4 >> (8 * r)) & 0xFFu;
    inter |= (wb & 0xC0u) == 0xC0u;  // rice and an inter candidate
    own[r] = par[r] = make_uint2(0u, 0u);
    ho[r][0] = ho[r][1] = ho[r][2] = 0;
    hp[r][0] = hp[r][1] = hp[r][2] = 0;
    if (wb & 0x80u) {  // uniform per warp
      own[r] = load_run(qc, (b0 + r) * VP_BLOCK + 4 * lane, L, vec);
      load_halo(qc, b0 + r, lane, ho[r]);
    }
  }
  if (inter) {  // uniform per warp
    const int16_t* qp = q + (int64_t)partner[c] * L;
#pragma unroll
    for (int r = 0; r < VP_UNARY_ROWS; ++r) {
      const uint32_t wb = (wb4 >> (8 * r)) & 0xFFu;
      if ((wb & 0xC0u) == 0xC0u) {
        par[r] = load_run(qp, (b0 + r) * VP_BLOCK + 4 * lane, L, vec);
        load_halo(qp, b0 + r, lane, hp[r]);
      }
    }
  }
  // each row's unary lengths: their lane-local inclusive sums e and the
  // lane totals s (0 on a width row); z <= 2^20, so a row's bits fit 32
  uint32_t e[VP_UNARY_ROWS][4], s[VP_UNARY_ROWS];
#pragma unroll
  for (int r = 0; r < VP_UNARY_ROWS; ++r) {
    const uint32_t wb = (wb4 >> (8 * r)) & 0xFFu;
    s[r] = 0u;
    e[r][0] = e[r][1] = e[r][2] = e[r][3] = 0u;
    if (!(wb & 0x80u)) continue;  // a width row (uniform per warp)
    const int rung = wb & 31u;
    const int w = rung < VP_NW ? vp_widths[rung] : 0;
    const int cand = vp_cand_of((uint8_t)wb);
    int32_t x[7], v[4];
    rice_window(own[r], ho[r], lane, x);
    window_diff(x, cand & 1, v);
    if (cand & 2) {
      int32_t p[4];
      rice_window(par[r], hp[r], lane, x);
      window_diff(x, cand & 1, p);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] -= p[k];
    }
    const int i0 = (b0 + r) * VP_BLOCK + 4 * lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t z = i0 + k < L ? vp_zigzag(v[k]) : 0u;
      s[r] += (z >> w) + 1u;
      e[r][k] = s[r];
    }
  }
  // the rows' warp scans side by side
  uint32_t incl[VP_UNARY_ROWS];
#pragma unroll
  for (int r = 0; r < VP_UNARY_ROWS; ++r) incl[r] = s[r];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int r = 0; r < VP_UNARY_ROWS; ++r) {
      const uint32_t y = __shfl_up_sync(FULL, incl[r], d);
      if (lane >= d) incl[r] += y;
    }
  }
  // zero the rows' deposit slots, deposit: a lane's terminators of one
  // word ORed together first
  uint32_t* slot = s_row[warp];
  int32_t ends[VP_UNARY_ROWS];
  int n = 0;
#pragma unroll
  for (int r = 0; r < VP_UNARY_ROWS; ++r) {
    const uint32_t total = __shfl_sync(FULL, incl[r], 31);
    const int uw = (int)((total + 31u) >> 5);  // 0 on a width row
    n += uw;
    ends[r] = n;
    for (int l = lane; l < uw && l < cap_urow; l += 32) {
      slot[r * VP_UNARY_ROW_MAX + l] = 0u;
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < VP_UNARY_ROWS; ++r) {
    if (!((wb4 >> (8 * r)) & 0x80u)) continue;
    uint32_t* row = slot + r * VP_UNARY_ROW_MAX;
    const uint32_t before = incl[r] - s[r];
    uint32_t pos = before + e[r][0] - 1u;
    uint32_t wd = pos >> 5, bits = 1u << (pos & 31u);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      pos = before + e[r][k] - 1u;
      if ((pos >> 5) != wd) {
        if (wd < (uint32_t)cap_urow) atomicOr(&row[wd], bits);
        wd = pos >> 5;
        bits = 0u;
      }
      bits |= 1u << (pos & 31u);
    }
    if (wd < (uint32_t)cap_urow) atomicOr(&row[wd], bits);
  }
  __syncwarp();
  const int64_t cap_bytes = 16 * cap_groups;
  uint8_t* sec = wire + hdr + nbt + (plane < cap_bytes ? plane : cap_bytes);
  store_words(sec, slot, ends, uoff, n, cap_urow, cap_uwords, store, lane);
}

// q int16 [C, L]; partner int32 [C]; wire u8 (16-byte aligned), a rice wire
// whose widx table and plane section K4 and K6 wrote; scan: K6's
// (dpack.cuh), made for this wire with rice on.
VP_API int vp_dpack_unary(const void* q, const void* partner, void* wire,
                          const void* scan, int64_t C, int64_t L, int64_t NB,
                          int64_t HDR, int64_t cap_groups,
                          int64_t cap_uwords, int64_t cap_urow,
                          void* stream) {
  const int64_t lim = (int64_t)1 << 31;
  const int64_t nbt = C * NB;
  if (cap_urow < 1 || cap_urow > VP_UNARY_ROW_MAX || C < 1 || C > 65535 ||
      NB < 0 || L < 0 || L > NB * VP_BLOCK || C * L >= lim ||
      VP_UNARY_ROW_MAX * nbt >= lim || cap_groups < 0 || cap_uwords < 0 ||
      cap_uwords >= lim ||
      HDR != 8 + 4 * C || ((uintptr_t)wire & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (nbt == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)vp_tiles((int)NB), (unsigned)C);  // a tile a CTA
  dpack_unary_kernel<<<grid, VP_UNARY_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int16_t*)q, (const int32_t*)partner, (uint8_t*)wire,
      (const int32_t*)scan, (int)L, (int)NB, (int)HDR, (int)nbt, cap_groups,
      (int)cap_uwords, (int)cap_urow, vp_store_mode(HDR + nbt));
  return (int)cudaGetLastError();
}
