// K6 dpack_pack: the scans between the select and the packers, the wire
// header and the plane section.
//
// Replaces vorbispizza_tpu/ops/pcm_pack.py words_matmul (321) and compact
// (387) plus the header of models/pipeline.py _fused_body (857-877). The
// reference packs bits on the TPU's matrix unit: a bf16 [NBt, 1152] bit-pair
// operand times a [1152, 672] selection matrix yields every width's packed
// words, and a row take per 16-byte group compacts the chosen ones.
//
// The C entry launches two kernels and the wrapper runs no torch op, so a
// call is two device ops from K4's dpack mode on:
// - dpack_pack_scan reads the widx|flags bytes K4 wrote into the wire (and,
//   on a rice wire, K4's unary bit counts) and writes the int32 scan
//   (dpack.cuh, VP_SCAN_HEAD): the exclusive offset in 16-byte groups (a
//   block of width w is w groups) of each tile of 32 consecutive block
//   rows of a channel (the rows of one pack CTA), on a rice wire its
//   exclusive offset in unary words (ceil(bits / 32)), the totals and the
//   row-overflow flag. It also writes the header, [i32 nbytes][u32
//   16*cap_groups][u32 ch_ubit[C]]: nbytes = plane + unary bytes, or
//   0x7FFFFFF0 when a rice block's unary words overflow the deposit row
//   (the reference's row_over); ch_ubit[c] = 32 * the unary words up to
//   the end of channel c, written by the thread that holds the channel's
//   last tile. One CTA of 1024 threads, 2 consecutive tiles (64 rows) a
//   thread and a block scan of the thread sums, a step of 65,536 rows at
//   a time. Per tile and not per row, the scan writes 32 times fewer
//   offsets, which keeps it to one CTA with no cluster and one step at
//   the chunks' sizes. int32 holds: a block has at most 18 groups and 72
//   unary words, and the host refuses 72 * NBt from 2^31; the header's u32
//   words wrap as the reference's do.
// - dpack_pack_kernel: a CTA a tile, 8 warps each taking 4 consecutive
//   block rows of one channel (the CTA's channel from the grid, so no
//   division), a row at a time, 4 consecutive samples a lane. A warp first
//   starts every load that waits on no other (the tile's group offset, its
//   rows' widx|flags bytes, the partner, its rows of q; the partner's rows
//   once a byte asks for an inter candidate), so a row waits on one or two
//   memory latencies, not a chain of them. A row's group offset is the
//   tile's plus the widths of the tile's rows before it (the warps' sums
//   through shared memory); on a rice wire the same sums give each row's
//   unary-word offset, which the kernel writes into the scan for K7. The 3
//   samples before a lane's run come from the lane before by
//   __shfl_up_sync, for lane 0 from lane 31's run of the row before (the
//   warp's first row reads them; 0 before the channel's first sample), the
//   partner channel's the same way. The lane zigzags its winner (the
//   candidate in the widx|flags byte) and masks it to the block's width w;
//   up to w = 8 it stages its 4 values as one 4w-bit chunk in the warp's
//   slice of shared memory, else the 4 values. Lane j then assembles words
//   j, j+32 and j+64 of the block's 4w from the at most 9 entries that
//   reach each (their range by a multiply and a shift, not a division),
//   with no atomics. The block's w groups go out at group goff (the scan's
//   offset) of the payload, which starts at HDR + NBt: as 16-byte stores
//   (lane j group j, from the words staged again) where that is 16-byte
//   aligned, as words where it is 4-byte aligned, as bytes otherwise.
//   Groups at or past cap_groups are dropped; nbytes still reports the true
//   size, as the reference's compact does. The pack spends more of its
//   time issuing instructions than moving bytes, so the assembly visits
//   only the entries a word needs.
//
// Bound: memory -- q read once (its partner's rows again, from L2), the
// payload written once; the scan moves a few bytes a row.
#include "dpack.cuh"

#define VP_PACK_WARPS 8  // warps a CTA
#define VP_PACK_ROWS 4   // consecutive block rows a warp, one after another
#if VP_PACK_WARPS * VP_PACK_ROWS != VP_TILE_ROWS
#error "a pack CTA takes one tile of the scan"
#endif
#define VP_SCAN_THREADS 1024
#define VP_SCAN_TILES 2  // consecutive tiles a scan thread holds
#define VP_SCAN_TSTEP (VP_SCAN_THREADS * VP_SCAN_TILES)

// per rung, ceil(2^20 / unit) of its staging unit (4w bits up to w = 8, else
// w): n / unit = (n * inv) >> 20 exactly for n < 4096, the error staying
// below 1 / unit
static __constant__ uint32_t vp_unit_inv[VP_NW] = {
    0, 262144, 131072, 87382, 65536, 52429, 43691, 32768, 104858, 87382,
    69906, 58255};

// -- the scan ----------------------------------------------------------------

// block-wide exclusive scans of two values a thread, and their totals
__device__ __forceinline__ void pack_block_scan(const uint32_t v[2],
                                                uint32_t ex[2],
                                                uint32_t total[2],
                                                uint32_t (*wsum)[32]) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t x[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    x[s] = v[s];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, x[s], off);
      if (lane >= off) x[s] += y;
    }
    if (lane == 31) wsum[s][warp] = x[s];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t t = lane < nwarps ? wsum[s][lane] : 0u;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, t, off);
        if (lane >= off) t += y;
      }
      if (lane < nwarps) wsum[s][lane] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    ex[s] = (warp ? wsum[s][warp - 1] : 0u) + x[s] - v[s];
    total[s] = wsum[s][nwarps - 1];
  }
  __syncthreads();  // wsum is rewritten by the next scan
}

// the rows of pack tile t (VP_TILE_ROWS consecutive block rows of one
// channel, a pack CTA's): its channel, its first row and how many it has
__device__ __forceinline__ void tile_rows(int t, int T, int NB, int& c,
                                          int& row0, int& n) {
  c = t / T;
  const int b = (t - c * T) * VP_TILE_ROWS;
  row0 = c * NB + b;
  n = min(VP_TILE_ROWS, NB - b);
}

// the widx|flags bytes of a tile's rows as 8 little-endian words (0 past
// its n rows), by 16-byte or 4-byte loads where the address allows
__device__ __forceinline__ void tile_bytes(const uint8_t* __restrict__ widx,
                                          int row0, int n, uint32_t b[8]) {
  const uint8_t* p = widx + row0;
  if (n == VP_TILE_ROWS && ((uintptr_t)p & 15) == 0) {
    const uint4 lo = ((const uint4*)p)[0], hi = ((const uint4*)p)[1];
    b[0] = lo.x;
    b[1] = lo.y;
    b[2] = lo.z;
    b[3] = lo.w;
    b[4] = hi.x;
    b[5] = hi.y;
    b[6] = hi.z;
    b[7] = hi.w;
  } else if (n == VP_TILE_ROWS && ((uintptr_t)p & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = ((const uint32_t*)p)[k];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t v = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * k + i < n) v |= (uint32_t)p[4 * k + i] << (8 * i);
      }
      b[k] = v;
    }
  }
}

// unary bit counts k .. k+3 of a tile's rows (0 past its n rows), by a
// 16-byte load where the tile is whole and the address allows
__device__ __forceinline__ int4 tile_ubits4(const int32_t* __restrict__ p,
                                           int k, int n, bool vec) {
  if (vec) return *(const int4*)(p + k);
  return make_int4(k < n ? p[k] : 0, k + 1 < n ? p[k + 1] : 0,
                   k + 2 < n ? p[k + 2] : 0, k + 3 < n ? p[k + 3] : 0);
}

__device__ __forceinline__ uint32_t unary_words(int32_t bits) {
  return ((uint32_t)bits + 31u) >> 5;
}

// sc: the scan (dpack.cuh); the header of wire. One CTA: a thread takes
// VP_SCAN_TILES consecutive tiles a step, the block scans the thread sums.
__global__ void __launch_bounds__(VP_SCAN_THREADS)
    dpack_pack_scan(uint8_t* __restrict__ wire,
                    const int32_t* __restrict__ ubits, int32_t* __restrict__ sc,
                    int C, int NB, int hdr, uint32_t cap_bytes, int cap_urow,
                    int rice) {
  __shared__ uint32_t wsum[2][32];
  __shared__ int s_w[32];
  if (threadIdx.x < 32) {
    s_w[threadIdx.x] = threadIdx.x < VP_NW ? vp_widths[threadIdx.x] : 0;
  }
  __syncthreads();
  const int T = vp_tiles(NB);
  const int nt = C * T;
  const uint8_t* widx = wire + hdr;
  int32_t* tpre = sc + VP_SCAN_HEAD;
  int32_t* tupre = tpre + vp_scan_pad(nt);
  uint32_t carry[2] = {0u, 0u};
  bool over = false;
  for (int base = 0; base < nt; base += VP_SCAN_TSTEP) {
    const int t0 = base + VP_SCAN_TILES * threadIdx.x;
    uint32_t gs[VP_SCAN_TILES], us[VP_SCAN_TILES], sum[2], ex[2], tot[2];
#pragma unroll
    for (int j = 0; j < VP_SCAN_TILES; ++j) {
      gs[j] = us[j] = 0u;
      if (t0 + j >= nt) continue;
      int c, row0, n;
      tile_rows(t0 + j, T, NB, c, row0, n);
      uint32_t b[8];
      tile_bytes(widx, row0, n, b);
#pragma unroll
      for (int k = 0; k < VP_TILE_ROWS; ++k) {
        gs[j] += (uint32_t)s_w[(b[k >> 2] >> (8 * (k & 3))) & 31u];
      }
      if (rice) {
        const int32_t* p = ubits + row0;
        const bool vec = n == VP_TILE_ROWS && ((uintptr_t)p & 15) == 0;
#pragma unroll
        for (int k = 0; k < VP_TILE_ROWS; k += 4) {
          const int4 t = tile_ubits4(p, k, n, vec);
          const uint32_t u[4] = {unary_words(t.x), unary_words(t.y),
                                 unary_words(t.z), unary_words(t.w)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            us[j] += u[i];
            over |= u[i] > (uint32_t)cap_urow;
          }
        }
      }
    }
    sum[0] = sum[1] = 0u;
#pragma unroll
    for (int j = 0; j < VP_SCAN_TILES; ++j) {
      sum[0] += gs[j];
      sum[1] += us[j];
    }
    pack_block_scan(sum, ex, tot, wsum);
    uint32_t gp = carry[0] + ex[0], up = carry[1] + ex[1];
#pragma unroll
    for (int j = 0; j < VP_SCAN_TILES; ++j) {
      if (t0 + j < nt) {
        int c, row0, n;
        tile_rows(t0 + j, T, NB, c, row0, n);
        tpre[t0 + j] = (int32_t)gp;
        if (rice) tupre[t0 + j] = (int32_t)up;
        // the channel's last tile: its cut, the unary words up to its end
        if (row0 + n == (c + 1) * NB) {
          ((uint32_t*)wire)[2 + c] = 32u * (up + us[j]);
        }
      }
      gp += gs[j];
      up += us[j];
    }
    carry[0] += tot[0];
    carry[1] += tot[1];
  }
  over = __syncthreads_or(over);
  if (threadIdx.x == 0) {
    sc[0] = (int32_t)carry[0];
    sc[1] = (int32_t)carry[1];
    sc[2] = over;
    sc[3] = 0;
    ((uint32_t*)wire)[0] =
        over ? 0x7FFFFFF0u : 16u * carry[0] + 4u * carry[1];
    ((uint32_t*)wire)[1] = cap_bytes;
  }
}

// -- the pack ----------------------------------------------------------------

// a warp's VP_PACK_ROWS consecutive rows of one channel's q: each lane's run
// of 4 samples a row, and the 3 samples before the warp's first row (lane 0
// reads them; 0 before the channel's first sample)
struct PackRuns {
  uint2 run[VP_PACK_ROWS];
  int32_t halo[3];
};

__device__ __forceinline__ void load_runs(const int16_t* __restrict__ qc,
                                          int b0, int L, bool vec, int lane,
                                          PackRuns& p) {
#pragma unroll
  for (int r = 0; r < VP_PACK_ROWS; ++r) {
    p.run[r] = load_run(qc, (b0 + r) * VP_BLOCK + 4 * lane, L, vec);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = b0 * VP_BLOCK - 3 + k;
    p.halo[k] = lane == 0 && i >= 0 ? (int32_t)qc[i] : 0;
  }
}

// x[0..6] = q[i-3 .. i+3] around a lane's run i .. i+3 of row r: its own 4
// samples, the 3 before from the lane before by __shfl_up_sync, for lane 0
// from lane 31's run of the row before (or the halo for the first row)
__device__ __forceinline__ void row_window(const PackRuns& p, int r, int lane,
                                           int32_t x[7]) {
  const uint2 own = p.run[r];
  const uint2 prev = p.run[r > 0 ? r - 1 : 0];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[3 + k] = run_sample(own, k);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int32_t up = __shfl_up_sync(0xffffffffu, x[4 + k], 1);
    const int32_t last = __shfl_sync(0xffffffffu, run_sample(prev, 1 + k), 31);
    x[k] = lane > 0 ? up : r > 0 ? last : p.halo[k];
  }
}

__global__ void __launch_bounds__(VP_PACK_WARPS * 32)
    dpack_pack_kernel(const int16_t* __restrict__ q,
                      const int32_t* __restrict__ partner,
                      uint8_t* __restrict__ wire,
                      int32_t* __restrict__ sc,
                      const int32_t* __restrict__ ubits, int L, int NB,
                      int hdr, int nbt, int cap_groups, int store, int rice) {
  __shared__ __align__(16) uint32_t s_val[VP_PACK_WARPS][VP_BLOCK];
  __shared__ __align__(16) uint32_t s_word[VP_PACK_WARPS][4 * VP_MAX_W];
  __shared__ int s_groups[VP_PACK_WARPS], s_uwords[VP_PACK_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.y;
  const int b0 = (blockIdx.x * VP_PACK_WARPS + warp) * VP_PACK_ROWS;
  const bool vec = (L & 3) == 0;
  // every load that waits on no other first: the tile's offsets, the rows'
  // widx|flags bytes (and unary bits), the partner, the own rows of q
  const int tile = c * gridDim.x + blockIdx.x;
  const int nt = (int)(gridDim.x * gridDim.y);
  const int tile_goff = sc[VP_SCAN_HEAD + tile];
  const int tile_uoff = rice ? sc[VP_SCAN_HEAD + vp_scan_pad(nt) + tile] : 0;
  uint32_t wb[VP_PACK_ROWS], uw[VP_PACK_ROWS];
#pragma unroll
  for (int r = 0; r < VP_PACK_ROWS; ++r) {
    const bool in = b0 + r < NB;
    wb[r] = in ? wire[hdr + c * NB + b0 + r] : 0u;
    uw[r] = rice && in ? unary_words(ubits[c * NB + b0 + r]) : 0u;
  }
  const int pc = partner[c];
  PackRuns own, par;
  bool inter = false;
#pragma unroll
  for (int r = 0; r < VP_PACK_ROWS; ++r) inter |= ((wb[r] >> 6) & 1) != 0;
  if (b0 < NB) {
    load_runs(q + c * L, b0, L, vec, lane, own);
    if (inter) load_runs(q + pc * L, b0, L, vec, lane, par);  // uniform
  }
  // each row's group offset: the tile's, the warps' before this one (through
  // shared memory) and the rows' before it in the warp
  int goff[VP_PACK_ROWS], groups = 0, uwords = 0;
#pragma unroll
  for (int r = 0; r < VP_PACK_ROWS; ++r) {
    goff[r] = groups;
    const int rung = wb[r] & 31;
    groups += rung < VP_NW ? vp_widths[rung] : 0;
    uwords += uw[r];
  }
  if (lane == 0) {
    s_groups[warp] = groups;
    s_uwords[warp] = uwords;
  }
  __syncthreads();
  if (b0 >= NB) return;
  int before = tile_goff, ubefore = tile_uoff;
  for (int v = 0; v < warp; ++v) {
    before += s_groups[v];
    ubefore += s_uwords[v];
  }
#pragma unroll
  for (int r = 0; r < VP_PACK_ROWS; ++r) goff[r] += before;
  if (rice && lane < VP_PACK_ROWS && b0 + lane < NB) {
    // each row's exclusive unary-word offset, which K7 reads (a rice row
    // of width 0 has no planes but its unary words)
    int u = ubefore;
#pragma unroll
    for (int r = 0; r < VP_PACK_ROWS; ++r) u += r < lane ? (int)uw[r] : 0;
    sc[VP_SCAN_HEAD + 2 * vp_scan_pad(nt) + c * NB + b0 + lane] = u;
  }
  uint32_t* val = s_val[warp];
  uint32_t* word = s_word[warp];  // a row's words, for the 16-byte stores
#pragma unroll
  for (int r = 0; r < VP_PACK_ROWS; ++r) {
    const int rung = wb[r] & 31;
    const int w = rung < VP_NW ? vp_widths[rung] : 0;
    // the own window's shuffles run on every row, so every lane takes them
    int32_t x[7], v[4];
    row_window(own, r, lane, x);
    const int cand = vp_cand_of((uint8_t)wb[r]);
    window_diff(x, cand & 1, v);
    if (inter) {  // uniform per warp
      row_window(par, r, lane, x);
      if (cand & 2) {
        int32_t p[4];
        window_diff(x, cand & 1, p);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] -= p[k];
      }
    }
    if (w == 0) continue;  // uniform per warp: no payload
    const int i0 = (b0 + r) * VP_BLOCK + 4 * lane;
    const bool whole = (b0 + r + 1) * VP_BLOCK <= L;  // uniform per warp
    const uint32_t mask = (1u << w) - 1u;
    uint32_t z[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      z[k] = whole || i0 + k < L ? vp_zigzag(v[k]) & mask : 0u;
    }
    // stage: up to 8 bits a lane's 4 values as one 4w-bit chunk, else the
    // values; an entry covers `unit` bits of the block
    __syncwarp();  // the row before has read val and word
    int unit;
    if (w <= 8) {
      val[lane] = z[0] | z[1] << w | z[2] << (2 * w) | z[3] << (3 * w);
      unit = 4 * w;
    } else {
      *(uint4*)(val + 4 * lane) = make_uint4(z[0], z[1], z[2], z[3]);
      unit = w;
    }
    __syncwarp();
    // word k holds bits 32k .. 32k+31 of the block: entries e0 .. e1 (at most
    // 9), the first possibly begun in the word before
    const uint32_t inv = vp_unit_inv[rung];
    const int nw = 4 * w;
    uint8_t* dst = wire + hdr + nbt + 16 * (size_t)goff[r];
    for (int k = lane; k < nw; k += 32) {
      const int bit0 = 32 * k;
      const int e0 = (int)(((uint32_t)bit0 * inv) >> 20);
      const int e1 = (int)(((uint32_t)(bit0 + 31) * inv) >> 20);
      int o = e0 * unit - bit0;  // -unit < o <= 0
      uint32_t acc = val[e0] >> -o;
      for (int e = e0 + 1; e <= e1; ++e) {
        o += unit;
        acc |= val[e] << o;
      }
      if (store == VP_STORE_16) {
        word[k] = acc;
      } else if (goff[r] + (k >> 2) < cap_groups) {
        if (store == VP_STORE_4) {
          *(uint32_t*)(dst + 4 * k) = acc;
        } else {
          vp_store_word(dst + 4 * k, acc);
        }
      }
    }
    if (store == VP_STORE_16) {  // lane j < w: group j as one 16-byte store
      __syncwarp();
      if (lane < w && goff[r] + lane < cap_groups) {
        *(uint4*)(dst + 16 * lane) = *(const uint4*)(word + 4 * lane);
      }
    }
  }
}

// q int16 [C, L]; partner int32 [C]; wire u8 (16-byte aligned) whose widx
// table at HDR holds K4's select; ubits int32 [C*NB] (read on a rice wire
// only); scan int32 [VP_SCAN_HEAD + vp_scan_pad(C*vp_tiles(NB)) * (rice ?
// 2 : 1) + (rice ? C*NB : 0)].
VP_API int vp_dpack_pack(const void* q, const void* partner, void* wire,
                         const void* ubits, void* scan, int64_t C, int64_t L,
                         int64_t NB, int64_t HDR, int64_t cap_groups,
                         int64_t cap_urow, int64_t rice, void* stream) {
  const int64_t lim = (int64_t)1 << 31;
  const int64_t nbt = C * NB;
  if (C < 1 || C > 65535 || NB < 0 || L < 0 || L > NB * VP_BLOCK ||
      C * L >= lim || VP_UNARY_ROW_MAX * nbt >= lim || cap_groups < 0 ||
      cap_groups >= lim || cap_urow < 0 || HDR != 8 + 4 * C ||
      ((uintptr_t)wire & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (nbt == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  uint8_t* w = (uint8_t*)wire;
  int32_t* sc = (int32_t*)scan;
  dpack_pack_scan<<<1, VP_SCAN_THREADS, 0, s>>>(
      w, (const int32_t*)ubits, sc, (int)C, (int)NB, (int)HDR,
      (uint32_t)(16 * cap_groups), (int)cap_urow, (int)rice);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t pay = HDR + nbt;  // payload offset in the wire
  const int store = vp_store_mode(pay);
  const dim3 grid((unsigned)vp_tiles((int)NB), (unsigned)C);  // a tile a CTA
  dpack_pack_kernel<<<grid, VP_PACK_WARPS * 32, 0, s>>>(
      (const int16_t*)q, (const int32_t*)partner, w, sc,
      (const int32_t*)ubits, (int)L, (int)NB, (int)HDR, (int)nbt,
      (int)cap_groups, store, (int)rice);
  return (int)cudaGetLastError();
}
