// K4 ola_assemble: overlap-add assembly, with the IMDCT epilogue, the s16
// quantize and the dpack candidate select folded in.
//
// Replaces vorbispizza_tpu/ops/ola.py block_assemble_wide (220, with
// _event_geometry, _block_levels and _row_phase_take: 128-lane row takes,
// barrel-shift lane rotations and row scatters, all TPU workarounds for
// slow gathers), the epilogue of ops/imdct.py imdct_window_batch (42) plus
// the prime/final masks of models/pipeline.py _synth_math, the s16
// quantize and planes of models/pipeline.py (819-826, 878-889), and
// ops/pcm_pack.py select_candidate (129) on the dpack wires.
//
// What it computes (the expand_assemble definition): with DA, DB, VA, VB
// the inclusive sums of the host's j-sorted events and k the last event
// with ev_j <= i (padding events sit at ev_j = L and are never reached),
//   a = i + DA[k], b = i + DB[k], pcm[c, i] = fa*(VA[k] > 0) + fb*(VB[k] > 0)
// where fa is the flat windowed-frame value at index a of channel c, made
// at read time from its bucket's DCT-IV output d: f, j = divmod(a - base,
// n), the IMDCT reflection [d[h:], -d[::-1], -d[:h]], x window[j], x
// keep(prime, final, j), in the reference's order. Flat indices outside
// [0, Tf) read 0. The [C, Tf] flat tensor is never written.
//
// Bound on the H100: memory. d is read once (about L*C floats: frames
// overlap by half, so each d value feeds two neighbouring output samples,
// the second time from L1/L2), the output written once (2 or 4 bytes a
// sample; in the dpack mode also a width byte and a unary count a block).
//
// Design, against what held the first version (one thread a sample) back:
// - Chain state scanned in the C entry. A scan kernel turns the int32
//   events into int32 inclusive sums DA, DB and the two validity levels as
//   bits (V: bit 0 VA > 0, bit 1 VB > 0): one CTA when the events fit a
//   step of 8192, else one cluster of 8 CTAs that each sum a range, meet
//   through distributed shared memory after a cluster barrier, and scan
//   their range from that carry. A thread adds 8 consecutive events
//   serially, so the shuffles come to one per 8 events. The wrapper runs no torch op: two device
//   ops a call. int32 holds it: a - i stays within +-Tf, and the host
//   refuses Tf + L or C*L from 2^31.
// - A tile per CTA. A CTA makes TILE consecutive samples (a power of two,
//   C*TILE <= 8192, at least 128) of every channel. Two warps find the
//   tile's first and last events with a 32-way ballot search of ev_j (one
//   round per 5 bits of Ep), then the CTA stages those events and their
//   scanned state in shared memory. A tile that holds more events than the
//   buffer reads its own range of them from global memory instead. No
//   thread searches the whole event table.
// - Runs of four consecutive samples a thread, a warp 128 consecutive
//   samples of one channel. A run finds its event by binary search in the
//   tile's events. Between events a and b rise by one a sample, so when no
//   event falls inside the run and each side's four samples lie in one
//   quarter of one frame (nearly every run), a side's four values share a
//   row, a read direction (consecutive or reversed, so the reads of d
//   coalesce), a sign and a keep flag, and its eight loads go out
//   together. The hot loop takes only that path: it marks the other runs
//   (an event inside the run, or a side that leaves a frame quarter or
//   its bucket) in a shared bitmask, and a loop after it makes them a
//   sample at a time. The stores are vector stores (16 bytes f32, 8 s16,
//   4 a plane for s16p) when L is a multiple of 4.
// - What bounds it in practice is latency, not bytes: with every load of d
//   and the window taken out it kept most of its time, and its time
//   followed the CTAs in flight (see VP_OLA_MIN_CTAS). Runs of 8 samples
//   were tried: more registers, fewer warps, slower.
// - 32-bit index math and no division: each bucket row carries log2 n, so
//   divmod(a - base, n) is a shift and a mask; a side keeps its bucket's
//   fields in registers from run to run and its frame's prime/final flags
//   until it leaves the frame.
// - The dpack mode (the s16 mode plus the select that was kernel K5)
//   writes q as the s16 mode does (K6 and K7 read it) and also keeps the
//   tile's q, with the 4 samples before the tile remade (samples before 0
//   read 0, as jnp.diff(prepend=0) has it), in shared memory. A warp then
//   takes one (channel, 128-sample block): d2/d3 of its own and of its
//   pair partner's channel come from shared memory, and the candidate
//   costs, tie order and outputs are K5's (a warp max per candidate, 11
//   warp sums per candidate with rice on; integer max and sum do not
//   depend on which lane holds which sample). K5's second pass over q,
//   from device memory, goes away.
// - Bit-exactness: every product and sum is spelt __fmul_rn/__fadd_rn in
//   the reference's order; the quantize compares (not fminf/fmaxf) so a
//   NaN stays a NaN through the clips, as torch.clamp and jnp.clip do.
#include <cooperative_groups.h>
#include <limits.h>

#include "dpack.cuh"

#define VP_OLA_MAX_BUCKETS 64
#define VP_OLA_MAX_C 255  // channels (the Vorbis limit)
#define VP_OLA_THREADS 256
// CTAs an SM: caps a thread at 64 registers. The kernel is latency-bound,
// and its time followed the CTAs in flight: 4 an SM (64 registers) ran
// faster than 3 (70-80 registers); 5 (48 registers) spilled and ran
// slower still.
#define VP_OLA_MIN_CTAS 4
#define VP_OLA_EVB 128  // events a CTA stages in shared memory
#define VP_OLA_HALO 4   // samples before the tile the dpack mode remakes
#define VP_OLA_QPAD 8   // where a tile's q starts in its shared row
#define VP_OLA_TILE_SAMPLES 8192  // C * TILE at most (TILE >= 128)
// words of a tile's run bitmask: C * TILE / 4 runs, TILE = 128 past 64
// channels
#define VP_OLA_SLOW_WORDS ((VP_OLA_MAX_C * 128 / 4 + 31) / 32)
#define VP_OLA_SCAN_THREADS 1024
#define VP_OLA_SCAN_CLUSTER 8  // CTAs of the scan (a portable cluster)
#define VP_OLA_SCAN_ITEMS 8  // consecutive events a scan thread holds
#define VP_OLA_SCAN_STEP (VP_OLA_SCAN_THREADS * VP_OLA_SCAN_ITEMS)
#define VP_INF (1 << 29)

// the narrowest WIDTHS rung holding a block max of `bits` bits (0..32):
// the count of rungs 0..10 narrower than bits; 11 past 15 bits
static __constant__ int8_t vp_rung_of_bits[33] = {
    0, 1, 2, 3, 4, 5, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10, 11,
    11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11};

enum { VP_OUT_F32 = 0, VP_OUT_S16 = 1, VP_OUT_S16P = 2, VP_OUT_DPACK = 3 };

// vorbispizza_tpu/decoder.py CLIP_MAX: float32(0.99999994) = 1 - 2^-24
#define VP_CLIP_MAX 0x1.fffffep-1f

struct OlaBucket {
  const float* d;        // DCT-IV output [Fp*C, n/2]
  const float* window;   // [n]
  const uint8_t* prime;  // [Fp]
  const uint8_t* fin;    // [Fp] chain-final flags
  int32_t base;          // flat index of the bucket's frame 0, sample 0
  int32_t end;           // base + Fp * n
  int32_t lg;            // log2 n
  int32_t pad;
};

struct OlaBuckets {
  int32_t count;
  int32_t pad;
  OlaBucket b[VP_OLA_MAX_BUCKETS];
};

// -- the chain-state scan ------------------------------------------------------

// block-wide exclusive scans of four values a thread, and their totals
__device__ __forceinline__ void block_scan4(const uint32_t v[4], uint32_t ex[4],
                                            uint32_t total[4],
                                            uint32_t (*wsum)[32]) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t x[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    x[s] = v[s];
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, x[s], off);
      if (lane >= off) x[s] += y;
    }
    if (lane == 31) wsum[s][warp] = x[s];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t t = lane < nwarps ? wsum[s][lane] : 0u;
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, t, off);
        if (lane >= off) t += y;
      }
      if (lane < nwarps) wsum[s][lane] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    ex[s] = (warp ? wsum[s][warp - 1] : 0u) + x[s] - v[s];
    total[s] = wsum[s][nwarps - 1];
  }
  __syncthreads();  // wsum is rewritten by the next scan
}

// a thread's VP_OLA_SCAN_ITEMS consecutive events of the four arrays from
// e0 (0 past Ep), by 16-byte loads where they can be
__device__ __forceinline__ void scan_items(const int32_t* const src[4], int e0,
                                           int Ep, bool vec_in,
                                           uint32_t x[4][VP_OLA_SCAN_ITEMS]) {
  const bool whole = e0 + VP_OLA_SCAN_ITEMS <= Ep;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (whole && vec_in) {
#pragma unroll
      for (int k = 0; k < VP_OLA_SCAN_ITEMS; k += 4) {
        const int4 t = *(const int4*)(src[s] + e0 + k);
        x[s][k] = t.x;
        x[s][k + 1] = t.y;
        x[s][k + 2] = t.z;
        x[s][k + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < VP_OLA_SCAN_ITEMS; ++k) {
        x[s][k] = e0 + k < Ep ? (uint32_t)src[s][e0 + k] : 0u;
      }
    }
  }
}

// st: int32 [3, Ep] = DA, DB (inclusive sums of ev_da, ev_db) and V. One
// CTA when the events fit one step, else one cluster of
// VP_OLA_SCAN_CLUSTER CTAs on neighbouring SMs (one SM's memory rate bounds
// a single CTA's scan of a large chunk's events): CTA r takes the r-th
// range of the events, sums it, and after a cluster barrier adds up the
// sums of the ranks before it from their shared memory. Each CTA scans its
// range a step of 8192 events at a time with a carry: a thread adds 8
// consecutive events of each array serially and the block scans the
// thread sums, so the shuffles come to one per 8 events. Sums run in
// uint32, so a partial sum that leaves the int32 range wraps and the
// final one (in range) is exact.
__global__ void __launch_bounds__(VP_OLA_SCAN_THREADS)
    ola_assemble_scan(const int32_t* __restrict__ ev_da,
                      const int32_t* __restrict__ ev_db,
                      const int32_t* __restrict__ ev_va,
                      const int32_t* __restrict__ ev_vb,
                      int32_t* __restrict__ st, int Ep) {
  __shared__ uint32_t wsum[4][32];
  __shared__ uint32_t s_tot[4];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int32_t* const src[4] = {ev_da, ev_db, ev_va, ev_vb};
  const bool vec_in = (((uintptr_t)ev_da | (uintptr_t)ev_db |
                        (uintptr_t)ev_va | (uintptr_t)ev_vb) & 15) == 0;
  // rows 1 and 2 of st are 16-byte aligned when row 0 is and 4 | Ep
  const bool vec_out = ((uintptr_t)st & 15) == 0 && (Ep & 3) == 0;
  const int span = ranks * VP_OLA_SCAN_STEP;
  const int per = (Ep + span - 1) / span * VP_OLA_SCAN_STEP;
  const int lo = min(rank * per, Ep);
  const int hi = min(lo + per, Ep);
  uint32_t x[4][VP_OLA_SCAN_ITEMS], sum[4], ex[4], tot[4];
  uint32_t carry[4] = {0u, 0u, 0u, 0u};
  if (ranks > 1) {  // the sums of the ranks before this one
    for (int base = lo; base < hi; base += VP_OLA_SCAN_STEP) {
      scan_items(src, base + threadIdx.x * VP_OLA_SCAN_ITEMS, hi, vec_in, x);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int k = 0; k < VP_OLA_SCAN_ITEMS; ++k) carry[s] += x[s][k];
      }
    }
    block_scan4(carry, ex, tot, wsum);
    if (threadIdx.x < 4) s_tot[threadIdx.x] = tot[threadIdx.x];
    cluster.sync();
#pragma unroll
    for (int s = 0; s < 4; ++s) carry[s] = 0u;
    for (int r = 0; r < rank; ++r) {
      const uint32_t* t = cluster.map_shared_rank(s_tot, r);
#pragma unroll
      for (int s = 0; s < 4; ++s) carry[s] += t[s];
    }
    cluster.sync();  // every rank has read the others' sums
  }
  for (int base = lo; base < hi; base += VP_OLA_SCAN_STEP) {
    const int e0 = base + threadIdx.x * VP_OLA_SCAN_ITEMS;
    const bool whole = e0 + VP_OLA_SCAN_ITEMS <= hi;
    scan_items(src, e0, hi, vec_in, x);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      sum[s] = 0u;
#pragma unroll
      for (int k = 0; k < VP_OLA_SCAN_ITEMS; ++k) {
        sum[s] += x[s][k];
        x[s][k] = sum[s];
      }
    }
    block_scan4(sum, ex, tot, wsum);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int k = 0; k < VP_OLA_SCAN_ITEMS; ++k) x[s][k] += carry[s] + ex[s];
      carry[s] += tot[s];
    }
#pragma unroll
    for (int k = 0; k < VP_OLA_SCAN_ITEMS; ++k) {  // V's two bits in row 2
      x[2][k] = ((int32_t)x[2][k] > 0) | (((int32_t)x[3][k] > 0) << 1);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      int32_t* dst = st + r * Ep + e0;
      if (whole && vec_out) {
#pragma unroll
        for (int k = 0; k < VP_OLA_SCAN_ITEMS; k += 4) {
          *(int4*)(dst + k) = make_int4(x[r][k], x[r][k + 1], x[r][k + 2],
                                        x[r][k + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < VP_OLA_SCAN_ITEMS; ++k) {
          if (e0 + k < hi) dst[k] = (int32_t)x[r][k];
        }
      }
    }
  }
}

// -- the tiled assembly --------------------------------------------------------

// last k with ev_j[k] <= x (-1 if none), by a 32-way ballot search: each
// round the lanes probe 32 evenly spaced events of the open range
__device__ __forceinline__ int warp_last_le(const int32_t* __restrict__ ev_j,
                                            int Ep, int x, int lane) {
  int lo = 0, hi = Ep;  // ev_j[lo - 1] <= x, ev_j[hi] > x (when in range)
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const unsigned le = __ballot_sync(0xffffffffu, p < hi && ev_j[p] <= x);
    const int cnt = __popc(le);
    if (cnt == 0) break;
    const int last = lo + (cnt - 1) * step;
    lo = last + 1;
    hi = min(last + step, hi);
  }
  return lo - 1;
}

__device__ __forceinline__ int find_bucket(const OlaBuckets& bk, int a) {
  int i = 0;
  while (i + 1 < bk.count && bk.b[i + 1].base <= a) ++i;
  return i;
}

// one side (a or b) of a thread's runs: the fields of the bucket it reads,
// in registers, and the keep flags of the frame it last read
struct OlaSide {
  const float* d;
  const float* window;
  const uint8_t* prime;
  const uint8_t* fin;
  int base, size, lg;
  int frame;
  uint8_t pf, ff;  // prime and final flags of `frame`
};

__device__ __forceinline__ void side_bucket(const OlaBuckets& bk, OlaSide& s,
                                            int a) {
  const OlaBucket& B = bk.b[find_bucket(bk, a)];
  s.d = B.d;
  s.window = B.window;
  s.prime = B.prime;
  s.fin = B.fin;
  s.base = B.base;
  s.size = B.end - B.base;
  s.lg = B.lg;
  s.frame = -1;
}

// the frame's flags are loaded into registers and first read at the end,
// so the loads of d and the window are not held behind them
__device__ __forceinline__ void side_frame(OlaSide& s, int f) {
  if (f != s.frame) {
    s.frame = f;
    s.pf = s.prime[f];
    s.ff = s.fin[f];
  }
}

// flat value at a (0 outside [0, Tf)), one sample
__device__ __forceinline__ float flat_value(const OlaBuckets& bk, OlaSide& s,
                                            int c, int C, int a, int Tf) {
  if (a < 0 || a >= Tf) return 0.0f;
  if ((unsigned)(a - s.base) >= (unsigned)s.size) side_bucket(bk, s, a);
  const int r = a - s.base;
  const int f = r >> s.lg;
  const int n = 1 << s.lg;
  const int j = r & (n - 1);
  const int m = n >> 1;
  const int h = m >> 1;
  side_frame(s, f);
  const float* row = s.d + (int64_t)(f * C + c) * m;
  float y;
  if (j < h) {
    y = row[h + j];
  } else if (j < h + m) {
    y = -row[m - 1 - (j - h)];
  } else {
    y = -row[j - h - m];
  }
  y = __fmul_rn(y, s.window[j]);
  const bool keep = (!s.pf || j >= m) && (!s.ff || j < m);
  return __fmul_rn(y, keep ? 1.0f : 0.0f);
}

// flat values at a0..a0+3 when the four lie in one quarter of one frame
// (nearly always): they share a row, a read direction, a sign and a keep
// flag, and their eight loads go out together. Returns false, with out
// unset, for the other runs.
__device__ __forceinline__ bool flat_run(const OlaBuckets& bk, OlaSide& s,
                                         int c, int C, int a0, int Tf,
                                         float out[4]) {
  if (a0 >= 0 && a0 < Tf - 3) {
    if ((unsigned)(a0 - s.base) >= (unsigned)s.size) side_bucket(bk, s, a0);
    const int r = a0 - s.base;
    const int lgh = s.lg - 2;  // a quarter frame is h = n/4 samples
    if (r + 3 < s.size && (r >> lgh) == ((r + 3) >> lgh)) {
      const int f = r >> s.lg;
      const int n = 1 << s.lg;
      const int m = n >> 1;
      const int h = m >> 1;
      const int j = r & (n - 1);
      const int qtr = j >> lgh;
      side_frame(s, f);
      const float* row = s.d + (int64_t)(f * C + c) * m;
      const float* src;
      int step = 1;
      if (qtr == 0) {
        src = row + h + j;
      } else if (qtr < 3) {
        src = row + (m + h - 1 - j);
        step = -1;
      } else {
        src = row + (j - h - m);
      }
      const float* w = s.window + j;
      float y[4], wv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        y[k] = src[step * k];
        wv[k] = w[k];
      }
      const float kf = (qtr < 2 ? !s.pf : !s.ff) ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        out[k] = __fmul_rn(__fmul_rn(qtr ? -y[k] : y[k], wv[k]), kf);
      }
      return true;
    }
  }
  return false;
}

// s16 quantize of one sample; comparisons (not fminf/fmaxf) keep a NaN a
// NaN through the clips, as torch.clamp and jnp.clip do
__device__ __forceinline__ int32_t quantize_s16(float x) {
  x = x < -VP_CLIP_MAX ? -VP_CLIP_MAX : x;
  x = x > VP_CLIP_MAX ? VP_CLIP_MAX : x;
  float r = rintf(__fmul_rn(x, 32768.0f));
  r = r < -32768.0f ? -32768.0f : r;
  r = r > 32767.0f ? 32767.0f : r;
  return (int32_t)r;
}

// the tile's events: entries 0..m-1 are events k0+1..k1 (ej, da, db, v, in
// shared memory or, past the buffer, global memory); the state before the
// first of them (event k0, or none) is init_*
struct TileEvents {
  const int32_t* ej;
  const int32_t* da;
  const int32_t* db;
  const int32_t* v;
  int m;
  int init_da, init_db, init_v;
};

__device__ __forceinline__ float combine(float fa, float fb, int v) {
  return __fadd_rn(__fmul_rn(fa, (v & 1) ? 1.0f : 0.0f),
                   __fmul_rn(fb, (v & 2) ? 1.0f : 0.0f));
}

// the last entry of the tile's events at or before i (-1: the state at k0)
__device__ __forceinline__ int tile_event(const TileEvents& te, int i) {
  int lo = 0, hi = te.m;  // first entry with ej > i
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (te.ej[mid] <= i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// pcm of samples i0..i0+3 of channel c (samples at or past L read 0) when
// no event falls inside the run (a and b are then affine in i) and both
// sides take flat_run's path; else false, with pcm unset
__device__ __forceinline__ bool run_fast(const OlaBuckets& bk,
                                         const TileEvents& te, OlaSide& sa,
                                         OlaSide& sb, int c, int C, int i0,
                                         int L, int Tf, float pcm[4]) {
  const int e = tile_event(te, i0);
  if (e + 1 < te.m && te.ej[e + 1] <= i0 + 3) return false;
  int da = te.init_da, db = te.init_db, v = te.init_v;
  if (e >= 0) {
    da = te.da[e];
    db = te.db[e];
    v = te.v[e];
  }
  float fa[4], fb[4];
  if (!flat_run(bk, sa, c, C, i0 + da, Tf, fa) ||
      !flat_run(bk, sb, c, C, i0 + db, Tf, fb)) {
    return false;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pcm[k] = i0 + k < L ? combine(fa[k], fb[k], v) : 0.0f;
  }
  return true;
}

// the same, a sample at a time, for any run
__device__ __forceinline__ void run_slow(const OlaBuckets& bk,
                                         const TileEvents& te, OlaSide& sa,
                                         OlaSide& sb, int c, int C, int i0,
                                         int L, int Tf, float pcm[4]) {
  int e = tile_event(te, i0);
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + k;
    pcm[k] = 0.0f;
    if (i >= L) continue;
    while (e + 1 < te.m && te.ej[e + 1] <= i) ++e;
    const int da = e >= 0 ? te.da[e] : te.init_da;
    const int db = e >= 0 ? te.db[e] : te.init_db;
    const int v = e >= 0 ? te.v[e] : te.init_v;
    pcm[k] = combine(flat_value(bk, sa, c, C, i + da, Tf),
                     flat_value(bk, sb, c, C, i + db, Tf), v);
  }
}

// the output of run i0..i0+3 of channel c (and, in the dpack mode, its q in
// the tile's shared row at qrow)
template <int MODE>
__device__ __forceinline__ void store_run(void* __restrict__ out,
                                          int16_t* qrow, const float p[4],
                                          int c, int C, int i0, int L,
                                          bool vec) {
  const int64_t o = (int64_t)c * L + i0;
  if (MODE == VP_OUT_F32) {
    float* dst = (float*)out + o;
    if (vec) {
      *(float4*)dst = make_float4(p[0], p[1], p[2], p[3]);
    } else {
      for (int k = 0; k < 4 && i0 + k < L; ++k) dst[k] = p[k];
    }
    return;
  }
  uint32_t q[4];  // q + 32768, in 0..65535
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = (uint32_t)(quantize_s16(p[k]) + 32768);
  if (MODE == VP_OUT_S16P) {
    uint8_t* lo = (uint8_t*)out + o;
    uint8_t* hi = lo + (int64_t)C * L;
    if (vec) {
      *(uint32_t*)lo = (q[0] & 0xFFu) | ((q[1] & 0xFFu) << 8) |
                       ((q[2] & 0xFFu) << 16) | ((q[3] & 0xFFu) << 24);
      *(uint32_t*)hi = (q[0] >> 8) | ((q[1] >> 8) << 8) |
                       ((q[2] >> 8) << 16) | ((q[3] >> 8) << 24);
    } else {
      for (int k = 0; k < 4 && i0 + k < L; ++k) {
        lo[k] = (uint8_t)(q[k] & 0xFF);
        hi[k] = (uint8_t)(q[k] >> 8);
      }
    }
    return;
  }
  // int16 q, two a word (flipping bit 15 takes the bias off)
  const uint2 q4 =
      make_uint2(((q[0] ^ 0x8000u) & 0xFFFFu) | ((q[1] ^ 0x8000u) << 16),
                 ((q[2] ^ 0x8000u) & 0xFFFFu) | ((q[3] ^ 0x8000u) << 16));
  int16_t* dst = (int16_t*)out + o;
  if (vec) {
    *(uint2*)dst = q4;
  } else {
    for (int k = 0; k < 4 && i0 + k < L; ++k) {
      dst[k] = (int16_t)((int32_t)q[k] - 32768);
    }
  }
  // samples past L are 0 in shared memory (the run gives 0 there)
  if (MODE == VP_OUT_DPACK) *(uint2*)qrow = q4;
}

// d2/d3 of the 4 samples at qs[0..3] of a tile's shared q, from qs[-3..3]
// (qs is 8-byte aligned; the halo makes qs[-4..-1] valid)
__device__ __forceinline__ void tile_diffs(const int16_t* qs, int32_t d2[4],
                                           int32_t d3[4]) {
  const short4 a = *(const short4*)(qs - 4);
  const short4 b = *(const short4*)qs;
  const int32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int32_t q0 = w[4 + s], q1 = w[3 + s], q2 = w[2 + s], q3 = w[1 + s];
    d2[s] = q0 - 2 * q1 + q2;
    d3[s] = q0 - 3 * q1 + 3 * q2 - q3;
  }
}

template <int MODE>
__global__ void __launch_bounds__(VP_OLA_THREADS, VP_OLA_MIN_CTAS)
    ola_assemble_kernel(
    const __grid_constant__ OlaBuckets bk, const int32_t* __restrict__ ev_j,
    const int32_t* __restrict__ st, void* __restrict__ out,
    uint8_t* __restrict__ wbyte, int32_t* __restrict__ ubits,
    const int32_t* __restrict__ partner, int Ep, int L, int C, int Tf,
    int lg_tile, int NB, int rice) {
  __shared__ int32_t s_ev[4][VP_OLA_EVB];
  __shared__ int32_t s_k[5];  // k0, k1, the state at k0
  __shared__ uint32_t s_slow[VP_OLA_SLOW_WORDS];  // the runs marked slow
  // dpack: q [C][QPAD + TILE], the halo in the 4 samples before QPAD
  extern __shared__ __align__(16) int16_t s_q[];
  const int tile = 1 << lg_tile;
  const int t0 = blockIdx.x << lg_tile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool dpack = MODE == VP_OUT_DPACK;
  const int first = dpack ? max(t0 - VP_OLA_HALO, 0) : t0;
  const int last = min(t0 + tile, L) - 1;
  if (warp < 2) {
    const int k = warp_last_le(ev_j, Ep, warp == 0 ? first : last, lane);
    if (lane == 0) s_k[warp] = k;
  }
  const int runs = C << (lg_tile - 2);  // runs of 4 samples in the tile
  for (int w = threadIdx.x; w < (runs + 31) >> 5; w += blockDim.x) {
    s_slow[w] = 0u;
  }
  __syncthreads();
  const int k0 = s_k[0];
  TileEvents te;
  te.m = s_k[1] - k0;
  if (threadIdx.x == 0) {
    s_k[2] = k0 >= 0 ? st[k0] : 0;
    s_k[3] = k0 >= 0 ? st[Ep + k0] : 0;
    s_k[4] = k0 >= 0 ? st[2 * Ep + k0] : 0;
  }
  if (te.m <= VP_OLA_EVB) {
    for (int e = threadIdx.x; e < te.m; e += blockDim.x) {
      const int k = k0 + 1 + e;
      s_ev[0][e] = ev_j[k];
      s_ev[1][e] = st[k];
      s_ev[2][e] = st[Ep + k];
      s_ev[3][e] = st[2 * Ep + k];
    }
    te.ej = s_ev[0];
    te.da = s_ev[1];
    te.db = s_ev[2];
    te.v = s_ev[3];
  } else {
    te.ej = ev_j + k0 + 1;
    te.da = st + k0 + 1;
    te.db = st + Ep + k0 + 1;
    te.v = st + 2 * Ep + k0 + 1;
  }
  __syncthreads();
  te.init_da = s_k[2];
  te.init_db = s_k[3];
  te.init_v = s_k[4];
  OlaSide sa, sb;  // kept from run to run: a thread's runs share buckets
  sa.base = sb.base = 0;
  sa.size = sb.size = 0;

  const bool vec = (L & 3) == 0;
  const int stride_q = tile + VP_OLA_QPAD;
  const int lg_runs = lg_tile - 2;  // runs a channel
  for (int u = threadIdx.x; u < runs; u += blockDim.x) {
    const int c = u >> lg_runs;
    const int i0 = t0 + ((u & ((1 << lg_runs) - 1)) << 2);
    int16_t* qrow = s_q + c * stride_q + VP_OLA_QPAD + (i0 - t0);
    if (i0 >= L) {
      if (dpack) *(uint2*)qrow = make_uint2(0u, 0u);
      continue;
    }
    float p[4];
    if (run_fast(bk, te, sa, sb, c, C, i0, L, Tf, p)) {
      store_run<MODE>(out, qrow, p, c, C, i0, L, vec);
    } else {
      atomicOr(&s_slow[u >> 5], 1u << (u & 31));
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < (runs + 31) >> 5; w += blockDim.x) {
    for (uint32_t bits = s_slow[w]; bits; bits &= bits - 1) {
      const int u = (w << 5) + __ffs(bits) - 1;
      const int c = u >> lg_runs;
      const int i0 = t0 + ((u & ((1 << lg_runs) - 1)) << 2);
      float p[4];
      run_slow(bk, te, sa, sb, c, C, i0, L, Tf, p);
      store_run<MODE>(out, s_q + c * stride_q + VP_OLA_QPAD + (i0 - t0), p,
                      c, C, i0, L, vec);
    }
  }
  if (!dpack) return;

  // the halo: the 4 samples before the tile, remade (0 before sample 0)
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    short4 q4 = make_short4(0, 0, 0, 0);
    if (t0 > 0) {
      float p[4];
      if (!run_fast(bk, te, sa, sb, c, C, t0 - VP_OLA_HALO, L, Tf, p)) {
        run_slow(bk, te, sa, sb, c, C, t0 - VP_OLA_HALO, L, Tf, p);
      }
      q4 = make_short4((short)quantize_s16(p[0]), (short)quantize_s16(p[1]),
                       (short)quantize_s16(p[2]), (short)quantize_s16(p[3]));
    }
    *(short4*)(s_q + c * stride_q + VP_OLA_QPAD - VP_OLA_HALO) = q4;
  }
  __syncthreads();

  // the select: a warp per (channel, 128-sample block) of the tile; lane l
  // holds samples 4l..4l+3 of the block
  const unsigned FULL = 0xffffffffu;
  const int lg_blocks = lg_tile - 7;
  const int rows = C << lg_blocks;
  const int ncand = C >= 2 ? 4 : 2;
  for (int row = warp; row < rows; row += VP_OLA_THREADS / 32) {
    const int c = row >> lg_blocks;
    const int bl = row & ((1 << lg_blocks) - 1);
    const int gb = (t0 >> 7) + bl;
    if (gb >= NB) continue;  // uniform per warp
    const int pc = partner[c];
    const bool inter_ok = C >= 2 && pc != c;
    const int x = VP_OLA_QPAD + bl * VP_BLOCK + 4 * lane;
    const int ib = t0 + bl * VP_BLOCK + 4 * lane;
    int32_t d2[4], d3[4], p2[4] = {0, 0, 0, 0}, p3[4] = {0, 0, 0, 0};
    tile_diffs(s_q + c * stride_q + x, d2, d3);
    if (ncand == 4) tile_diffs(s_q + pc * stride_q + x, p2, p3);
    uint32_t z[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const bool in = ib + s < L;
      z[0][s] = in ? vp_zigzag(d2[s]) : 0u;
      z[1][s] = in ? vp_zigzag(d3[s]) : 0u;
      z[2][s] = in && ncand == 4 ? vp_zigzag(d2[s] - p2[s]) : 0u;
      z[3][s] = in && ncand == 4 ? vp_zigzag(d3[s] - p3[s]) : 0u;
    }
    int best_cost = 0, best_byte = 0, best_ubits = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= ncand) break;
      uint32_t mx = max(max(z[k][0], z[k][1]), max(z[k][2], z[k][3]));
      mx = __reduce_max_sync(FULL, mx);
      const int bits = 32 - __clz(mx);
      const int wi = vp_rung_of_bits[bits];
      const int wcost = bits > VP_MAX_W ? VP_INF : vp_widths[wi] * VP_BLOCK;
      int cost = wcost, rung = wi, is_rice = 0, ub = 0;
      if (rice) {
        int rcost = 0, rbest = 0, rsum = 0;
#pragma unroll
        for (int r = 0; r < VP_NW - 1; ++r) {  // rungs with w <= 15
          const int kw = vp_widths[r];
          uint32_t sm = (z[k][0] >> kw) + (z[k][1] >> kw) + (z[k][2] >> kw) +
                        (z[k][3] >> kw);
          sm = __reduce_add_sync(FULL, sm);
          const int rc = VP_BLOCK * kw + (((int)sm + VP_BLOCK + 31) & ~31);
          if (r == 0 || rc < rcost) {
            rcost = rc;
            rbest = r;
            rsum = (int)sm;
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
      wbyte[c * NB + gb] = (uint8_t)best_byte;
      ubits[c * NB + gb] = best_ubits;
    }
  }
}

template <int MODE>
static cudaError_t launch_tiles(const OlaBuckets& bk, const int32_t* ev_j,
                                const int32_t* st, void* out, uint8_t* wbyte,
                                int32_t* ubits, const int32_t* partner, int Ep,
                                int L, int C, int Tf, int lg_tile, int NB,
                                int rice, cudaStream_t s) {
  const size_t smem =
      MODE == VP_OUT_DPACK
          ? (size_t)C * ((1 << lg_tile) + VP_OLA_QPAD) * sizeof(int16_t)
          : 0;
  if (smem > 48 * 1024 - sizeof(int32_t) * (4 * VP_OLA_EVB + 2)) {
    const cudaError_t err = cudaFuncSetAttribute(
        ola_assemble_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned tiles = (unsigned)((L + (1 << lg_tile) - 1) >> lg_tile);
  ola_assemble_kernel<MODE><<<tiles, VP_OLA_THREADS, smem, s>>>(
      bk, ev_j, st, out, wbyte, ubits, partner, Ep, L, C, Tf, lg_tile, NB,
      rice);
  return cudaGetLastError();
}

static cudaError_t launch_scan(const int32_t* da, const int32_t* db,
                               const int32_t* va, const int32_t* vb,
                               int32_t* st, int Ep, cudaStream_t s) {
  if (Ep <= VP_OLA_SCAN_STEP) {
    ola_assemble_scan<<<1, VP_OLA_SCAN_THREADS, 0, s>>>(da, db, va, vb, st,
                                                        Ep);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(VP_OLA_SCAN_CLUSTER);
  cfg.blockDim = dim3(VP_OLA_SCAN_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = VP_OLA_SCAN_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ola_assemble_scan, da, db, va, vb, st, Ep);
}

// desc: host array of n_buckets rows (d, window, prime, final, base, n),
// each an int64 (pointers as addresses), in flat order; ev_*: int32 [Ep]
// sorted by ev_j; st: int32 [3, Ep] scratch; mode: VP_OUT_F32 (out f32
// [C, L]), VP_OUT_S16 (int16 [C, L]), VP_OUT_S16P (u8 [2, C, L]) or
// VP_OUT_DPACK (int16 [C, L], and per 128-sample block row c*NB + b the
// widx|flags byte in wbyte and the unary bit count in ubits; partner int32
// [C]). wbyte, ubits and partner are unread in the other modes.
VP_API int vp_ola_assemble(const void* desc, const void* ev_j,
                           const void* ev_da, const void* ev_db,
                           const void* ev_va, const void* ev_vb, void* st,
                           void* out, void* wbyte, void* ubits,
                           const void* partner, int64_t n_buckets, int64_t Ep,
                           int64_t L, int64_t C, int64_t Tf, int64_t mode,
                           int64_t rice, void* stream) {
  const int64_t lim = (int64_t)1 << 31;
  if (n_buckets < 1 || n_buckets > VP_OLA_MAX_BUCKETS || mode < VP_OUT_F32 ||
      mode > VP_OUT_DPACK || Ep < 1 || Ep >= lim || C < 1 ||
      C > VP_OLA_MAX_C || L < 0 ||
      Tf < 0 || Tf + L >= lim || C * L >= lim)
    return (int)cudaErrorInvalidValue;
  OlaBuckets bk;
  const int64_t* rows = (const int64_t*)desc;
  bk.count = (int32_t)n_buckets;
  bk.pad = 0;
  for (int64_t i = 0; i < n_buckets; ++i) {
    const int64_t* r = rows + 6 * i;
    const int64_t n = r[5];
    if (n < 4 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
    bk.b[i].d = (const float*)r[0];
    bk.b[i].window = (const float*)r[1];
    bk.b[i].prime = (const uint8_t*)r[2];
    bk.b[i].fin = (const uint8_t*)r[3];
    bk.b[i].base = (int32_t)r[4];
    bk.b[i].end = (int32_t)(i + 1 < n_buckets ? rows[6 * (i + 1) + 4] : Tf);
    bk.b[i].lg = __builtin_ctzll((unsigned long long)n);
    bk.b[i].pad = 0;
  }
  if (C * L == 0) return (int)cudaGetLastError();
  int lg_tile = 13;
  while (lg_tile > 7 && (C << lg_tile) > VP_OLA_TILE_SAMPLES) --lg_tile;
  const int NB = (int)((L + VP_BLOCK - 1) / VP_BLOCK);
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* sc = (int32_t*)st;
  cudaError_t err = launch_scan((const int32_t*)ev_da, (const int32_t*)ev_db,
                                (const int32_t*)ev_va, (const int32_t*)ev_vb,
                                sc, (int)Ep, s);
  if (err != cudaSuccess) return (int)err;
  const int32_t* j = (const int32_t*)ev_j;
  uint8_t* wb = (uint8_t*)wbyte;
  int32_t* ub = (int32_t*)ubits;
  const int32_t* pt = (const int32_t*)partner;
  const int e = (int)Ep, l = (int)L, c = (int)C, tf = (int)Tf, r = (int)rice;
  switch (mode) {
    case VP_OUT_F32:
      err = launch_tiles<VP_OUT_F32>(bk, j, sc, out, wb, ub, pt, e, l, c, tf,
                                     lg_tile, NB, r, s);
      break;
    case VP_OUT_S16:
      err = launch_tiles<VP_OUT_S16>(bk, j, sc, out, wb, ub, pt, e, l, c, tf,
                                     lg_tile, NB, r, s);
      break;
    case VP_OUT_S16P:
      err = launch_tiles<VP_OUT_S16P>(bk, j, sc, out, wb, ub, pt, e, l, c, tf,
                                      lg_tile, NB, r, s);
      break;
    default:
      err = launch_tiles<VP_OUT_DPACK>(bk, j, sc, out, wb, ub, pt, e, l, c,
                                       tf, lg_tile, NB, r, s);
  }
  return (int)err;
}
