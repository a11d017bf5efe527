// K2 floor1_synth: floor1 curves from the coded-ys wire, or (posts mode)
// from the posts/step2 wire.
//
// Replaces three XLA stages of vorbispizza_tpu: the ys rebuild of
// models/pipeline.py _fused_body (683-719: mask bits -> rank cumsum -> take
// from the compacted u8 stream), ops/floor.py floor1_unwrap (119: the spec
// 7.2.2 cascade unrolled over static neighbour tables) and ops/floor.py
// floor1_curves (26: which brackets every bin by one-hot MXU contractions
// because gathers are slow on the TPU). Here they are direct lookups.
//
// Bound: the [rows, half] f32 output write. What stood in its way was not
// bytes but latency: the first design ran a rank cumsum of torch ops
// before each launch, and thread 0 of a block did each row's rebuild, its
// P-2 step cascade and two neighbour passes while 255 threads waited. Now:
//
// - The C entry launches a rank kernel first: one block walks the group's
//   rows in tiles of 1024 with a carry, pops each row's P-2 mask bits and
//   writes the exclusive prefix (each row's start in the compacted nonzero
//   stream) into a scratch the wrapper allocates. The wrapper runs no
//   torch op but the two allocations.
// - The main kernel gives each (frame, channel) row one warp, 8 rows a
//   block, and nothing runs on one lane while the others wait:
//   * rebuild: lane l takes posts 2+l, 2+l+32, ...; its index into the
//     nonzero stream is the row's start rank plus the set bits of lower
//     lanes in the stripe's ballot plus a carry per stripe, clamped to
//     cap-1 as the reference's clip is;
//   * unwrap by dependency level (ops/floor.floor1_levels, a static table
//     per floor config): a post reads only its low and high neighbours,
//     which sit on lower levels, so the warp finishes one level a step
//     with __syncwarp between levels (6 and 5 levels on the corpus's
//     floors, against 17 and 27 serial steps). The step2 flags are ORs
//     (s2[i] = nz, s2[lo] |= nz, s2[hi] |= nz), so shared atomicOr on bit
//     words gives the serial order's bits;
//   * neighbours: a ballot of the enabled x-sorted posts (at most 8
//     words); each sorted post finds its enabled low and high neighbours
//     with __clz/__ffs on the masked words;
//   * render: each sorted post's line (its enabled neighbours' x and y)
//     is made once in shared memory, and the block's rows share the
//     base-post table (u8) and A/B there, so a bin's chain is two shared
//     loads, the integer line of spec 9.2.6 clipped to 0..255 and the
//     inverse-dB value A[v>>4]*B[v&15] (the reference's exact table
//     product, so the curve is bit-identical to it); the warp writes 32
//     consecutive bins a step (128-byte stores), four steps unrolled.
//
// Posts mode replaces the posts/step2 branch of _fused_body (737-748: the
// step2 bit planes unpacked LSB-first over P, the u8 posts taken as they
// are) followed by floor1_curves. The same kernel (template flag) reads the
// row's shipped posts (not clamped again, as the reference feeds them
// straight to floor1_curves) and step2 bits, skips the rebuild and the
// unwrap, and shares the neighbour search and the render, so the two modes
// cannot drift apart.
#include "common.cuh"

#define VP_FLOOR1_MAX_POSTS 256
#define VP_FLOOR1_MAX_HALF 4096  // blocksize 8192, the spec's largest
#define VP_FLOOR1_WORDS (VP_FLOOR1_MAX_POSTS / 32)
#define VP_FLOOR1_ROWS 8  // rows (warps) a block
#define VP_RANK_THREADS 1024

static constexpr unsigned kFull = 0xffffffffu;

// rank[g] = the set bits of rows 0..g-1 among each row's first P2 mask bits
// (u8 [G, mb], LSB-first). One block of VP_RANK_THREADS threads.
__global__ void __launch_bounds__(VP_RANK_THREADS)
    floor1_ranks_kernel(const uint8_t* __restrict__ mask,
                        int32_t* __restrict__ rank, int64_t G, int mb,
                        int P2) {
  __shared__ int warp_sum[VP_RANK_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned last = (P2 & 7) ? (1u << (P2 & 7)) - 1 : 0xffu;
  int carry = 0;
  for (int64_t base = 0; base < G; base += blockDim.x) {
    const int64_t g = base + threadIdx.x;
    int c = 0;
    if (g < G) {
      const uint8_t* row = mask + g * mb;
      for (int k = 0; k < mb; ++k)
        c += __popc(k == mb - 1 ? (row[k] & last) : row[k]);
    }
    int x = c;  // inclusive scan over the warp
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      int t = lane < nwarps ? warp_sum[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, t, off);
        if (lane >= off) t += y;
      }
      if (lane < nwarps) warp_sum[lane] = t;
    }
    __syncthreads();
    if (g < G) rank[g] = carry + (warp ? warp_sum[warp - 1] : 0) + x - c;
    carry += warp_sum[nwarps - 1];
    __syncthreads();  // warp_sum is rewritten by the next tile
  }
}

// The line a bin of base post p is rendered on: from p's enabled low
// neighbour (x0, y0) to its enabled high one, dy and adx = max(dx, 1)
// apart; adx 0 when p has no enabled high neighbour (the bin takes y0).
// x fits 16 bits (rangebits <= 15), y 11 bits (255 * multiplier 4).
struct Floor1Seg {
  uint16_t x0, adx;
  int16_t y0, dy;
};

// One warp's row in shared memory.
struct Floor1Row {
  int val[VP_FLOOR1_MAX_POSTS];  // coded values, unwrapped in place
  int y_s[VP_FLOOR1_MAX_POSTS];  // x-sorted posts times the multiplier
  Floor1Seg seg[VP_FLOOR1_MAX_POSTS];  // per x-sorted post
  unsigned s2[VP_FLOOR1_WORDS];  // step2 flags, config order
  unsigned en[VP_FLOOR1_WORDS];  // step2 flags, x-sorted order
};

// tab (int32): xs[P] config order | low_nb[P] | high_nb[P] | order[P]
// (config index of each x-sorted post) | xs_s[P] (sorted x) | base_p[half]
// lev (int32, ys mode): D | start[D+1] | posts 2..P-1 by level
//
// kPosts: ys01 holds the posts [G, P] and ysmask the step2 bits
// [G, ceil(P/8)]; ysnz, rank and lev are unread.
template <bool kPosts>
__global__ void __launch_bounds__(32 * VP_FLOOR1_ROWS) floor1_synth_kernel(
    const uint8_t* __restrict__ ys01, const uint8_t* __restrict__ ysmask,
    const uint8_t* __restrict__ ysnz, const int32_t* __restrict__ rank,
    const uint8_t* __restrict__ used, const int32_t* __restrict__ tab,
    const int32_t* __restrict__ lev, const float* __restrict__ ab,
    float* __restrict__ out, int64_t G, int P, int half, int multiplier,
    int rng, int64_t cap) {
  __shared__ Floor1Row rows[VP_FLOOR1_ROWS];
  // the render's static tables, shared by the block's rows: base_p fits
  // u8 (P <= 256) and A/B are 32 floats
  __shared__ uint8_t base_s[VP_FLOOR1_MAX_HALF];
  __shared__ float ab_s[32];
  for (int x = threadIdx.x; x < half; x += blockDim.x)
    base_s[x] = (uint8_t)tab[5 * P + x];
  if (threadIdx.x < 32) ab_s[threadIdx.x] = ab[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t g = (int64_t)blockIdx.x * VP_FLOOR1_ROWS + (threadIdx.x >> 5);
  if (g >= G) return;  // a whole warp: no block-wide barrier follows
  Floor1Row& s = rows[threadIdx.x >> 5];
  float* row = out + g * half;
  if (!used[g]) {  // the reference zeroes an unused row's curve
    for (int x = lane; x < half; x += 32) row[x] = 0.0f;
    return;
  }
  const int32_t* xs = tab;
  const int32_t* low_nb = tab + P;
  const int32_t* high_nb = tab + 2 * P;
  const int32_t* order = tab + 3 * P;
  const int32_t* xs_s = tab + 4 * P;
  const int nw = (P + 31) >> 5;
  const unsigned below = (1u << lane) - 1;  // lanes under this one

  if (kPosts) {
    // the shipped posts and step2 bits (LSB-first over P)
    const int sb = (P + 7) >> 3;
    for (int j = 0; j < nw; ++j) {
      const int i = 32 * j + lane;
      int bit = 0;
      if (i < P) {
        s.val[i] = ys01[g * P + i];
        bit = (ysmask[g * sb + (i >> 3)] >> (i & 7)) & 1;
      }
      const unsigned m = __ballot_sync(kFull, bit);
      if (lane == 0) s.s2[j] = m;
    }
  } else {
    // rebuild: posts 0/1 raw, the rest zero or the next value of the
    // compacted nonzero stream (row-major ranks over the padded rows)
    if (lane < 2) s.val[lane] = ys01[g * 2 + lane];
    const int P2 = P - 2;
    const int mb = (P2 + 7) >> 3;
    int64_t r = P2 > 0 ? rank[g] : 0;
    for (int b0 = 0; b0 < P2; b0 += 32) {
      const int b = b0 + lane;
      const int bit = b < P2 ? (ysmask[g * mb + (b >> 3)] >> (b & 7)) & 1 : 0;
      const unsigned m = __ballot_sync(kFull, bit);
      if (b < P2) {
        int v = 0;
        if (bit) {
          const int64_t k = r + __popc(m & below);
          v = ysnz[k < cap ? k : cap - 1];
        }
        s.val[2 + b] = v;
      }
      r += __popc(m);
    }
    for (int j = lane; j < nw; j += 32) s.s2[j] = j == 0 ? 3u : 0u;
    __syncwarp();
    // unwrap cascade (spec 7.2.2 step 2), one dependency level a step
    const int D = lev[0];
    const int32_t* start = lev + 1;
    const int32_t* posts = lev + 2 + D;
    for (int L = 0; L < D; ++L) {
      for (int k = start[L] + lane; k < start[L + 1]; k += 32) {
        const int i = posts[k];
        const int lo = low_nb[i], hi = high_nb[i];
        const int y0 = s.val[lo], y1 = s.val[hi];
        const int dy = y1 - y0;
        const int adx = xs[hi] - xs[lo];
        const int dx = xs[i] - xs[lo];
        const int off = (abs(dy) * dx) / adx;
        const int pred = dy < 0 ? y0 - off : y0 + off;
        const int val = s.val[i];
        const int highroom = rng - pred;
        const int lowroom = pred;
        const int room = 2 * min(highroom, lowroom);
        const int big = highroom > lowroom ? val - lowroom + pred
                                           : pred - val + highroom - 1;
        const int small =
            (val & 1) == 1 ? pred - ((val + 1) >> 1) : pred + (val >> 1);
        const int nz = val != 0;
        s.val[i] = nz ? (val >= room ? big : small) : pred;
        if (nz) {
          atomicOr(&s.s2[i >> 5], 1u << (i & 31));
          atomicOr(&s.s2[lo >> 5], 1u << (lo & 31));
          atomicOr(&s.s2[hi >> 5], 1u << (hi & 31));
        }
      }
      __syncwarp();
    }
  }
  __syncwarp();

  // x-sorted posts (clamped to the floor range in ys mode, times the
  // multiplier) and their step2 flags as ballot words
  for (int j = 0; j < nw; ++j) {
    const int p = 32 * j + lane;
    int bit = 0;
    if (p < P) {
      const int c = order[p];
      const int post = kPosts ? s.val[c] : min(max(s.val[c], 0), rng - 1);
      s.y_s[p] = post * multiplier;
      bit = (s.s2[c >> 5] >> (c & 31)) & 1;
    }
    const unsigned m = __ballot_sync(kFull, bit);
    if (lane == 0) s.en[j] = m;
  }
  __syncwarp();
  // each sorted post's enabled neighbours, lo = largest enabled q <= p (0
  // when none) and hi = smallest enabled q > p (P when none), and the line
  // between them
  for (int p = lane; p < P; p += 32) {
    const int w = p >> 5;
    const unsigned upto = kFull >> (31 - (p & 31));  // bits 0..p of word w
    int lo = 0;
    for (int k = w; k >= 0; --k) {
      const unsigned m = s.en[k] & (k == w ? upto : kFull);
      if (m) {
        lo = 32 * k + 31 - __clz(m);
        break;
      }
    }
    int hi = P;
    for (int k = w; k < nw; ++k) {
      const unsigned m = s.en[k] & (k == w ? ~upto : kFull);
      if (m) {
        hi = 32 * k + __ffs(m) - 1;
        break;
      }
    }
    Floor1Seg sg;
    sg.x0 = (uint16_t)xs_s[lo];
    sg.y0 = (int16_t)s.y_s[lo];
    sg.adx = hi < P ? (uint16_t)max(xs_s[hi] - xs_s[lo], 1) : 0;
    sg.dy = hi < P ? (int16_t)(s.y_s[hi] - s.y_s[lo]) : 0;
    s.seg[p] = sg;
  }
  __syncwarp();

  // render: 32 consecutive bins a step, four steps in flight
#pragma unroll 4
  for (int x = lane; x < half; x += 32) {
    const Floor1Seg sg = s.seg[base_s[x]];
    int val = sg.y0;
    if (sg.adx) {
      const int off = (int)((unsigned)(abs(sg.dy) * (x - sg.x0)) / sg.adx);
      val += sg.dy > 0 ? off : (sg.dy < 0 ? -off : 0);
    }
    val = min(max(val, 0), 255);
    row[x] = __fmul_rn(ab_s[val >> 4], ab_s[16 + (val & 15)]);
  }
}

// rank: int32 [G] scratch (unread for P == 2).
VP_API int vp_floor1_synth(const void* ys01, const void* ysmask,
                           const void* ysnz, void* rank, const void* used,
                           const void* tab, const void* lev, const void* ab,
                           void* out, int64_t G, int64_t P, int64_t half,
                           int64_t multiplier, int64_t rng, int64_t cap,
                           void* stream) {
  if (P < 2 || P > VP_FLOOR1_MAX_POSTS || half > VP_FLOOR1_MAX_HALF)
    return (int)cudaErrorInvalidValue;
  if (G > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (P > 2) {
      floor1_ranks_kernel<<<1, VP_RANK_THREADS, 0, st>>>(
          (const uint8_t*)ysmask, (int32_t*)rank, G, (int)((P - 2 + 7) / 8),
          (int)(P - 2));
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    floor1_synth_kernel<false>
        <<<vp_blocks(G, VP_FLOOR1_ROWS), 32 * VP_FLOOR1_ROWS, 0, st>>>(
            (const uint8_t*)ys01, (const uint8_t*)ysmask,
            (const uint8_t*)ysnz, (const int32_t*)rank, (const uint8_t*)used,
            (const int32_t*)tab, (const int32_t*)lev, (const float*)ab,
            (float*)out, G, (int)P, (int)half, (int)multiplier, (int)rng,
            cap);
  }
  return (int)cudaGetLastError();
}

// Posts mode: posts u8 [G, P], step2 bits u8 [G, ceil(P/8)].
VP_API int vp_floor1_posts(const void* posts, const void* step2,
                           const void* used, const void* tab, const void* ab,
                           void* out, int64_t G, int64_t P, int64_t half,
                           int64_t multiplier, void* stream) {
  if (P < 2 || P > VP_FLOOR1_MAX_POSTS || half > VP_FLOOR1_MAX_HALF)
    return (int)cudaErrorInvalidValue;
  if (G > 0) {
    floor1_synth_kernel<true>
        <<<vp_blocks(G, VP_FLOOR1_ROWS), 32 * VP_FLOOR1_ROWS, 0,
           (cudaStream_t)stream>>>(
            (const uint8_t*)posts, (const uint8_t*)step2, nullptr, nullptr,
            (const uint8_t*)used, (const int32_t*)tab, nullptr,
            (const float*)ab, (float*)out, G, (int)P, (int)half,
            (int)multiplier, 0, 1);
  }
  return (int)cudaGetLastError();
}
