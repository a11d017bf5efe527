// K2 floor1_synth: floor1 curves from the coded-ys wire, or (posts mode)
// from the posts/step2 wire.
//
// Replaces three XLA stages of vorbispizza_tpu: the ys rebuild of
// models/pipeline.py _fused_body (mask bits -> rank cumsum -> take from the
// compacted u8 stream), ops/floor.py floor1_unwrap (the spec 7.2.2 cascade
// unrolled over static neighbour tables) and ops/floor.py floor1_curves
// (which brackets every bin by one-hot MXU contractions because gathers are
// slow on the TPU). Here they are direct lookups.
//
// One block per (frame, channel) row of a floor group. Thread 0 rebuilds
// the row's coded values from its start rank (an exclusive prefix of
// per-row mask popcounts, computed outside), runs the cascade in shared
// memory, and finds each sorted post's enabled low/high neighbours. Then
// all threads render the bins from the static base-post table: the
// integer line of spec 9.2.6, clipped to 0..255, and the inverse-dB value
// A[v>>4]*B[v&15] -- the reference's exact table product, so the curve is
// bit-identical to it.
//
// Posts mode replaces the posts/step2 branch of _fused_body (737-748: the
// step2 bit planes unpacked LSB-first over P, the u8 posts taken as they
// are) followed by ops/floor.py floor1_curves. Thread 0 reads the row's
// shipped posts (u8 [G, P]; not clamped again, as the reference feeds them
// straight to floor1_curves) and step2 bits (u8 [G, ceil(P/8)]), skips the
// rebuild and the cascade, and the render is the same.
//
// Bound: the [rows, half] f32 output write; the serial cascade (at most
// P-2 steps of a few integer ops) runs once a row, beside half/256 store
// rounds. The design keeps every row's posts in shared memory and reads
// the static tables through L1.
#include "common.cuh"

#define VP_FLOOR1_MAX_POSTS 256

// tab (int32): xs[P] config order | low_nb[P] | high_nb[P] | order[P]
// (config index of each x-sorted post) | xs_s[P] (sorted x) | base_p[half]
//
// kPosts: ys01 holds the posts [G, P] and ysmask the step2 bits
// [G, ceil(P/8)]; ysnz and rank are unread.
template <bool kPosts>
__global__ void floor1_synth_kernel(
    const uint8_t* __restrict__ ys01, const uint8_t* __restrict__ ysmask,
    const uint8_t* __restrict__ ysnz, const int64_t* __restrict__ rank,
    const uint8_t* __restrict__ used, const int32_t* __restrict__ tab,
    const float* __restrict__ ab, float* __restrict__ out, int P, int half,
    int multiplier, int rng, int64_t cap) {
  __shared__ int ys[VP_FLOOR1_MAX_POSTS];
  __shared__ int fin[VP_FLOOR1_MAX_POSTS];
  __shared__ int s2[VP_FLOOR1_MAX_POSTS];
  __shared__ int y_s[VP_FLOOR1_MAX_POSTS];
  __shared__ int lo_s[VP_FLOOR1_MAX_POSTS];
  __shared__ int hi_s[VP_FLOOR1_MAX_POSTS];

  const int64_t g = blockIdx.x;
  const int32_t* xs = tab;
  const int32_t* low_nb = tab + P;
  const int32_t* high_nb = tab + 2 * P;
  const int32_t* order = tab + 3 * P;
  const int32_t* xs_s = tab + 4 * P;
  const int32_t* base_p = tab + 5 * P;

  if (kPosts && threadIdx.x == 0) {
    // the shipped posts and step2 bits (LSB-first over P)
    const int sb = (P + 7) / 8;
    for (int i = 0; i < P; ++i) {
      fin[i] = ys01[g * P + i];
      s2[i] = (ysmask[g * sb + i / 8] >> (i % 8)) & 1;
    }
  } else if (threadIdx.x == 0) {
    // ys rebuild: posts 0/1 raw, the rest from the zero bitmask + the
    // compacted nonzero stream (row-major ranks over the padded rows)
    ys[0] = ys01[g * 2];
    ys[1] = ys01[g * 2 + 1];
    const int mb = (P - 2 + 7) / 8;
    int64_t r = rank[g];
    for (int i = 2; i < P; ++i) {
      const int b = i - 2;
      if ((ysmask[g * mb + b / 8] >> (b % 8)) & 1) {
        ys[i] = ysnz[r < cap ? r : cap - 1];
        ++r;
      } else {
        ys[i] = 0;
      }
    }
    // unwrap cascade (spec 7.2.2 step 2; setup/floor.py Floor1._unwrap)
    fin[0] = ys[0];
    fin[1] = ys[1];
    s2[0] = 1;
    s2[1] = 1;
    for (int i = 2; i < P; ++i) {
      const int lo = low_nb[i], hi = high_nb[i];
      const int y0 = fin[lo], y1 = fin[hi];
      const int dy = y1 - y0;
      const int adx = xs[hi] - xs[lo];
      const int dx = xs[i] - xs[lo];
      const int off = (abs(dy) * dx) / adx;
      const int pred = dy < 0 ? y0 - off : y0 + off;
      const int val = ys[i];
      const int highroom = rng - pred;
      const int lowroom = pred;
      const int room = 2 * min(highroom, lowroom);
      const int big = highroom > lowroom ? val - lowroom + pred
                                         : pred - val + highroom - 1;
      const int small =
          (val & 1) == 1 ? pred - ((val + 1) >> 1) : pred + (val >> 1);
      const int nz = val != 0;
      fin[i] = nz ? (val >= room ? big : small) : pred;
      s2[i] = nz;
      if (nz) {
        s2[lo] = 1;
        s2[hi] = 1;
      }
    }
  }
  if (threadIdx.x == 0) {
    // x-sorted posts (clamped to the floor range, times the multiplier)
    // and each one's enabled neighbours: lo = largest enabled q <= p
    // (0 when none), hi = smallest enabled q > p (P when none)
    int last = -1;
    for (int p = 0; p < P; ++p) {
      const int c = order[p];
      const int post = kPosts ? fin[c] : min(max(fin[c], 0), rng - 1);
      y_s[p] = post * multiplier;
      if (s2[c]) last = p;
      lo_s[p] = max(last, 0);
    }
    int next = P;
    for (int p = P - 1; p >= 0; --p) {
      hi_s[p] = next;
      if (s2[order[p]]) next = p;
    }
  }
  __syncthreads();

  const bool on = used[g] != 0;
  float* row = out + g * half;
  for (int x = threadIdx.x; x < half; x += blockDim.x) {
    if (!on) {
      row[x] = 0.0f;
      continue;
    }
    const int b = base_p[x];
    const int lb = lo_s[b];
    const int hb = hi_s[b];
    const int x0 = xs_s[lb];
    const int y0 = y_s[lb];
    int val = y0;
    if (hb < P) {
      const int dy = y_s[hb] - y0;
      const int adx = max(xs_s[hb] - x0, 1);
      const int off = (abs(dy) * (x - x0)) / adx;
      val = y0 + (dy > 0 ? off : (dy < 0 ? -off : 0));
    }
    val = min(max(val, 0), 255);
    row[x] = __fmul_rn(ab[val >> 4], ab[16 + (val & 15)]);
  }
}

VP_API int vp_floor1_synth(const void* ys01, const void* ysmask,
                           const void* ysnz, const void* rank,
                           const void* used, const void* tab, const void* ab,
                           void* out, int64_t G, int64_t P, int64_t half,
                           int64_t multiplier, int64_t rng, int64_t cap,
                           void* stream) {
  if (P < 2 || P > VP_FLOOR1_MAX_POSTS) return (int)cudaErrorInvalidValue;
  if (G > 0) {
    floor1_synth_kernel<false><<<(unsigned)G, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)ys01, (const uint8_t*)ysmask, (const uint8_t*)ysnz,
        (const int64_t*)rank, (const uint8_t*)used, (const int32_t*)tab,
        (const float*)ab, (float*)out, (int)P, (int)half, (int)multiplier,
        (int)rng, cap);
  }
  return (int)cudaGetLastError();
}

// Posts mode: posts u8 [G, P], step2 bits u8 [G, ceil(P/8)].
VP_API int vp_floor1_posts(const void* posts, const void* step2,
                           const void* used, const void* tab, const void* ab,
                           void* out, int64_t G, int64_t P, int64_t half,
                           int64_t multiplier, void* stream) {
  if (P < 2 || P > VP_FLOOR1_MAX_POSTS) return (int)cudaErrorInvalidValue;
  if (G > 0) {
    floor1_synth_kernel<true><<<(unsigned)G, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)posts, (const uint8_t*)step2, nullptr, nullptr,
        (const uint8_t*)used, (const int32_t*)tab, (const float*)ab,
        (float*)out, (int)P, (int)half, (int)multiplier, 0, 1);
  }
  return (int)cudaGetLastError();
}
