// K4 ola_assemble: overlap-add assembly, with the IMDCT epilogue folded in.
//
// Replaces vorbispizza_tpu/ops/ola.py block_assemble_wide (with
// _event_geometry, _block_levels and _row_phase_take: 128-lane row takes,
// barrel-shift lane rotations and row scatters, all TPU workarounds for
// slow gathers) and the epilogue of ops/imdct.py imdct_window_batch plus
// the prime/final masks of models/pipeline.py _synth_math.
//
// One thread per (channel, output sample i). It finds the last host event
// with ev_j <= i by binary search (padding events carry ev_j = out_len),
// then a = i + DA[k], va = VA[k] > 0 and likewise for b, where DA/VA are
// inclusive cumsums of the events -- the expand_assemble definition. Each
// side's flat value is produced at read time from its bucket's DCT-IV
// output d: the bucket comes from the base table, f, j = divmod(a - base,
// n), then the IMDCT reflection [d[h:], -d[::-1], -d[:h]], x window[j],
// x keep(prime, final, j), in the reference's order. The [C, sum F*n]
// flat tensor of windowed frames is therefore never written. Flat indices
// outside [0, sum F*n) read 0. pcm = fa*va + fb*vb.
//
// Output mode (template parameter): f32 stores pcm; s16 and s16p also
// replace models/pipeline.py:819-826 and 878-889. They quantize pcm in
// registers -- clip to +-CLIP_MAX, x32768 (exact), rintf (round half to
// even, as jnp.round), clip to [-32768, 32767] -- and store q as int16
// (lossless: q is already in range) or as the s16p byte planes [2, C, L]
// u8 (lo, hi of q + 32768). The float pcm is never written in those modes.
//
// Bound: memory -- per sample one 4-byte store, two scattered 4-byte reads
// of d (consecutive samples read consecutive or reversed addresses, so
// they coalesce) and a binary search over the event table, which stays in
// L1/L2. Folding the epilogue in saves writing and re-reading the flat
// tensor (8 bytes a sample).
#include "common.cuh"

#define VP_OLA_MAX_BUCKETS 64

enum { VP_OUT_F32 = 0, VP_OUT_S16 = 1, VP_OUT_S16P = 2 };

// vorbispizza_tpu/decoder.py CLIP_MAX: float32(0.99999994) = 1 - 2^-24
#define VP_CLIP_MAX 0x1.fffffep-1f

struct OlaBucket {
  const float* d;        // DCT-IV output [Fp*C, n/2]
  const float* window;   // [n]
  const uint8_t* prime;  // [Fp]
  const uint8_t* fin;    // [Fp] chain-final flags
  int64_t base;          // flat index of the bucket's frame 0, sample 0
  int64_t n;
};

struct OlaBuckets {
  int64_t count;
  OlaBucket b[VP_OLA_MAX_BUCKETS];
};

__device__ __forceinline__ float flat_value(const OlaBuckets& bk, int c,
                                            int C, int64_t a, int64_t Tf) {
  if (a < 0 || a >= Tf) return 0.0f;
  int i = 0;
  while (i + 1 < bk.count && bk.b[i + 1].base <= a) ++i;
  const OlaBucket& B = bk.b[i];
  const int64_t r = a - B.base;
  const int64_t f = r / B.n;
  const int64_t j = r - f * B.n;
  const int64_t m = B.n / 2;
  const int64_t h = m / 2;
  const float* row = B.d + (f * C + c) * m;
  float y;
  if (j < h) {
    y = row[h + j];
  } else if (j < h + m) {
    y = -row[m - 1 - (j - h)];
  } else {
    y = -row[j - h - m];
  }
  y = __fmul_rn(y, B.window[j]);
  const bool keep = (!B.prime[f] || j >= m) && (!B.fin[f] || j < m);
  return __fmul_rn(y, keep ? 1.0f : 0.0f);
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

// __grid_constant__: the table stays in parameter space and is indexed
// there, with no per-thread copy
template <int MODE>
__global__ void ola_assemble_kernel(const __grid_constant__ OlaBuckets bk,
                                    const int32_t* __restrict__ ev_j,
                                    const int64_t* __restrict__ da,
                                    const int64_t* __restrict__ db,
                                    const int64_t* __restrict__ va,
                                    const int64_t* __restrict__ vb,
                                    void* __restrict__ out, int64_t Ep,
                                    int64_t L, int C, int64_t Tf) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)C * L) return;
  const int c = (int)(t / L);
  const int64_t i = t - (int64_t)c * L;
  // k = last event with ev_j <= i (events are sorted by j)
  int64_t lo = 0, hi = Ep;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (ev_j[mid] <= i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int64_t k = lo - 1;
  int64_t a = i, b = i;
  float fva = 0.0f, fvb = 0.0f;
  if (k >= 0) {
    a = i + da[k];
    b = i + db[k];
    fva = va[k] > 0 ? 1.0f : 0.0f;
    fvb = vb[k] > 0 ? 1.0f : 0.0f;
  }
  const float fa = flat_value(bk, c, C, a, Tf);
  const float fb = flat_value(bk, c, C, b, Tf);
  const float pcm = __fadd_rn(__fmul_rn(fa, fva), __fmul_rn(fb, fvb));
  if (MODE == VP_OUT_F32) {
    ((float*)out)[t] = pcm;
    return;
  }
  const int32_t q = quantize_s16(pcm);
  if (MODE == VP_OUT_S16) {
    ((int16_t*)out)[t] = (int16_t)q;
  } else {
    const uint32_t u = (uint32_t)(q + 32768);
    ((uint8_t*)out)[t] = (uint8_t)(u & 0xFF);
    ((uint8_t*)out)[(int64_t)C * L + t] = (uint8_t)(u >> 8);
  }
}

// desc: host array of n_buckets rows (d, window, prime, final, base, n),
// each an int64 (pointers as addresses); mode: VP_OUT_F32 (out f32 [C, L]),
// VP_OUT_S16 (int16 [C, L]) or VP_OUT_S16P (u8 [2, C, L])
VP_API int vp_ola_assemble(const void* desc, const void* ev_j, const void* da,
                           const void* db, const void* va, const void* vb,
                           void* out, int64_t n_buckets, int64_t Ep,
                           int64_t L, int64_t C, int64_t Tf, int64_t mode,
                           void* stream) {
  if (n_buckets < 1 || n_buckets > VP_OLA_MAX_BUCKETS || mode < VP_OUT_F32 ||
      mode > VP_OUT_S16P)
    return (int)cudaErrorInvalidValue;
  OlaBuckets bk;
  const int64_t* rows = (const int64_t*)desc;
  bk.count = n_buckets;
  for (int64_t i = 0; i < n_buckets; ++i) {
    const int64_t* r = rows + 6 * i;
    bk.b[i].d = (const float*)r[0];
    bk.b[i].window = (const float*)r[1];
    bk.b[i].prime = (const uint8_t*)r[2];
    bk.b[i].fin = (const uint8_t*)r[3];
    bk.b[i].base = r[4];
    bk.b[i].n = r[5];
  }
  const int64_t n = C * L;
  if (n > 0) {
    const int threads = 256;
    const unsigned blocks = vp_blocks(n, threads);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* j = (const int32_t*)ev_j;
    const int64_t *a = (const int64_t*)da, *b = (const int64_t*)db;
    const int64_t *pa = (const int64_t*)va, *pb = (const int64_t*)vb;
    if (mode == VP_OUT_F32) {
      ola_assemble_kernel<VP_OUT_F32><<<blocks, threads, 0, s>>>(
          bk, j, a, b, pa, pb, out, Ep, L, (int)C, Tf);
    } else if (mode == VP_OUT_S16) {
      ola_assemble_kernel<VP_OUT_S16><<<blocks, threads, 0, s>>>(
          bk, j, a, b, pa, pb, out, Ep, L, (int)C, Tf);
    } else {
      ola_assemble_kernel<VP_OUT_S16P><<<blocks, threads, 0, s>>>(
          bk, j, a, b, pa, pb, out, Ep, L, (int)C, Tf);
    }
  }
  return (int)cudaGetLastError();
}
