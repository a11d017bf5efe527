// K3 couple_spectrum: square-polar coupling inverse times the floor, every
// bucket of a chunk in one launch.
//
// Replaces vorbispizza_tpu/ops/coupling.py inverse_couple_batch (one XLA
// select pass per coupling step over the whole [F, C, half] batch) and the
// residue * floor product of models/pipeline.py _synth_math. For each bin
// of each frame: the C residues, the coupling steps in reverse declaration
// order (spec 4.3.4 step 2), then each channel times its floor. Each
// bucket's output [F, C, half] is the [F*C, half] operand of its DCT-IV
// product.
//
// Bound: memory -- 12 bytes a value (residue and floor read, spectrum
// written once).
//
// Design:
// - One launch a chunk. The wrapper's descriptor (res, floors, steps, out,
//   F, half, steps a bucket) goes by value; the C entry gives each bucket
//   its first tile of VP_CS_THREADS threads, and a CTA finds its bucket by
//   a walk over those first tiles (uniform across the CTA).
// - A thread takes 4 consecutive bins of one frame and every channel:
//   float4 loads of each channel's residue and floor, float4 stores. The
//   frame and the bin come from a shift and a mask (half is a power of
//   two); all index math is 32-bit (the host refuses F*C*half from 2^31).
// - Up to 8 channels the values stay in registers: a fully unrolled loop
//   over the channel bound with selects picks a step's two channels (a
//   dynamic index into a register array would spill to local memory). Past
//   8 channels the steps run in place in the thread's own columns of out.
// - Bit-exactness: the same __fadd_rn/__fsub_rn selects and __fmul_rn as
//   the reference's order; a step whose two channels coincide keeps the
//   angle's value, as the twin's second write does.
#include "common.cuh"

#define VP_CS_MAX_BUCKETS 64
#define VP_CS_MAX_C 255  // channels (the Vorbis limit)
#define VP_CS_THREADS 256

struct CsBucket {
  const float4* res;     // [F, C, half] as float4
  const float4* floors;  // [F, C, half]
  const int32_t* steps;  // [n_steps, 2] (mag, ang)
  float4* out;           // [F, C, half]
  int32_t first;         // first tile (CTA) of the bucket
  int32_t items;         // F * half / 4 threads
  int32_t lg;            // log2(half / 4)
  int32_t n_steps;
};

struct CsChunk {
  int32_t count;
  int32_t C;
  CsBucket b[VP_CS_MAX_BUCKETS];
};

__device__ __forceinline__ void vp_couple(float mag, float ang, float& nm,
                                          float& na) {
  if (ang > 0.0f) {
    nm = mag;
    na = mag > 0.0f ? __fsub_rn(mag, ang) : __fadd_rn(mag, ang);
  } else {
    nm = mag > 0.0f ? __fadd_rn(mag, ang) : __fsub_rn(mag, ang);
    na = mag;
  }
}

__device__ __forceinline__ void vp_couple4(const float4 m, const float4 a,
                                           float4& nm, float4& na) {
  vp_couple(m.x, a.x, nm.x, na.x);
  vp_couple(m.y, a.y, nm.y, na.y);
  vp_couple(m.z, a.z, nm.z, na.z);
  vp_couple(m.w, a.w, nm.w, na.w);
}

__device__ __forceinline__ float4 vp_mul4(const float4 a, const float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

// MAXC > 0: channels in registers (C <= MAXC); MAXC == 0: in place in out
template <int MAXC>
__global__ void __launch_bounds__(VP_CS_THREADS)
    couple_spectrum_kernel(const __grid_constant__ CsChunk ch) {
  int k = 0;
  while (k + 1 < ch.count && (int)blockIdx.x >= ch.b[k + 1].first) ++k;
  const CsBucket& bk = ch.b[k];
  const int t = ((int)blockIdx.x - bk.first) * VP_CS_THREADS + threadIdx.x;
  if (t >= bk.items) return;
  const int C = ch.C;
  const int q4 = 1 << bk.lg;  // float4s a (frame, channel) row
  const int base = (t >> bk.lg) * C * q4 + (t & (q4 - 1));
  if (MAXC > 0) {
    float4 v[MAXC > 0 ? MAXC : 1], fl[MAXC > 0 ? MAXC : 1];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      v[c] = fl[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c < C) {
        v[c] = __ldg(bk.res + base + c * q4);
        fl[c] = __ldg(bk.floors + base + c * q4);
      }
    }
    for (int s = bk.n_steps - 1; s >= 0; --s) {
      const int m = __ldg(bk.steps + 2 * s), a = __ldg(bk.steps + 2 * s + 1);
      float4 mag = v[0], ang = v[0];
#pragma unroll
      for (int c = 1; c < MAXC; ++c) {
        if (c == m) mag = v[c];
        if (c == a) ang = v[c];
      }
      float4 nm, na;
      vp_couple4(mag, ang, nm, na);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c == m) v[c] = nm;
        if (c == a) v[c] = na;
      }
    }
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) bk.out[base + c * q4] = vp_mul4(v[c], fl[c]);
    }
  } else {
    for (int c = 0; c < C; ++c) {
      bk.out[base + c * q4] = __ldg(bk.res + base + c * q4);
    }
    for (int s = bk.n_steps - 1; s >= 0; --s) {
      float4* pm = bk.out + base + __ldg(bk.steps + 2 * s) * q4;
      float4* pa = bk.out + base + __ldg(bk.steps + 2 * s + 1) * q4;
      float4 nm, na;
      vp_couple4(*pm, *pa, nm, na);
      *pm = nm;
      *pa = na;
    }
    for (int c = 0; c < C; ++c) {
      float4* o = bk.out + base + c * q4;
      *o = vp_mul4(*o, __ldg(bk.floors + base + c * q4));
    }
  }
}

// desc: host array of n_buckets rows (res, floors, steps, out, F, half,
// n_steps), each an int64 (pointers as addresses; res, floors and out
// 16-byte aligned, float32 [F, C, half], half a power of two >= 4).
VP_API int vp_couple_spectrum(const void* desc, int64_t n_buckets, int64_t C,
                              void* stream) {
  const int64_t lim = (int64_t)1 << 31;
  if (n_buckets < 1 || n_buckets > VP_CS_MAX_BUCKETS || C < 1 ||
      C > VP_CS_MAX_C)
    return (int)cudaErrorInvalidValue;
  CsChunk ch;
  ch.count = (int32_t)n_buckets;
  ch.C = (int32_t)C;
  const int64_t* rows = (const int64_t*)desc;
  int64_t tiles = 0;
  for (int64_t i = 0; i < n_buckets; ++i) {
    const int64_t* r = rows + 7 * i;
    const int64_t F = r[4], half = r[5], n_steps = r[6];
    if (((r[0] | r[1] | r[3]) & 15) != 0 || F < 0 || half < 4 ||
        (half & (half - 1)) != 0 || F * C * half >= lim || n_steps < 0)
      return (int)cudaErrorInvalidValue;
    const int64_t items = F * (half / 4);
    CsBucket& b = ch.b[i];
    b.res = (const float4*)r[0];
    b.floors = (const float4*)r[1];
    b.steps = (const int32_t*)r[2];
    b.out = (float4*)r[3];
    b.first = (int32_t)tiles;
    b.items = (int32_t)items;
    b.lg = __builtin_ctzll((unsigned long long)(half / 4));
    b.n_steps = (int32_t)n_steps;
    tiles += (items + VP_CS_THREADS - 1) / VP_CS_THREADS;
  }
  if (tiles == 0) return (int)cudaGetLastError();
  if (tiles >= lim) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)tiles;
  if (C == 1) {
    couple_spectrum_kernel<1><<<grid, VP_CS_THREADS, 0, s>>>(ch);
  } else if (C == 2) {
    couple_spectrum_kernel<2><<<grid, VP_CS_THREADS, 0, s>>>(ch);
  } else if (C <= 4) {
    couple_spectrum_kernel<4><<<grid, VP_CS_THREADS, 0, s>>>(ch);
  } else if (C <= 8) {
    couple_spectrum_kernel<8><<<grid, VP_CS_THREADS, 0, s>>>(ch);
  } else {
    couple_spectrum_kernel<0><<<grid, VP_CS_THREADS, 0, s>>>(ch);
  }
  return (int)cudaGetLastError();
}
