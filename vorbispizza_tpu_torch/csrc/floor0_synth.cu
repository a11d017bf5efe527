// K8 floor0_synth: floor0 (LSP) curves.
//
// Replaces vorbispizza_tpu/ops/floor.py floor0_curves (201-247): an XLA
// program that unrolls the static-order LSP product into `order` broadcast
// multiplies over the whole [G, half] batch, then takes the square root,
// the amplitude exponent and exp.
//
// A warp takes one (frame, channel) row, 8 rows a CTA, and walks it in
// steps of 128 bins, 4 consecutive bins a lane: float4 loads of cos_w and
// of the two tails, a float4 store of the curve. Lanes j < order take the
// precise cosf of the row's coefficients, 32 at a time, into the warp's
// slab of shared memory (behind a __syncwarp, no barrier of the CTA); every
// lane then reads them 4 at a time as float4 broadcasts (one shared load
// for 4 coefficients, where __shfl_sync from lane j took one a
// coefficient and ran slower). A row with used == 0 is written as float4
// zeros.
//
// The arithmetic follows the reference step by step, in its order, each
// product and sum rounded on its own (the _rn intrinsics; the library is
// built with -fmad=false), with the precise cosf, sqrtf and expf:
//   t = 4*(cos_c[j]-cos_w)^2, odd j into p and even j into q, j ascending;
//   the tail factors (odd order: 1-cos_w^2 and 0.25; even: (1-cos_w)/2 and
//   (1+cos_w)/2, made on the host in float32 from the float64-made cos_w);
//   denom = sqrt(p+q), a zero replaced by 1e-9;
//   0.11512925*(amp*offset/(amp_max*denom) - offset); exp(min(x, 80));
//   the used mask.
// A lane's 4 bins are 4 independent chains, each in that order. So the
// kernel repeats its plain PyTorch twin (ops/floor.py floor0_curves_plain)
// operation for operation.
//
// Bound: memory -- the [rows, half] float32 write (4 bytes a bin) against
// about 4*order+8 float operations a bin; for the orders of real floor0
// files (up to ~30) the card's float32 rate is not reached before its
// memory rate, but the precise sqrt, division and exp cost some 40 more
// instructions a bin, so the kernel is held back by the instructions it
// issues, not by its bytes. The tables ([3, half], a few KB) stay in
// L1/L2.
#include "common.cuh"

#define VP_FLOOR0_MAX_ORDER 255
#define VP_FLOOR0_WARPS 8  // rows a CTA, a warp a row

// bin k's curve value from its chain's products p and q
__device__ __forceinline__ float floor0_value(float p, float q, float tp,
                                              float tq, float num,
                                              float amp_max, float offset) {
  p = __fmul_rn(p, tp);
  q = __fmul_rn(q, tq);
  float denom = sqrtf(__fadd_rn(p, q));
  if (denom == 0.0f) denom = 1e-9f;
  const float e = __fmul_rn(
      0.11512925f,
      __fsub_rn(__fdiv_rn(num, __fmul_rn(amp_max, denom)), offset));
  // min(e, 80) that keeps a NaN, as jnp.minimum and torch.minimum do
  return expf(e > 80.0f ? 80.0f : e);
}

// p and q of 4 bins times t = 4*(cj - cos_w)^2, into p (odd) or q (even)
__device__ __forceinline__ void floor0_step(float cj, const float w[4],
                                            float acc[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float d = __fsub_rn(cj, w[k]);
    acc[k] = __fmul_rn(acc[k], __fmul_rn(4.0f, __fmul_rn(d, d)));
  }
}

// tab: [3, half] float32 (cos_w, then the tails of p and of q); half % 4 ==
// 0, tab and out 16-byte aligned
__global__ void __launch_bounds__(VP_FLOOR0_WARPS * 32)
    floor0_synth_kernel(const float* __restrict__ coeffs,
                        const int32_t* __restrict__ amplitude,
                        const uint8_t* __restrict__ used,
                        const float* __restrict__ tab,
                        float* __restrict__ out, int64_t G, int order,
                        int half, float amp_max, float offset) {
  __shared__ __align__(16) float s_cos[VP_FLOOR0_WARPS]
                                      [VP_FLOOR0_MAX_ORDER + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t g = (int64_t)blockIdx.x * VP_FLOOR0_WARPS + warp;
  if (g >= G) return;
  const int nq = half >> 2;  // float4s a row
  float4* row = (float4*)(out + g * half);
  if (used[g] == 0) {
    for (int x = lane; x < nq; x += 32) {
      row[x] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const float* cg = coeffs + g * order;
  float* slab = s_cos[warp];
  for (int j = lane; j < order; j += 32) slab[j] = cosf(cg[j]);
  __syncwarp();
  const float num = __fmul_rn((float)amplitude[g], offset);
  const float4* cw4 = (const float4*)tab;
  const float4* tp4 = (const float4*)(tab + half);
  const float4* tq4 = (const float4*)(tab + 2 * (int64_t)half);
  for (int x = lane; x < nq; x += 32) {
    const float4 cw = cw4[x];
    const float w[4] = {cw.x, cw.y, cw.z, cw.w};
    float p[4] = {1.0f, 1.0f, 1.0f, 1.0f}, q[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    int j = 0;
    for (; j + 3 < order; j += 4) {  // even j into q, odd j into p
      const float4 c4 = *(const float4*)(slab + j);
      floor0_step(c4.x, w, q);
      floor0_step(c4.y, w, p);
      floor0_step(c4.z, w, q);
      floor0_step(c4.w, w, p);
    }
    for (; j < order; ++j) {
      if (j & 1) {
        floor0_step(slab[j], w, p);
      } else {
        floor0_step(slab[j], w, q);
      }
    }
    const float4 tp = tp4[x], tq = tq4[x];
    row[x] = make_float4(
        floor0_value(p[0], q[0], tp.x, tq.x, num, amp_max, offset),
        floor0_value(p[1], q[1], tp.y, tq.y, num, amp_max, offset),
        floor0_value(p[2], q[2], tp.z, tq.z, num, amp_max, offset),
        floor0_value(p[3], q[3], tp.w, tq.w, num, amp_max, offset));
  }
}

VP_API int vp_floor0_synth(const void* coeffs, const void* amplitude,
                           const void* used, const void* tab, void* out,
                           int64_t G, int64_t order, int64_t half,
                           double amp_max, double offset, void* stream) {
  if (order < 1 || order > VP_FLOOR0_MAX_ORDER || G < 0 || half < 0 ||
      half % 4 != 0 || half >= ((int64_t)1 << 30) ||
      ((uintptr_t)tab & 15) != 0 || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t ctas = (G + VP_FLOOR0_WARPS - 1) / VP_FLOOR0_WARPS;
  if (ctas > 0) {
    floor0_synth_kernel<<<(unsigned)ctas, VP_FLOOR0_WARPS * 32, 0,
                          (cudaStream_t)stream>>>(
        (const float*)coeffs, (const int32_t*)amplitude,
        (const uint8_t*)used, (const float*)tab, (float*)out, G, (int)order,
        (int)half, (float)amp_max, (float)offset);
  }
  return (int)cudaGetLastError();
}
