// K8 floor0_synth: floor0 (LSP) curves.
//
// Replaces vorbispizza_tpu/ops/floor.py floor0_curves (201-247): an XLA
// program that unrolls the static-order LSP product into `order` broadcast
// multiplies over the whole [G, half] batch, then takes the square root,
// the amplitude exponent and exp. Here one block takes one (frame, channel)
// row: its threads put cosf of the row's `order` coefficients into shared
// memory (order <= 255), then each thread walks bins, keeping p and q in
// registers.
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
// So the kernel repeats its plain PyTorch twin (ops/floor.py
// floor0_curves_plain) operation for operation.
//
// Bound: memory -- the [rows, half] float32 write (4 bytes a bin) against
// about 4*order+8 float operations a bin; for the orders of real floor0
// files (up to ~30) the card's float32 rate is not reached before its
// memory rate. cos_w and the tails ([3, half], a few KB) stay in L1/L2.
#include "common.cuh"

#define VP_FLOOR0_MAX_ORDER 255

__global__ void floor0_synth_kernel(const float* __restrict__ coeffs,
                                    const int32_t* __restrict__ amplitude,
                                    const uint8_t* __restrict__ used,
                                    const float* __restrict__ cos_w,
                                    const float* __restrict__ tail,
                                    float* __restrict__ out, int order,
                                    int half, float amp_max, float offset) {
  __shared__ float cos_c[VP_FLOOR0_MAX_ORDER];
  const int64_t g = blockIdx.x;
  float* row = out + g * half;
  if (used[g] == 0) {
    for (int x = threadIdx.x; x < half; x += blockDim.x) row[x] = 0.0f;
    return;
  }
  for (int j = threadIdx.x; j < order; j += blockDim.x)
    cos_c[j] = cosf(coeffs[g * order + j]);
  __syncthreads();
  const float amp = (float)amplitude[g];
  const float num = __fmul_rn(amp, offset);
  for (int x = threadIdx.x; x < half; x += blockDim.x) {
    const float cw = cos_w[x];
    float p = 1.0f, q = 1.0f;
    for (int j = 0; j < order; ++j) {
      const float d = __fsub_rn(cos_c[j], cw);
      const float t = __fmul_rn(4.0f, __fmul_rn(d, d));
      if (j & 1)
        p = __fmul_rn(p, t);
      else
        q = __fmul_rn(q, t);
    }
    p = __fmul_rn(p, tail[x]);
    q = __fmul_rn(q, tail[half + x]);
    float denom = sqrtf(__fadd_rn(p, q));
    if (denom == 0.0f) denom = 1e-9f;
    const float e = __fmul_rn(
        0.11512925f,
        __fsub_rn(__fdiv_rn(num, __fmul_rn(amp_max, denom)), offset));
    // min(e, 80) that keeps a NaN, as jnp.minimum and torch.minimum do
    row[x] = expf(e > 80.0f ? 80.0f : e);
  }
}

VP_API int vp_floor0_synth(const void* coeffs, const void* amplitude,
                           const void* used, const void* cos_w,
                           const void* tail, void* out, int64_t G,
                           int64_t order, int64_t half, double amp_max,
                           double offset, void* stream) {
  if (order < 1 || order > VP_FLOOR0_MAX_ORDER)
    return (int)cudaErrorInvalidValue;
  if (G > 0) {
    floor0_synth_kernel<<<(unsigned)G, 128, 0, (cudaStream_t)stream>>>(
        (const float*)coeffs, (const int32_t*)amplitude,
        (const uint8_t*)used, (const float*)cos_w, (const float*)tail,
        (float*)out, (int)order, (int)half, (float)amp_max, (float)offset);
  }
  return (int)cudaGetLastError();
}
