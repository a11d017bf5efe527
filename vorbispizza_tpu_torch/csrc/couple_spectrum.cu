// K3 couple_spectrum: square-polar coupling inverse times the floor.
//
// Replaces vorbispizza_tpu/ops/coupling.py inverse_couple_batch (one XLA
// select pass per coupling step over the whole [F, C, half] batch) and the
// residue * floor product of models/pipeline.py _synth_math. One thread
// per (frame, bin): it copies its C residues into the output, applies the
// coupling steps in reverse declaration order (spec 4.3.4 step 2; the
// steps are a small device array, so the channel index is dynamic), then
// multiplies each channel by its floor. The output [F, C, half] is the
// [F*C, half] operand of the DCT-IV product.
//
// Bound: memory -- 12 bytes a value (residue and floor read, spectrum
// written); neighbouring threads take neighbouring bins, so every access is
// coalesced. The steps touch only the thread's own output column, so the
// coupling runs in place without scratch.
#include "common.cuh"

__global__ void couple_spectrum_kernel(const float* __restrict__ res,
                                       const float* __restrict__ floors,
                                       const int32_t* __restrict__ steps,
                                       float* __restrict__ out, int64_t F,
                                       int C, int half, int n_steps) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= F * half) return;
  const int64_t f = t / half;
  const int64_t x = t - f * half;
  const int64_t base = f * C * half + x;
  for (int c = 0; c < C; ++c) out[base + (int64_t)c * half] = res[base + (int64_t)c * half];
  for (int s = n_steps - 1; s >= 0; --s) {
    float* pm = out + base + (int64_t)steps[2 * s] * half;
    float* pa = out + base + (int64_t)steps[2 * s + 1] * half;
    const float mag = *pm, ang = *pa;
    float new_m, new_a;
    if (ang > 0.0f) {
      new_m = mag;
      new_a = mag > 0.0f ? __fsub_rn(mag, ang) : __fadd_rn(mag, ang);
    } else {
      new_m = mag > 0.0f ? __fadd_rn(mag, ang) : __fsub_rn(mag, ang);
      new_a = mag;
    }
    *pm = new_m;
    *pa = new_a;
  }
  for (int c = 0; c < C; ++c) {
    const int64_t o = base + (int64_t)c * half;
    out[o] = __fmul_rn(out[o], floors[o]);
  }
}

VP_API int vp_couple_spectrum(const void* res, const void* floors,
                              const void* steps, void* out, int64_t F,
                              int64_t C, int64_t half, int64_t n_steps,
                              void* stream) {
  const int64_t n = F * half;
  if (n > 0) {
    const int threads = 256;
    couple_spectrum_kernel<<<vp_blocks(n, threads), threads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)res, (const float*)floors, (const int32_t*)steps,
        (float*)out, F, (int)C, (int)half, (int)n_steps);
  }
  return (int)cudaGetLastError();
}
