// K9 residue_gather: residue vectors from the value-transport wire.
//
// Replaces the value-transport branch of vorbispizza_tpu/models/pipeline.py
// _fused_body (789-804): jnp.take of packed nonzero 32-value rows by a row
// map, with the u16 map bit-cast out of the i16 buffer and the u8 rows
// un-biased by 128, then reshaped to [Fp, C, half] float32.
//
//   out[r, :] = float(packed[gmap[r], :]) (- 128 for u8 rows)
//
// packed is [Kp, 32] of u8 (biased by 128; row 0 is the biased zero row),
// int16 or float32; gmap is [rows] of uint16 (read bit for bit out of the
// i16 buffer, never sign-extended) or int32. The host writes map entries
// in [0, Kp) only; an entry outside it gives a row of zeros, never a read
// past the buffer.
//
// One thread per 4 outputs: 8 threads a row, one 16-byte store each, so a
// warp writes four whole rows (512 contiguous bytes). The wire slots start
// at any element offset of their typed buffer, so the reads are scalar;
// neighbouring threads read neighbouring elements of one row.
//
// Bound: memory -- the [rows, 32] float32 write (4 bytes a value) plus the
// map and the distinct packed rows it names; no arithmetic beyond a cast.
#include "common.cuh"

#define VP_PACK_GRAN 32

template <typename P, typename M>
__global__ void residue_gather_kernel(const P* __restrict__ packed,
                                      const M* __restrict__ gmap,
                                      float4* __restrict__ out, int64_t rows,
                                      int64_t Kp, float bias) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * (VP_PACK_GRAN / 4)) return;
  const int64_t r = t >> 3;
  const int c = (int)(t & 7) * 4;
  const int64_t k = (int64_t)gmap[r];
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (k >= 0 && k < Kp) {
    const P* src = packed + k * VP_PACK_GRAN + c;
    v = make_float4(__fsub_rn((float)src[0], bias),
                    __fsub_rn((float)src[1], bias),
                    __fsub_rn((float)src[2], bias),
                    __fsub_rn((float)src[3], bias));
  }
  out[t] = v;
}

template <typename P>
static void launch_p(const void* packed, const void* gmap, int gtag,
                     void* out, int64_t rows, int64_t Kp, float bias,
                     cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = vp_blocks(rows * (VP_PACK_GRAN / 4), threads);
  if (gtag == 0)
    residue_gather_kernel<P, uint16_t><<<blocks, threads, 0, stream>>>(
        (const P*)packed, (const uint16_t*)gmap, (float4*)out, rows, Kp,
        bias);
  else
    residue_gather_kernel<P, int32_t><<<blocks, threads, 0, stream>>>(
        (const P*)packed, (const int32_t*)gmap, (float4*)out, rows, Kp,
        bias);
}

// ptag: 0 u8 (biased by 128), 1 int16, 2 float32; gtag: 0 uint16, 1 int32.
// out: float32 [rows, 32], 16-byte aligned.
VP_API int vp_residue_gather(const void* packed, const void* gmap, void* out,
                             int64_t rows, int64_t Kp, int64_t ptag,
                             int64_t gtag, void* stream) {
  if (ptag < 0 || ptag > 2 || gtag < 0 || gtag > 1 ||
      ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (ptag == 0)
      launch_p<uint8_t>(packed, gmap, (int)gtag, out, rows, Kp, 128.0f, s);
    else if (ptag == 1)
      launch_p<int16_t>(packed, gmap, (int)gtag, out, rows, Kp, 0.0f, s);
    else
      launch_p<float>(packed, gmap, (int)gtag, out, rows, Kp, 0.0f, s);
  }
  return (int)cudaGetLastError();
}
