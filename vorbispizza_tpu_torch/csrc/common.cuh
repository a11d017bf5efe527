// Shared declarations of the port's hand-written Hopper kernels.
//
// Every entry point is a plain C function (bound from Python with ctypes):
// it launches one kernel on the stream it is given, allocates nothing, and
// returns cudaGetLastError() after the launch so a refused launch is seen.
// The library is built with -fmad=false and the arithmetic spells its
// products and sums with the _rn intrinsics, so nothing is contracted into a
// fused multiply-add: each kernel is bit-identical to its PyTorch twin.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define VP_API extern "C" __attribute__((visibility("default")))

// LSB-first fixed-width field at bit position `pos` of a packed u8 stream
// (the host packs with np.packbits(..., bitorder="little")); 1 <= w <= 32.
// Reads only the bytes the field touches, so a field at the very end of a
// buffer never reads past it.
__device__ __forceinline__ uint32_t vp_read_bits(const uint8_t* buf,
                                                 int64_t pos, int w) {
  const int64_t b0 = pos >> 3;
  const int sh = (int)(pos & 7);
  const int nb = (sh + w + 7) >> 3;
  uint64_t acc = 0;
  for (int i = 0; i < nb; ++i) acc |= (uint64_t)buf[b0 + i] << (8 * i);
  return (uint32_t)((acc >> sh) & ((1ull << w) - 1));
}

__host__ __forceinline__ unsigned vp_blocks(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}
