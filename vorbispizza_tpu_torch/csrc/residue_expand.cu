// K1 residue_expand: residue vectors from bit-packed VQ entry numbers.
//
// Replaces vorbispizza_tpu/ops/residue_sym.py unpack_bits + expand_submap
// (the XLA unpack, VQ row take, format-0 stride transpose, scatter-add into
// the [F*Pt*V, psize] region, region transpose, limit_begin pad and the
// residue-2 de-interleave). One launch per (submap, pass, book) group; one
// thread per (applied partition, covered column). The thread decodes its
// partition's region row and its own symbol from the u8 wire, reads one
// VQ value and maps (region row, column) straight to its final address in
// the zeroed [F, n_ch, half] output, so no region or vector tensor exists.
//
// Bound: the output's zeroing and atomics (4 bytes a covered column); the
// bit reads touch a few bytes per thread and the VQ tables sit in L1/L2.
// The work is proportional to the APPLIED partitions, as the reference's
// sparse scatter is.
//
// Exactness: the f32 atomicAdd is order-free here only because every VQ
// value is an integer and every sum stays below 2^24 in magnitude -- the
// symbol-transport eligibility of native/symbols.py (integral lookup
// tables, |value| <= 2^20, at most 8 cascade passes add into one column).
#include "common.cuh"

__global__ void residue_expand_kernel(
    const uint8_t* __restrict__ syms, const uint8_t* __restrict__ idx,
    const float* __restrict__ vq, float* __restrict__ out, int64_t n_part,
    int w, int d, int nsym, int fmt1, int64_t entries, int w_i, int64_t PV,
    int64_t n_rows, int V, int psize, int64_t limit_begin, int n_ch,
    int half, int fmt2) {
  const int64_t cov = (int64_t)nsym * d;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_part * cov) return;
  const int64_t p = t / cov;
  const int col = (int)(t - p * cov);
  const int64_t row = vp_read_bits(idx, p * w_i, w_i);
  if (row >= n_rows) return;  // sentinel F*PV (padding partition): dropped
  // format 1: symbol k covers columns [k*d, k*d+d); format 0: symbol k
  // covers the strided columns k, k+nsym, ...
  const int k = fmt1 ? col / d : col % nsym;
  const int e = fmt1 ? col % d : col / nsym;
  const int64_t s = vp_read_bits(syms, (p * nsym + k) * (int64_t)w, w);
  // entries is the zero-row sentinel; a larger code is not a valid wire
  // (the reference's fill-mode take reads NaN there)
  const float v = s <= entries ? vq[s * d + e] : __int_as_float(0x7fc00000);
  // region row = f*PV + pt*V + vrow; column pt*psize + col of vector vrow,
  // shifted by limit_begin into the [vec_len] residue vector
  const int64_t f = row / PV;
  const int64_t pv = row - f * PV;
  const int64_t pt = pv / V;
  const int64_t vrow = pv - pt * V;
  const int64_t q = limit_begin + pt * psize + col;
  int64_t dst;
  if (fmt2) {
    // residue 2: one interleaved vector, q = k*n_ch + c -> out[f, c, k]
    dst = (f * n_ch + q % n_ch) * half + q / n_ch;
  } else {
    dst = (f * n_ch + vrow) * half + q;
  }
  atomicAdd(out + dst, v);
}

VP_API int vp_residue_expand(const void* syms, const void* idx,
                             const void* vq, void* out, int64_t n_part,
                             int64_t w, int64_t d, int64_t nsym, int64_t fmt1,
                             int64_t entries, int64_t w_i, int64_t PV,
                             int64_t n_rows, int64_t V, int64_t psize,
                             int64_t limit_begin, int64_t n_ch, int64_t half,
                             int64_t fmt2, void* stream) {
  const int64_t n = n_part * nsym * d;
  if (n > 0) {
    const int threads = 256;
    residue_expand_kernel<<<vp_blocks(n, threads), threads, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)syms, (const uint8_t*)idx, (const float*)vq,
        (float*)out, n_part, (int)w, (int)d, (int)nsym, (int)fmt1, entries,
        (int)w_i, PV, n_rows, (int)V, (int)psize, limit_begin, (int)n_ch,
        (int)half, (int)fmt2);
  }
  return (int)cudaGetLastError();
}
