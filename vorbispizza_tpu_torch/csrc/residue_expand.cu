// K1 residue_expand: a bucket's residue vectors from bit-packed VQ entry
// numbers, in one launch.
//
// Replaces vorbispizza_tpu/ops/residue_sym.py unpack_bits + expand_submap
// (29, 44; called per submap at models/pipeline.py:777): the XLA unpack,
// VQ row take, format-0 stride transpose, scatter-add into the
// [F*Pt*V, psize] region, region transpose, limit_begin pad, the residue-2
// de-interleave, and the placement of each submap at its channels.
//
// Bound: the [Fp, C, half] output's zeroing and atomics (4 bytes a covered
// column); the bit reads touch a few bytes a thread and the VQ tables sit
// in L1/L2. The work is proportional to the APPLIED partitions, as the
// reference's sparse scatter is. What stood in its way was launches, not
// bytes: the first design made one ctypes launch per (submap, pass, book)
// group, 13 a bucket of the corpus, each a small grid behind the host's
// Python and ctypes, plus a zeroed tensor per submap and a copy into the
// bucket. Now:
//
// - A descriptor table made on the host from the chunk's signature alone
//   (ops/residue_sym.bucket_table, cached per signature and sent to the
//   card once) holds one record per group: byte offsets of its symbol and
//   index streams in the chunk's u8 buffer, its offset in the bucket's
//   concatenated VQ buffer, its stream and submap geometry and its
//   submap's channel list. The buffer's base pointer is the only
//   per-chunk argument.
// - One grid covers the bucket. Every group starts on a block of its own,
//   so a block finds its group by a binary search of the groups' first
//   blocks (the same few addresses for every thread, served by L1). Each
//   thread takes one (applied partition, covered column), decodes its
//   partition's region row and its own symbol from the wire, reads one VQ
//   value and adds it straight into its channel's row of the bucket's
//   [Fp, C, half] residues, which the C entry zeroes once with a memset.
//
// Exactness: the f32 atomicAdd is order-free here only because every VQ
// value is an integer and every sum stays below 2^24 in magnitude -- the
// symbol-transport eligibility of native/symbols.py (integral lookup
// tables, |value| <= 2^20, at most 8 cascade passes add into one column).
// Sentinel rows (F*Pt*V, padding) are dropped; a code past `entries` reads
// NaN, as the reference's fill-mode take does.
#include "common.cuh"

// fields of a group record (int64), ops/residue_sym.K1_FIELDS
enum {
  R_SYM, R_IDX, R_VQ, R_W, R_D, R_NSYM, R_FMT1, R_ENTRIES, R_WI, R_NPPAD,
  R_PV, R_NROWS, R_V, R_PSIZE, R_LB, R_FMT2, R_NCH, R_CHOFF, VP_K1_REC
};

// desc (int64): first block of each group [n_groups + 1] | records
// [n_groups][VP_K1_REC] | channel lists. The host keeps a group's threads
// and region rows below 2^31 (bucket_table), so a thread's index arithmetic
// is 32-bit: a 64-bit division costs several times a 32-bit one, and this
// kernel does five a thread.
__global__ void residue_expand_kernel(const uint8_t* __restrict__ wire,
                                      const int64_t* __restrict__ desc,
                                      const float* __restrict__ vq,
                                      float* __restrict__ out, int n_groups,
                                      int C, int half) {
  __shared__ int64_t rec[VP_K1_REC];
  const int64_t b = blockIdx.x;
  int lo = 0, hi = n_groups - 1;  // the last group whose first block <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (desc[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const int64_t* r = desc + (n_groups + 1) + (int64_t)lo * VP_K1_REC;
  if (threadIdx.x < VP_K1_REC) rec[threadIdx.x] = r[threadIdx.x];
  __syncthreads();
  const unsigned d = (unsigned)rec[R_D];
  const unsigned nsym = (unsigned)rec[R_NSYM];
  const unsigned cov = nsym * d;
  const unsigned t = (unsigned)(b - desc[lo]) * blockDim.x + threadIdx.x;
  const unsigned p = t / cov;
  if (p >= (unsigned)rec[R_NPPAD]) return;
  const unsigned col = t - p * cov;
  const int w_i = (int)rec[R_WI];
  const unsigned row = vp_read_bits(wire + rec[R_IDX], (int64_t)p * w_i, w_i);
  if (row >= (unsigned)rec[R_NROWS]) return;  // sentinel F*PV (padding)
  // format 1: symbol k covers columns [k*d, k*d+d); format 0: symbol k
  // covers the strided columns k, k+nsym, ...
  const unsigned k = rec[R_FMT1] ? col / d : col % nsym;
  const unsigned e = rec[R_FMT1] ? col % d : col / nsym;
  const int w = (int)rec[R_W];
  const unsigned s =
      vp_read_bits(wire + rec[R_SYM], ((int64_t)p * nsym + k) * w, w);
  // entries is the zero-row sentinel; a larger code is not a valid wire
  const float v = s <= (unsigned)rec[R_ENTRIES]
                      ? vq[rec[R_VQ] + (int64_t)s * d + e]
                      : __int_as_float(0x7fc00000);
  // region row = f*PV + pt*V + vrow; column pt*psize + col of vector vrow,
  // shifted by limit_begin into the [vec_len] residue vector
  const unsigned PV = (unsigned)rec[R_PV];
  const unsigned V = (unsigned)rec[R_V];
  const unsigned f = row / PV;
  const unsigned pv = row - f * PV;
  const unsigned pt = pv / V;
  const unsigned vrow = pv - pt * V;
  const unsigned q = (unsigned)rec[R_LB] + pt * (unsigned)rec[R_PSIZE] + col;
  const int64_t* chans = desc + (n_groups + 1) +
                         (int64_t)n_groups * VP_K1_REC + rec[R_CHOFF];
  int64_t ch;
  unsigned pos;
  if (rec[R_FMT2]) {
    // residue 2: one interleaved vector, q = k*n_ch + c -> channel c, bin k
    const unsigned n_ch = (unsigned)rec[R_NCH];
    ch = chans[q % n_ch];
    pos = q / n_ch;
  } else {
    ch = chans[vrow];
    pos = q;
  }
  atomicAdd(out + ((int64_t)f * C + ch) * half + pos, v);
}

// out: f32 [Fp, C, half], zeroed here, then filled by n_blocks blocks of
// `threads` threads (the block size the table's first blocks assume).
VP_API int vp_residue_expand(const void* wire, const void* desc,
                             const void* vq, void* out, int64_t n_groups,
                             int64_t n_blocks, int64_t threads, int64_t C,
                             int64_t half, int64_t out_numel, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)out_numel * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks > 0) {
    residue_expand_kernel<<<(unsigned)n_blocks, (unsigned)threads, 0, st>>>(
        (const uint8_t*)wire, (const int64_t*)desc, (const float*)vq,
        (float*)out, (int)n_groups, (int)C, (int)half);
  }
  return (int)cudaGetLastError();
}
