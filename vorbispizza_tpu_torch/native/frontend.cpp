// Native entropy front end: per-packet Vorbis floor/residue decode.
//
// Exact behavioral mirror of the Python host path (bitstream.py,
// setup/codebook.py decode_scalar, setup/floor.py unpack/unwrap,
// setup/residue.py decode, setup/mapping.py decode_packet_raw) — the
// counterpart of the reference's SIMD-accelerated managed hot loops
// (NVorbis/Codebook.cs:300, Huffman.cs:24, Floor1.cs:162, Residue0.cs:117).
// Packets are independent after header parse, so decode fans out across
// threads; outputs land in caller-allocated dense tensors ready for the
// TPU synthesis pipeline.
//
// Setup config arrives as one flat binary blob (native/serialize.py writes
// it, _parse_setup below reads it; all fields little-endian, arrays 4-byte
// aligned).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread (native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <thread>
#include <type_traits>
#include <vector>

namespace {

// ---------------------------------------------------------------- bit reader

struct BitReader {
    const uint8_t* data;
    int64_t nbits;
    int64_t pos = 0;
    bool overrun = false;

    BitReader(const uint8_t* d, int64_t len) : data(d), nbits(8 * len) {}

    uint64_t peek(int count) const {
        if (count <= 0) return 0;
        int64_t byte_pos = pos >> 3;
        int bit_off = (int)(pos & 7);
        int64_t total_bytes = nbits >> 3;
        uint64_t v = 0;
        if (byte_pos + 8 <= total_bytes) {
            std::memcpy(&v, data + byte_pos, 8);  // little-endian host
            v >>= bit_off;
            if (count + bit_off > 64 && bit_off > 0 &&
                byte_pos + 8 < total_bytes) {
                uint64_t hi = data[byte_pos + 8];
                v |= hi << (64 - bit_off);
            }
        } else {
            // near the end: gather what remains, zero-extend (bitstream.py
            // semantics — past-end bits read as 0)
            int64_t take = total_bytes - byte_pos;
            if (take < 0) take = 0;
            if (take > 0) std::memcpy(&v, data + byte_pos, (size_t)take);
            v >>= bit_off;
        }
        if (count >= 64) return v;
        return v & ((1ull << count) - 1);
    }

    uint64_t read(int count) {
        uint64_t v = peek(count);
        pos += count;
        if (pos > nbits) { pos = nbits; overrun = true; }
        return v;
    }

    void skip(int count) {
        pos += count;
        if (pos > nbits) { pos = nbits; overrun = true; }
    }

    int64_t remaining() const { return nbits - pos; }
};

// ---------------------------------------------------------------- setup view

constexpr int PREFIX_BITS = 10;
constexpr int PREFIX_SIZE = 1 << PREFIX_BITS;

struct CodebookV {
    uint32_t dims, entries, max_len, has_lookup;
    const int32_t* prefix_sym;   // [1024]
    const int32_t* prefix_len;   // [1024]
    uint32_t n_overflow;
    const uint32_t* ov;          // [n_overflow*3]: len, bits, sym (sorted by len)
    const float* lookup;         // [entries*dims] or null

    // mirror of Codebook.decode_scalar (setup/codebook.py:193)
    int decode_scalar(BitReader& br) const {
        uint64_t v = br.peek(max_len < (uint32_t)PREFIX_BITS ? (int)max_len
                                                             : PREFIX_BITS);
        int32_t sym = prefix_sym[v & (PREFIX_SIZE - 1)];
        if (sym >= 0) {
            int32_t l = prefix_len[v & (PREFIX_SIZE - 1)];
            if (l > br.remaining()) { br.skip(l); return -1; }
            br.skip(l);
            return sym;
        }
        if (max_len > (uint32_t)PREFIX_BITS) {
            uint64_t w = br.peek((int)max_len);
            for (uint32_t i = 0; i < n_overflow; i++) {
                uint32_t l = ov[3 * i], bits = ov[3 * i + 1], s = ov[3 * i + 2];
                if ((w & ((1ull << l) - 1)) == bits) {
                    if ((int64_t)l > br.remaining()) { br.skip((int)l); return -1; }
                    br.skip((int)l);
                    return (int)s;
                }
            }
        }
        br.skip(max_len ? (int)max_len : 1);
        return -1;
    }
};

struct Floor0V {
    uint32_t order, amplitude_bits, amplitude_offset, book_bits, n_books;
    const uint32_t* book_ids;
};

struct Floor1V {
    uint32_t n_partitions;
    const uint32_t* partition_classes;
    uint32_t n_classes;
    std::vector<uint32_t> class_dims, class_subclasses;
    std::vector<int32_t> class_masterbooks;
    std::vector<std::vector<int32_t>> subclass_books;
    uint32_t multiplier, range, y_bits, n_posts;
    const int32_t* xs;
    const int32_t* low_nb;
    const int32_t* high_nb;
};

struct FloorV {
    uint32_t ftype;
    Floor0V f0;
    Floor1V f1;
};

struct ResidueV {
    uint32_t rtype, begin, end, psize, ncls, classbook;
    const uint32_t* cascades;  // [ncls]
    const int32_t* books;      // [ncls*8], -1 = none
};

struct MappingV {
    uint32_t n_submaps, n_coupling;
    const uint32_t* steps;          // [2*n_coupling]
    const uint32_t* mux;            // [channels]
    const uint32_t* submap_floor;   // [n_submaps]
    const uint32_t* submap_residue; // [n_submaps]
};

struct ModeV {
    uint32_t block_flag, mapping_idx;
};

struct Setup {
    uint32_t channels, bs0, bs1, mode_bits;
    std::vector<CodebookV> codebooks;
    std::vector<FloorV> floors;
    std::vector<ResidueV> residues;
    std::vector<MappingV> mappings;
    std::vector<ModeV> modes;
    uint32_t max_half;   // bs1 / 2
    uint32_t max_order;  // max floor0 order (0 if none)
    // symbol-transport group table: per mapping, slot = groups[sm*8*n_cb +
    // pass*n_cb + book_id] (-1 = book unused in that (submap, pass)).
    // Enumeration order — submap-major, pass, ascending book id — must match
    // native/symbols.py group_enumeration() exactly.
    std::vector<std::vector<int32_t>> group_of;
    std::vector<int32_t> n_groups_of;
};

void build_group_tables(Setup& s) {
    size_t n_cb = s.codebooks.size();
    s.group_of.resize(s.mappings.size());
    s.n_groups_of.assign(s.mappings.size(), 0);
    for (size_t m = 0; m < s.mappings.size(); m++) {
        const MappingV& map = s.mappings[m];
        std::vector<int32_t>& tbl = s.group_of[m];
        tbl.assign(map.n_submaps * 8 * n_cb, -1);
        int32_t slot = 0;
        for (uint32_t sm = 0; sm < map.n_submaps; sm++) {
            const ResidueV& r = s.residues[map.submap_residue[sm]];
            for (int p = 0; p < 8; p++) {
                for (size_t b = 0; b < n_cb; b++) {  // ascending book id
                    bool used = false;
                    for (uint32_t c = 0; c < r.ncls && !used; c++)
                        used = r.books[(size_t)c * 8 + p] == (int32_t)b;
                    if (used) tbl[(sm * 8 + p) * n_cb + b] = slot++;
                }
            }
        }
        s.n_groups_of[m] = slot;
    }
}

struct BlobReader {
    const uint8_t* p;
    const uint8_t* end;
    bool ok = true;

    uint32_t u32() {
        if (p + 4 > end) { ok = false; return 0; }
        uint32_t v;
        std::memcpy(&v, p, 4);
        p += 4;
        return v;
    }
    const int32_t* i32_arr(size_t n) {
        if (p + 4 * n > end) { ok = false; return nullptr; }
        const int32_t* v = reinterpret_cast<const int32_t*>(p);
        p += 4 * n;
        return v;
    }
    const uint32_t* u32_arr(size_t n) {
        return reinterpret_cast<const uint32_t*>(i32_arr(n));
    }
    const float* f32_arr(size_t n) {
        return reinterpret_cast<const float*>(i32_arr(n));
    }
};

bool parse_setup(const uint8_t* blob, int64_t len, Setup& s) {
    BlobReader b{blob, blob + len};
    if (b.u32() != 0x56505445u || b.u32() != 1u) return false;
    s.channels = b.u32();
    s.bs0 = b.u32();
    s.bs1 = b.u32();
    s.mode_bits = b.u32();
    s.max_half = s.bs1 / 2;
    s.max_order = 0;

    uint32_t n_cb = b.u32();
    s.codebooks.resize(n_cb);
    for (auto& cb : s.codebooks) {
        cb.dims = b.u32();
        cb.entries = b.u32();
        cb.max_len = b.u32();
        cb.has_lookup = b.u32();
        cb.prefix_sym = b.i32_arr(PREFIX_SIZE);
        cb.prefix_len = b.i32_arr(PREFIX_SIZE);
        cb.n_overflow = b.u32();
        cb.ov = b.u32_arr((size_t)cb.n_overflow * 3);
        cb.lookup = cb.has_lookup ? b.f32_arr((size_t)cb.entries * cb.dims)
                                  : nullptr;
    }

    uint32_t n_fl = b.u32();
    s.floors.resize(n_fl);
    for (auto& fl : s.floors) {
        fl.ftype = b.u32();
        if (fl.ftype == 0) {
            auto& f = fl.f0;
            f.order = b.u32();
            f.amplitude_bits = b.u32();
            f.amplitude_offset = b.u32();
            f.book_bits = b.u32();
            f.n_books = b.u32();
            f.book_ids = b.u32_arr(f.n_books);
            if (f.order > s.max_order) s.max_order = f.order;
        } else {
            auto& f = fl.f1;
            f.n_partitions = b.u32();
            f.partition_classes = b.u32_arr(f.n_partitions);
            f.n_classes = b.u32();
            f.class_dims.resize(f.n_classes);
            f.class_subclasses.resize(f.n_classes);
            f.class_masterbooks.resize(f.n_classes);
            f.subclass_books.resize(f.n_classes);
            for (uint32_t c = 0; c < f.n_classes; c++) {
                f.class_dims[c] = b.u32();
                f.class_subclasses[c] = b.u32();
                f.class_masterbooks[c] = (int32_t)b.u32();
                uint32_t nb = 1u << f.class_subclasses[c];
                f.subclass_books[c].resize(nb);
                const int32_t* arr = b.i32_arr(nb);
                if (arr)
                    for (uint32_t k = 0; k < nb; k++) f.subclass_books[c][k] = arr[k];
            }
            f.multiplier = b.u32();
            f.range = b.u32();
            f.y_bits = b.u32();
            f.n_posts = b.u32();
            f.xs = b.i32_arr(f.n_posts);
            f.low_nb = b.i32_arr(f.n_posts);
            f.high_nb = b.i32_arr(f.n_posts);
        }
    }

    uint32_t n_res = b.u32();
    s.residues.resize(n_res);
    for (auto& r : s.residues) {
        r.rtype = b.u32();
        r.begin = b.u32();
        r.end = b.u32();
        r.psize = b.u32();
        r.ncls = b.u32();
        r.classbook = b.u32();
        r.cascades = b.u32_arr(r.ncls);
        r.books = b.i32_arr((size_t)r.ncls * 8);
    }

    uint32_t n_map = b.u32();
    s.mappings.resize(n_map);
    for (auto& m : s.mappings) {
        m.n_submaps = b.u32();
        m.n_coupling = b.u32();
        m.steps = b.u32_arr((size_t)m.n_coupling * 2);
        m.mux = b.u32_arr(s.channels);
        m.submap_floor = b.u32_arr(m.n_submaps);
        m.submap_residue = b.u32_arr(m.n_submaps);
    }

    uint32_t n_modes = b.u32();
    s.modes.resize(n_modes);
    for (auto& m : s.modes) {
        m.block_flag = b.u32();
        m.mapping_idx = b.u32();
    }
    return b.ok;
}

// ---------------------------------------------------------------- floor decode

// mirror of Floor1.unpack + _unwrap (setup/floor.py:212,245); also emits
// the CODED values ys (pre-unwrap prediction residuals) so the batch
// pipeline can ship those and run the unwrap cascade on device
// (ops/floor.py floor1_unwrap; saturated to int16 — the ys wire is only
// taken when the static subclass-book gate proves ys <= 255)
bool floor1_unpack(const Floor1V& f, const Setup& s, BitReader& br,
                   int32_t* out_posts, uint8_t* out_step2,
                   int16_t* out_ys) {
    if (!br.read(1) || br.overrun) return false;
    int64_t ys[65];
    ys[0] = (int64_t)br.read((int)f.y_bits);
    ys[1] = (int64_t)br.read((int)f.y_bits);
    uint32_t offset = 2;
    for (uint32_t pi = 0; pi < f.n_partitions; pi++) {
        uint32_t cls = f.partition_classes[pi];
        uint32_t cdim = f.class_dims[cls];
        uint32_t cbits = f.class_subclasses[cls];
        uint32_t csub = (1u << cbits) - 1;
        int64_t cval = 0;
        if (cbits > 0) {
            cval = s.codebooks[f.class_masterbooks[cls]].decode_scalar(br);
            if (cval < 0) return false;
        }
        for (uint32_t j = 0; j < cdim; j++) {
            int32_t book = f.subclass_books[cls][cval & csub];
            cval >>= cbits;
            if (book >= 0) {
                int v = s.codebooks[book].decode_scalar(br);
                if (v < 0) return false;
                ys[offset + j] = v;
            } else {
                ys[offset + j] = 0;
            }
        }
        offset += cdim;
    }
    if (br.overrun) return false;

    if (out_ys) {
        for (uint32_t i = 0; i < f.n_posts; i++) {
            int64_t v = ys[i];
            out_ys[i] = (int16_t)(v > 32767 ? 32767 : v);
        }
    }

    // unwrap (prediction + room folding)
    int64_t rng = f.range;
    int64_t fin[65];
    uint8_t st2[65];
    fin[0] = ys[0];
    fin[1] = ys[1];
    st2[0] = st2[1] = 1;
    for (uint32_t i = 2; i < f.n_posts; i++) {
        int32_t low = f.low_nb[i], high = f.high_nb[i];
        // render_point (spec 9.2.6)
        int64_t x0 = f.xs[low], y0 = fin[low], x1 = f.xs[high], y1 = fin[high];
        int64_t dy = y1 - y0, adx = x1 - x0;
        int64_t err = (dy < 0 ? -dy : dy) * ((int64_t)f.xs[i] - x0);
        int64_t off = err / adx;
        int64_t predicted = dy < 0 ? y0 - off : y0 + off;
        int64_t val = ys[i];
        int64_t highroom = rng - predicted;
        int64_t lowroom = predicted;
        int64_t room = 2 * (highroom < lowroom ? highroom : lowroom);
        if (val) {
            st2[low] = 1;
            st2[high] = 1;
            st2[i] = 1;
            if (val >= room) {
                fin[i] = highroom > lowroom ? val - lowroom + predicted
                                            : predicted - val + highroom - 1;
            } else {
                fin[i] = (val & 1) ? predicted - ((val + 1) >> 1)
                                   : predicted + (val >> 1);
            }
        } else {
            st2[i] = 0;
            fin[i] = predicted;
        }
    }
    for (uint32_t i = 0; i < f.n_posts; i++) {
        // clamp to the floor range (setup/floor.py _unwrap parity):
        // malformed streams can fold past [0, range-1]
        int64_t v = fin[i];
        if (v < 0) v = 0;
        if (v > rng - 1) v = rng - 1;
        out_posts[i] = (int32_t)v;
        out_step2[i] = st2[i];
    }
    return true;
}

// mirror of Floor0.unpack (setup/floor.py:93)
bool floor0_unpack(const Floor0V& f, const Setup& s, BitReader& br,
                   float* out_coeffs, int32_t* out_amp) {
    int64_t amplitude = (int64_t)br.read((int)f.amplitude_bits);
    if (amplitude <= 0 || br.overrun) return false;
    uint64_t book_num = br.read((int)f.book_bits);
    if (book_num >= f.n_books) return false;
    const CodebookV& book = s.codebooks[f.book_ids[book_num]];
    double coeffs[256];
    uint32_t n = 0;
    double last = 0.0;
    while (n < f.order) {
        int sym = book.decode_scalar(br);
        if (sym < 0) return false;
        const float* vec = book.lookup + (size_t)sym * book.dims;
        for (uint32_t d = 0; d < book.dims && n < 256; d++)
            coeffs[n++] = (double)vec[d] + last;
        last = coeffs[n - 1];
    }
    for (uint32_t i = 0; i < f.order; i++) out_coeffs[i] = (float)coeffs[i];
    *out_amp = (int32_t)amplitude;
    return true;
}

// ---------------------------------------------------------------- residue

// mirror of Residue._decode_partition (setup/residue.py:146)
inline bool decode_partition(const CodebookV& book, BitReader& br, double* vec,
                             int64_t vec_len, int64_t offset, int64_t psize,
                             bool fmt1) {
    int64_t dims = book.dims;
    if (dims < 1) return false;  // rejected at parse time; belt-and-braces
    const float* table = book.lookup;
    if (fmt1) {
        for (int64_t i = 0; i < psize; i += dims) {
            int sym = book.decode_scalar(br);
            if (sym < 0) return false;
            const float* row = table + (size_t)sym * dims;
            int64_t lim = offset + i + dims;
            if (lim > vec_len) lim = vec_len;
            for (int64_t k = offset + i, d = 0; k < lim; k++, d++)
                vec[k] += row[d];
        }
    } else {
        int64_t step = psize / dims;
        for (int64_t k = 0; k < step; k++) {
            int sym = book.decode_scalar(br);
            if (sym < 0) return false;
            const float* row = table + (size_t)sym * dims;
            for (int64_t d = 0, idx = offset + k; d < dims && idx < vec_len;
                 d++, idx += step)
                vec[idx] += row[d];
        }
    }
    return true;
}

// mirror of Residue._decode_core (setup/residue.py:95)
void residue_decode_core(const ResidueV& r, const Setup& s, BitReader& br,
                         double** vectors, int64_t vec_len, int n_ch,
                         const bool* do_not_decode, int64_t actual_size,
                         bool force_format1, std::vector<int64_t>& cls_buf) {
    int64_t limit_begin = r.begin < actual_size ? r.begin : actual_size;
    int64_t limit_end = r.end < actual_size ? r.end : actual_size;
    int64_t n_to_read = limit_end - limit_begin;
    if (n_to_read <= 0) return;
    int64_t psize = r.psize;
    int64_t partitions_to_read = n_to_read / psize;
    const CodebookV& classbook = s.codebooks[r.classbook];
    int64_t cwords = classbook.dims;
    bool fmt1 = force_format1 || r.rtype != 0;
    int64_t ncls = r.ncls;

    int64_t stride = partitions_to_read + cwords;
    cls_buf.assign((size_t)(n_ch * stride), 0);

    for (int p = 0; p < 8; p++) {
        int64_t partition_count = 0;
        while (partition_count < partitions_to_read) {
            if (p == 0) {
                for (int j = 0; j < n_ch; j++) {
                    if (do_not_decode[j]) continue;
                    int64_t temp = classbook.decode_scalar(br);
                    if (temp < 0) return;  // EOP: keep partial data
                    for (int64_t i = cwords - 1; i >= 0; i--) {
                        cls_buf[(size_t)(j * stride + partition_count + i)] =
                            temp % ncls;
                        temp /= ncls;
                    }
                }
            }
            for (int64_t w = 0; w < cwords; w++) {
                if (partition_count >= partitions_to_read) break;
                int64_t offset = limit_begin + partition_count * psize;
                for (int j = 0; j < n_ch; j++) {
                    if (do_not_decode[j]) continue;
                    int64_t cls = cls_buf[(size_t)(j * stride + partition_count)];
                    int32_t book_idx = r.books[(size_t)cls * 8 + p];
                    if (book_idx < 0) continue;
                    if (!decode_partition(s.codebooks[book_idx], br, vectors[j],
                                          vec_len, offset, psize, fmt1))
                        return;  // EOP
                }
                partition_count++;
            }
        }
    }
}

// ---------------------------------------------------- residue (symbol mode)
//
// Symbol-level transport: instead of expanding VQ entries into dense
// spectra on the host, record (a) the per-partition classifications and
// (b) the raw codebook entry numbers, grouped by (submap, pass, book) in
// traversal order. The device reconstructs the residue exactly (the VQ
// tables ride along as compiled constants) — the wire carries the entropy
// symbols, which are 2-4x smaller than packed residue values. The
// expansion contract (traversal order, EOP prefix semantics, padding) is
// documented and mirrored in native/symbols.py expand_symbols().

struct SymOut {
    uint8_t* cls;          // [P, C, pt_max], 0xFF = not decoded
    uint16_t* syms;        // [P, sym_cap] group-major per packet
    uint16_t* slots;       // [P, sym_cap] group-major per packet: one entry
                           // per APPLIED partition, the traversal slot id
                           // pv = partition_index * V + vector_row (the
                           // device scatters partition rows straight to
                           // region row frame*Pt*V + pv — no cls/rank
                           // reconstruction needed; ops/residue_sym.py)
    int32_t* sym_counts;   // [P, n_groups]
    int32_t* pair_counts;  // [P, n_sp]: applied pairs per (submap, pass)
    int64_t pt_max, sym_cap, n_groups, n_sp;
};

struct SymScratch {
    std::vector<std::vector<uint16_t>> grp;
    std::vector<std::vector<uint16_t>> slot;
    std::vector<int32_t> pairs;
};

// 0 = EOP before any symbol (pair not applied), 1 = partial (padded with
// the zero-row sentinel), 2 = full partition
int decode_partition_sym(const CodebookV& book, BitReader& br,
                         std::vector<uint16_t>& out, int64_t psize,
                         bool fmt1) {
    int64_t dims = book.dims;
    int64_t nsym = fmt1 ? (psize + dims - 1) / dims : psize / dims;
    uint16_t sentinel = (uint16_t)book.entries;
    for (int64_t k = 0; k < nsym; k++) {
        int sym = book.decode_scalar(br);
        if (sym < 0) {
            if (k == 0) return 0;
            for (int64_t q = k; q < nsym; q++) out.push_back(sentinel);
            return 1;
        }
        out.push_back((uint16_t)sym);
    }
    return 2;
}

// traversal identical to residue_decode_core; records instead of expanding
void residue_core_sym(const ResidueV& r, const Setup& s, BitReader& br,
                      int n_ch, const bool* do_not_decode,
                      int64_t actual_size, bool force_format1,
                      uint8_t** cls_rows, const int32_t* grp_tbl,
                      size_t n_cb, int sm, SymScratch& sy) {
    int64_t limit_begin = r.begin < actual_size ? r.begin : actual_size;
    int64_t limit_end = r.end < actual_size ? r.end : actual_size;
    int64_t n_to_read = limit_end - limit_begin;
    if (n_to_read <= 0) return;
    int64_t psize = r.psize;
    int64_t partitions_to_read = n_to_read / psize;
    const CodebookV& classbook = s.codebooks[r.classbook];
    int64_t cwords = classbook.dims;
    bool fmt1 = force_format1 || r.rtype != 0;
    int64_t ncls = r.ncls;

    for (int p = 0; p < 8; p++) {
        int64_t partition_count = 0;
        while (partition_count < partitions_to_read) {
            if (p == 0) {
                for (int j = 0; j < n_ch; j++) {
                    if (do_not_decode[j]) continue;
                    int64_t temp = classbook.decode_scalar(br);
                    if (temp < 0) return;  // EOP: keep partial data
                    for (int64_t i = cwords - 1; i >= 0; i--) {
                        if (partition_count + i < partitions_to_read)
                            cls_rows[j][partition_count + i] =
                                (uint8_t)(temp % ncls);
                        temp /= ncls;
                    }
                }
            }
            for (int64_t w = 0; w < cwords; w++) {
                if (partition_count >= partitions_to_read) break;
                for (int j = 0; j < n_ch; j++) {
                    if (do_not_decode[j]) continue;
                    uint8_t cls = cls_rows[j][partition_count];
                    if (cls == 0xFF || cls >= ncls) continue;
                    int32_t book_idx = r.books[(size_t)cls * 8 + p];
                    if (book_idx < 0) continue;
                    int32_t slot = grp_tbl[(size_t)p * n_cb + book_idx];
                    int st = decode_partition_sym(
                        s.codebooks[book_idx], br, sy.grp[slot], psize, fmt1);
                    if (st >= 1) {
                        sy.pairs[sm * 8 + p] += 1;
                        sy.slot[slot].push_back(
                            (uint16_t)(partition_count * n_ch + j));
                    }
                    if (st <= 1) return;  // EOP
                }
                partition_count++;
            }
        }
    }
}

// ---------------------------------------------------------------- packet decode

struct Outputs {
    int32_t* meta;       // [n_pkts, 4]: ok, mode_idx, prev, next
    float* residues;     // [n_pkts, C, max_half]
    int32_t* posts;      // [n_pkts, C, 65]
    uint8_t* step2;      // [n_pkts, C, 65]
    uint8_t* used;       // [n_pkts, C]
    float* f0_coeffs;    // [n_pkts, C, max_order] (or null)
    int32_t* f0_amp;     // [n_pkts, C] (or null)
    int16_t* ys;         // [n_pkts, C, 65] coded floor1 values (or null)
};

struct Scratch {
    std::vector<double> acc;        // [C * max_half] or [C*max_half] flat (type2)
    std::vector<double*> vec_ptrs;
    std::vector<bool> dummy;
    std::vector<int64_t> cls_buf;
};

void decode_one(const Setup& s, const uint8_t* data, int64_t len, int64_t pkt,
                const Outputs& o, Scratch& sc, const SymOut* so = nullptr,
                SymScratch* sy = nullptr) {
    int32_t* meta = o.meta + pkt * 5;
    meta[0] = 0;
    meta[4] = 0;  // audio bits consumed (reference StreamStats.cs:94-122:
                  // audio = bits actually read; trailing unread bits = waste)
    if (len <= 0) return;
    BitReader br(data, len);
    if (br.read(1)) return;  // not an audio packet
    uint64_t mode_idx = br.read((int)s.mode_bits);
    if (mode_idx >= s.modes.size() || br.overrun) return;
    const ModeV& mode = s.modes[mode_idx];
    int prev = 0, next = 0;
    if (mode.block_flag) {
        prev = (int)br.read(1);
        next = (int)br.read(1);
    }
    if (br.overrun) return;
    meta[1] = (int32_t)mode_idx;
    meta[2] = prev;
    meta[3] = next;
    meta[0] = 1;

    const MappingV& map = s.mappings[mode.mapping_idx];
    uint32_t C = s.channels;
    int64_t n = mode.block_flag ? s.bs1 : s.bs0;
    int64_t half = n / 2;

    // 1. floors for all channels
    bool floor_used[256];
    for (uint32_t c = 0; c < C; c++) {
        const FloorV& fl = s.floors[map.submap_floor[map.mux[c]]];
        bool ok;
        if (fl.ftype == 1) {
            ok = floor1_unpack(fl.f1, s, br,
                               o.posts + (pkt * C + c) * 65,
                               o.step2 + (pkt * C + c) * 65,
                               o.ys ? o.ys + (pkt * C + c) * 65 : nullptr);
        } else {
            ok = floor0_unpack(fl.f0, s, br,
                               o.f0_coeffs + (pkt * C + c) * s.max_order,
                               o.f0_amp + pkt * C + c);
        }
        floor_used[c] = ok;
        o.used[pkt * C + c] = ok ? 1 : 0;
    }

    // 2. nonzero propagation through couplings
    bool no_residue[256];
    for (uint32_t c = 0; c < C; c++) no_residue[c] = !floor_used[c];
    for (uint32_t k = 0; k < map.n_coupling; k++) {
        uint32_t m = map.steps[2 * k], a = map.steps[2 * k + 1];
        if (!(no_residue[m] && no_residue[a])) {
            no_residue[m] = false;
            no_residue[a] = false;
        }
    }

    // 3a. symbol mode: record classifications + VQ entry numbers, no
    // expansion (the device reconstructs; see native/symbols.py)
    if (so) {
        size_t n_cb = s.codebooks.size();
        const int32_t* grp_map = s.group_of[mode.mapping_idx].data();
        int32_t n_groups_m = s.n_groups_of[mode.mapping_idx];
        for (auto& v : sy->grp) v.clear();
        for (auto& v : sy->slot) v.clear();
        sy->pairs.assign((size_t)so->n_sp, 0);
        for (uint32_t sm = 0; sm < map.n_submaps; sm++) {
            int ch_list[256];
            int n_ch = 0;
            for (uint32_t c = 0; c < C; c++)
                if (map.mux[c] == sm) ch_list[n_ch++] = (int)c;
            if (n_ch == 0) continue;
            const ResidueV& r = s.residues[map.submap_residue[sm]];
            const int32_t* grp_tbl = grp_map + (size_t)sm * 8 * n_cb;
            uint8_t* rows[256];
            bool dnd[256];
            if (r.rtype == 2) {
                bool all_dnd = true;
                for (int j = 0; j < n_ch; j++) all_dnd &= no_residue[ch_list[j]];
                if (all_dnd) continue;
                rows[0] = so->cls + (pkt * C + ch_list[0]) * so->pt_max;
                dnd[0] = false;
                residue_core_sym(r, s, br, 1, dnd, (int64_t)half * n_ch, true,
                                 rows, grp_tbl, n_cb, (int)sm, *sy);
            } else {
                for (int j = 0; j < n_ch; j++) {
                    rows[j] = so->cls + (pkt * C + ch_list[j]) * so->pt_max;
                    dnd[j] = no_residue[ch_list[j]];
                }
                residue_core_sym(r, s, br, n_ch, dnd, half, false, rows,
                                 grp_tbl, n_cb, (int)sm, *sy);
            }
        }
        // flush group streams (group-major) + counters for this packet;
        // slot streams flush in the same group order with their own cursor
        // (one entry per applied partition — host derives the offsets from
        // sym_counts / nsym per group)
        uint16_t* sdst = so->syms + pkt * so->sym_cap;
        uint16_t* pdst = so->slots + pkt * so->sym_cap;
        int32_t* cnt = so->sym_counts + pkt * so->n_groups;
        int64_t wpos = 0, spos = 0;
        for (int32_t g = 0; g < n_groups_m; g++) {
            const auto& v = sy->grp[g];
            const auto& sv = sy->slot[g];
            if (wpos + (int64_t)v.size() > so->sym_cap ||
                spos + (int64_t)sv.size() > so->sym_cap) {
                meta[0] = 0;  // capacity bug: fail the frame loudly
                return;
            }
            cnt[g] = (int32_t)v.size();
            if (!v.empty())
                std::memcpy(sdst + wpos, v.data(), v.size() * 2);
            if (!sv.empty())
                std::memcpy(pdst + spos, sv.data(), sv.size() * 2);
            wpos += (int64_t)v.size();
            spos += (int64_t)sv.size();
        }
        int32_t* pc = so->pair_counts + pkt * so->n_sp;
        for (int64_t k = 0; k < so->n_sp; k++) pc[k] = sy->pairs[(size_t)k];
        meta[4] = (int32_t)br.pos;
        return;
    }

    // 3b. value mode: residue decode per submap -> double accumulators ->
    // f32 out
    sc.acc.assign((size_t)C * s.max_half, 0.0);
    float* res_out = o.residues + pkt * C * s.max_half;

    for (uint32_t sm = 0; sm < map.n_submaps; sm++) {
        int ch_list[256];
        int n_ch = 0;
        for (uint32_t c = 0; c < C; c++)
            if (map.mux[c] == sm) ch_list[n_ch++] = (int)c;
        if (n_ch == 0) continue;
        const ResidueV& r = s.residues[map.submap_residue[sm]];

        if (r.rtype == 2) {
            // all channels interleaved in one vector (spec 8.6.5)
            bool all_dnd = true;
            for (int j = 0; j < n_ch; j++) all_dnd &= no_residue[ch_list[j]];
            if (all_dnd) continue;
            std::vector<double>& flat = sc.acc;  // reuse region scratch
            // use a separate flat buffer: n * n_ch doubles
            static thread_local std::vector<double> flat2;
            flat2.assign((size_t)half * n_ch, 0.0);
            double* vptr = flat2.data();
            bool dnd0 = false;
            double* vecs[1] = {vptr};
            residue_decode_core(r, s, br, vecs, (int64_t)half * n_ch, 1, &dnd0,
                                (int64_t)half * n_ch, true, sc.cls_buf);
            // de-interleave: flat[i*n_ch + j] -> channel ch_list[j][i]
            for (int j = 0; j < n_ch; j++) {
                double* dst = flat.data() + (size_t)ch_list[j] * s.max_half;
                for (int64_t i = 0; i < half; i++)
                    dst[i] = flat2[(size_t)i * n_ch + j];
            }
        } else {
            double* vecs[256];
            bool dnd[256];
            for (int j = 0; j < n_ch; j++) {
                vecs[j] = sc.acc.data() + (size_t)ch_list[j] * s.max_half;
                dnd[j] = no_residue[ch_list[j]];
            }
            residue_decode_core(r, s, br, vecs, half, n_ch, dnd, half,
                                false, sc.cls_buf);
        }
    }
    for (uint32_t c = 0; c < C; c++) {
        const double* src = sc.acc.data() + (size_t)c * s.max_half;
        float* dst = res_out + (size_t)c * s.max_half;
        for (int64_t i = 0; i < half; i++) dst[i] = (float)src[i];
    }
    meta[4] = (int32_t)br.pos;
}

}  // namespace

// ------------------------------------------------ dpack unpack SIMD kernel
//
// AVX-512 path for vp_unpack_pcm's per-block inner loop (the headline
// corpus is host-CPU-bound on single-vCPU TPU hosts; this loop is the
// largest term). 16-lane field extraction (gather + variable shift),
// SIMD zigzag, and carry-propagated 16-lane inclusive scans for the
// d3 -> d2 -> d1 -> sample chains. All arithmetic is two's-complement
// mod 2^32; the scalar path accumulates in int64 but stores low 16
// bits, and addition commutes with mod, so both paths store identical
// PCM (valid wires never leave int32 range anyway: |d3| <= 2^18, rice
// q <= 2304 by the block cost bound).

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VL__)
#define VP_UNPACK_AVX512 1
#include <immintrin.h>

namespace {

//: must match ops/pcm_pack.py WIDTHS and the W[] table in vp_unpack_pcm
static const int VP_W[12] = {0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 18};

// per-width gather byte offsets and residual bit shifts for the 128
// fields of one block (field i lives at bit i*w of the block's plane)
struct VpWTab {
    alignas(64) int32_t off[12][128];
    alignas(64) int32_t sh[12][128];
    VpWTab() {
        for (int wi = 0; wi < 12; wi++) {
            int w = VP_W[wi];
            for (int i = 0; i < 128; i++) {
                int64_t bit = (int64_t)i * w;
                off[wi][i] = (int32_t)(bit >> 3);
                sh[wi][i] = (int32_t)(bit & 7);
            }
        }
    }
};
static const VpWTab VP_WTAB;

static inline int32_t vp_lane15(__m512i x) {
    return _mm_extract_epi32(_mm512_extracti32x4_epi32(x, 3), 3);
}

// 16-lane inclusive prefix sum (Hillis-Steele via lane-shifts)
static inline __m512i vp_prefix32(__m512i x) {
    const __m512i z = _mm512_setzero_si512();
    x = _mm512_add_epi32(x, _mm512_alignr_epi32(x, z, 15));
    x = _mm512_add_epi32(x, _mm512_alignr_epi32(x, z, 14));
    x = _mm512_add_epi32(x, _mm512_alignr_epi32(x, z, 12));
    x = _mm512_add_epi32(x, _mm512_alignr_epi32(x, z, 8));
    return x;
}

static inline __m512i vp_scan_carry(__m512i x, int32_t& carry) {
    x = _mm512_add_epi32(vp_prefix32(x), _mm512_set1_epi32(carry));
    carry = vp_lane15(x);
    return x;
}

// One 128-sample block: plane extraction, optional rice high parts
// (qv[128] pre-scanned from the unary stream), optional inter-channel
// add, the integration chain, int16 store (truncating, like the scalar
// path's (int16_t) cast). Gathers read up to 4 bytes past the block's
// plane — covered by the caller's 8-byte slack contract (see
// vp_unpack_pcm's header comment).
template <bool ORD3, bool INTER, bool STASH, bool RICE>
static void vp_block_avx512(const uint8_t* p, int wi, const int32_t* qv,
                            const int32_t* d2in, int32_t* d2out,
                            int64_t base, int64_t L, int16_t* dst,
                            int32_t& acc1, int32_t& acc2, int32_t& ld2) {
    const int w = VP_W[wi];
    const __m512i vzero = _mm512_setzero_si512();
    const __m512i vone = _mm512_set1_epi32(1);
    const __m512i vmask =
        _mm512_set1_epi32(w ? (int32_t)((1u << w) - 1) : 0);
    const __m512i vw = _mm512_set1_epi32(w);
    for (int g = 0; g < 8; g++) {
        const int64_t s0 = base + g * 16;
        __m512i v;
        if (w) {
            __m512i vidx = _mm512_load_si512(
                (const void*)(VP_WTAB.off[wi] + g * 16));
            __m512i vsh = _mm512_load_si512(
                (const void*)(VP_WTAB.sh[wi] + g * 16));
            v = _mm512_i32gather_epi32(vidx, (const void*)p, 1);
            v = _mm512_and_si512(_mm512_srlv_epi32(v, vsh), vmask);
        } else {
            v = vzero;
        }
        if (RICE) {
            __m512i q = _mm512_load_si512((const void*)(qv + g * 16));
            v = _mm512_or_si512(v, _mm512_sllv_epi32(q, vw));
        }
        // zigzag: (v >> 1) ^ -(v & 1)
        __m512i dd = _mm512_xor_si512(
            _mm512_srli_epi32(v, 1),
            _mm512_sub_epi32(vzero, _mm512_and_si512(v, vone)));
        if (INTER) {
            __m512i a = _mm512_loadu_si512((const void*)(d2in + s0));
            if (ORD3) {
                // partner's d3 = d2in[s] - d2in[s-1] (0 at channel
                // start; the masked lane suppresses the d2in[-1] access)
                __m512i b =
                    s0 == 0
                        ? _mm512_maskz_loadu_epi32(0xFFFE, d2in + s0 - 1)
                        : _mm512_loadu_si512((const void*)(d2in + s0 - 1));
                dd = _mm512_add_epi32(dd, _mm512_sub_epi32(a, b));
            } else {
                dd = _mm512_add_epi32(dd, a);
            }
        }
        __m512i d2;
        if (ORD3) {
            d2 = vp_scan_carry(dd, ld2);
        } else {
            d2 = dd;
            ld2 = vp_lane15(dd);
        }
        if (STASH)
            _mm512_storeu_si512((void*)(d2out + s0), d2);
        __m512i d1 = vp_scan_carry(d2, acc1);
        __m512i sm = vp_scan_carry(d1, acc2);
        int64_t left = L - s0;
        if (left >= 16) {
            _mm256_storeu_si256((__m256i*)(dst + s0),
                                _mm512_cvtepi32_epi16(sm));
        } else if (left > 0) {
            _mm256_mask_storeu_epi16(
                dst + s0, (__mmask16)((1u << left) - 1),
                _mm512_cvtepi32_epi16(sm));
        }
    }
}

}  // namespace
#endif  // VP_UNPACK_AVX512

namespace {

// CPU nanoseconds the calling thread has run (CLOCK_THREAD_CPUTIME_ID).
int64_t thread_cpu_ns() {
    timespec ts;
    clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
    return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

// Runs work(lo, hi) over [0, n_pkts) on n_threads threads (the caller's
// own when 1). A non-null cpu_ns gets each run's thread CPU added
// atomically; a null one reads no clock.
template <typename Work>
void run_threads(const Work& work, int64_t n_pkts, int n_threads,
                 int64_t* cpu_ns) {
    auto timed = [&](int64_t lo, int64_t hi) {
        if (!cpu_ns) {
            work(lo, hi);
            return;
        }
        int64_t c0 = thread_cpu_ns();
        work(lo, hi);
        __atomic_fetch_add(cpu_ns, thread_cpu_ns() - c0, __ATOMIC_RELAXED);
    };
    if (n_threads == 1) {
        timed(0, n_pkts);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_pkts + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < n_pkts ? lo + chunk : n_pkts;
        if (lo >= hi) break;
        threads.emplace_back(timed, lo, hi);
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Packets are addressed by independent (start, end) spans into pkt_data so
// callers can hand the Ogg scanner's blob straight in (audio packets need
// not be contiguous there): no re-join, no per-packet copies on the host.
int vp_decode_packets(const uint8_t* blob, int64_t blob_len,
                      const uint8_t* pkt_data, const int64_t* pkt_start,
                      const int64_t* pkt_end,
                      int64_t n_pkts, int32_t* meta, float* residues,
                      int32_t* posts, uint8_t* step2, uint8_t* used,
                      float* f0_coeffs, int32_t* f0_amp, int16_t* ys,
                      int n_threads, int64_t* cpu_ns) {
    Setup s;
    if (!parse_setup(blob, blob_len, s)) return -1;
    if (s.channels > 256) return -2;
    Outputs o{meta, residues, posts, step2, used, f0_coeffs, f0_amp, ys};

    if (n_threads < 1) n_threads = 1;
    if (n_threads > (int)n_pkts) n_threads = (int)(n_pkts > 0 ? n_pkts : 1);

    auto work = [&](int64_t lo, int64_t hi) {
        Scratch sc;
        for (int64_t i = lo; i < hi; i++) {
            decode_one(s, pkt_data + pkt_start[i], pkt_end[i] - pkt_start[i],
                       i, o, sc);
        }
    };

    run_threads(work, n_pkts, n_threads, cpu_ns);
    return 0;
}

// Symbol-mode variant: floors as vp_decode_packets, residues recorded as
// per-partition classifications + VQ entry numbers grouped by
// (submap, pass, book). No dense expansion — the wire carries the entropy
// symbols; the device (models/pipeline.py) or native/symbols.py
// expand_symbols() reconstructs the exact residue vectors.
int vp_decode_packets_sym(const uint8_t* blob, int64_t blob_len,
                          const uint8_t* pkt_data, const int64_t* pkt_start,
                          const int64_t* pkt_end, int64_t n_pkts,
                          int32_t* meta, int32_t* posts, uint8_t* step2,
                          uint8_t* used, float* f0_coeffs, int32_t* f0_amp,
                          int16_t* ys,
                          uint8_t* cls, uint16_t* syms, uint16_t* slots,
                          int32_t* sym_counts,
                          int32_t* pair_counts, int64_t pt_max,
                          int64_t sym_cap, int64_t n_groups, int64_t n_sp,
                          int n_threads, int64_t* cpu_ns) {
    Setup s;
    if (!parse_setup(blob, blob_len, s)) return -1;
    if (s.channels > 256) return -2;
    build_group_tables(s);
    for (int32_t g : s.n_groups_of)
        if (g > n_groups) return -4;  // group table disagreement with caller
    Outputs o{meta, nullptr, posts, step2, used, f0_coeffs, f0_amp, ys};
    SymOut so{cls, syms, slots, sym_counts, pair_counts,
              pt_max, sym_cap, n_groups, n_sp};
    std::memset(cls, 0xFF, (size_t)(n_pkts * s.channels * pt_max));

    if (n_threads < 1) n_threads = 1;
    if (n_threads > (int)n_pkts) n_threads = (int)(n_pkts > 0 ? n_pkts : 1);

    auto work = [&](int64_t lo, int64_t hi) {
        Scratch sc;
        SymScratch sy;
        sy.grp.resize((size_t)n_groups);
        sy.slot.resize((size_t)n_groups);
        for (int64_t i = lo; i < hi; i++) {
            decode_one(s, pkt_data + pkt_start[i], pkt_end[i] - pkt_start[i],
                       i, o, sc, &so, &sy);
        }
    };

    run_threads(work, n_pkts, n_threads, cpu_ns);
    return 0;
}

// Delta block-pack s16 PCM unpack (wire format: ops/pcm_pack.py).
// Blocks of 128 zigzagged second-difference values, LSB-first bit-packed
// at the per-block width W[widx[b]]; rice blocks (widx bit 7) pack only
// the k = W[widx[b]] low bits there and carry the high parts in a shared
// unary section after the planes (q zeros + a 1 terminator per sample,
// channel cuts in ch_ubit). Double prefix-sum restores the samples.
// Threaded per channel (each channel's byte region is found by a prefix
// walk over its blocks' widths; its unary region comes from ch_ubit).
// The caller must provide 8 readable bytes past data+nbytes (unaligned
// 64-bit loads in both the plane and unary scanners).
int vp_unpack_pcm(const uint8_t* data, int64_t nbytes, const uint8_t* widx,
                  int64_t nbt, int64_t C, int64_t L,
                  const uint32_t* ch_ubit, int16_t* out, int n_threads) {
    // must match ops/pcm_pack.py WIDTHS (fine rungs at the measured
    // width histogram's mass, coarse escape rungs above)
    static const int W[12] = {0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 18};
    if (C <= 0 || nbt % C != 0) return -1;
    int64_t NB = nbt / C;
    if (NB * 128 < L) return -1;
    // per-channel byte offsets (blocks are laid out channel-major);
    // widx byte: bits 0-4 width index, bit 5 = third-difference flag,
    // bit 6 = inter, bit 7 = rice
    bool any_rice = false;
    std::vector<int64_t> ch_off(C + 1, 0);
    for (int64_t c = 0; c < C; c++) {
        int64_t bytes = 0;
        for (int64_t b = 0; b < NB; b++) {
            uint8_t wb = widx[c * NB + b];
            uint8_t wi = wb & 0x1F;
            if (wi > 11) return -2;
            if (wb & 0x80) any_rice = true;
            bytes += 16 * W[wi];
        }
        ch_off[c + 1] = ch_off[c] + bytes;
    }
    if (ch_off[C] > nbytes) return -3;
    int64_t ubits = 0;
    if (ch_ubit) {
        for (int64_t c = 0; c < C; c++) {
            if ((int64_t)ch_ubit[c] < ubits) return -5;  // not monotonic
            ubits = (int64_t)ch_ubit[c];
        }
    }
    if (any_rice && !ch_ubit) return -6;
    if (ch_off[C] + 4 * ((ubits + 31) / 32) > nbytes) return -3;
    const uint8_t* ubase = data + ch_off[C];
    std::atomic<int> err{0};

    // unary scanner: gap-to-next-terminator with a hard segment bound so
    // a corrupt stream fails loudly instead of desyncing into the next
    // channel's bits (returns -1 past the limit)
    struct UnaryScan {
        const uint8_t* base;
        int64_t pos, limit;
        inline int64_t next() {
            int64_t q = 0;
            for (;;) {
                if (pos >= limit) return -1;
                uint64_t w8;
                std::memcpy(&w8, base + (pos >> 3), 8);
                w8 >>= (pos & 7);
                if (w8) {
                    int t = __builtin_ctzll(w8);
                    if (pos + t >= limit) return -1;
                    pos += t + 1;
                    return q + t;
                }
                int adv = 64 - (int)(pos & 7);
                q += adv;
                pos += adv;
            }
        }
    };

    // One channel: ld2 = current d2, acc1 = current d1, acc2 = current
    // sample. Order-2 blocks set ld2 directly; order-3 blocks accumulate
    // their d3 values into it. Inter blocks first add the pair partner's
    // same-order difference (d2out/d2in stash the partner's d2 stream).
    // The per-block flag combination dispatches to a specialized inner
    // loop so the sample loop carries no branches (single-core hosts pay
    // for every one).
    struct ChState {
        int64_t acc1 = 0, acc2 = 0, ld2 = 0;
    };
    auto decode_ch = [&](int64_t c, int32_t* d2out, const int32_t* d2in) {
        const uint8_t* p = data + ch_off[c];
        ChState st;
        UnaryScan un{ubase, ch_ubit && c ? (int64_t)ch_ubit[c - 1] : 0,
                     ch_ubit ? (int64_t)ch_ubit[c] : 0};
        bool fail = false;
        int16_t* dst = out + c * L;
#ifdef VP_UNPACK_AVX512
        (void)st;
        std::integral_constant<bool, false> F;
        std::integral_constant<bool, true> T;
        int32_t a1 = 0, a2 = 0, l2 = 0;
        alignas(64) int32_t qv[128];
        for (int64_t b = 0; b < NB; b++) {
            uint8_t wb = widx[c * NB + b];
            int wi = wb & 0x1F;
            bool ord3 = wb & 0x20;
            bool inter = (wb & 0x40) && d2in;
            bool rice = wb & 0x80;
            int64_t base = b * 128;
            if (rice) {
                // pre-scan this block's 128 unary high parts (same
                // scanner + fail semantics as the scalar path)
                for (int i = 0; i < 128; i++) {
                    int64_t qq = un.next();
                    if (qq < 0) { fail = true; qq = 0; }
                    qv[i] = (int32_t)qq;
                }
            }
            auto call = [&](auto o3, auto in, auto stv, auto rc_) {
                vp_block_avx512<decltype(o3)::value, decltype(in)::value,
                                decltype(stv)::value,
                                decltype(rc_)::value>(
                    p, wi, qv, d2in, d2out, base, L, dst, a1, a2, l2);
            };
            // same flag -> specialization mapping as the scalar dispatch
            if (d2out) {
                if (rice) { if (ord3) call(T, F, T, T); else call(F, F, T, T); }
                else      { if (ord3) call(T, F, T, F); else call(F, F, T, F); }
            } else if (inter) {
                if (rice) { if (ord3) call(T, T, F, T); else call(F, T, F, T); }
                else      { if (ord3) call(T, T, F, F); else call(F, T, F, F); }
            } else {
                if (rice) { if (ord3) call(T, F, F, T); else call(F, F, F, T); }
                else      { if (ord3) call(T, F, F, F); else call(F, F, F, F); }
            }
            if (rice)
                un.pos = (un.pos + 31) & ~(int64_t)31;
            p += 16 * W[wi];
        }
#else
        auto run_block = [&](auto ord3_t, auto inter_t, auto stash_t,
                             auto rice_t, int w, int64_t base) {
            constexpr bool ORD3 = decltype(ord3_t)::value;
            constexpr bool INTER = decltype(inter_t)::value;
            constexpr bool STASH = decltype(stash_t)::value;
            constexpr bool RICE = decltype(rice_t)::value;
            uint32_t mask = (1u << w) - 1;
            int64_t acc1 = st.acc1, acc2 = st.acc2, ld2 = st.ld2;
            int64_t nstore = L - base;
            if (nstore > 128) nstore = 128;
            if (nstore < 0) nstore = 0;
            int16_t* d = dst + base;
            for (int64_t i = 0; i < 128; i++) {
                uint64_t v = 0;
                if (w) {
                    int64_t bit = i * w;
                    uint64_t v8;
                    std::memcpy(&v8, p + (bit >> 3), 8);  // block >=16B
                    v = (uint32_t)(v8 >> (bit & 7)) & mask;
                }
                if (RICE) {
                    int64_t qq = un.next();
                    if (qq < 0) { fail = true; qq = 0; }
                    v |= (uint64_t)qq << w;
                }
                int64_t dd = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
                if (INTER) {
                    int64_t s = base + i;
                    if (ORD3)
                        dd += (int64_t)d2in[s] - (s ? (int64_t)d2in[s - 1] : 0);
                    else
                        dd += d2in[s];
                }
                if (ORD3) ld2 += dd; else ld2 = dd;
                if (STASH) d2out[base + i] = (int32_t)ld2;
                acc1 += ld2;
                acc2 += acc1;
                if (i < nstore) d[i] = (int16_t)acc2;
            }
            st.acc1 = acc1; st.acc2 = acc2; st.ld2 = ld2;
        };
        std::integral_constant<bool, false> F;
        std::integral_constant<bool, true> T;
        for (int64_t b = 0; b < NB; b++) {
            uint8_t wb = widx[c * NB + b];
            int w = W[wb & 0x1F];
            bool ord3 = wb & 0x20;
            bool inter = (wb & 0x40) && d2in;
            int64_t base = b * 128;
            auto dispatch = [&](auto rice_t) {
                if (d2out) {
                    if (ord3) run_block(T, F, T, rice_t, w, base);
                    else run_block(F, F, T, rice_t, w, base);
                } else if (inter) {
                    if (ord3) run_block(T, T, F, rice_t, w, base);
                    else run_block(F, T, F, rice_t, w, base);
                } else {
                    if (ord3) run_block(T, F, F, rice_t, w, base);
                    else run_block(F, F, F, rice_t, w, base);
                }
            };
            if (wb & 0x80) {
                dispatch(T);
                // each rice block's unary segment is padded to a u32
                // word boundary (block-local device construction)
                un.pos = (un.pos + 31) & ~(int64_t)31;
            } else {
                dispatch(F);
            }
            p += 16 * w;
        }
#endif  // VP_UNPACK_AVX512
        // a valid stream's cursor lands exactly on the channel cut; a
        // short segment (missing terminators) is a corrupt wire
        if (ch_ubit && un.pos != (int64_t)ch_ubit[c]) fail = true;
        if (fail) err.store(-5, std::memory_order_relaxed);
    };
    // channels decode per UNIT — a (stash, dependent) pair or a singleton
    // (the inter candidates reference the partner's d2 stream). Pairing
    // must match ops/pcm_pack.py pair_partner (_PARTNERS): the 3/5/6/7/8
    // spec channel orders interleave center/LFE with the correlated L/R
    // and surround pairs, so those counts pair (0,2), (3,4) and — for 8
    // channels — (5,6); every other count pairs adjacently. Threading
    // splits across units.
    struct Unit { int a; int b; };  // b = -1 for singletons
    std::vector<Unit> units;
    {
        std::vector<int> partner(C, -1);
        if (C == 3) { partner[2] = 0; }
        else if (C >= 5 && C <= 7) { partner[2] = 0; partner[4] = 3; }
        else if (C == 8) { partner[2] = 0; partner[4] = 3; partner[6] = 5; }
        else for (int64_t c = 1; c < C; c += 2) partner[c] = (int)(c - 1);
        std::vector<char> used(C, 0);
        for (int64_t c = 0; c < C; c++)
            if (partner[c] >= 0) {
                units.push_back({partner[c], (int)c});
                used[partner[c]] = used[c] = 1;
            }
        for (int64_t c = 0; c < C; c++)
            if (!used[c]) units.push_back({(int)c, -1});
    }
    int64_t NP = (int64_t)units.size();
    auto work = [&](int64_t p0, int64_t p1) {
        std::vector<int32_t> d2buf;
        for (int64_t p = p0; p < p1; p++) {
            Unit u = units[(size_t)p];
            if (u.b >= 0) {
                d2buf.resize((size_t)(NB * 128));
                decode_ch(u.a, d2buf.data(), nullptr);
                decode_ch(u.b, nullptr, d2buf.data());
            } else {
                decode_ch(u.a, nullptr, nullptr);
            }
        }
    };
    if (n_threads <= 1 || NP == 1) {
        work(0, NP);
    } else {
        std::vector<std::thread> threads;
        int nt = n_threads < (int)NP ? n_threads : (int)NP;
        int64_t chunk = (NP + nt - 1) / nt;
        for (int t = 0; t < nt; t++) {
            int64_t lo = t * chunk, hi = lo + chunk < NP ? lo + chunk : NP;
            if (lo >= hi) break;
            threads.emplace_back(work, lo, hi);
        }
        for (auto& th : threads) th.join();
    }
    return err.load();
}

}  // extern "C"

// ============================================================ plan and gather
//
// Pass 1 of the batch front end (its numpy twin: frames.py
// build_plan_from_scan) from the Ogg scan's arrays, and the per-bucket
// gather after pass 2 (frames.py _gather_buckets calls it). Both run on
// the calling thread; through ctypes, without the interpreter lock.

namespace {

// int64 arithmetic that wraps as numpy's does (no signed overflow)
inline int64_t wadd(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a + (uint64_t)b);
}
inline int64_t wsub(int64_t a, int64_t b) {
    return (int64_t)((uint64_t)a - (uint64_t)b);
}

// One resync-free chain, frames [a, b), for the dominant stream shape:
// every granule anchor agrees with the window math bar an end trim on the
// final frame. Offsets, prime/final and the kept range (seg[0] == seg[1]:
// none); false where the granules ask for the exact per-frame layout
// (frames.py _lay_out_chain: start trims or offsets, gaps, forward jumps,
// a trim before the final frame, a cut past the chain start).
bool lay_out_chain_fast(int64_t a, int64_t b, int64_t& base,
                        const int64_t* n, const int64_t* le, const int64_t* re,
                        const int64_t* g, int64_t* off, uint8_t* prime,
                        uint8_t* fin, int64_t* seg) {
    off[a] = wsub(base, n[a] / 2);
    for (int64_t j = a + 1; j < b; j++)
        off[j] = wadd(off[j - 1], wsub(re[j - 1], le[j]));
    const int64_t c0 = wadd(off[a], n[a] / 2);
    const int64_t end = wadd(off[b - 1], n[b - 1] / 2);
    int64_t last = -1, cut = 0;
    for (int64_t j = a; j < b; j++) {
        if (g[j] < 0) continue;
        int64_t emis = wsub(wadd(off[j], n[j] / 2), c0);
        // the first anchor must imply a start at 0; every anchor but the
        // last must sit where the window math puts it
        if (last < 0 && g[j] != emis) return false;
        if (last >= 0 && cut != 0) return false;
        cut = wsub(emis, g[j]);
        last = j;
    }
    if (cut < 0) return false;                    // forward jump at the end
    if (cut > 0 && last != b - 1) return false;   // trim not on the final frame
    int64_t keep_end = wsub(end, cut);
    if (keep_end < base) return false;            // cut past the chain start
    for (int64_t j = a; j < b; j++) prime[j] = fin[j] = 0;
    prime[a] = 1;
    fin[b - 1] = 1;
    seg[0] = base;
    seg[1] = keep_end > base ? keep_end : base;
    base = end;
    return true;
}

}  // namespace

extern "C" {

// Pass 1 from the Ogg scan's arrays (packet i: blob[offs[i]:offs[i+1]],
// granules[i], flags[i] bit0 resync, bit1 EOS): the cut after the first
// EOS packet, the mode-header parse, the decodability filter, the chain
// split at resync packets, the fast chain layout and the buckets in order
// of first appearance. win[combo*4 ..] = n, left_start, left_end,
// right_end of combo = mode*4 + prev*2 + next.
//
// Per frame (capacity n_pkts - first_audio): its packet span, window
// geometry, offset, prime and final; perm: the frames bucket after bucket,
// in frame order within one, bucket k being perm[bstart[k]:bstart[k+1]]
// and its combo bcombo[k] (capacity n_modes*4); chains [chain[k],
// chain[k+1]) with kept range seg[2k], seg[2k+1]; counts = frames,
// chains, buckets, total_len.
//
// Returns 0, 1 where a chain needs the exact layout (the caller plans the
// stream in numpy), -1 for an audio packet's mode index out of bounds,
// -2 for bad arguments.
int vp_plan_scan(const uint8_t* blob, int64_t blob_len, const int64_t* offs,
                 const int64_t* granules, const uint8_t* flags,
                 int64_t n_pkts, int64_t first_audio, int64_t mode_bits,
                 int64_t n_modes, const uint8_t* block_flag,
                 const int64_t* win, int64_t* f_start, int64_t* f_end,
                 int64_t* f_n, int64_t* f_ls, int64_t* f_le, int64_t* f_re,
                 int64_t* f_off, uint8_t* f_prime, uint8_t* f_final,
                 int64_t* perm, int64_t* bstart, int32_t* bcombo,
                 int64_t* chain, int64_t* seg, int64_t* counts) {
    if (mode_bits < 0 || mode_bits > 8 || n_modes < 1 || n_modes > 64)
        return -2;
    int64_t P = n_pkts - first_audio;
    if (P < 0) P = 0;
    for (int64_t i = 0; i < P; i++)
        if (flags[first_audio + i] & 2) { P = i + 1; break; }
    const int64_t mask = ((int64_t)1 << mode_bits) - 1;
    std::vector<int32_t> combo((size_t)P);
    std::vector<int64_t> g((size_t)P);
    int64_t F = 0, n_chains = 0;
    bool resync = false;
    for (int64_t i = 0; i < P; i++) {
        const int64_t p = first_audio + i;
        if (flags[p] & 1) resync = true;
        const int64_t s = offs[p], len = offs[p + 1] - offs[p];
        if (len <= 0) continue;
        if (s < 0 || s + len > blob_len) return -2;
        const int64_t v = blob[s] | (len > 1 ? blob[s + 1] << 8 : 0);
        if (v & 1) continue;  // not an audio packet
        const int64_t m = (v >> 1) & mask;
        if (m >= n_modes) return -1;
        if (1 + mode_bits + (block_flag[m] ? 2 : 0) > 8 * len)
            continue;  // window flags truncated: undecodable
        int64_t pf = 0, nf = 0;
        if (block_flag[m]) {
            pf = (v >> (1 + mode_bits)) & 1;
            nf = (v >> (2 + mode_bits)) & 1;
        }
        if (F == 0 || resync) chain[n_chains++] = F;
        resync = false;
        const int32_t c = (int32_t)(m * 4 + pf * 2 + nf);
        combo[(size_t)F] = c;
        g[(size_t)F] = granules[p];
        f_start[F] = s;
        f_end[F] = s + len;
        f_n[F] = win[c * 4];
        f_ls[F] = win[c * 4 + 1];
        f_le[F] = win[c * 4 + 2];
        f_re[F] = win[c * 4 + 3];
        F++;
    }
    chain[n_chains] = F;

    int64_t base = 0;
    for (int64_t k = 0; k < n_chains; k++) {
        if (!lay_out_chain_fast(chain[k], chain[k + 1], base, f_n, f_le,
                                f_re, g.data(), f_off, f_prime, f_final,
                                seg + 2 * k))
            return 1;
    }

    // buckets in order of first appearance; frames in order within each
    std::vector<int32_t> bucket_of((size_t)n_modes * 4, -1);
    std::vector<int64_t> fill;
    int64_t nb = 0;
    for (int64_t f = 0; f < F; f++) {
        int32_t& b = bucket_of[(size_t)combo[(size_t)f]];
        if (b < 0) {
            b = (int32_t)nb++;
            bcombo[b] = combo[(size_t)f];
            fill.push_back(0);
        }
        fill[(size_t)b]++;
    }
    bstart[0] = 0;
    for (int64_t b = 0; b < nb; b++) {
        bstart[b + 1] = bstart[b] + fill[(size_t)b];
        fill[(size_t)b] = bstart[b];
    }
    for (int64_t f = 0; f < F; f++)
        perm[fill[(size_t)bucket_of[(size_t)combo[(size_t)f]]]++] = f;

    counts[0] = F;
    counts[1] = n_chains;
    counts[2] = nb;
    counts[3] = base > 1 ? base : 1;
    return 0;
}

// The packet decode's per-frame outputs (vp_decode_packets[_sym], frame i
// = packet i) gathered into per-bucket arrays: bucket k holds frames
// perm[bstart[k]:bstart[k+1]] of mode bmode[k], and each of its arrays
// lies contiguous after the previous bucket's, rows in frame order.
//
// - meta is checked against the plan (ok, and the bucket's mode, on every
//   frame); audio_bits[i] = meta[i, 4] in frame order.
// - o_off/o_prime/o_final: each bucket's frames' offset (int32), prime
//   and final.
// - floors: job j = jobs[7j ..] = bucket, floor type, width (posts or
//   order), first channel in chs, channel count nc, element offset of its
//   [F_k, nc, width] block in o_posts/o_step2/o_ys (type 1) or o_f0c
//   (type 0), and of its [F_k, nc] block in o_used and o_f0a.
// - symbols (syms non-null): bucket k has bgroups[k] groups, group g
//   nsym[k*n_groups + g] symbols a partition. o_pc gets each bucket's
//   [F_k, G_k] applied partitions; o_syms and o_slots each group's
//   stream, group after group and bucket after bucket;
//   o_len[2(k*n_groups + g) ..] their lengths. o_cap bounds both outputs.
//
// Returns 0; 1 where meta disagrees with the plan (at frame *bad, the
// lowest, or at a frame no bucket holds); 2 where a symbol stream is not
// partition-aligned; 3 where the symbol outputs are too small; 4 where an
// offset does not fit int32; -2 for bad arguments.
int vp_gather_buckets(
    int64_t n_frames, int64_t C, const int32_t* meta, const int64_t* perm,
    const int64_t* bstart, const int64_t* bmode, int64_t n_buckets,
    const int64_t* f_off, const uint8_t* f_prime, const uint8_t* f_final,
    int32_t* o_off, uint8_t* o_prime, uint8_t* o_final, int64_t* audio_bits,
    int64_t n_jobs, const int64_t* jobs, const int64_t* chs,
    const int32_t* posts, const uint8_t* step2, const int16_t* ys,
    const uint8_t* used, const float* f0c, int64_t f0_width,
    const int32_t* f0a, int32_t* o_posts, uint8_t* o_step2, int16_t* o_ys,
    uint8_t* o_used, float* o_f0c, int32_t* o_f0a, const uint16_t* syms,
    const uint16_t* slots, const int32_t* sym_counts, int64_t sym_cap,
    int64_t n_groups, const int64_t* bgroups, const int64_t* nsym,
    int32_t* o_pc, uint16_t* o_syms,
    uint16_t* o_slots, int64_t o_cap, int64_t* o_len, int64_t* bad) {
    // the plan: every frame in one bucket, its packet decoded in its mode
    std::vector<uint8_t> seen((size_t)n_frames, 0);
    int64_t first_bad = n_frames;
    for (int64_t k = 0; k < n_buckets; k++) {
        for (int64_t r = bstart[k]; r < bstart[k + 1]; r++) {
            int64_t f = perm[r];
            if (f < 0 || f >= n_frames) return -2;
            seen[(size_t)f] = 1;
            const int32_t* m = meta + f * 5;
            if ((m[0] != 1 || m[1] != bmode[k]) && f < first_bad)
                first_bad = f;
        }
    }
    for (int64_t f = 0; f < first_bad; f++)
        if (!seen[(size_t)f]) { first_bad = f; break; }
    if (first_bad < n_frames) {
        *bad = first_bad;
        return 1;
    }
    for (int64_t f = 0; f < n_frames; f++) audio_bits[f] = meta[f * 5 + 4];

    for (int64_t r = 0; r < bstart[n_buckets]; r++) {
        int64_t f = perm[r];
        if (f_off[f] < INT32_MIN || f_off[f] > INT32_MAX) return 4;
        o_off[r] = (int32_t)f_off[f];
        o_prime[r] = f_prime[f] != 0;
        o_final[r] = f_final[f] != 0;
    }

    for (int64_t j = 0; j < n_jobs; j++) {
        const int64_t* jb = jobs + 7 * j;
        const int64_t k = jb[0], ftype = jb[1], w = jb[2], nc = jb[4];
        const int64_t* ch = chs + jb[3];
        int64_t at = jb[5], uat = jb[6];
        for (int64_t r = bstart[k]; r < bstart[k + 1]; r++) {
            const int64_t f = perm[r];
            for (int64_t ci = 0; ci < nc; ci++, at += w, uat++) {
                const int64_t fc = f * C + ch[ci];
                o_used[uat] = used[fc] != 0;
                if (ftype == 1) {
                    std::memcpy(o_posts + at, posts + fc * 65, 4 * (size_t)w);
                    std::memcpy(o_ys + at, ys + fc * 65, 2 * (size_t)w);
                    const uint8_t* s2 = step2 + fc * 65;
                    for (int64_t q = 0; q < w; q++)
                        o_step2[at + q] = s2[q] != 0;
                } else {
                    std::memcpy(o_f0c + at, f0c + fc * f0_width,
                                4 * (size_t)w);
                    o_f0a[uat] = f0a[fc];
                }
            }
        }
    }
    if (!syms) return 0;

    // each bucket: its group streams' lengths, then one pass over its
    // frames' rows (group-major, syms and slots each with its own cursor:
    // decode_one's flush) appending to every group's stream
    int64_t spos = 0, ppos = 0, pcpos = 0;
    std::vector<int64_t> sat((size_t)n_groups), pat((size_t)n_groups);
    for (int64_t k = 0; k < n_buckets; k++) {
        const int64_t G = bgroups[k];
        const int64_t* ns = nsym + k * n_groups;
        if (G > n_groups) return -2;
        std::fill(sat.begin(), sat.end(), 0);
        std::fill(pat.begin(), pat.end(), 0);
        for (int64_t r = bstart[k]; r < bstart[k + 1]; r++) {
            const int32_t* cnt = sym_counts + perm[r] * n_groups;
            for (int64_t gi = 0; gi < G; gi++) {
                // numpy's integer remainder and quotient by 0 give 0
                if (ns[gi] && cnt[gi] % ns[gi]) return 2;
                sat[(size_t)gi] += cnt[gi];
                pat[(size_t)gi] += ns[gi] ? cnt[gi] / ns[gi] : 0;
            }
        }
        for (int64_t gi = 0; gi < G; gi++) {
            int64_t* len = o_len + 2 * (k * n_groups + gi);
            len[0] = sat[(size_t)gi];
            len[1] = pat[(size_t)gi];
            sat[(size_t)gi] = spos;  // now each stream's write cursor
            pat[(size_t)gi] = ppos;
            spos += len[0];
            ppos += len[1];
        }
        if (spos > o_cap || ppos > o_cap) return 3;
        for (int64_t r = bstart[k]; r < bstart[k + 1]; r++) {
            const int64_t f = perm[r];
            const int32_t* cnt = sym_counts + f * n_groups;
            const uint16_t* srow = syms + f * sym_cap;
            const uint16_t* prow = slots + f * sym_cap;
            for (int64_t gi = 0; gi < G; gi++) {
                const int64_t c = cnt[gi], pc = ns[gi] ? c / ns[gi] : 0;
                std::memcpy(o_syms + sat[(size_t)gi], srow, 2 * (size_t)c);
                std::memcpy(o_slots + pat[(size_t)gi], prow, 2 * (size_t)pc);
                sat[(size_t)gi] += c;
                pat[(size_t)gi] += pc;
                srow += c;
                prow += pc;
                o_pc[pcpos++] = (int32_t)pc;
            }
        }
    }
    return 0;
}

}  // extern "C"

// ===================================================================== ogg scan
//
// Sequential Ogg physical-layer scan + packet assembly for ONE logical
// stream, mirroring ogg/page.py (capture scan, CRC verify, resync) and
// ogg/logical.py (sequence-gap resync, packet assembly across pages,
// granule/EOS attribution). Whole-buffer input; used by the batch front end
// (the streaming/seeking paths keep the Python implementation).

namespace {

struct OggCrc {
    uint32_t table[256];
    OggCrc() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t r = i << 24;
            for (int j = 0; j < 8; j++)
                r = (r << 1) ^ ((r & 0x80000000u) ? 0x04c11db7u : 0u);
            table[i] = r;
        }
    }
    uint32_t compute(const uint8_t* d, int64_t n, const uint8_t* zero_at,
                     int64_t zero_len) const {
        uint32_t crc = 0;
        for (int64_t i = 0; i < n; i++) {
            uint8_t b = d[i];
            if (zero_at && d + i >= zero_at && d + i < zero_at + zero_len)
                b = 0;
            crc = (crc << 8) ^ table[((crc >> 24) ^ b) & 0xff];
        }
        return crc;
    }
};

struct OggPageView {
    int64_t offset;
    uint8_t flags;
    int64_t granule;
    uint32_t serial;
    uint32_t sequence;
    const uint8_t* payload;
    int64_t body_len;
    int64_t page_size;
    // packet slices
    int64_t starts[256];
    int64_t lens[256];
    int n_slices;
    bool continues_packet;
    bool last_incomplete;
    bool is_resync;
};

inline uint32_t rd32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}
inline int64_t rd64(const uint8_t* p) {
    int64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

// parse+verify a candidate page at data[off]; returns page_size or -1
int64_t try_page(const OggCrc& crc, const uint8_t* data, int64_t len,
                 int64_t off, OggPageView& pg) {
    if (len - off < 27) return -1;
    const uint8_t* p = data + off;
    if (std::memcmp(p, "OggS", 4) != 0 || p[4] != 0) return -1;
    int nsegs = p[26];
    int64_t hdr_len = 27 + nsegs;
    if (len - off < hdr_len) return -1;
    int64_t body = 0;
    for (int i = 0; i < nsegs; i++) body += p[27 + i];
    int64_t total = hdr_len + body;
    if (len - off < total) return -1;
    uint32_t want = rd32(p + 22);
    if (crc.compute(p, total, p + 22, 4) != want) return -1;

    pg.offset = off;
    pg.flags = p[5];
    pg.granule = rd64(p + 6);
    pg.serial = rd32(p + 14);
    pg.sequence = rd32(p + 18);
    pg.payload = p + hdr_len;
    pg.body_len = body;
    pg.page_size = total;
    pg.n_slices = 0;
    int64_t pos = 0, cur = 0;
    bool last255 = false;
    for (int i = 0; i < nsegs; i++) {
        cur += p[27 + i];
        last255 = p[27 + i] == 255;
        if (!last255) {
            pg.starts[pg.n_slices] = pos;
            pg.lens[pg.n_slices] = cur;
            pg.n_slices++;
            pos += cur;
            cur = 0;
        }
    }
    pg.last_incomplete = false;
    if (cur > 0 || (nsegs > 0 && last255)) {
        pg.starts[pg.n_slices] = pos;
        pg.lens[pg.n_slices] = cur;
        pg.n_slices++;
        pg.last_incomplete = true;
    }
    pg.continues_packet = (pg.flags & 0x01) != 0;
    return total;
}

}  // namespace

extern "C" {

// Scan one logical stream's packets out of an Ogg byte buffer.
//
//   serial_wanted: -1 => first BOS serial encountered
//   outputs: packet payload bytes appended into pkt_blob (caller-allocated,
//   len bytes always suffices); pkt_off[n+1] prefix offsets; per packet
//   granule (i64, -1 = none) and flags (bit0 resync, bit1 eos).
//
// Returns the packet count, or a negative error (-2 buffer too small,
// -3 granule regression — caller falls back to the Python layer which
// raises the spec-mandated error).
int64_t vp_scan_ogg(const uint8_t* data, int64_t len, int64_t serial_wanted,
                    uint8_t* pkt_blob, int64_t blob_cap, int64_t* pkt_off,
                    int64_t* pkt_granule, uint8_t* pkt_flags,
                    int64_t max_pkts, int64_t* out_serial) {
    OggCrc crc;
    // pass 1: collect this serial's pages (views into `data`)
    std::vector<OggPageView> pages;
    int64_t scan = 0;
    bool pending_resync = false;
    bool have_serial = serial_wanted >= 0;
    uint32_t serial = (uint32_t)serial_wanted;
    bool saw_eos = false;
    int64_t max_seq = -1;
    int64_t max_granule = -1;
    while (scan < len && !saw_eos) {
        // find capture pattern
        const void* hit = std::memchr(data + scan, 'O', (size_t)(len - scan));
        if (!hit) break;
        int64_t off = (const uint8_t*)hit - data;
        if (len - off < 4) break;
        if (std::memcmp(data + off, "OggS", 4) != 0) {
            if (off != scan) pending_resync = true;
            scan = off + 1;
            pending_resync = true;
            continue;
        }
        if (off != scan) pending_resync = true;
        OggPageView pg;
        int64_t size = try_page(crc, data, len, off, pg);
        if (size < 0) {
            scan = off + 4;  // skip the failed capture pattern
            pending_resync = true;
            continue;
        }
        scan = off + size;
        pg.is_resync = pending_resync;
        pending_resync = false;
        if (!have_serial) {
            if (!(pg.flags & 0x02)) continue;  // want a BOS page
            serial = pg.serial;
            have_serial = true;
        }
        if (pg.serial != serial) continue;
        // sequence-gap resync + granule monotonicity (ogg/logical.py:88-99)
        if (max_seq >= 0 && (int64_t)pg.sequence != max_seq + 1)
            pg.is_resync = true;
        max_seq = (int64_t)pg.sequence;
        if (pg.granule >= 0) {
            if (pg.granule < max_granule && !pg.is_resync) return -3;
            if (pg.granule > max_granule) max_granule = pg.granule;
        }
        if (pg.flags & 0x04) saw_eos = true;
        pages.push_back(pg);
    }
    if (out_serial) *out_serial = have_serial ? (int64_t)serial : -1;

    // pass 2: assemble packets (ogg/logical.py PacketProvider semantics)
    int64_t n_pkts = 0;
    int64_t blob_pos = 0;
    pkt_off[0] = 0;
    bool carry_resync = false;
    size_t pi = 0;
    int packet_cursor = 0;
    while (pi < pages.size()) {
        const OggPageView& meta = pages[pi];
        if (meta.is_resync && packet_cursor == 0) carry_resync = true;
        int n_starts = meta.n_slices - ((meta.continues_packet && meta.n_slices) ? 1 : 0);
        if (packet_cursor >= n_starts) {
            pi++;
            packet_cursor = 0;
            continue;
        }
        int slice_idx = packet_cursor + (meta.continues_packet ? 1 : 0);
        if (slice_idx >= meta.n_slices) break;  // truncated at end of stream
        // follow continuations
        size_t end_pi = pi;
        int end_slice = slice_idx;
        int64_t total_len = pages[end_pi].lens[end_slice];
        bool lost = false, truncated = false;
        while (end_slice == pages[end_pi].n_slices - 1 &&
               pages[end_pi].last_incomplete) {
            if (end_pi + 1 >= pages.size()) { truncated = true; break; }
            const OggPageView& nxt = pages[end_pi + 1];
            if (!nxt.continues_packet || nxt.is_resync) { lost = true; break; }
            end_pi++;
            end_slice = 0;
            total_len += nxt.lens[0];
        }
        packet_cursor++;
        if (truncated) break;
        if (lost) { carry_resync = true; continue; }
        if (n_pkts >= max_pkts || blob_pos + total_len > blob_cap) return -2;
        // copy the parts
        {
            const OggPageView& first = pages[pi];
            std::memcpy(pkt_blob + blob_pos, first.payload + first.starts[slice_idx],
                        (size_t)first.lens[slice_idx]);
            int64_t w = first.lens[slice_idx];
            for (size_t q = pi + 1; q <= end_pi; q++) {
                std::memcpy(pkt_blob + blob_pos + w,
                            pages[q].payload + pages[q].starts[0],
                            (size_t)pages[q].lens[0]);
                w += pages[q].lens[0];
            }
            blob_pos += total_len;
        }
        const OggPageView& endp = pages[end_pi];
        int last_completing = endp.n_slices - (endp.last_incomplete ? 2 : 1);
        bool is_last_completed = end_slice == last_completing;
        int64_t granule =
            (is_last_completed && endp.granule >= 0) ? endp.granule : -1;
        uint8_t flags = 0;
        if (carry_resync) flags |= 1;
        if ((endp.flags & 0x04) && is_last_completed) flags |= 2;
        carry_resync = false;
        pkt_granule[n_pkts] = granule;
        pkt_flags[n_pkts] = flags;
        n_pkts++;
        pkt_off[n_pkts] = blob_pos;
    }
    return n_pkts;
}

}  // extern "C"
