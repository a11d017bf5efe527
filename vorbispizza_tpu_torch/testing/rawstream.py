"""Hand-crafted Vorbis streams for conformance corners libvorbisenc never
emits: Floor0 (LSP), residue type 0/1, and extreme blocksizes (64/8192 with
block switching).

Mirrors the role of the Xiph conformance vectors (SURVEY.md §4: lsp-test*,
beta-encoder vintages) in an offline environment: streams are built bit-by-
bit from the spec, paged by a Python copy of libogg's paging (``_Pager``:
the same bytes, with no libogg needed), and checked against the float64
scalar decoder (reader.py).

The bit-level writers are the exact inverses of the framework's parsers
(bitstream.py, setup/codebook.py) — Huffman codewords are assigned with the
same canonical algorithm and written branch-first into the LSB-first stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ogg.crc import ogg_crc
from ..setup.codebook import assign_codewords
from ..utils.bits import bit_reverse, ilog

# ------------------------------------------------------------------ bit writer


class BitWriter:
    """LSB-first bit packer (inverse of bitstream.BitReader)."""

    def __init__(self):
        self._bits: int = 0
        self._val: int = 0

    def write(self, value: int, count: int) -> None:
        assert 0 <= value < (1 << count) or count == 0
        self._val |= (value & ((1 << count) - 1)) << self._bits
        self._bits += count

    def write_bytes(self, data: bytes) -> None:
        for b in data:
            self.write(b, 8)

    def bytes(self) -> bytes:
        n = (self._bits + 7) // 8
        return self._val.to_bytes(n, "little") if n else b""


def pack_float(mantissa: int, exponent: int, negative: bool = False) -> int:
    """Vorbis packed float: value = mantissa * 2**(exponent - 788)
    (spec 9.2.2; inverse of utils.bits.float32_unpack)."""
    x = (exponent << 21) | mantissa
    if negative:
        x |= 0x80000000
    return x


# ------------------------------------------------------------------ codebooks


@dataclass
class BookSpec:
    dims: int
    lengths: list[int]  # 0 == unused entry (requires sparse=True)
    # VQ lookup (None minimum => no lookup / scalar context); map_type 1 is
    # the lattice (mults len = lookup1_values), map_type 2 the direct table
    # (mults len = entries*dims — spec 3.2.1, reference Codebook.cs:264-281)
    minimum: int | None = None  # packed float
    delta: int | None = None  # packed float
    value_bits: int = 2
    mults: list[int] | None = None
    sequence_p: int = 0
    sparse: bool = False
    ordered: bool = False
    map_type: int = 1

    @property
    def entries(self) -> int:
        return len(self.lengths)

    def codewords(self) -> list[int]:
        return assign_codewords(self.lengths)

    def write(self, w: BitWriter) -> None:
        w.write(0x564342, 24)  # sync
        w.write(self.dims, 16)
        w.write(self.entries, 24)
        if self.ordered:
            # the ordered coding cannot express skipped lengths (the parser
            # increments cur_len by exactly 1 per run)
            assert all(
                b - a in (0, 1)
                for a, b in zip(self.lengths, self.lengths[1:])
            ), "ordered codebook lengths must be ascending without gaps"
            w.write(1, 1)
            w.write(self.lengths[0] - 1, 5)
            i = 0
            while i < self.entries:
                cur = self.lengths[i]
                j = i
                while j < self.entries and self.lengths[j] == cur:
                    j += 1
                w.write(j - i, ilog(self.entries - i))
                i = j
        else:
            w.write(0, 1)  # not ordered
            w.write(1 if self.sparse else 0, 1)
            for l in self.lengths:
                if self.sparse:
                    if l == 0:
                        w.write(0, 1)
                        continue
                    w.write(1, 1)
                w.write(l - 1, 5)
        if self.minimum is None:
            w.write(0, 4)  # no lookup
        else:
            w.write(self.map_type, 4)
            w.write(self.minimum, 32)
            w.write(self.delta, 32)
            w.write(self.value_bits - 1, 4)
            w.write(self.sequence_p, 1)
            for m in self.mults:
                w.write(m, self.value_bits)

    def write_symbol(self, w: BitWriter, sym: int) -> None:
        codes = self.codewords()
        l = self.lengths[sym]
        w.write(bit_reverse(codes[sym], l), l)


# ------------------------------------------------------------------ headers


def ident_packet(channels: int, rate: int, bs0: int, bs1: int) -> bytes:
    w = BitWriter()
    w.write(0x01, 8)
    w.write_bytes(b"vorbis")
    w.write(0, 32)  # version
    w.write(channels, 8)
    w.write(rate, 32)
    w.write(0, 32)  # bitrate upper
    w.write(0, 32)  # nominal
    w.write(0, 32)  # lower
    w.write(int(np.log2(bs0)), 4)
    w.write(int(np.log2(bs1)), 4)
    w.write(1, 1)  # framing
    return w.bytes()


def comment_packet(vendor: bytes = b"vorbispizza_tpu rawstream") -> bytes:
    w = BitWriter()
    w.write(0x03, 8)
    w.write_bytes(b"vorbis")
    w.write(len(vendor), 32)
    w.write_bytes(vendor)
    w.write(0, 32)  # no comments
    w.write(1, 1)
    return w.bytes()


@dataclass
class Floor0Spec:
    order: int
    rate: int
    bark_map_size: int
    amplitude_bits: int
    amplitude_offset: int
    book_ids: list[int]

    floor_type = 0

    def write(self, w: BitWriter) -> None:
        w.write(0, 16)  # floor type 0
        w.write(self.order, 8)
        w.write(self.rate, 16)
        w.write(self.bark_map_size, 16)
        w.write(self.amplitude_bits, 6)
        w.write(self.amplitude_offset, 8)
        w.write(len(self.book_ids) - 1, 4)
        for b in self.book_ids:
            w.write(b, 8)


@dataclass
class Floor1Spec:
    partition_classes: list[int]
    class_dims: list[int]
    class_subclasses: list[int]
    class_masterbooks: list[int | None]
    subclass_books: list[list[int | None]]
    multiplier: int
    rangebits: int
    xs_extra: list[int]  # X values after the implicit [0, 1 << rangebits]

    floor_type = 1

    def write(self, w: BitWriter) -> None:
        w.write(1, 16)  # floor type 1
        w.write(len(self.partition_classes), 5)
        for c in self.partition_classes:
            w.write(c, 4)
        for c in range(len(self.class_dims)):
            w.write(self.class_dims[c] - 1, 3)
            w.write(self.class_subclasses[c], 2)
            if self.class_subclasses[c] > 0:
                w.write(self.class_masterbooks[c], 8)
            for b in self.subclass_books[c]:
                w.write(0 if b is None else b + 1, 8)
        w.write(self.multiplier - 1, 2)
        w.write(self.rangebits, 4)
        for x in self.xs_extra:
            w.write(x, self.rangebits)


@dataclass
class ResidueSpec:
    rtype: int
    begin: int
    end: int
    partition_size: int
    classifications: int
    classbook: int
    # books[class][pass] (None = absent); cascade bitmap derived
    books: list[list[int | None]]

    def write(self, w: BitWriter) -> None:
        w.write(self.rtype, 16)
        w.write(self.begin, 24)
        w.write(self.end, 24)
        w.write(self.partition_size - 1, 24)
        w.write(self.classifications - 1, 6)
        w.write(self.classbook, 8)
        for row in self.books:
            cascade = 0
            for p, b in enumerate(row):
                if b is not None:
                    cascade |= 1 << p
            w.write(cascade & 7, 3)
            if cascade > 7:
                w.write(1, 1)
                w.write(cascade >> 3, 5)
            else:
                w.write(0, 1)
        for row in self.books:
            for b in row:
                if b is not None:
                    w.write(b, 8)


@dataclass
class MappingSpec:
    submap_floor: list[int]
    submap_residue: list[int]
    coupling_steps: list[tuple[int, int]] = field(default_factory=list)
    mux: list[int] | None = None  # per channel (defaults to all 0)

    def write(self, w: BitWriter, channels: int) -> None:
        w.write(0, 16)  # mapping type 0
        n_sub = len(self.submap_floor)
        if n_sub > 1:
            w.write(1, 1)
            w.write(n_sub - 1, 4)
        else:
            w.write(0, 1)
        if self.coupling_steps:
            w.write(1, 1)
            w.write(len(self.coupling_steps) - 1, 8)
            bits = ilog(channels - 1)
            for m, a in self.coupling_steps:
                w.write(m, bits)
                w.write(a, bits)
        else:
            w.write(0, 1)
        w.write(0, 2)  # reserved
        if n_sub > 1:
            for c in range(channels):
                w.write((self.mux or [0] * channels)[c], 4)
        for s in range(n_sub):
            w.write(0, 8)  # time config placeholder
            w.write(self.submap_floor[s], 8)
            w.write(self.submap_residue[s], 8)


@dataclass
class ModeSpec:
    block_flag: int
    mapping: int = 0

    def write(self, w: BitWriter) -> None:
        w.write(self.block_flag, 1)
        w.write(0, 16)  # window type
        w.write(0, 16)  # transform type
        w.write(self.mapping, 8)


def setup_packet(books, floors, residues, mappings, modes, channels) -> bytes:
    w = BitWriter()
    w.write(0x05, 8)
    w.write_bytes(b"vorbis")
    w.write(len(books) - 1, 8)
    for b in books:
        b.write(w)
    w.write(0, 6)  # one time transform
    w.write(0, 16)
    w.write(len(floors) - 1, 6)
    for f in floors:
        f.write(w)
    w.write(len(residues) - 1, 6)
    for r in residues:
        r.write(w)
    w.write(len(mappings) - 1, 6)
    for m in mappings:
        m.write(w, channels)
    w.write(len(modes) - 1, 6)
    for m in modes:
        m.write(w)
    w.write(1, 1)  # framing
    return w.bytes()


# ------------------------------------------------------------------ paging


class _Pager:
    """libogg's packet-to-page logic (ogg_stream_packetin, ogg_stream_pageout
    and ogg_stream_flush of framing.c) in Python, so raw streams page alike
    on machines without libogg: the same lacing, page breaks, flags,
    granules and CRCs, hence the same bytes."""

    NFILL = 4096  # pageout's fill target (bytes of body)

    def __init__(self, serial: int):
        self.serial = serial
        self.lacing: list[int] = []  # segment sizes, | 0x100 on a packet start
        self.granules: list[int] = []
        self.body = bytearray()
        self.pageno = 0
        self.bos = False  # the first page went out
        self.eos = False
        self.out = bytearray()

    def packetin(self, data: bytes, granule: int, eos: bool) -> None:
        n = len(data)
        segs = n // 255 + 1
        prev = self.granules[-1] if self.granules else 0
        self.lacing += [255] * (segs - 1) + [n % 255]
        self.lacing[-segs] |= 0x100
        self.granules += [prev] * (segs - 1) + [granule]
        self.body += data
        self.eos = self.eos or eos

    def page(self, force: bool) -> bool:
        """Emit one page if libogg's flush rule says so; False when not."""
        maxvals = min(len(self.lacing), 255)
        if maxvals == 0:
            return False
        granule = -1
        if not self.bos:  # the first page holds the first packet alone
            granule = 0
            vals = 0
            while vals < maxvals:
                if (self.lacing[vals] & 0xFF) < 255:
                    vals += 1
                    break
                vals += 1
        else:
            acc = done = just_done = 0
            vals = 0
            while vals < maxvals:
                if acc > self.NFILL and just_done >= 4:
                    force = True
                    break
                acc += self.lacing[vals] & 0xFF
                if (self.lacing[vals] & 0xFF) < 255:
                    granule = self.granules[vals]
                    done += 1
                    just_done = done
                else:
                    just_done = 0
                vals += 1
            if vals == 255:
                force = True
        if not force:
            return False
        flags = 0 if self.lacing[0] & 0x100 else 0x01
        if not self.bos:
            flags |= 0x02
        if self.eos and len(self.lacing) == vals:
            flags |= 0x04
        self.bos = True
        sizes = [v & 0xFF for v in self.lacing[:vals]]
        nbytes = sum(sizes)
        header = bytearray(b"OggS\x00")
        header.append(flags)
        header += (granule & (2**64 - 1)).to_bytes(8, "little")
        header += (self.serial & 0xFFFFFFFF).to_bytes(4, "little")
        header += self.pageno.to_bytes(4, "little")
        header += bytes(4)  # CRC, filled below
        header.append(vals)
        header += bytes(sizes)
        self.pageno += 1
        page = header + self.body[:nbytes]
        page[22:26] = ogg_crc(bytes(page)).to_bytes(4, "little")
        self.out += page
        del self.lacing[:vals], self.granules[:vals], self.body[:nbytes]
        return True

    def pageout(self) -> bool:
        force = (self.eos and bool(self.lacing)) or (
            bool(self.body) and not self.bos
        )
        return self.page(force)


def page_stream(packets: list[tuple[bytes, int]], serial: int = 777) -> bytes:
    """Page packets (data, granulepos) into one logical Ogg stream the way
    libogg does (headers flushed onto their own pages, as encoders do)."""
    pager = _Pager(serial)
    for i, (data, granule) in enumerate(packets):
        pager.packetin(data, granule, eos=i == len(packets) - 1)
        if i == 0 or i == 2:  # ident alone; comment+setup together
            while pager.page(force=True):
                pass
        while pager.pageout():
            pass
    while pager.page(force=True):
        pass
    return bytes(pager.out)


# ------------------------------------------------------------------ streams


def make_floor0_stream(n_packets: int = 40, rate: int = 8000, seed: int = 0):
    """Mono Floor0 (LSP) + residue type 0 stream, blocksize 256."""
    rng = np.random.default_rng(seed)
    n = 256
    half = n // 2

    classbook = BookSpec(dims=2, lengths=[2, 2, 2, 2])
    resbook = BookSpec(
        dims=2, lengths=[2, 2, 2, 2],
        minimum=pack_float(1, 788, negative=True),  # -1.0
        delta=pack_float(1, 788),  # 1.0
        value_bits=1, mults=[0, 1],
    )
    # dims=1 with strictly positive values: the decoder accumulates across
    # vectors, so LSP roots come out ascending and well-separated (coincident
    # roots would make the synthesis denominator blow up — in any decoder)
    lspbook = BookSpec(
        dims=1, lengths=[2, 2, 2, 2],
        minimum=pack_float(1, 786),  # 0.25
        delta=pack_float(1, 785),  # 0.125
        value_bits=2, mults=[0, 1, 2, 3],
    )
    books = [classbook, resbook, lspbook]
    floor = Floor0Spec(
        order=4, rate=rate, bark_map_size=64,
        amplitude_bits=6, amplitude_offset=64, book_ids=[2],
    )
    residue = ResidueSpec(
        rtype=0, begin=0, end=half, partition_size=8,
        classifications=2, classbook=0,
        books=[[1] + [None] * 7, [1] + [None] * 7],
    )
    mapping = MappingSpec(submap_floor=[0], submap_residue=[0])
    mode = ModeSpec(block_flag=0)

    headers = [
        ident_packet(1, rate, n, n),
        comment_packet(),
        setup_packet(books, [floor], [residue], [mapping], [mode], channels=1),
    ]

    packets: list[tuple[bytes, int]] = [(h, 0) for h in headers]
    for k in range(n_packets):
        w = BitWriter()
        w.write(0, 1)  # audio packet (mode bits: ilog(0) == 0 -> none)
        # floor0: amplitude + book number + LSP vectors (order/dims symbols)
        w.write(int(rng.integers(4, 12)), floor.amplitude_bits)
        w.write(0, ilog(len(floor.book_ids)))
        for _ in range(floor.order // lspbook.dims):
            lspbook.write_symbol(w, int(rng.integers(0, 4)))
        # residue type 0: interleaved classwords + 4 symbols per partition
        n_parts = half // residue.partition_size
        cwords = classbook.dims
        pc = 0
        while pc < n_parts:
            classbook.write_symbol(w, int(rng.integers(0, 4)))
            for _ in range(cwords):
                if pc >= n_parts:
                    break
                for _s in range(residue.partition_size // resbook.dims):
                    resbook.write_symbol(w, int(rng.integers(0, 4)))
                pc += 1
        packets.append((w.bytes(), half * k))
    return page_stream(packets)


def make_extreme_blocksize_stream(
    n_packets: int = 30, rate: int = 44100, seed: int = 1, pad_to: int = 0,
    pattern: str = "alternate",
):
    """Mono floor1 + residue type 1 stream with 64/8192 blocksizes —
    the full spec blocksize range in one stream.

    ``pad_to``: zero-pad each audio packet to at least this many bytes
    (trailing bytes are never read by decode); large values force packets
    to span page boundaries (continued packets), the libnogg "split
    packet" / seek-on-continued-packet shapes.

    ``pattern``: "alternate" switches blocks every two packets (every hop
    transition class); "long"/"short" keep one uniform blocksize
    (128-aligned steady-state hop geometry)."""
    rng = np.random.default_rng(seed)
    bs0, bs1 = 64, 8192

    classbook = BookSpec(dims=2, lengths=[2, 2, 2, 2])
    # lattice lookup needs entries == count**dims: 2**4 = 16
    resbook = BookSpec(
        dims=4, lengths=[4] * 16,
        minimum=pack_float(1, 787, negative=True),  # -0.5
        delta=pack_float(1, 787),  # 0.5
        value_bits=1, mults=[0, 1],
    )
    ybook = BookSpec(dims=1, lengths=[2, 2, 2, 2])  # floor1 Y values (scalar)
    books = [classbook, resbook, ybook]

    floor = Floor1Spec(
        partition_classes=[0],
        class_dims=[2],
        class_subclasses=[0],
        class_masterbooks=[None],
        subclass_books=[[2]],
        multiplier=2,
        rangebits=8,
        xs_extra=[64, 160],
    )
    residue = ResidueSpec(
        rtype=1, begin=0, end=32, partition_size=8,
        classifications=2, classbook=0,
        books=[[1] + [None] * 7, [1] + [None] * 7],
    )
    mapping = MappingSpec(submap_floor=[0], submap_residue=[0])
    modes = [ModeSpec(block_flag=0), ModeSpec(block_flag=1)]

    headers = [
        ident_packet(1, rate, bs0, bs1),
        comment_packet(),
        setup_packet(books, [floor], [residue], [mapping], modes, channels=1),
    ]

    # deterministic mode sequence exercising every transition
    if pattern == "long":
        flags = [1] * n_packets
    elif pattern == "short":
        flags = [0] * n_packets
    else:
        flags = [(k // 2) % 2 for k in range(n_packets)]
    packets: list[tuple[bytes, int]] = [(h, 0) for h in headers]
    granule = 0
    for k in range(n_packets):
        bf = flags[k]
        n = bs1 if bf else bs0
        w = BitWriter()
        w.write(0, 1)
        w.write(bf, 1)  # mode index (ilog(1) == 1 bit)
        if bf:
            w.write(1 if k > 0 and flags[k - 1] else 0, 1)  # prev window flag
            w.write(1 if k + 1 < n_packets and flags[k + 1] else 0, 1)  # next
        # floor1: present flag + two 8-bit Y values + class symbols
        w.write(1, 1)
        w.write(int(rng.integers(0, 128)), ilog(floor_range(floor) - 1))
        w.write(int(rng.integers(0, 128)), ilog(floor_range(floor) - 1))
        for _ in range(floor.class_dims[0]):
            ybook.write_symbol(w, int(rng.integers(0, 4)))
        # residue type 1 over [begin, end): classwords + contiguous symbols
        n_parts = (residue.end - residue.begin) // residue.partition_size
        pc = 0
        while pc < n_parts:
            classbook.write_symbol(w, int(rng.integers(0, 4)))
            for _ in range(classbook.dims):
                if pc >= n_parts:
                    break
                for _s in range(residue.partition_size // resbook.dims):
                    resbook.write_symbol(w, int(rng.integers(0, resbook.entries)))
                pc += 1
        # granule: libvorbis center-boundary accounting
        if k > 0:
            granule += (prev_n + n) // 4
        prev_n = n
        body = w.bytes()
        if pad_to > len(body):
            body += b"\x00" * (pad_to - len(body))
        packets.append((body, granule))
    return page_stream(packets)


def floor_range(floor: Floor1Spec) -> int:
    from ..setup.floor import Floor1

    return Floor1.RANGES[floor.multiplier - 1]


def make_multisubmap_stream(n_packets: int = 24, rate: int = 22050, seed: int = 2):
    """Stereo stream with TWO submaps — each channel gets its own floor1
    config and residue — exercising the per-floor-config channel grouping of
    the batch pipeline (a spec-legal layout no mainstream encoder emits)."""
    rng = np.random.default_rng(seed)
    n = 512

    classbook = BookSpec(dims=2, lengths=[2, 2, 2, 2])
    resbook_a = BookSpec(
        dims=2, lengths=[2, 2, 2, 2],
        minimum=pack_float(1, 788, negative=True), delta=pack_float(1, 788),
        value_bits=1, mults=[0, 1],
    )
    resbook_b = BookSpec(
        dims=4, lengths=[4] * 16,
        minimum=pack_float(1, 787, negative=True), delta=pack_float(1, 787),
        value_bits=1, mults=[0, 1],
    )
    ybook = BookSpec(dims=1, lengths=[2, 2, 2, 2])
    books = [classbook, resbook_a, resbook_b, ybook]

    floor_a = Floor1Spec(
        partition_classes=[0], class_dims=[2], class_subclasses=[0],
        class_masterbooks=[None], subclass_books=[[3]],
        multiplier=1, rangebits=7, xs_extra=[32, 96],
    )
    floor_b = Floor1Spec(
        partition_classes=[0, 0], class_dims=[1], class_subclasses=[0],
        class_masterbooks=[None], subclass_books=[[3]],
        multiplier=3, rangebits=8, xs_extra=[128, 64],
    )
    residue_a = ResidueSpec(
        rtype=1, begin=0, end=64, partition_size=8,
        classifications=2, classbook=0,
        books=[[1] + [None] * 7, [1] + [None] * 7],
    )
    residue_b = ResidueSpec(
        rtype=2, begin=0, end=128, partition_size=16,
        classifications=2, classbook=0,
        books=[[2] + [None] * 7, [2] + [None] * 7],
    )
    mapping = MappingSpec(
        submap_floor=[0, 1], submap_residue=[0, 1], mux=[0, 1]
    )
    mode = ModeSpec(block_flag=0)

    headers = [
        ident_packet(2, rate, n, n),
        comment_packet(),
        setup_packet(
            books, [floor_a, floor_b], [residue_a, residue_b], [mapping],
            [mode], channels=2,
        ),
    ]

    def write_floor1(w, floor, ybook):
        w.write(1, 1)
        rng_bits = ilog(floor_range(floor) - 1)
        w.write(int(rng.integers(0, floor_range(floor) // 2)), rng_bits)
        w.write(int(rng.integers(0, floor_range(floor) // 2)), rng_bits)
        for cls in floor.partition_classes:
            for _ in range(floor.class_dims[cls]):
                ybook.write_symbol(w, int(rng.integers(0, ybook.entries)))

    def write_residue(w, residue, book, n_ch, fmt2):
        size = (residue.end - residue.begin) * (n_ch if fmt2 else 1)
        vecs = 1 if fmt2 else n_ch
        n_parts = size // residue.partition_size if fmt2 else (
            (residue.end - residue.begin) // residue.partition_size
        )
        pc = 0
        while pc < n_parts:
            for _j in range(vecs):
                classbook.write_symbol(w, int(rng.integers(0, 4)))
            for _ in range(classbook.dims):
                if pc >= n_parts:
                    break
                for _j in range(vecs):
                    for _s in range(residue.partition_size // book.dims):
                        book.write_symbol(w, int(rng.integers(0, book.entries)))
                pc += 1

    packets: list[tuple[bytes, int]] = [(h, 0) for h in headers]
    for k in range(n_packets):
        w = BitWriter()
        w.write(0, 1)
        write_floor1(w, floor_a, ybook)  # channel 0 (submap 0)
        write_floor1(w, floor_b, ybook)  # channel 1 (submap 1)
        write_residue(w, residue_a, resbook_a, 1, fmt2=False)
        # residue type 2 over one channel == type 1 over its samples
        write_residue(w, residue_b, resbook_b, 1, fmt2=True)
        packets.append((w.bytes(), (n // 2) * k))
    return page_stream(packets)


def make_oddbooks_stream(n_packets: int = 16, rate: int = 16000, seed: int = 4):
    """Mono floor1 stream exercising codebook corner cases the encoder
    never emits: an ORDERED-length residue book, a SPARSE floor book with
    unused entries, and 33 modes (6-bit per-packet mode numbers — the
    libnogg '6-mode-bits' vector analog)."""
    rng = np.random.default_rng(seed)
    n = 256

    classbook = BookSpec(dims=2, lengths=[2, 2, 2, 2])
    # ordered code lengths: canonical assignment over an ascending-length
    # codebook (spec 3.2.1 ordered flag)
    resbook = BookSpec(
        dims=2, lengths=[1, 2, 3, 3],
        minimum=pack_float(1, 788, negative=True), delta=pack_float(1, 788),
        value_bits=1, mults=[0, 1], ordered=True,
    )
    # sparse floor book: 8 entries, only 4 used
    ybook = BookSpec(dims=1, lengths=[2, 0, 2, 0, 2, 0, 2, 0], sparse=True)
    books = [classbook, resbook, ybook]

    floor = Floor1Spec(
        partition_classes=[0], class_dims=[2], class_subclasses=[0],
        class_masterbooks=[None], subclass_books=[[2]],
        multiplier=2, rangebits=7, xs_extra=[32, 96],
    )
    residue = ResidueSpec(
        rtype=1, begin=0, end=64, partition_size=8,
        classifications=2, classbook=0,
        books=[[1] + [None] * 7, [1] + [None] * 7],
    )
    mapping = MappingSpec(submap_floor=[0], submap_residue=[0])
    modes = [ModeSpec(0)] * 33  # ilog(32) == 6 mode bits

    headers = [
        ident_packet(1, rate, n, n),
        comment_packet(),
        setup_packet(books, [floor], [residue], [mapping], modes, channels=1),
    ]
    used_syms = [i for i, l in enumerate(ybook.lengths) if l > 0]
    packets: list[tuple[bytes, int]] = [(h, 0) for h in headers]
    for k in range(n_packets):
        w = BitWriter()
        w.write(0, 1)
        w.write(int(rng.integers(0, 33)), 6)  # any of the 33 modes
        w.write(1, 1)  # floor present
        w.write(int(rng.integers(0, 128)), ilog(floor_range(floor) - 1))
        w.write(int(rng.integers(0, 128)), ilog(floor_range(floor) - 1))
        for _ in range(2):
            ybook.write_symbol(w, int(rng.choice(used_syms)))
        n_parts = 64 // 8
        pc = 0
        while pc < n_parts:
            classbook.write_symbol(w, int(rng.integers(0, 4)))
            for _ in range(2):
                if pc >= n_parts:
                    break
                for _s in range(4):
                    resbook.write_symbol(w, int(rng.integers(0, 4)))
                pc += 1
        packets.append((w.bytes(), 128 * k))
    return page_stream(packets)


def make_lookup2_stream(n_packets: int = 16, rate: int = 16000, seed: int = 5):
    """Mono floor1 stream whose residue book uses LOOKUP TYPE 2 (the direct
    VQ table, spec 3.2.1) with sequence_p set — a spec corner libvorbisenc
    never emits (reference decode path Codebook.cs:264-281). Values land on
    a 0.5 grid, so this also pins the value-transport fallback (symbol
    transport requires integer-valued books)."""
    rng = np.random.default_rng(seed)
    n = 256

    classbook = BookSpec(dims=2, lengths=[2, 2, 2, 2])
    # direct table: mults has entries*dims values; sequence_p accumulates
    # across dims within each entry
    resbook = BookSpec(
        dims=2, lengths=[2, 2, 2, 2],
        minimum=pack_float(1, 787, negative=True),  # -0.5
        delta=pack_float(1, 787),  # 0.5
        value_bits=2, mults=[0, 1, 2, 3, 3, 2, 1, 0],
        sequence_p=1, map_type=2,
    )
    ybook = BookSpec(dims=1, lengths=[2, 2, 2, 2])
    books = [classbook, resbook, ybook]

    floor = Floor1Spec(
        partition_classes=[0], class_dims=[2], class_subclasses=[0],
        class_masterbooks=[None], subclass_books=[[2]],
        multiplier=2, rangebits=7, xs_extra=[32, 96],
    )
    residue = ResidueSpec(
        rtype=1, begin=0, end=64, partition_size=8,
        classifications=2, classbook=0,
        books=[[1] + [None] * 7, [1] + [None] * 7],
    )
    mapping = MappingSpec(submap_floor=[0], submap_residue=[0])
    mode = ModeSpec(0)

    headers = [
        ident_packet(1, rate, n, n),
        comment_packet(),
        setup_packet(books, [floor], [residue], [mapping], [mode], channels=1),
    ]
    packets: list[tuple[bytes, int]] = [(h, 0) for h in headers]
    for k in range(n_packets):
        w = BitWriter()
        w.write(0, 1)
        w.write(1, 1)  # floor present
        w.write(int(rng.integers(0, 128)), ilog(floor_range(floor) - 1))
        w.write(int(rng.integers(0, 128)), ilog(floor_range(floor) - 1))
        for _ in range(2):
            ybook.write_symbol(w, int(rng.integers(0, 4)))
        n_parts = 64 // 8
        pc = 0
        while pc < n_parts:
            classbook.write_symbol(w, int(rng.integers(0, 4)))
            for _ in range(2):
                if pc >= n_parts:
                    break
                for _s in range(4):
                    resbook.write_symbol(w, int(rng.integers(0, 4)))
                pc += 1
        packets.append((w.bytes(), 128 * k))
    return page_stream(packets)
