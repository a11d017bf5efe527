"""Vorbis codebooks: setup parsing, canonical Huffman codeword assignment,
scalar/VQ symbol decode.

Behavior parity with reference NVorbis/Codebook.cs:10 (InitTree:44,
ComputeCodewords:147, InitLookupTable:220, DecodeScalar:300) and
NVorbis/Huffman.cs:8 (prefix acceleration table, MAX_TABLE_BITS=10).
Implemented from the Vorbis I specification sections 3.2.1 and 9.2.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import BitReader
from ..errors import InvalidDataError
from ..utils.bits import float32_unpack, ilog, lookup1_values

_SYNC = 0x564342  # "BCV" little-endian (spec 3.2.1)
PREFIX_BITS = 10  # reference Huffman.MAX_TABLE_BITS (Huffman.cs:12)

# decode_scalar sentinel: end-of-packet / no matching codeword
EOP = -1


def assign_codewords(lengths: list[int]) -> list[int]:
    """Canonical Vorbis codeword assignment (spec 3.2.1 decision step 6):
    each used entry, in order, takes the lowest-valued unused codeword of its
    length. Codewords are MSB-first branch paths.

    Maintains at most one available subtree per depth (the classic stb-style
    invariant; reference Codebook.ComputeCodewords:147-218 is the same
    algorithm). Raises on an over-specified tree; under-specified trees are
    permitted (decode simply never yields the missing leaves) to match the
    reference's tolerance for sparse single-entry books.
    """
    codes = [0] * len(lengths)
    avail: list[int | None] = [None] * 33
    first = True
    for i, l in enumerate(lengths):
        if l <= 0:
            continue
        if l > 32:
            raise InvalidDataError("codeword length > 32")
        if first:
            codes[i] = 0
            for d in range(1, l + 1):
                avail[d] = 1  # sibling subtree 0^(d-1)1 as a d-bit path
            first = False
            continue
        z = l
        while z > 0 and avail[z] is None:
            z -= 1
        if z == 0:
            raise InvalidDataError("over-specified huffman tree")
        root = avail[z]
        avail[z] = None
        codes[i] = root << (l - z)
        for d in range(z + 1, l + 1):
            avail[d] = (root << (d - z)) | 1
    return codes


def _reverse_bits(v: int, n: int) -> int:
    out = 0
    for _ in range(n):
        out = (out << 1) | (v & 1)
        v >>= 1
    return out


class Codebook:
    """One parsed codebook: Huffman decoder + optional VQ lookup table."""

    __slots__ = (
        "dimensions", "entries", "map_type", "lookup_table",
        "_prefix_sym", "_prefix_len", "_overflow", "max_len", "_prefix_mask",
        "code_lengths",
    )

    def __init__(self, br: BitReader):
        if br.read_bits(24) != _SYNC:
            raise InvalidDataError("codebook sync pattern missing")
        self.dimensions = br.read_bits(16)
        self.entries = br.read_bits(24)
        lengths = self._read_lengths(br)
        self._build_decoder(lengths)
        self._read_lookup(br, lengths)

    # -- parse ------------------------------------------------------------------

    def _read_lengths(self, br: BitReader) -> list[int]:
        ordered = br.read_bit()
        lengths = [0] * self.entries
        if not ordered:
            sparse = br.read_bit()
            for i in range(self.entries):
                if sparse:
                    if br.read_bit():
                        lengths[i] = br.read_bits(5) + 1
                else:
                    lengths[i] = br.read_bits(5) + 1
        else:
            cur_entry = 0
            cur_len = br.read_bits(5) + 1
            while cur_entry < self.entries:
                num = br.read_bits(ilog(self.entries - cur_entry))
                if cur_entry + num > self.entries:
                    raise InvalidDataError("ordered codebook overruns entries")
                for i in range(cur_entry, cur_entry + num):
                    lengths[i] = cur_len
                cur_entry += num
                cur_len += 1
                if cur_len > 32:
                    raise InvalidDataError("codeword length overflow")
        if br.overrun:
            raise InvalidDataError("codebook lengths truncated")
        return lengths

    def _build_decoder(self, lengths: list[int]) -> None:
        codes = assign_codewords(lengths)
        self.max_len = max((l for l in lengths if l > 0), default=0)
        # kept for the symbol-wire frequency-rank remap (shorter codeword
        # == more frequent by the encoder's own Huffman construction)
        self.code_lengths = np.asarray(lengths, dtype=np.int32)
        self._prefix_mask = (1 << PREFIX_BITS) - 1
        size = 1 << PREFIX_BITS
        prefix_sym = np.full(size, -1, dtype=np.int32)
        prefix_len = np.zeros(size, dtype=np.int32)
        overflow: dict[int, dict[int, int]] = {}
        for sym, l in enumerate(lengths):
            if l <= 0:
                continue
            rev = _reverse_bits(codes[sym], l)
            if l <= PREFIX_BITS:
                step = 1 << l
                idx = rev
                while idx < size:
                    prefix_sym[idx] = sym
                    prefix_len[idx] = l
                    idx += step
            else:
                overflow.setdefault(l, {})[rev] = sym
        self._prefix_sym = prefix_sym
        self._prefix_len = prefix_len
        # sorted by length so the shortest match wins (prefix-free anyway)
        self._overflow = sorted(overflow.items())

    def _read_lookup(self, br: BitReader, lengths: list[int]) -> None:
        self.map_type = br.read_bits(4)
        self.lookup_table = None
        if self.map_type == 0:
            return
        if self.map_type not in (1, 2):
            raise InvalidDataError(f"bad codebook lookup type {self.map_type}")
        minimum = float32_unpack(br.read_bits(32))
        delta = float32_unpack(br.read_bits(32))
        value_bits = br.read_bits(4) + 1
        sequence_p = br.read_bit()
        if self.map_type == 1:
            count = lookup1_values(self.entries, self.dimensions)
        else:
            count = self.entries * self.dimensions
        if count * value_bits > br.bits_remaining:
            # reject before allocating/looping: a crafted entries*dims can
            # reach ~1e12 while the packet holds only a few bytes
            raise InvalidDataError("codebook lookup table exceeds packet size")
        mults = np.array(
            [br.read_bits(value_bits) for _ in range(count)], dtype=np.float64
        )
        if br.overrun:
            raise InvalidDataError("codebook lookup truncated")
        dims = self.dimensions
        table = np.zeros((self.entries, dims), dtype=np.float64)
        if self.map_type == 1:
            # lattice: entry's j-th value indexes mults via mixed radix
            # (spec 3.2.1 / reference Codebook.cs:232-263)
            if count == 0:
                raise InvalidDataError("empty lattice lookup")
            idx = np.arange(self.entries, dtype=np.int64)
            last = np.zeros(self.entries, dtype=np.float64)
            divisor = 1
            for j in range(dims):
                moff = (idx // divisor) % count
                table[:, j] = mults[moff] * delta + minimum + last
                if sequence_p:
                    last = table[:, j]
                divisor *= count
        else:
            flat = mults.reshape(self.entries, dims) if dims else mults.reshape(self.entries, 0)
            last = np.zeros(self.entries, dtype=np.float64)
            for j in range(dims):
                table[:, j] = flat[:, j] * delta + minimum + last
                if sequence_p:
                    last = table[:, j]
        # store in float32: both libvorbis and the reference build these
        # tables in single precision (Codebook.cs:220-288)
        self.lookup_table = table.astype(np.float32)

    # -- decode -----------------------------------------------------------------

    def decode_scalar(self, br: BitReader) -> int:
        """Decode one Huffman symbol; returns EOP (-1) on end-of-packet or an
        unmatched codeword (reference Codebook.DecodeScalar:300 +
        DecodeOverflowScalar:318 behave the same way)."""
        v = br.peek_bits(self.max_len if self.max_len < PREFIX_BITS else PREFIX_BITS)
        sym = self._prefix_sym[v & self._prefix_mask]
        if sym >= 0:
            l = self._prefix_len[v & self._prefix_mask]
            if l > br.bits_remaining:
                br.skip_bits(l)
                return EOP
            br.skip_bits(int(l))
            return int(sym)
        if self.max_len > PREFIX_BITS:
            v = br.peek_bits(self.max_len)
            for l, d in self._overflow:
                sym2 = d.get(v & ((1 << l) - 1))
                if sym2 is not None:
                    if l > br.bits_remaining:
                        br.skip_bits(l)
                        return EOP
                    br.skip_bits(l)
                    return sym2
        # no match: either truncated packet or an under-specified tree leaf
        br.skip_bits(self.max_len or 1)
        return EOP

    def decode_vq(self, br: BitReader) -> np.ndarray | None:
        """Decode one VQ vector (dimensions floats) or None at end-of-packet."""
        sym = self.decode_scalar(br)
        if sym < 0:
            return None
        return self.lookup_table[sym]

    @property
    def has_lookup(self) -> bool:
        return self.lookup_table is not None
