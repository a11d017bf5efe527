"""Vorbis residues 0/1/2: config parse + host-side VQ decode-and-accumulate.

Behavior parity with reference NVorbis/Residue0.cs:9 (cascade/decode-map
parse :25-115, partition loop Decode:117-206), Residue1.cs:6, Residue2.cs:6.
Implemented from Vorbis I spec section 8.6.

Decode emits dense per-channel float spectra — the "irregular -> dense"
boundary of the TPU design (SURVEY.md section 7): everything downstream of
this function is batched device math.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import BitReader
from ..errors import InvalidDataError
from .codebook import Codebook


class Residue:
    """Base residue (type 0). Types 1/2 share the config format."""

    def __init__(self, br: BitReader, codebooks: list[Codebook], residue_type: int):
        self.residue_type = residue_type
        self.begin = br.read_bits(24)
        self.end = br.read_bits(24)
        self.partition_size = br.read_bits(24) + 1
        self.classifications = br.read_bits(6) + 1
        classbook_idx = br.read_bits(8)
        if classbook_idx >= len(codebooks):
            raise InvalidDataError("residue classbook out of range")
        self.classbook = codebooks[classbook_idx]
        cascades = []
        for _ in range(self.classifications):
            low = br.read_bits(3)
            high = br.read_bits(5) if br.read_bit() else 0
            cascades.append((high << 3) | low)
        self.cascades = cascades
        self.books: list[list[Codebook | None]] = []
        for c in cascades:
            row: list[Codebook | None] = []
            for p in range(8):
                if c & (1 << p):
                    bi = br.read_bits(8)
                    if bi >= len(codebooks):
                        raise InvalidDataError("residue book out of range")
                    book = codebooks[bi]
                    if not book.has_lookup or book.dimensions < 1:
                        # dims==0 books cannot advance the partition loop
                        # (and would divide by zero in format 0)
                        raise InvalidDataError("residue book lacks value mapping")
                    row.append(book)
                else:
                    row.append(None)
            self.books.append(row)
        if br.overrun:
            raise InvalidDataError("residue configuration truncated")
        if self.classbook.dimensions < 1:
            raise InvalidDataError("classbook with zero dimensions")
        # max classifications^dims must fit in classbook entries (libvorbis
        # enforces this; malformed files in the corpus exercise it)
        if self.classifications ** self.classbook.dimensions > self.classbook.entries:
            raise InvalidDataError("residue classbook too small for classifications")

    # -- decode -------------------------------------------------------------------

    def decode(self, br: BitReader, do_not_decode: list[bool], n: int) -> np.ndarray:
        """Decode residue vectors for ``len(do_not_decode)`` channels of
        half-block size ``n`` -> float64 [channels, n]."""
        if self.residue_type == 2:
            return self._decode_type2(br, do_not_decode, n)
        return self._decode_01(br, do_not_decode, n)

    def _decode_01(self, br: BitReader, do_not_decode: list[bool], n: int) -> np.ndarray:
        channels = len(do_not_decode)
        out = np.zeros((channels, n), dtype=np.float64)
        self._decode_core(
            br,
            [out[j] for j in range(channels)],
            do_not_decode,
            n,
        )
        return out

    def _decode_type2(self, br: BitReader, do_not_decode: list[bool], n: int) -> np.ndarray:
        """All channels interleaved into one vector (spec 8.6.5; reference
        Residue2.Decode:12-52): decode as a single type-1 channel of size
        n*channels, then de-interleave."""
        channels = len(do_not_decode)
        if all(do_not_decode):
            return np.zeros((channels, n), dtype=np.float64)
        flat = np.zeros(n * channels, dtype=np.float64)
        self._decode_core(br, [flat], [False], n * channels, force_format1=True)
        return flat.reshape(n, channels).T.copy()

    def _decode_core(
        self,
        br: BitReader,
        vectors: list[np.ndarray],
        do_not_decode: list[bool],
        actual_size: int,
        force_format1: bool = False,
    ) -> None:
        limit_begin = min(self.begin, actual_size)
        limit_end = min(self.end, actual_size)
        n_to_read = limit_end - limit_begin
        if n_to_read <= 0:
            return
        psize = self.partition_size
        partitions_to_read = n_to_read // psize
        cwords = self.classbook.dimensions
        n_ch = len(vectors)
        fmt1 = force_format1 or self.residue_type != 0
        ncls = self.classifications
        classbook = self.classbook
        books = self.books
        # classification buffer [ch][partition]
        cls_buf = np.zeros((n_ch, partitions_to_read + cwords), dtype=np.int64)

        for p in range(8):
            partition_count = 0
            while partition_count < partitions_to_read:
                if p == 0:
                    for j in range(n_ch):
                        if do_not_decode[j]:
                            continue
                        temp = classbook.decode_scalar(br)
                        if temp < 0:
                            return  # EOP: keep partial data (spec 8.6.2)
                        for i in range(cwords - 1, -1, -1):
                            cls_buf[j][partition_count + i] = temp % ncls
                            temp //= ncls
                for _ in range(cwords):
                    if partition_count >= partitions_to_read:
                        break
                    offset = limit_begin + partition_count * psize
                    for j in range(n_ch):
                        if do_not_decode[j]:
                            continue
                        vqbook = books[cls_buf[j][partition_count]][p]
                        if vqbook is None:
                            continue
                        if not self._decode_partition(br, vqbook, vectors[j], offset, psize, fmt1):
                            return  # EOP
                    partition_count += 1

    @staticmethod
    def _decode_partition(
        br: BitReader, book: Codebook, vec: np.ndarray, offset: int, psize: int, fmt1: bool
    ) -> bool:
        dims = book.dimensions
        table = book.lookup_table
        decode_scalar = book.decode_scalar
        if fmt1:
            # format 1 (spec 8.6.4): contiguous dims (reference Residue1.cs:12)
            i = 0
            while i < psize:
                sym = decode_scalar(br)
                if sym < 0:
                    return False
                seg = vec[offset + i : offset + i + dims]
                # clamp at the vector end (possible when partition_size is
                # not a multiple of dims on a malformed stream); mirrors the
                # C++ front end exactly
                seg += table[sym][: len(seg)]
                i += dims
        else:
            # format 0 (spec 8.6.3): interleaved stride (reference Residue0.cs:208)
            step = psize // dims
            for k in range(step):
                sym = decode_scalar(br)
                if sym < 0:
                    return False
                vec[offset + k : offset + psize : step] += table[sym]
        return True


def parse_residue(br: BitReader, codebooks: list[Codebook]) -> Residue:
    rtype = br.read_bits(16)
    if rtype not in (0, 1, 2):
        raise InvalidDataError(f"bad residue type {rtype}")
    return Residue(br, codebooks, rtype)
