"""LSB-first bit reader over packet bytes (Vorbis I spec section 2).

Behavior parity with the reference's VorbisPacket struct
(NVorbis/VorbisPacket.cs:157-348): reads of up to 64 bits, peeks, skips, and
end-of-packet semantics (reads past the end return the available low bits
zero-extended and mark the reader as overrun — Vorbis treats premature packet
end as "end of packet" condition, not stream corruption).

Design difference from the reference: packets are assembled into a single
contiguous ``bytes`` by the Ogg layer before decode (the reference lazily
pages in continuation parts, VorbisPacket.cs:124-135). Contiguous bytes keep
the hot read path branch-free and make the future C++ front end trivial.
"""

from __future__ import annotations


class BitReader:
    """Reads little-endian (LSB-first) bit fields from a byte buffer."""

    __slots__ = ("data", "_nbits", "pos", "overrun")

    def __init__(self, data: bytes):
        self.data = data
        self._nbits = 8 * len(data)
        self.pos = 0  # absolute bit position
        self.overrun = False

    # -- core ---------------------------------------------------------------

    def read_bits(self, count: int) -> int:
        """Read ``count`` bits (0..64). Past-end bits read as 0 and set
        ``overrun`` (reference VorbisPacket.ReadBits:157 returns partial)."""
        v = self.peek_bits(count)
        self.pos += count
        if self.pos > self._nbits:
            self.pos = self._nbits
            self.overrun = True
        return v

    def peek_bits(self, count: int) -> int:
        if count == 0:
            return 0
        byte_pos = self.pos >> 3
        bit_off = self.pos & 7
        # Read enough bytes to cover bit_off + count bits.
        nbytes = (bit_off + count + 7) >> 3
        chunk = self.data[byte_pos : byte_pos + nbytes]
        v = int.from_bytes(chunk, "little")
        return (v >> bit_off) & ((1 << count) - 1)

    def skip_bits(self, count: int) -> None:
        self.pos += count
        if self.pos > self._nbits:
            self.pos = self._nbits
            self.overrun = True

    # -- helpers (reference PacketExtensions.cs:17-153) ----------------------

    def read_bit(self) -> bool:
        return bool(self.read_bits(1))

    def read_byte(self) -> int:
        return self.read_bits(8)

    def read_bytes(self, count: int) -> bytes:
        """Bulk byte read (vendor strings, comments): one slice when the
        cursor is byte-aligned, one big-int shift otherwise — no per-byte
        Python loop. Past-end bytes read as 0 and set ``overrun``."""
        if count <= 0:
            return b""
        byte_pos = self.pos >> 3
        bit_off = self.pos & 7
        if bit_off == 0:
            chunk = self.data[byte_pos : byte_pos + count]
        else:
            raw = self.data[byte_pos : byte_pos + count + 1]
            v = int.from_bytes(raw, "little") >> bit_off
            chunk = v.to_bytes(count + 1, "little")[:count]
        self.skip_bits(8 * count)
        if len(chunk) < count:
            chunk = chunk + b"\x00" * (count - len(chunk))
        return bytes(chunk)

    def read_u16(self) -> int:
        return self.read_bits(16)

    def read_u32(self) -> int:
        return self.read_bits(32)

    def read_u64(self) -> int:
        return self.read_bits(64)

    @property
    def bits_read(self) -> int:
        return self.pos

    @property
    def bits_remaining(self) -> int:
        return self._nbits - self.pos

    @property
    def total_bits(self) -> int:
        return self._nbits
