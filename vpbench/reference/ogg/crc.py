"""Ogg page CRC-32 (polynomial 0x04c11db7, unreflected, init 0, no final xor).

Behavior parity with reference NVorbis/Ogg/Crc.cs:6 (slicing-by-8 table CRC).

Performance design: instead of a Python table loop, we exploit the identity
    unreflected_crc(P, data) == bitrev32( reflected_crc(rev(P), bitrev8(data)) )
where rev(0x04c11db7) == 0xEDB88320 — exactly the zlib/IEEE polynomial. So an
Ogg CRC is one vectorized numpy byte-reversal plus one ``zlib.crc32`` call
(C speed), with the init/xor conventions compensated. A pure-Python table
implementation is kept for cross-checking in tests.
"""

from __future__ import annotations

import zlib

import numpy as np

# Per-byte bit-reversal table (uint8 -> uint8).
_BITREV8 = np.array(
    [int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8
)


def _bitrev32(x: int) -> int:
    out = 0
    for _ in range(32):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def ogg_crc(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    """CRC of ``data`` with the Ogg convention (register starts at 0)."""
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    rev = _BITREV8[arr]
    # raw reflected CRC with register init 0: zlib pre/post-xors with ~0.
    raw = zlib.crc32(rev.tobytes(), 0xFFFFFFFF) ^ 0xFFFFFFFF
    return _bitrev32(raw)


# ---------------------------------------------------------------------------
# Slow reference implementation (tests only).
# ---------------------------------------------------------------------------

_POLY = 0x04C11DB7


def _make_table() -> list[int]:
    table = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ _POLY) & 0xFFFFFFFF if r & 0x80000000 else (r << 1) & 0xFFFFFFFF
        table.append(r)
    return table


_TABLE = _make_table()


def ogg_crc_slow(data: bytes) -> int:
    reg = 0
    for b in data:
        reg = ((reg << 8) & 0xFFFFFFFF) ^ _TABLE[((reg >> 24) & 0xFF) ^ b]
    return reg
