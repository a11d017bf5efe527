"""Small bit-level helpers shared across the codec.

Behavior parity with reference NVorbis/Utils.cs (ilog:18, BitReverse:30,
ConvertFromVorbisFloat32:98) — implemented independently from the Vorbis I
specification.
"""

from __future__ import annotations

import numpy as np


def ilog(x: int) -> int:
    """Number of bits needed to represent ``x``; ilog(0) == 0, ilog(1) == 1.

    Vorbis I spec section 9.2.1. Negative inputs use the spec convention of
    treating the value as having all higher bits set (reference returns 0 for
    negatives via unsigned shift; spec defines ilog over non-negative values
    — callers never pass negatives except Floor1 deltas where [lo,hi) ranges
    are positive).
    """
    if x <= 0:
        return 0
    return x.bit_length()


def bit_reverse(value: int, bits: int = 32) -> int:
    """Reverse the low ``bits`` bits of ``value``."""
    out = 0
    for _ in range(bits):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def float32_unpack(x: int) -> float:
    """Decode the Vorbis packed float format (spec section 9.2.2).

    21-bit mantissa, 10-bit biased exponent (bias 788), sign bit.
    Used for codebook VQ minimum/delta values (reference Utils.cs:98-112).
    """
    mantissa = x & 0x1FFFFF
    sign = x & 0x80000000
    exponent = (x & 0x7FE00000) >> 21
    if sign:
        mantissa = -mantissa
    return float(mantissa) * (2.0 ** (exponent - 788))


def lookup1_values(entries: int, dimensions: int) -> int:
    """Greatest integer v such that v ** dimensions <= entries.

    Vorbis I spec section 9.2.3; used for lookup-type-1 codebook lattices
    (reference Codebook.cs:290-298).
    """
    if dimensions <= 0:
        return 0
    v = int(np.floor(entries ** (1.0 / dimensions)))
    # Guard against FP rounding on the float pow.
    while (v + 1) ** dimensions <= entries:
        v += 1
    while v > 0 and v**dimensions > entries:
        v -= 1
    return v
