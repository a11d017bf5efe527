"""Vorbis modes and window geometry.

Behavior parity with reference NVorbis/Mode.cs:6 (GetPacketInfo:30 window
geometry — also used to measure packet sample counts without full decode —
and Decode:68) and NVorbis/BlockSizes.cs. Spec sections 4.2.4 (mode header)
and 4.3.1 (window decode).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bitstream import BitReader
from ..errors import InvalidDataError


@dataclass(frozen=True)
class WindowInfo:
    """Window geometry of one packet (reference PacketInfo.cs)."""

    n: int  # blocksize
    block_flag: bool
    prev_flag: bool  # previous window was long (meaningful for long blocks)
    next_flag: bool
    left_start: int
    left_end: int
    right_start: int
    right_end: int

    @property
    def sample_count(self) -> int:
        # samples this packet contributes (reference PacketInfo.cs:14)
        return self.right_start - self.left_start


class Mode:
    def __init__(self, br: BitReader, blocksizes: tuple[int, int], n_mappings: int):
        self.block_flag = br.read_bit()
        if br.read_bits(16) != 0:
            raise InvalidDataError("mode window type must be 0")
        if br.read_bits(16) != 0:
            raise InvalidDataError("mode transform type must be 0")
        self.mapping_idx = br.read_bits(8)
        if self.mapping_idx >= n_mappings:
            raise InvalidDataError("mode references missing mapping")
        if br.overrun:
            raise InvalidDataError("mode truncated")
        self.blocksizes = blocksizes
        self.n = blocksizes[1] if self.block_flag else blocksizes[0]

    def read_window_flags(self, br: BitReader) -> tuple[bool, bool]:
        """Long-block packets carry prev/next window-shape flags
        (spec 4.3.1; reference Mode.GetPacketInfo:30)."""
        if not self.block_flag:
            return (False, False)
        prev = br.read_bit()
        nxt = br.read_bit()
        return (prev, nxt)

    def window_info(self, prev_flag: bool, next_flag: bool) -> WindowInfo:
        return window_geometry(
            self.blocksizes, self.block_flag, prev_flag, next_flag
        )


def window_geometry(
    blocksizes: tuple[int, int], block_flag: bool, prev_flag: bool, next_flag: bool
) -> WindowInfo:
    """Left/right overlap geometry (spec 4.3.1).

    For a long block, a short previous window shrinks the left overlap to the
    short slope centered at n/4; likewise on the right. Short blocks always
    use full-width slopes.
    """
    n0, n1 = blocksizes
    n = n1 if block_flag else n0
    if block_flag and not prev_flag:
        left_start = n // 4 - n0 // 4
        left_end = n // 4 + n0 // 4
    else:
        left_start = 0
        left_end = n // 2
    if block_flag and not next_flag:
        right_start = n - n // 4 - n0 // 4
        right_end = n - n // 4 + n0 // 4
    else:
        right_start = n // 2
        right_end = n
    return WindowInfo(
        n=n,
        block_flag=block_flag,
        prev_flag=prev_flag,
        next_flag=next_flag,
        left_start=left_start,
        left_end=left_end,
        right_start=right_start,
        right_end=right_end,
    )
