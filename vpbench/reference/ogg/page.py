"""Ogg physical page layer: capture-pattern scan, header parse, CRC verify,
resync after corruption.

Behavior parity with reference NVorbis/Ogg/PageReaderBase.cs:12 (page sync
scanner: ReadNextPage:286, VerifyHeader:176, VerifyPage:41) and
Ogg/PageHeader.cs:8 (field layout). Architecture differs: we scan with
``bytes.find`` over a growing buffer (C-speed) instead of a byte-at-a-time
state machine, and pages are immutable Python objects instead of pooled
ref-counted buffers (PageData.cs / RefCounted.cs are .NET-GC artifacts with
no TPU-framework analog).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .crc import ogg_crc

CAPTURE = b"OggS"
HEADER_BASE = 27
MAX_HEADER = 27 + 255
MAX_PAGE = 27 + 255 + 255 * 255  # 65307

# header type flags (reference Contracts/Ogg/PageFlags.cs:6)
FLAG_CONTINUES_PACKET = 0x01
FLAG_BOS = 0x02
FLAG_EOS = 0x04

_HDR = struct.Struct("<qIIIB")  # granule, serial, seqno, crc, nsegs  (bytes 6..27)


@dataclass(frozen=True)
class Page:
    """One CRC-verified Ogg page."""

    offset: int  # absolute byte offset of the capture pattern
    flags: int
    granule: int  # signed 64-bit; -1 == no packet completes on this page
    serial: int
    sequence: int
    payload: bytes
    # packet layout: (start, length) slices into payload, one per packet piece
    packet_slices: tuple[tuple[int, int], ...]
    continues_packet: bool  # first slice continues a packet from prior page
    last_incomplete: bool  # last slice continues onto the next page
    is_resync: bool = False
    page_size: int = 0  # total bytes incl. header

    @property
    def is_bos(self) -> bool:
        return bool(self.flags & FLAG_BOS)

    @property
    def is_eos(self) -> bool:
        return bool(self.flags & FLAG_EOS)

    def with_resync(self) -> "Page":
        return Page(
            self.offset, self.flags, self.granule, self.serial, self.sequence,
            self.payload, self.packet_slices, self.continues_packet,
            self.last_incomplete, True, self.page_size,
        )


@dataclass(frozen=True)
class PageInfo:
    """Header-only view (no payload) for cheap seeks."""

    offset: int
    flags: int
    granule: int
    serial: int
    sequence: int
    page_size: int
    packet_count: int


def _parse_layout(lacing: bytes) -> tuple[tuple[tuple[int, int], ...], bool]:
    """Split lacing values into packet-piece (start, len) slices.

    Returns (slices, last_incomplete). A lacing value < 255 terminates a
    packet; a page whose final lacing value is 255 leaves its last packet
    incomplete (continued on the next page). Zero-length packets are valid.
    """
    slices: list[tuple[int, int]] = []
    pos = 0
    cur = 0
    last_incomplete = False
    for v in lacing:
        cur += v
        if v < 255:
            slices.append((pos, cur))
            pos += cur
            cur = 0
    if cur > 0 or (lacing and lacing[-1] == 255):
        slices.append((pos, cur))
        last_incomplete = True
    return tuple(slices), last_incomplete


class PageScanner:
    """Sequential page scanner with resync, over a (possibly unseekable)
    binary stream. Also supports random-access page reads when the stream is
    seekable (needed for granule bisection seeks).

    Corruption handling parity (reference PageReaderBase.cs:286-361): bytes
    that fail the capture/CRC check are counted as waste and scanning resumes
    one byte past the failed candidate; the page after any gap is flagged
    ``is_resync``.
    """

    CHUNK = 1 << 16

    def __init__(self, stream):
        self._stream = stream
        try:
            self.seekable = bool(stream.seekable())
        except AttributeError:
            self.seekable = False
        self._buf = bytearray()
        self._buf_start = 0  # absolute offset of _buf[0]
        self._scan_pos = 0  # absolute offset where scanning continues
        self._eof = False
        self._stream_pos = 0  # absolute offset of next sequential stream read
        # stats (reference counts bits: PageReaderBase.cs:341, StreamStats)
        self.container_bits = 0
        self.waste_bits = 0
        self._pending_resync = False

    # -- buffered sequential reading -----------------------------------------

    def _fill(self, need_end: int) -> None:
        """Ensure buffer covers absolute offsets up to ``need_end`` (or EOF)."""
        while not self._eof and self._buf_start + len(self._buf) < need_end:
            chunk = self._stream.read(self.CHUNK)
            if not chunk:
                self._eof = True
                break
            self._buf.extend(chunk)
            self._stream_pos += len(chunk)

    def _trim(self) -> None:
        """Drop consumed buffer prefix."""
        cut = self._scan_pos - self._buf_start
        if cut > self.CHUNK:
            del self._buf[:cut]
            self._buf_start = self._scan_pos

    # -- sequential scan ------------------------------------------------------

    def next_page(self) -> Page | None:
        """Scan forward from the current position to the next valid page."""
        while True:
            self._fill(self._scan_pos + MAX_PAGE + 4)
            rel = self._scan_pos - self._buf_start
            idx = self._buf.find(CAPTURE, rel)
            if idx < 0:
                if self._eof:
                    # everything left is waste
                    tail = len(self._buf) - rel
                    if tail > 0:
                        self.waste_bits += 8 * tail
                        self._scan_pos += tail
                    return None
                # keep last 3 bytes in case capture straddles the chunk edge
                skipped = len(self._buf) - rel - 3
                if skipped > 0:
                    self.waste_bits += 8 * skipped
                    self._scan_pos += skipped
                    self._pending_resync = True
                self._trim()
                continue
            if idx > rel:
                self.waste_bits += 8 * (idx - rel)
                self._scan_pos = self._buf_start + idx
                self._pending_resync = True
            page = self._try_page_at_buffer(self._buf_start + idx)
            if page is None:
                if not self._eof and self._buf_start + len(self._buf) < self._scan_pos + MAX_PAGE:
                    # might just be an incomplete read; _fill capped earlier
                    self._fill(self._scan_pos + MAX_PAGE)
                    page = self._try_page_at_buffer(self._buf_start + idx)
                if page is None:
                    # bad candidate: skip the capture pattern, rescan
                    self.waste_bits += 8 * 4
                    self._scan_pos += 4
                    self._pending_resync = True
                    self._trim()
                    continue
            self._scan_pos = page.offset + page.page_size
            self._trim()
            if self._pending_resync:
                page = page.with_resync()
                self._pending_resync = False
            self.container_bits += 8 * (page.page_size - len(page.payload))
            return page

    def _try_page_at_buffer(self, offset: int) -> Page | None:
        """Parse + CRC-verify a candidate page at absolute ``offset`` (must be
        within the buffer). Returns None if invalid or not enough bytes."""
        rel = offset - self._buf_start
        buf = self._buf
        if len(buf) - rel < HEADER_BASE:
            return None
        if buf[rel : rel + 4] != CAPTURE or buf[rel + 4] != 0:
            return None
        granule, serial, seqno, crc, nsegs = _HDR.unpack_from(buf, rel + 6)
        flags = buf[rel + 5]
        hdr_len = HEADER_BASE + nsegs
        if len(buf) - rel < hdr_len:
            return None
        lacing = bytes(buf[rel + HEADER_BASE : rel + hdr_len])
        body_len = sum(lacing)
        total = hdr_len + body_len
        if len(buf) - rel < total:
            return None
        # CRC over the page with the CRC field zeroed
        raw = bytearray(buf[rel : rel + total])
        raw[22:26] = b"\x00\x00\x00\x00"
        if ogg_crc(raw) != crc:
            return None
        payload = bytes(buf[rel + hdr_len : rel + total])
        slices, last_inc = _parse_layout(lacing)
        return Page(
            offset=offset,
            flags=flags,
            granule=granule,
            serial=serial,
            sequence=seqno,
            payload=payload,
            packet_slices=slices,
            continues_packet=bool(flags & FLAG_CONTINUES_PACKET),
            last_incomplete=last_inc,
            page_size=total,
        )

    # -- random access (seekable only) ----------------------------------------

    def read_page_at(self, offset: int) -> Page | None:
        """Read and verify the page at an exact known offset (reference
        PageReader.ReadPageAt:104)."""
        data = self._read_at(offset, MAX_HEADER)
        if len(data) < HEADER_BASE or data[:4] != CAPTURE:
            return None
        nsegs = data[26]
        hdr_len = HEADER_BASE + nsegs
        if len(data) < hdr_len:
            return None
        lacing = data[HEADER_BASE:hdr_len]
        total = hdr_len + sum(lacing)
        data = self._read_at(offset, total)
        if len(data) < total:
            return None
        saved = (self._buf, self._buf_start, self._eof)
        self._buf, self._buf_start, self._eof = bytearray(data), offset, True
        try:
            return self._try_page_at_buffer(offset)
        finally:
            self._buf, self._buf_start, self._eof = saved

    def read_header_at(self, offset: int) -> PageInfo | None:
        """Header-only read, no CRC (reference PageReader.ReadPageHeaderAt:159)."""
        data = self._read_at(offset, MAX_HEADER)
        if len(data) < HEADER_BASE or data[:4] != CAPTURE or data[4] != 0:
            return None
        granule, serial, seqno, _crc, nsegs = _HDR.unpack_from(data, 6)
        hdr_len = HEADER_BASE + nsegs
        if len(data) < hdr_len:
            return None
        lacing = data[HEADER_BASE:hdr_len]
        slices, _ = _parse_layout(lacing)
        return PageInfo(
            offset=offset,
            flags=data[5],
            granule=granule,
            serial=serial,
            sequence=seqno,
            page_size=hdr_len + sum(lacing),
            packet_count=len(slices),
        )

    def find_page_after(self, offset: int) -> Page | None:
        """Scan forward from an arbitrary offset for the next valid page
        without disturbing sequential-scan state (seekable only)."""
        saved = (self._buf, self._buf_start, self._scan_pos, self._eof,
                 self._pending_resync, self.waste_bits, self.container_bits,
                 self._stream_pos)
        self._buf = bytearray()
        self._buf_start = offset
        self._scan_pos = offset
        self._eof = False
        self._stream.seek(offset)
        self._stream_pos = offset
        try:
            page = self.next_page()
        finally:
            (self._buf, self._buf_start, self._scan_pos, self._eof,
             self._pending_resync, self.waste_bits, self.container_bits,
             self._stream_pos) = saved
            self._stream.seek(self._stream_pos)
        return page

    def _read_at(self, offset: int, n: int) -> bytes:
        if not self.seekable:
            raise OSError("stream is not seekable")
        self._stream.seek(offset)
        data = self._stream.read(n)
        self._stream.seek(self._stream_pos)
        return data

    def stream_length(self) -> int | None:
        if not self.seekable:
            return None
        cur = self._stream.tell()
        end = self._stream.seek(0, 2)
        self._stream.seek(cur)
        return end
