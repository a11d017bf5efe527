"""Logical Ogg stream: per-serial page index, packet assembly across page
continuations, and granule-position seeking.

Behavior parity with reference NVorbis/Ogg/StreamPageReader.cs:8 (page index,
granule monotonicity check, FindPage) and Ogg/PacketProvider.cs:11 (packet
assembly CreatePacket:427, seek SeekTo:56, page end-granule cache
FillPageEndGranuleCache:203, GetGranuleCount:35).

Architecture difference from the reference: packets are addressed by
(page, k) where k counts packets *starting* on that page, and seeking builds
a whole-stream per-packet granule table once (an O(packets) pass, the same
work the reference's FillPageEndGranuleCache does lazily) then bisects in
memory. The table is re-anchored to page granule positions in a backward
pass, which reproduces the reference's end-trim and initial-offset handling
(StreamDecoder.cs:657-666, PacketProvider.cs:203-307). The same table is the
frame table consumed by the TPU batch front end.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import NamedTuple

from ..errors import InvalidDataError, NotSeekableError, SeekOutOfRangeError
from .page import Page


class Packet(NamedTuple):
    """One assembled Vorbis packet (NamedTuple: constructed ~1900x/s of
    audio, so creation cost matters on the batch front-end path)."""

    data: bytes
    granule: int  # end-page granule if this packet is the last to complete there
    is_resync: bool
    is_end_of_stream: bool
    page_index: int  # page the packet starts on
    packet_index: int  # index among packets starting on that page
    # Ogg framing bits attributed to this packet: its start page's header if
    # it is the first packet beginning there, plus every continuation page's
    # header it spans (reference VorbisPacket.ContainerOverheadBits,
    # PacketProvider.CreatePacket:427-512). Each page is charged exactly once.
    container_bits: int = 0


@dataclass
class _PageMeta:
    offset: int
    granule: int
    sequence: int
    flags: int
    n_slices: int
    n_starts: int  # packets starting on this page
    continues_packet: bool
    last_incomplete: bool
    is_resync: bool
    overhead: int = 0  # header bytes (capture..segment table) of this page


@dataclass
class GranuleTable:
    """Per-packet sample spans for one logical stream (audio packets only)."""

    page_idx: list[int]
    packet_idx: list[int]
    start: list[int]
    end: list[int]
    blocksize: list[int]  # 0 == undecodable packet (cannot prime lapping)
    count: list[int]  # samples the packet emits (gap-free, decoder order)
    anchor: list[int]  # raw page end-granule where the packet completes, else -1

    @property
    def total(self) -> int:
        return (self.end[-1] - self.start[0]) if self.end else 0

    @property
    def emitted_total(self) -> int:
        """Samples a full sequential decode emits (excludes granule gaps)."""
        return sum(self.count)


class LogicalStream:
    """All pages sharing one serial number, in arrival order."""

    PAYLOAD_CACHE = 64

    def __init__(self, container, serial: int):
        self._container = container
        self.serial = serial
        self.pages: list[_PageMeta] = []
        self._payloads: dict[int, Page] = {}
        self._payload_order: list[int] = []
        self.saw_eos = False
        self.first_data_page: int | None = None  # set by the decoder after headers
        self._max_seen_sequence = -1
        self._max_seen_granule = -1
        self.provider: "PacketProvider | None" = None

    # -- page intake (pushed by the container's sequential scan) -------------

    def add_page(self, page: Page) -> None:
        is_resync = page.is_resync
        if self._max_seen_sequence >= 0 and page.sequence != self._max_seen_sequence + 1:
            # sequence gap: pages were lost (reference StreamPageReader.cs:87-97
            # marks this with a negative offset)
            is_resync = True
        self._max_seen_sequence = page.sequence
        if page.granule >= 0:
            if page.granule < self._max_seen_granule and not is_resync:
                raise InvalidDataError(
                    f"granule position regressed on page {page.sequence} "
                    f"({page.granule} < {self._max_seen_granule})"
                )  # reference StreamPageReader.cs:67-71
            self._max_seen_granule = max(self._max_seen_granule, page.granule)
        if page.is_eos:
            self.saw_eos = True
        n_slices = len(page.packet_slices)
        n_starts = n_slices - (1 if page.continues_packet and n_slices else 0)
        idx = len(self.pages)
        self.pages.append(
            _PageMeta(
                offset=page.offset,
                granule=page.granule,
                sequence=page.sequence,
                flags=page.flags,
                n_slices=n_slices,
                n_starts=n_starts,
                continues_packet=page.continues_packet,
                last_incomplete=page.last_incomplete,
                is_resync=is_resync,
                overhead=page.page_size - len(page.payload),
            )
        )
        self._cache_payload(idx, page)

    def _cache_payload(self, idx: int, page: Page) -> None:
        self._payloads[idx] = page
        self._payload_order.append(idx)
        if len(self._payload_order) > self.PAYLOAD_CACHE:
            old = self._payload_order.pop(0)
            if old not in self._payloads:
                return
            if self._container.seekable:
                del self._payloads[old]
            else:
                # forward-only: only evict pages the reader has moved past
                cursor = self.provider._page_cursor if self.provider else 0
                if old < cursor:
                    del self._payloads[old]
                else:
                    self._payload_order.insert(0, old)

    # -- page access ----------------------------------------------------------

    def ensure_page(self, idx: int) -> bool:
        """Grow the index until page ``idx`` exists. Returns False at EOS."""
        while idx >= len(self.pages):
            if not self._container.scan_into(self):
                return False
        return True

    def get_page(self, idx: int) -> Page:
        if not self.ensure_page(idx):
            raise IndexError(idx)
        pg = self._payloads.get(idx)
        if pg is None:
            if not self._container.seekable:
                raise NotSeekableError(
                    "page payload was consumed; seeking / granule counting "
                    "on long forward-only streams needs a seekable source"
                )
            meta = self.pages[idx]
            pg = self._container.scanner.read_page_at(meta.offset)
            if pg is None:
                raise InvalidDataError(f"page at offset {meta.offset} vanished")
            self._cache_payload(idx, pg)
        return pg

    def ensure_all_pages(self) -> None:
        while self._container.scan_into(self):
            pass

    @property
    def max_granule(self) -> int:
        """End granule of the final page (requires full index); reference
        StreamPageReader.MaxGranulePosition:452."""
        self.ensure_all_pages()
        for meta in reversed(self.pages):
            if meta.granule >= 0:
                return meta.granule
        return 0


_LOST = object()  # sentinel: packet start consumed by a resync gap


class PacketProvider:
    """Pull-based packet iterator + seek engine for one logical stream.

    Public-surface parity with reference Contracts/IPacketProvider.cs:9
    (GetNextPacket, SeekTo, GetGranuleCount).
    """

    def __init__(self, stream: LogicalStream):
        self._s = stream
        stream.provider = self
        self._page_cursor = 0
        self._packet_cursor = 0  # among packets *starting* on the page
        self._pending_resync = False
        self._granule_table: GranuleTable | None = None

    @property
    def serial(self) -> int:
        return self._s.serial

    # -- iteration -------------------------------------------------------------

    def get_next_packet(self) -> Packet | None:
        s = self._s
        while True:
            if not s.ensure_page(self._page_cursor):
                return None
            meta = s.pages[self._page_cursor]
            if meta.is_resync and self._packet_cursor == 0:
                # only the first packet after the gap reports the resync
                # (reference VorbisPacket.IsResync semantics)
                self._pending_resync = True
            if self._packet_cursor >= meta.n_starts:
                self._page_cursor += 1
                self._packet_cursor = 0
                continue
            pkt = self._assemble(self._page_cursor, self._packet_cursor)
            self._packet_cursor += 1
            if pkt is _LOST:
                self._pending_resync = True
                continue
            if pkt is None:
                return None  # truncated at end of stream
            if self._pending_resync:
                pkt = Packet(pkt.data, pkt.granule, True, pkt.is_end_of_stream,
                             pkt.page_index, pkt.packet_index,
                             pkt.container_bits)
            self._pending_resync = False
            return pkt

    def peek_next_packet(self) -> Packet | None:
        save = (self._page_cursor, self._packet_cursor, self._pending_resync)
        pkt = self.get_next_packet()
        (self._page_cursor, self._packet_cursor, self._pending_resync) = save
        return pkt

    def _assemble(self, page_idx: int, packet_idx: int, head_only: int = 0):
        """Build the ``packet_idx``-th packet *starting* on ``page_idx``.

        Returns a Packet, None (stream truncated mid-packet), or _LOST (the
        packet's continuation was severed by a resync; reference drops these,
        PacketProvider.CreatePacket:427).

        ``head_only=N``: only the first N payload bytes are materialized —
        the granule table measures packets from their mode header alone
        (reference FillPageEndGranuleCache reads headers, not payloads), so
        whole-stream passes avoid copying every packet's bytes.
        """
        s = self._s
        page = s.get_page(page_idx)
        meta = s.pages[page_idx]
        slice_idx = packet_idx + (1 if meta.continues_packet else 0)
        if slice_idx >= meta.n_slices:
            return None
        # container attribution: the first packet BEGINNING on a page carries
        # its header; a page opening with a continuation tail was already
        # charged to the spanning packet (see the walk below)
        overhead = (
            meta.overhead
            if packet_idx == 0 and not meta.continues_packet
            else 0
        )
        start, length = page.packet_slices[slice_idx]
        if head_only and length > head_only:
            parts = [page.payload[start : start + head_only]]
            have = head_only
        else:
            parts = [page.payload[start : start + length]]
            have = length
        end_page_idx = page_idx
        end_slice_idx = slice_idx
        cur_meta = meta
        # Follow continuation across pages while the current slice is the
        # page's last and it is incomplete.
        while end_slice_idx == cur_meta.n_slices - 1 and cur_meta.last_incomplete:
            nxt_idx = end_page_idx + 1
            if not s.ensure_page(nxt_idx):
                return None
            nxt_meta = s.pages[nxt_idx]
            if not nxt_meta.continues_packet or nxt_meta.is_resync:
                return _LOST
            overhead += nxt_meta.overhead
            if head_only and have >= head_only:
                # metadata-only walk: the remaining parts are not needed
                end_page_idx, end_slice_idx = nxt_idx, 0
                cur_meta = nxt_meta
                continue
            nxt_page = s.get_page(nxt_idx)
            st, ln = nxt_page.packet_slices[0]
            if head_only and have + ln > head_only:
                ln = head_only - have
            parts.append(nxt_page.payload[st : st + ln])
            have += ln
            end_page_idx, end_slice_idx = nxt_idx, 0
            cur_meta = nxt_meta

        end_meta = s.pages[end_page_idx]
        # last slice index on the end page that completes a packet
        last_completing = end_meta.n_slices - (2 if end_meta.last_incomplete else 1)
        is_last_completed = end_slice_idx == last_completing
        granule = end_meta.granule if is_last_completed and end_meta.granule >= 0 else -1
        is_eos = bool(end_meta.flags & 0x04) and is_last_completed
        return Packet(
            data=parts[0] if len(parts) == 1 else b"".join(parts),
            granule=granule,
            is_resync=False,
            is_end_of_stream=is_eos,
            page_index=page_idx,
            packet_index=packet_idx,
            container_bits=8 * overhead,
        )

    def get_packet_at(self, page_idx: int, packet_idx: int) -> Packet | None:
        pkt = self._assemble(page_idx, packet_idx)
        return None if pkt is _LOST or pkt is None else pkt

    # -- granule table -----------------------------------------------------------

    def build_granule_table(self, blocksize_of) -> GranuleTable:
        """Measure every audio packet's sample span (reference
        FillPageEndGranuleCache:203 measures via GetPacketGranuleCount).

        ``blocksize_of(Packet) -> int`` parses only the mode header; returns
        0 for undecodable packets. Per the Vorbis granule convention a packet
        contributes (prev_blocksize + blocksize)/4 samples — the emission
        boundary is the window center (matches libvorbis page granules at
        every boundary, including long->short transitions; the reference
        instead ignores mid-stream granules, StreamDecoder.cs:658).
        """
        if self._granule_table is not None:
            return self._granule_table
        s = self._s
        s.ensure_all_pages()
        first_data = s.first_data_page or 0
        pages_i: list[int] = []
        packets_i: list[int] = []
        counts: list[int] = []
        blocksizes: list[int] = []
        anchors: list[int] = []  # page end-granule where packet completes, else -1
        prev_n = 0  # 0 marks "no previous frame": first packet emits nothing
        pi, ki = first_data, 0
        pending_resync = False
        while pi < len(s.pages):
            meta = s.pages[pi]
            if meta.is_resync and ki == 0:
                # lost data: the decoder drops its lap state, so the next
                # decodable packet re-primes and emits nothing
                # (StreamDecoder._next_block resync handling)
                pending_resync = True
            if ki >= meta.n_starts:
                pi += 1
                ki = 0
                continue
            pkt = self._assemble(pi, ki, head_only=8)
            if pkt is None:
                break
            if pkt is _LOST:
                pending_resync = True
            else:
                n = blocksize_of(pkt)
                if n > 0:
                    if pending_resync:
                        count = 0
                        pending_resync = False
                    else:
                        count = (prev_n + n) // 4 if prev_n else 0
                    prev_n = n
                else:
                    count = 0  # undecodable: lapping state unchanged
                pages_i.append(pi)
                packets_i.append(ki)
                counts.append(count)
                blocksizes.append(n)
                anchors.append(pkt.granule)
            ki += 1
        # Anchoring semantics (libvorbis-compatible, verified vs oracle):
        # - start offset comes from the FIRST anchored packet: if its granule
        #   exceeds the forward-accumulated count, the stream starts late
        #   (issue6test: +63); if smaller, samples are trimmed at the END of
        #   that span, not the start.
        # - mid-stream anchors re-sync the position (resync gaps).
        # - the FINAL anchor clamps all trailing ends (encoder end-trim may
        #   span several packets of the last page).
        n = len(counts)
        start = [0] * n
        end = [0] * n
        first_anchor = next((i for i in range(n) if anchors[i] >= 0), None)
        pos = 0
        if first_anchor is not None:
            lead = sum(counts[: first_anchor + 1])
            pos = max(anchors[first_anchor] - lead, 0)
        for i in range(n):
            start[i] = pos
            pos += counts[i]
            if anchors[i] >= 0:
                pos = anchors[i]  # trust the container at every page boundary
            end[i] = max(pos, start[i])
        last_anchor = next((i for i in range(n - 1, -1, -1) if anchors[i] >= 0), None)
        if last_anchor is not None:
            final = anchors[last_anchor]
            for i in range(n - 1, -1, -1):
                if end[i] <= final and start[i] <= final:
                    break
                end[i] = min(end[i], final)
                start[i] = min(start[i], final)
        self._granule_table = GranuleTable(
            pages_i, packets_i, start, end, blocksizes, counts, anchors
        )
        return self._granule_table

    def invalidate_granule_table(self) -> None:
        self._granule_table = None

    # -- seeking ---------------------------------------------------------------

    def seek_to_granule(self, granule: int, preroll: int, blocksize_of) -> int:
        """Position the cursor ``preroll`` packets before the packet containing
        sample ``granule``; returns the start granule of the target packet
        (reference PacketProvider.SeekTo:56).

        Fast path: bisect the page index by end-granule and measure only the
        packets of the target page (reference FindPageBisection:269 +
        GetTargetPageInfo:90 measure only what the seek touches). Streams
        with resync gaps or odd anchoring fall back to the exact full
        granule table."""
        if granule < 0:
            raise SeekOutOfRangeError(str(granule))
        if self._granule_table is None:
            result = self._seek_bisect(granule, preroll, blocksize_of)
            if result is not None:
                return result
        table = self.build_granule_table(blocksize_of)
        if not table.end:
            raise SeekOutOfRangeError(str(granule))
        if granule > table.end[-1]:
            raise SeekOutOfRangeError(str(granule))
        # first packet whose end granule exceeds the target
        idx = bisect.bisect_right(table.end, granule)
        if idx >= len(table.end):
            idx = len(table.end) - 1
        target_start = table.start[idx]
        # preroll must land on DECODABLE packets: an undecodable one cannot
        # prime lapping, and the decoder would consume the target as the
        # primer instead — shifting all returned audio
        j = idx
        needed = preroll
        while j > 0 and needed > 0:
            j -= 1
            if table.blocksize[j] > 0:
                needed -= 1
        self._page_cursor = table.page_idx[j]
        self._packet_cursor = table.packet_idx[j]
        self._pending_resync = False
        return target_start

    def _seek_bisect(self, granule: int, preroll: int, blocksize_of):
        """Page-granule bisection seek; returns the target packet's start
        granule, or None when this stream needs the exact-table fallback
        (resync gaps, missing anchors, target before the first anchor)."""
        s = self._s
        s.ensure_all_pages()
        first_data = s.first_data_page or 0
        pages = s.pages
        if first_data >= len(pages):
            raise SeekOutOfRangeError(str(granule))
        # anchored data pages in index order
        anchored = [
            i for i in range(first_data, len(pages)) if pages[i].granule >= 0
        ]
        if not anchored:
            return None
        if any(pages[i].is_resync for i in range(first_data, len(pages))):
            return None  # corrupted stream: use the exact table
        if granule > pages[anchored[-1]].granule:
            raise SeekOutOfRangeError(str(granule))
        # first anchored page whose end-granule covers the target
        lo, hi = 0, len(anchored) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if pages[anchored[mid]].granule < granule:
                lo = mid + 1
            else:
                hi = mid
        pi = anchored[lo]
        base = pages[anchored[lo - 1]].granule if lo > 0 else None

        # measure the packets completing on page pi: walk forward from the
        # previous packet's blocksize (reference GetPacketGranuleCount —
        # mode header only), then derive start granules from the page's
        # end-granule anchor
        entries = self._measure_page(pi, blocksize_of)
        if entries is None:
            return None
        counts = [c for (_, _, c, _) in entries]
        end_granule = pages[pi].granule
        start0 = end_granule - sum(counts)
        if base is not None and start0 != base:
            # lapping irregularities (start offsets, end trims) — be exact
            return None
        if base is None and start0 < 0:
            return None  # start-trimmed stream (issue6test): exact table
        # locate the packet containing `granule` (table-path semantics:
        # first packet whose END granule exceeds the target)
        pos = start0
        for k, (pg, pk, c, _n) in enumerate(entries):
            if granule < pos + c or k == len(entries) - 1:
                target_start = pos
                # step back over `preroll` DECODABLE packets (an undecodable
                # packet cannot prime lapping; see the table path)
                j = k
                needed = preroll
                head_page = pi  # page whose measurement produced entries[0]
                while needed > 0:
                    if j == 0:
                        start_pg = entries[0][0]
                        prev = None
                        if start_pg < head_page:
                            # entries[0] is continued from an earlier page:
                            # the packets COMPLETING on its start page come
                            # next in the walk, not the page before it —
                            # otherwise the cursor lands up to a page early
                            # (extra silent preroll decode)
                            prev = self._measure_page(start_pg, blocksize_of)
                            prev_page = start_pg
                        if prev is None:
                            prev_page, prev = self._prev_measurable(
                                min(start_pg, head_page), blocksize_of
                            )
                        if prev is None:
                            break
                        head_page = prev_page
                        entries = prev + entries
                        j += len(prev)
                        k += len(prev)
                    j -= 1
                    if entries[j][3] > 0:
                        needed -= 1
                pg, pk = entries[max(j, 0)][0], entries[max(j, 0)][1]
                self._page_cursor = pg
                self._packet_cursor = pk
                self._pending_resync = False
                return target_start
            pos += c
        return None

    def _measure_page(self, pi: int, blocksize_of):
        """[(page_idx, packet_idx, sample_count)] for packets COMPLETING on
        page ``pi`` — including a packet continued from an earlier page —
        measured from mode headers only (reference GetPacketGranuleCount),
        or None if unmeasurable."""
        s = self._s
        meta = s.pages[pi]
        completing: list[tuple[int, int]] = []
        if meta.continues_packet:
            loc = self._last_start_before(pi)
            if loc is None:
                return None
            completing.append(loc)
        n_st = meta.n_starts - (1 if meta.last_incomplete else 0)
        completing.extend((pi, k) for k in range(n_st))
        if not completing:
            return None
        # lapping context: the packet preceding the first completing one
        prev_n = 0
        prev_loc = self._packet_before(*completing[0])
        if prev_loc is not None:
            pkt = self.get_packet_at(*prev_loc)
            if pkt is None:
                return None
            prev_n = blocksize_of(pkt)
        out = []
        for pg, pk in completing:
            pkt = self.get_packet_at(pg, pk)
            if pkt is None:
                return None
            n = blocksize_of(pkt)
            if n > 0:
                count = (prev_n + n) // 4 if prev_n else 0
                prev_n = n
            else:
                count = 0
            out.append((pg, pk, count, n))
        return out

    def _last_start_before(self, pi: int):
        """(page_idx, packet_idx) of the last packet starting before page
        ``pi``, or None."""
        qi = pi - 1
        first_data = self._s.first_data_page or 0
        while qi >= first_data:
            if self._s.pages[qi].n_starts > 0:
                return (qi, self._s.pages[qi].n_starts - 1)
            qi -= 1
        return None

    def _packet_before(self, pg: int, pk: int):
        if pk > 0:
            return (pg, pk - 1)
        return self._last_start_before(pg)

    def _prev_measurable(self, pi: int, blocksize_of):
        """(page_idx, measurement entries) for the page before ``pi``
        (preroll walk), or (None, None)."""
        qi = pi - 1
        first_data = self._s.first_data_page or 0
        while qi >= first_data:
            if self._s.pages[qi].granule >= 0 and (
                self._s.pages[qi].n_starts > 0
                or self._s.pages[qi].continues_packet
            ):
                return qi, self._measure_page(qi, blocksize_of)
            qi -= 1
        return None, None

    def get_granule_count(self, blocksize_of) -> int:
        return self.build_granule_table(blocksize_of).total
