"""Page-level anomaly vectors (libnogg-corpus analogs, unreachable here):
re-frame a healthy single-stream Ogg file with hand-written pages and inject
the shapes the libnogg conformance set encodes by existing —

  * long-first-packet  -> first audio packet spans several pages
  * empty-page         -> zero-segment page mid-stream
  * partial-granule-position -> mid-stream data page with granule -1
  * bad-continued-packet-flag -> continuation flag on a fresh packet

Reference expectations: NVorbis.Tests/OggTests.cs:9-64 (diff budgets 0-2;
bad-continued follows libvorbis and silently drops the orphan data).
"""

from __future__ import annotations

import io
import struct

from ..ogg.crc import ogg_crc


def write_page(
    serial: int,
    seq: int,
    granule: int,
    flags: int,
    lacing: list[int],
    payload: bytes,
) -> bytes:
    hdr = b"OggS" + bytes([0, flags]) + struct.pack(
        "<qIII", granule, serial, seq, 0
    )
    hdr += bytes([len(lacing)]) + bytes(lacing)
    full = bytearray(hdr + payload)
    full[22:26] = struct.pack("<I", ogg_crc(bytes(full)))
    return bytes(full)


def extract_packets(data: bytes):
    """(packets, serial): each packet is (bytes, end_granule). End granules
    come from the per-packet granule table so EVERY audio packet gets one
    (page anchors only mark the last packet completing on a page).

    Uses the library's own Ogg layer; the vectors built from these are
    validated against native libvorbis, so self-extraction cannot mask a
    framing bug."""
    from ..decoder import StreamDecoder
    from ..ogg.container import OggContainer

    c = OggContainer(io.BytesIO(data))
    if not c.try_init():
        raise ValueError("no logical stream")
    pr = c.providers[0]
    dec = StreamDecoder(pr)
    dec.initialize()
    table = pr.build_granule_table(dec.get_packet_blocksize)
    headers = []
    c2 = OggContainer(io.BytesIO(data))
    c2.try_init()
    pr2 = c2.providers[0]
    for _ in range(3):
        headers.append((pr2.get_next_packet().data, 0))
    audio = []
    for i in range(len(table.end)):
        pkt = pr2.get_next_packet()
        if pkt is None:
            break
        audio.append((pkt.data, table.end[i]))
    return headers, audio, pr.serial


def _lace(length: int) -> list[int]:
    return [255] * (length // 255) + [length % 255]


class _Framer:
    """Greedy packetizer with per-page knobs: body-size cap, hooks mutating
    (granule, flags) per page before emission."""

    def __init__(self, serial: int):
        self.serial = serial
        self.seq = 0
        self.pages: list[bytes] = []

    def add_packets(
        self,
        packets,  # [(data, end_granule)]
        *,
        body_cap: int = 4096,
        first_flags: int = 0,
        page_hooks=(),
    ) -> None:
        lacing: list[int] = []
        payload = bytearray()
        page_granule = -1
        fresh = True  # page does not open with a continuation slice
        flags = first_flags
        n = len(packets)

        def flush():
            nonlocal lacing, payload, page_granule, fresh, flags
            g, fl = page_granule, flags
            for hook in page_hooks:
                g, fl = hook(self.seq, g, fl, fresh)
            self.pages.append(
                write_page(self.serial, self.seq, g, fl, lacing, bytes(payload))
            )
            self.seq += 1
            lacing, payload, page_granule = [], bytearray(), -1
            fresh = True
            flags = 0

        for i, (data, g) in enumerate(packets):
            segs = _lace(len(data))
            pos = 0
            for k, seg in enumerate(segs):
                lacing.append(seg)
                payload.extend(data[pos : pos + seg])
                pos += seg
                last_seg = k == len(segs) - 1
                if last_seg:
                    page_granule = g
                if (len(payload) >= body_cap or len(lacing) == 255) and not (
                    last_seg and i == n - 1
                ):
                    mid_packet = not last_seg
                    flush()
                    if mid_packet:
                        fresh = False
                        flags = 0x01  # continuation
        if lacing:
            flush()

    def insert_empty_page(self) -> None:
        self.pages.append(write_page(self.serial, self.seq, -1, 0, [], b""))
        self.seq += 1

    def finish(self) -> bytes:
        """Mark the final page EOS and join."""
        if self.pages:
            last = bytearray(self.pages[-1])
            last[5] |= 0x04
            last[22:26] = b"\x00\x00\x00\x00"
            last[22:26] = struct.pack("<I", ogg_crc(bytes(last)))
            self.pages[-1] = bytes(last)
        return b"".join(self.pages)


def _reframe(
    data: bytes,
    *,
    body_cap: int = 4096,
    page_hooks=(),
    first_audio_cap: int | None = None,
    empty_page_before_seq: int | None = None,
) -> bytes:
    headers, audio, serial = extract_packets(data)
    fr = _Framer(serial)
    # frame headers as encoders do: ident alone (BOS page), comment+setup
    fr.add_packets(headers[:1], first_flags=0x02)
    fr.add_packets(headers[1:])
    if first_audio_cap is not None and audio:
        fr.add_packets([audio[0]], body_cap=first_audio_cap)
        audio = audio[1:]
    # emit audio page-group by page-group so the empty page lands mid-stream
    if empty_page_before_seq is None:
        fr.add_packets(audio, body_cap=body_cap, page_hooks=page_hooks)
    else:
        cut = max(1, len(audio) // 2)
        fr.add_packets(audio[:cut], body_cap=body_cap, page_hooks=page_hooks)
        fr.insert_empty_page()
        fr.add_packets(audio[cut:], body_cap=body_cap, page_hooks=page_hooks)
    return fr.finish()


def make_long_first_packet(data: bytes) -> bytes:
    """First audio packet spans several small pages (libnogg
    6ch-long-first-packet analog). Ogg can only break packets at lacing
    (255-byte) granularity, so the packet is zero-padded to page-spanning
    size first — trailing bytes are never read by any decoder (they count
    as waste bits only)."""
    headers, audio, serial = extract_packets(data)
    first, rest = audio[0], audio[1:]
    if len(first[0]) < 2000:
        first = (first[0] + b"\x00" * (2000 - len(first[0])), first[1])
    fr = _Framer(serial)
    fr.add_packets(headers[:1], first_flags=0x02)
    fr.add_packets(headers[1:])
    fr.add_packets([first], body_cap=255)
    fr.add_packets(rest)
    return fr.finish()


def make_empty_page(data: bytes) -> bytes:
    """Zero-segment page mid-stream (libnogg empty-page analog)."""
    return _reframe(data, body_cap=1000, empty_page_before_seq=0)


def make_partial_granule(data: bytes, at_seq: int = 5) -> bytes:
    """Mid-stream data page reports granule -1 (libnogg
    partial-granule-position analog; reference budget 2)."""

    def hook(seq, granule, flags, fresh):
        return (-1, flags) if seq == at_seq else (granule, flags)

    return _reframe(data, body_cap=1000, page_hooks=(hook,))


def make_bad_continued_flag(data: bytes, at_seq: int = 2) -> bytes:
    """Continuation flag on a page whose first packet is fresh: libvorbis
    (and we) silently drop the orphan 'tail' (libnogg
    bad-continued-packet-flag analog; reference OggTests.cs:23-31 — the
    vector flags the first audio page, so the swallowed packet is the
    zero-emission priming packet and PCM parity is exact). A mid-music bad
    flag additionally diverges decoders on flagged-vs-actual window
    geometry and is not modeled here."""

    def hook(seq, granule, flags, fresh):
        if seq == at_seq and fresh:
            return granule, flags | 0x01
        return granule, flags

    return _reframe(data, body_cap=1000, page_hooks=(hook,))


def make_zero_length_packets(data: bytes, every: int = 4) -> bytes:
    """Zero-length packets interleaved mid-stream: a lacing value of 0 is a
    legal empty packet (Ogg spec §4; lewton/libnogg zero-packet analogs).
    Decoders must count them as undecodable packets and emit no samples
    (reference StreamDecoder ReadNextPacket:650 records a failed decode)."""
    headers, audio, serial = extract_packets(data)
    fr = _Framer(serial)
    fr.add_packets(headers[:1], first_flags=0x02)
    fr.add_packets(headers[1:])
    mixed = []
    for i, (d, g) in enumerate(audio):
        mixed.append((d, g))
        if i % every == every - 1:
            # empty packet carries the preceding packet's granule so page
            # granule bookkeeping stays monotone
            mixed.append((b"", g))
    fr.add_packets(mixed, body_cap=1000)
    return fr.finish()


def make_max_lacing_page(data: bytes) -> bytes:
    """A FULL Ogg page: 255 lacing values of 255 (body 65025 bytes, the
    address-quantum ceiling) with no terminating lacing value, continued
    on the next page (libnogg large-page analog). One mid-stream audio
    packet is zero-padded past the page ceiling — the padding is never
    read by any decoder (waste bits only)."""
    headers, audio, serial = extract_packets(data)
    mid = len(audio) // 2
    big = audio[mid]
    need = 255 * 255 + 1000
    if len(big[0]) < need:
        big = (big[0] + b"\x00" * (need - len(big[0])), big[1])
    fr = _Framer(serial)
    fr.add_packets(headers[:1], first_flags=0x02)
    fr.add_packets(headers[1:])
    if mid:
        fr.add_packets(audio[:mid], body_cap=4096)
    fr.add_packets([big], body_cap=255 * 255)
    fr.add_packets(audio[mid + 1 :], body_cap=4096)
    return fr.finish()


def make_multipage_continued(data: bytes, span_pages: int = 4) -> bytes:
    """A mid-stream audio packet continued across MORE than two pages
    (``span_pages`` small pages): zero-padded to spanning size — padding
    is never read by a decoder (waste bits only). The >2-page shape
    matters because the continuation chain has interior pages that are
    pure continuation (flag 0x01 at both ends), the geometry a 2-page
    span never produces (reference Ogg continuation assembly:
    NVorbis/Ogg/PacketProvider.cs; OggTests.cs:9-92)."""
    headers, audio, serial = extract_packets(data)
    mid = len(audio) // 2
    big = audio[mid]
    cap = 2048
    need = cap * span_pages + 500
    if len(big[0]) < need:
        big = (big[0] + b"\x00" * (need - len(big[0])), big[1])
    fr = _Framer(serial)
    fr.add_packets(headers[:1], first_flags=0x02)
    fr.add_packets(headers[1:])
    if mid:
        fr.add_packets(audio[:mid], body_cap=4096)
    fr.add_packets([big], body_cap=cap)
    fr.add_packets(audio[mid + 1 :], body_cap=4096)
    return fr.finish()


def corrupt_interior_continuation(data: bytes, which: int = 1) -> bytes:
    """Flip one body byte of an INTERIOR page of the longest continuation
    run — a resync inside a multi-page continued packet. The damaged page
    fails CRC and is skipped; the packet it carried can never complete, so
    the decoder must drop the partial data, resync on the next page
    boundary, and keep decoding (libvorbis reports a hole and continues).
    ``which`` indexes into the run's continuation pages (1 = second page
    of the packet, i.e. not the final one for runs of length >= 2)."""
    import io

    from ..ogg.page import PageScanner

    sc = PageScanner(io.BytesIO(data))
    pages = []
    while (p := sc.next_page()) is not None:
        pages.append(p)
    # continuation runs: consecutive pages with the continued-packet flag
    runs: list[list[int]] = []
    for i, p in enumerate(pages):
        if p.continues_packet:
            if runs and runs[-1][-1] == i - 1:
                runs[-1].append(i)
            else:
                runs.append([i])
    best = max(runs, key=len)
    assert len(best) >= 2, "need a >2-page continued packet to corrupt"
    target = pages[best[min(which, len(best) - 2)]]
    out = bytearray(data)
    out[target.offset + target.page_size - 1] ^= 0xFF  # last body byte
    return bytes(out)


def make_multipage_setup_header(data: bytes) -> bytes:
    """Comment + setup headers re-framed over many tiny pages (255-byte
    body cap): a ~4 KB setup packet spans ~16 pages — the shape real
    encoders produce with large codebooks. Header continuation assembly
    must be page-count-agnostic (reference: header packets flow through
    the same PacketProvider continuation path as audio)."""
    headers, audio, serial = extract_packets(data)
    fr = _Framer(serial)
    fr.add_packets(headers[:1], first_flags=0x02)
    fr.add_packets(headers[1:], body_cap=255)
    fr.add_packets(audio, body_cap=4096)
    return fr.finish()


def make_sample_rate(data: bytes, rate: int) -> bytes:
    """Rewrite the ident header's sample-rate field (u32) and re-page:
    the libnogg sample-rate-max vector analog (rate = 2^32-1). The rate is
    informational for decode — PCM must be unchanged — but ident parsing,
    stats bitrate math, and granule<->time conversion must survive the
    unsigned extreme."""
    headers, audio, serial = extract_packets(data)
    ident = bytearray(headers[0][0])
    # "\x01vorbis" (7) + version u32 (4) + channels u8 (1) -> rate at 12
    ident[12:16] = struct.pack("<I", rate & 0xFFFFFFFF)
    headers = [(bytes(ident), headers[0][1])] + headers[1:]
    fr = _Framer(serial)
    fr.add_packets(headers[:1], first_flags=0x02)
    fr.add_packets(headers[1:])
    fr.add_packets(audio, body_cap=4096)
    return fr.finish()


def make_serial_reuse_chain(data: bytes) -> bytes:
    """Chained file whose second chain REUSES the first chain's serial
    number — legal: EOS retires a serial, a later BOS may claim it again
    (reference Ogg/PageReader.cs:77-87 retires EOS serials;
    OggTests.cs:9-92 chained cases). Sequence numbers restart at 0."""
    headers, audio, serial = extract_packets(data)

    def one_chain() -> bytes:
        fr = _Framer(serial)
        fr.add_packets(headers[:1], first_flags=0x02)
        fr.add_packets(headers[1:])
        fr.add_packets(audio, body_cap=2000)
        return fr.finish()

    return one_chain() + one_chain()
