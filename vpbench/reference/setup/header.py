"""Vorbis header packets: identification, comments, setup.

Behavior parity with reference NVorbis/StreamDecoder.cs header state machine
(ProcessHeaderPackets:125, LoadStreamHeader:213, LoadComments:242,
LoadBooks:262) including the codec-detection diagnostics for non-Vorbis
streams (GetInvalidStreamException:88-121). Spec sections 4.2.1-4.2.4.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..bitstream import BitReader
from ..errors import InvalidDataError
from ..utils.bits import ilog
from .codebook import Codebook
from .floor import Floor0, Floor1
from .mapping import Mapping
from .mode import Mode
from .residue import parse_residue

_VORBIS = b"vorbis"

# Signatures of other codecs, for helpful errors on mis-fed streams
# (reference StreamDecoder.GetInvalidStreamException:88-121)
_KNOWN_CODECS = [
    (b"OpusHead", "Opus"),
    (b"\x7fFLAC", "FLAC"),
    (b"Speex   ", "Speex"),
    (b"fishead\x00", "Ogg Skeleton"),
    (b"\x80theora", "Theora"),
]


def detect_codec(data: bytes) -> str | None:
    for sig, name in _KNOWN_CODECS:
        if data.startswith(sig):
            return name
    return None


@dataclass
class IdentHeader:
    channels: int
    sample_rate: int
    bitrate_upper: int
    bitrate_nominal: int
    bitrate_lower: int
    blocksizes: tuple[int, int]  # (short, long)


def parse_ident(data: bytes) -> IdentHeader:
    br = BitReader(data)
    if br.read_bits(8) != 0x01 or br.read_bytes(6) != _VORBIS:
        codec = detect_codec(data)
        if codec:
            raise InvalidDataError(f"not a Vorbis stream (detected {codec})")
        raise InvalidDataError("invalid identification header signature")
    if br.read_bits(32) != 0:
        raise InvalidDataError("unsupported Vorbis version")
    channels = br.read_bits(8)
    rate = br.read_bits(32)
    upper = br.read_bits(32)
    nominal = br.read_bits(32)
    lower = br.read_bits(32)
    bs0 = 1 << br.read_bits(4)
    bs1 = 1 << br.read_bits(4)
    framing = br.read_bit()
    if channels < 1 or rate < 1:
        raise InvalidDataError("bad channel count or sample rate")
    if not (64 <= bs0 <= 8192 and 64 <= bs1 <= 8192 and bs0 <= bs1):
        raise InvalidDataError(f"bad blocksizes ({bs0}, {bs1})")
    if not framing or br.overrun:
        raise InvalidDataError("identification header framing error")
    # signed bitrates
    def s32(x):
        return x - (1 << 32) if x >= (1 << 31) else x

    return IdentHeader(channels, rate, s32(upper), s32(nominal), s32(lower), (bs0, bs1))


@dataclass
class CommentHeader:
    vendor: str
    comments: list[str]


def parse_comments(data: bytes) -> CommentHeader:
    br = BitReader(data)
    if br.read_bits(8) != 0x03 or br.read_bytes(6) != _VORBIS:
        raise InvalidDataError("invalid comment header signature")
    vlen = br.read_bits(32)
    if vlen > br.bits_remaining // 8:
        raise InvalidDataError("comment header vendor length exceeds packet")
    vendor = br.read_bytes(vlen).decode("utf-8", errors="replace")
    count = br.read_bits(32)
    if count > br.bits_remaining // 32:  # each comment needs >= 32 bits
        raise InvalidDataError("comment count exceeds packet size")
    comments = []
    for _ in range(count):
        clen = br.read_bits(32)
        if clen > br.bits_remaining // 8:
            raise InvalidDataError("comment header truncated")
        comments.append(br.read_bytes(clen).decode("utf-8", errors="replace"))
    if not br.read_bit() or br.overrun:
        raise InvalidDataError("comment header framing error")
    return CommentHeader(vendor, comments)


@dataclass
class SetupHeader:
    codebooks: list[Codebook]
    floors: list
    residues: list
    mappings: list[Mapping]
    modes: list[Mode]
    mode_bits: int  # bits to read for the per-packet mode number


_SETUP_CACHE: dict = {}
_SETUP_CACHE_MAX = 64
_SETUP_CACHE_LOCK = threading.Lock()


def parse_setup_cached(data: bytes, ident: IdentHeader) -> SetupHeader:
    """Content-addressed setup parse: corpus files produced by the same
    encoder settings share byte-identical setup headers, so the expensive
    codebook/Huffman construction amortizes across streams. SetupHeader is
    immutable after construction, so sharing is safe.

    Thread-safe: decode_corpus parses headers from a thread pool, and the
    shared-BatchSynthesizer grouping keys on setup identity — a racy
    duplicate parse or a mid-corpus eviction of a live entry would split
    one encoder setting into several compiled-program groups. The lock plus
    single-entry FIFO eviction keeps identities stable."""
    key = (hash(data), ident.channels, ident.blocksizes)
    with _SETUP_CACHE_LOCK:
        hit = _SETUP_CACHE.get(key)
        if hit is not None and hit[0] == data:
            return hit[1]
    setup = parse_setup(data, ident)  # expensive; outside the lock
    with _SETUP_CACHE_LOCK:
        hit = _SETUP_CACHE.get(key)
        if hit is not None and hit[0] == data:
            return hit[1]  # another thread won the race: share its object
        if len(_SETUP_CACHE) >= _SETUP_CACHE_MAX:
            _SETUP_CACHE.pop(next(iter(_SETUP_CACHE)))  # oldest insertion
        _SETUP_CACHE[key] = (data, setup)
    return setup


def parse_setup(data: bytes, ident: IdentHeader) -> SetupHeader:
    br = BitReader(data)
    if br.read_bits(8) != 0x05 or br.read_bytes(6) != _VORBIS:
        raise InvalidDataError("invalid setup header signature")
    codebooks = [Codebook(br) for _ in range(br.read_bits(8) + 1)]
    # time-domain transform placeholders (spec 4.2.4 step 2)
    for _ in range(br.read_bits(6) + 1):
        if br.read_bits(16) != 0:
            raise InvalidDataError("nonzero time transform")
    floors = []
    for _ in range(br.read_bits(6) + 1):
        ftype = br.read_bits(16)
        if ftype == 0:
            floors.append(Floor0(br, ident.channels, ident.blocksizes, codebooks))
        elif ftype == 1:
            floors.append(Floor1(br, ident.channels, ident.blocksizes, codebooks))
        else:
            raise InvalidDataError(f"bad floor type {ftype}")
    residues = [parse_residue(br, codebooks) for _ in range(br.read_bits(6) + 1)]
    mappings = [
        Mapping(br, ident.channels, floors, residues)
        for _ in range(br.read_bits(6) + 1)
    ]
    n_modes = br.read_bits(6) + 1
    modes = [Mode(br, ident.blocksizes, len(mappings)) for _ in range(n_modes)]
    if not br.read_bit() or br.overrun:
        raise InvalidDataError("setup header framing error")
    return SetupHeader(
        codebooks=codebooks,
        floors=floors,
        residues=residues,
        mappings=mappings,
        modes=modes,
        mode_bits=ilog(n_modes - 1),
    )
