"""Synthesize Ogg Vorbis test vectors with the system libvorbisenc (ctypes).

The reference downloads its conformance corpora (Xiph/libnogg/lewton) from
the network (NVorbis.Tests/Utils/TestAssets.cs); this environment has no
egress, so we synthesize equivalent coverage locally: multichannel (coupling
+ Residue2), long/short block switching (transients), chained and multiplexed
physical streams, quality extremes. Test/bench-support only.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

_ogg = None
_vbs = None
_enc = None


class _OggPacket(C.Structure):
    _fields_ = [
        ("packet", C.POINTER(C.c_ubyte)), ("bytes", C.c_long),
        ("b_o_s", C.c_long), ("e_o_s", C.c_long),
        ("granulepos", C.c_int64), ("packetno", C.c_int64),
    ]


class _OggPage(C.Structure):
    _fields_ = [
        ("header", C.POINTER(C.c_ubyte)), ("header_len", C.c_long),
        ("body", C.POINTER(C.c_ubyte)), ("body_len", C.c_long),
    ]


class _OggStreamState(C.Structure):
    _fields_ = [("_opaque", C.c_byte * 408)]


class _VorbisInfo(C.Structure):
    _fields_ = [
        ("version", C.c_int), ("channels", C.c_int), ("rate", C.c_long),
        ("bitrate_upper", C.c_long), ("bitrate_nominal", C.c_long),
        ("bitrate_lower", C.c_long), ("bitrate_window", C.c_long),
        ("codec_setup", C.c_void_p),
    ]


class _VorbisComment(C.Structure):
    _fields_ = [
        ("user_comments", C.POINTER(C.c_char_p)),
        ("comment_lengths", C.POINTER(C.c_int)),
        ("comments", C.c_int), ("vendor", C.c_char_p),
    ]


class _VorbisDspState(C.Structure):
    _fields_ = [("_opaque", C.c_byte * 512)]


class _VorbisBlock(C.Structure):
    _fields_ = [("_opaque", C.c_byte * 512)]


def _load():
    global _ogg, _vbs, _enc
    if _ogg is None:
        _ogg = C.CDLL("libogg.so.0")
        _vbs = C.CDLL("libvorbis.so.0")
        _enc = C.CDLL("libvorbisenc.so.2")
        _vbs.vorbis_analysis_buffer.restype = C.POINTER(C.POINTER(C.c_float))
    return _ogg, _vbs, _enc


def encode_vorbis(
    pcm: np.ndarray,
    rate: int = 44100,
    quality: float = 0.4,
    serial: int = 1,
    comments: dict[str, str] | None = None,
    bitrate: int | None = None,
) -> bytes:
    """Encode planar float PCM [channels, n] -> one logical Ogg Vorbis stream.

    ``bitrate`` (bits/s) switches to the bitrate-MANAGED encoder setup
    (vorbis_encode_init nominal mode) instead of VBR quality mode — a
    different codebook/floor/residue vintage than init_vbr, widening the
    synthesized conformance coverage (the reference's corpora span both;
    NVorbis.Tests/Utils/TestAssets.cs)."""
    ogg, vbs, enc = _load()
    pcm = np.ascontiguousarray(pcm, dtype=np.float32)
    channels, n = pcm.shape

    vi = _VorbisInfo()
    vbs.vorbis_info_init(C.byref(vi))
    if bitrate is not None:
        rc = enc.vorbis_encode_init(
            C.byref(vi),
            C.c_long(channels),
            C.c_long(rate),
            C.c_long(-1),
            C.c_long(int(bitrate)),
            C.c_long(-1),
        )
        if rc != 0:
            raise RuntimeError(f"vorbis_encode_init failed: {rc}")
    else:
        rc = enc.vorbis_encode_init_vbr(
            C.byref(vi), C.c_long(channels), C.c_long(rate), C.c_float(quality)
        )
        if rc != 0:
            raise RuntimeError(f"vorbis_encode_init_vbr failed: {rc}")
    vc = _VorbisComment()
    vbs.vorbis_comment_init(C.byref(vc))
    for k, v in (comments or {}).items():
        vbs.vorbis_comment_add_tag(C.byref(vc), k.encode(), v.encode())
    vd = _VorbisDspState()
    vb = _VorbisBlock()
    vbs.vorbis_analysis_init(C.byref(vd), C.byref(vi))
    vbs.vorbis_block_init(C.byref(vd), C.byref(vb))

    os_ = _OggStreamState()
    ogg.ogg_stream_init(C.byref(os_), C.c_int(serial))

    out = bytearray()
    pg = _OggPage()

    def flush_pages(force: bool) -> None:
        fn = ogg.ogg_stream_flush if force else ogg.ogg_stream_pageout
        while fn(C.byref(os_), C.byref(pg)) != 0:
            out.extend(C.string_at(pg.header, pg.header_len))
            out.extend(C.string_at(pg.body, pg.body_len))

    # headers
    hdr = _OggPacket()
    hdr_comm = _OggPacket()
    hdr_code = _OggPacket()
    vbs.vorbis_analysis_headerout(
        C.byref(vd), C.byref(vc), C.byref(hdr), C.byref(hdr_comm), C.byref(hdr_code)
    )
    ogg.ogg_stream_packetin(C.byref(os_), C.byref(hdr))
    ogg.ogg_stream_packetin(C.byref(os_), C.byref(hdr_comm))
    ogg.ogg_stream_packetin(C.byref(os_), C.byref(hdr_code))
    flush_pages(True)

    op = _OggPacket()
    pos = 0
    CHUNK = 4096
    while True:
        take = min(CHUNK, n - pos)
        if take > 0:
            buf = vbs.vorbis_analysis_buffer(C.byref(vd), C.c_int(take))
            for c in range(channels):
                C.memmove(
                    buf[c],
                    pcm[c, pos : pos + take].ctypes.data,
                    take * 4,
                )
            vbs.vorbis_analysis_wrote(C.byref(vd), C.c_int(take))
            pos += take
        else:
            vbs.vorbis_analysis_wrote(C.byref(vd), C.c_int(0))  # EOS
        while vbs.vorbis_analysis_blockout(C.byref(vd), C.byref(vb)) == 1:
            vbs.vorbis_analysis(C.byref(vb), None)
            vbs.vorbis_bitrate_addblock(C.byref(vb))
            while vbs.vorbis_bitrate_flushpacket(C.byref(vd), C.byref(op)) == 1:
                ogg.ogg_stream_packetin(C.byref(os_), C.byref(op))
                flush_pages(False)
        if take == 0:
            break
    flush_pages(True)

    ogg.ogg_stream_clear(C.byref(os_))
    vbs.vorbis_block_clear(C.byref(vb))
    vbs.vorbis_dsp_clear(C.byref(vd))
    vbs.vorbis_comment_clear(C.byref(vc))
    vbs.vorbis_info_clear(C.byref(vi))
    return bytes(out)


# -- signal generators ---------------------------------------------------------


def make_signal(
    channels: int, seconds: float, rate: int = 44100, kind: str = "music", seed: int = 0
) -> np.ndarray:
    """Deterministic test signals. ``music`` mixes tones + transients so the
    encoder exercises long/short block switching."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    out = np.zeros((channels, n), dtype=np.float64)
    for c in range(channels):
        if kind == "sine":
            out[c] = 0.5 * np.sin(2 * np.pi * (220 * (c + 1)) * t)
        elif kind == "noise":
            out[c] = 0.3 * rng.standard_normal(n)
        else:  # music-like: chords + AM + periodic clicks (forces short blocks)
            f0 = 110.0 * (c + 1)
            sig = (
                0.30 * np.sin(2 * np.pi * f0 * t)
                + 0.20 * np.sin(2 * np.pi * f0 * 1.5 * t + 0.1)
                + 0.10 * np.sin(2 * np.pi * f0 * 2.01 * t)
            )
            sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)
            clicks = np.zeros(n)
            step = int(0.25 * rate)
            for k in range(step // 2, n, step):
                w = min(400, n - k)
                clicks[k : k + w] += np.hanning(max(w, 1)) * rng.uniform(0.4, 0.8)
            sig += clicks * np.sin(2 * np.pi * 3000 * t)
            out[c] = 0.8 * sig / np.max(np.abs(sig))
    return out.astype(np.float32)


def chain_streams(*streams: bytes) -> bytes:
    """Concatenate logical streams into one chained physical stream."""
    return b"".join(streams)


def multiplex_streams(*streams: bytes) -> bytes:
    """Interleave the pages of two or more logical streams into one
    physical stream (grouped multiplexing: all BOS pages first, per Ogg
    spec), round-robin page order."""
    from ..ogg.page import PageScanner
    import io

    def pages(data):
        sc = PageScanner(io.BytesIO(data))
        out = []
        while (p := sc.next_page()) is not None:
            out.append(data[p.offset : p.offset + p.page_size])
        return out

    plists = [pages(s) for s in streams]
    out = [pl[0] for pl in plists]  # all BOS pages first
    idx = [1] * len(plists)
    while any(i < len(pl) for i, pl in zip(idx, plists)):
        for k, pl in enumerate(plists):
            # alternate, draining whichever remains
            if idx[k] < len(pl):
                out.append(pl[idx[k]])
                idx[k] += 1
    return b"".join(out)
