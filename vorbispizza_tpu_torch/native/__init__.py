"""Native (C++) entropy front end: build-on-demand loader + ctypes wrapper.

Counterpart of the reference's SIMD hot paths (Codebook.DecodeScalar,
Huffman prefix table, Floor1.Unpack, Residue0.Decode). The shared library
is compiled lazily from frontend.cpp with g++ into the package's
``_build/`` directory (listed in ``.gitignore``, so every checkout builds
its own); decode_packets() fans packets out across threads and fills
dense numpy tensors for the batch synthesis pipeline.

Falls back cleanly: callers check ``available()`` and use the pure-Python
path when the toolchain or build is missing.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "frontend.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_LIB = os.path.join(_BUILD, "_frontend.so")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    """Compile frontend.cpp -> _frontend.so; returns error text or None."""
    # a per-process temporary, so concurrent first uses cannot interleave
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", "-o", tmp, _SRC,
    ]
    try:
        os.makedirs(_BUILD, exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:  # no toolchain
        return str(e)
    if proc.returncode != 0:
        return proc.stderr[-2000:]
    os.replace(tmp, _LIB)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        need_build = (
            not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        )
        if need_build:
            _build_error = _build()
            if _build_error is not None:
                return None
        try:
            lib = C.CDLL(_LIB)
        except OSError as e:
            _build_error = str(e)
            return None
        lib.vp_scan_ogg.restype = C.c_int64
        lib.vp_scan_ogg.argtypes = [
            C.c_char_p, C.c_int64, C.c_int64,
            C.POINTER(C.c_uint8), C.c_int64,
            C.POINTER(C.c_int64), C.POINTER(C.c_int64), C.POINTER(C.c_uint8),
            C.c_int64, C.POINTER(C.c_int64),
        ]
        lib.vp_decode_packets.restype = C.c_int
        lib.vp_decode_packets.argtypes = [
            C.c_char_p, C.c_int64,            # setup blob
            C.c_void_p,                       # packet bytes base
            C.POINTER(C.c_int64), C.POINTER(C.c_int64), C.c_int64,  # spans
            C.POINTER(C.c_int32),             # meta
            C.POINTER(C.c_float),             # residues
            C.POINTER(C.c_int32),             # posts
            C.POINTER(C.c_uint8),             # step2
            C.POINTER(C.c_uint8),             # used
            C.POINTER(C.c_float),             # f0_coeffs
            C.POINTER(C.c_int32),             # f0_amp
            C.POINTER(C.c_int16),             # ys (coded floor1 values)
            C.c_int,                          # n_threads
            C.POINTER(C.c_int64),             # threads' CPU ns (nullable)
        ]
        lib.vp_unpack_pcm.restype = C.c_int
        lib.vp_unpack_pcm.argtypes = [
            C.POINTER(C.c_uint8), C.c_int64,   # packed data
            C.POINTER(C.c_uint8), C.c_int64,   # width table
            C.c_int64, C.c_int64,              # C, L
            C.POINTER(C.c_uint32),             # ch_ubit (nullable)
            C.POINTER(C.c_int16),              # out
            C.c_int,                           # n_threads
        ]
        lib.vp_decode_packets_sym.restype = C.c_int
        lib.vp_decode_packets_sym.argtypes = [
            C.c_char_p, C.c_int64,            # setup blob
            C.c_void_p,                       # packet bytes base
            C.POINTER(C.c_int64), C.POINTER(C.c_int64), C.c_int64,  # spans
            C.POINTER(C.c_int32),             # meta
            C.POINTER(C.c_int32),             # posts
            C.POINTER(C.c_uint8),             # step2
            C.POINTER(C.c_uint8),             # used
            C.POINTER(C.c_float),             # f0_coeffs
            C.POINTER(C.c_int32),             # f0_amp
            C.POINTER(C.c_int16),             # ys (coded floor1 values)
            C.POINTER(C.c_uint8),             # cls
            C.POINTER(C.c_uint16),            # syms
            C.POINTER(C.c_uint16),            # slots
            C.POINTER(C.c_int32),             # sym_counts
            C.POINTER(C.c_int32),             # pair_counts
            C.c_int64, C.c_int64, C.c_int64, C.c_int64,  # pt_max/sym_cap/n_groups/n_sp
            C.c_int,                          # n_threads
            C.POINTER(C.c_int64),             # threads' CPU ns (nullable)
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def _ptr(a, ctype):
    return a.ctypes.data_as(C.POINTER(ctype))


def scan_ogg_arrays(data: bytes, serial: int = -1):
    """Scan one logical stream out of an Ogg byte buffer (frontend.cpp
    vp_scan_ogg — mirrors ogg/page.py + ogg/logical.py), keeping the result
    as RAW ARRAYS: no per-packet Python objects or slice copies.

    Returns (blob u8[.], offs i64[P+1], granules i64[P], flags u8[P],
    serial) — packet i's bytes are blob[offs[i]:offs[i+1]], laid out
    back-to-back — or None when the native scanner cannot model the stream
    (caller falls back to the Python layer). flags: bit0 resync, bit1 EOS.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(data)
    blob = np.empty(max(n, 1), dtype=np.uint8)
    max_pkts = max(n // 64, 64)
    out_serial = C.c_int64(-1)
    while True:
        offs = np.zeros(max_pkts + 1, dtype=np.int64)
        granules = np.zeros(max_pkts, dtype=np.int64)
        flags = np.zeros(max_pkts, dtype=np.uint8)
        rc = lib.vp_scan_ogg(
            data, n, serial,
            _ptr(blob, C.c_uint8), blob.nbytes,
            _ptr(offs, C.c_int64), _ptr(granules, C.c_int64),
            _ptr(flags, C.c_uint8),
            max_pkts, C.byref(out_serial),
        )
        if rc == -2 and max_pkts < n + 2:  # packet-table capacity: grow
            max_pkts = min(max_pkts * 4, n + 2)
            continue
        break
    if rc < 0:
        return None
    return (
        blob,
        offs[: rc + 1],
        granules[:rc],
        flags[:rc],
        int(out_serial.value),
    )


def scan_ogg(data: bytes, serial: int = -1):
    """scan_ogg_arrays materialized into ogg.logical.Packet objects (the
    compatibility surface for provider-shaped callers)."""
    from ..ogg.logical import Packet

    res = scan_ogg_arrays(data, serial)
    if res is None:
        return None
    blob, offs, granules, flags, out_serial = res
    raw = blob.tobytes()
    packets = [
        Packet(
            data=raw[offs[i] : offs[i + 1]],
            granule=int(granules[i]),
            is_resync=bool(flags[i] & 1),
            is_end_of_stream=bool(flags[i] & 2),
            page_index=0,
            packet_index=i,
        )
        for i in range(len(granules))
    ]
    return packets, out_serial


def decode_packets(
    blob: bytes,
    packets: list[bytes],
    channels: int,
    max_half: int,
    max_order: int,
    n_threads: int | None = None,
):
    """Decode a LIST of packet byte strings -> dense tensors (convenience
    over decode_packet_spans for provider-shaped callers)."""
    P = len(packets)
    offs = np.zeros(P + 1, dtype=np.int64)
    for i, p in enumerate(packets):
        offs[i + 1] = offs[i] + len(p)
    data = np.frombuffer(b"".join(packets), dtype=np.uint8)
    return decode_packet_spans(
        blob, data, offs[:-1], offs[1:], channels, max_half, max_order,
        n_threads=n_threads,
    )


def decode_packet_spans(
    blob: bytes,
    data: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    channels: int,
    max_half: int,
    max_order: int,
    n_threads: int | None = None,
    cpu_ns: C.c_int64 | None = None,
):
    """Decode audio packets addressed as (start, end) spans into ``data``
    (u8 array — e.g. the Ogg scan's blob, handed straight through with no
    re-join or per-packet copies) -> dense tensors. ``cpu_ns``: a
    ctypes.c_int64 to which the decode adds the CPU nanoseconds of every
    thread that ran it (CLOCK_THREAD_CPUTIME_ID); None reads no clock.

    Returns dict with: meta [P,5] i32 (ok, mode_idx, prev, next,
    audio bits consumed — exact StreamStats accounting),
    residues [P,C,max_half] f32 (pre-coupling), posts [P,C,65] i32,
    step2 [P,C,65] u8, used [P,C] u8, f0_coeffs [P,C,max_order] f32,
    f0_amp [P,C] i32, ys [P,C,65] i16 (coded floor1 values, pre-unwrap,
    saturated to 32767)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native front end unavailable: {_build_error}")
    P = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)

    meta = np.zeros((P, 5), dtype=np.int32)
    # residues[:, :, :half] is fully written by the decoder for every audio
    # packet; the tail past each packet's half-blocksize is never read
    residues = np.empty((P, channels, max_half), dtype=np.float32)
    posts = np.zeros((P, channels, 65), dtype=np.int32)
    step2 = np.zeros((P, channels, 65), dtype=np.uint8)
    used = np.zeros((P, channels), dtype=np.uint8)
    mo = max(max_order, 1)
    f0_coeffs = np.zeros((P, channels, mo), dtype=np.float32)
    f0_amp = np.zeros((P, channels), dtype=np.int32)
    ys = np.zeros((P, channels, 65), dtype=np.int16)

    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    rc = lib.vp_decode_packets(
        blob, len(blob),
        data.ctypes.data_as(C.c_void_p),
        _ptr(starts, C.c_int64), _ptr(ends, C.c_int64), P,
        _ptr(meta, C.c_int32),
        _ptr(residues, C.c_float),
        _ptr(posts, C.c_int32),
        _ptr(step2, C.c_uint8),
        _ptr(used, C.c_uint8),
        _ptr(f0_coeffs, C.c_float),
        _ptr(f0_amp, C.c_int32),
        _ptr(ys, C.c_int16),
        int(n_threads),
        None if cpu_ns is None else C.byref(cpu_ns),
    )
    if rc != 0:
        raise RuntimeError(f"vp_decode_packets failed: {rc}")
    return {
        "meta": meta,
        "residues": residues,
        "posts": posts,
        "step2": step2,
        "used": used,
        "f0_coeffs": f0_coeffs,
        "f0_amp": f0_amp,
        "ys": ys,
    }


def unpack_pcm(
    data: np.ndarray,
    widx: np.ndarray,
    channels: int,
    length: int,
    ch_ubit: np.ndarray | None = None,
):
    """Delta block-pack s16 unpack (frontend.cpp vp_unpack_pcm) ->
    int16 [channels, length], or None when the native library is missing
    (callers fall back to the numpy unpack in ops/pcm_pack.py).
    ``ch_ubit``: per-channel cumulative unary bit cuts (rice blocks);
    None is only valid for wires without rice blocks. A wire the C++
    side REJECTS (bad geometry / width class / unary desync) raises
    instead of returning None: falling through to the less-validated
    numpy path would turn an integrity failure into silently truncated
    PCM."""
    lib = _load()
    if lib is None:
        return None
    # the C unpacker reads up to 7 bytes past the last plane block and
    # the unary tail (unaligned 8-byte loads); give it slack
    buf = np.empty(data.size + 8, dtype=np.uint8)
    buf[: data.size] = data
    widx = np.ascontiguousarray(widx, dtype=np.uint8)
    if ch_ubit is not None:
        ch_ubit = np.ascontiguousarray(ch_ubit, dtype=np.uint32)
        if ch_ubit.size != channels:
            raise ValueError(
                f"ch_ubit has {ch_ubit.size} cuts for {channels} channels"
            )
        cuts_ptr = _ptr(ch_ubit, C.c_uint32)
    else:
        cuts_ptr = None
    out = np.empty((channels, length), dtype=np.int16)
    rc = lib.vp_unpack_pcm(
        _ptr(buf, C.c_uint8), int(data.size),
        _ptr(widx, C.c_uint8), int(widx.size),
        int(channels), int(length),
        cuts_ptr,
        _ptr(out, C.c_int16),
        min(os.cpu_count() or 1, max(int(channels), 1)),
    )
    if rc != 0:
        raise ValueError(
            f"vp_unpack_pcm rejected the dpack wire (rc={rc}): "
            f"nbt={widx.size} C={channels} L={length} nb={data.size}"
        )
    return out


def decode_packet_spans_sym(
    blob: bytes,
    data: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    channels: int,
    max_order: int,
    layout,
    n_threads: int | None = None,
    cpu_ns: C.c_int64 | None = None,
):
    """Symbol-mode decode (frontend.cpp vp_decode_packets_sym): floors as
    decode_packet_spans, residues as classifications + VQ entry numbers
    (see native/symbols.py for the wire contract). ``layout`` is the
    SymLayout from symbols.symbol_layout(); ``cpu_ns`` as
    decode_packet_spans's.

    Returns the decode_packet_spans dict minus ``residues`` (``ys``
    included), plus
    cls [P,C,pt_max] u8, syms [P,sym_cap] u16, slots [P,sym_cap] u16 (one
    traversal slot id pv = partition*V + vector_row per APPLIED partition,
    group-major like syms), sym_counts [P,n_groups] i32,
    pair_counts [P,n_sp] i32."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native front end unavailable: {_build_error}")
    P = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)

    meta = np.zeros((P, 5), dtype=np.int32)
    posts = np.zeros((P, channels, 65), dtype=np.int32)
    step2 = np.zeros((P, channels, 65), dtype=np.uint8)
    used = np.zeros((P, channels), dtype=np.uint8)
    mo = max(max_order, 1)
    f0_coeffs = np.zeros((P, channels, mo), dtype=np.float32)
    f0_amp = np.zeros((P, channels), dtype=np.int32)
    ys = np.zeros((P, channels, 65), dtype=np.int16)
    cls = np.empty((P, channels, layout.pt_max), dtype=np.uint8)
    syms = np.empty((P, layout.sym_cap), dtype=np.uint16)
    slots = np.empty((P, layout.sym_cap), dtype=np.uint16)
    sym_counts = np.zeros((P, layout.n_groups), dtype=np.int32)
    pair_counts = np.zeros((P, layout.n_sp), dtype=np.int32)

    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    rc = lib.vp_decode_packets_sym(
        blob, len(blob),
        data.ctypes.data_as(C.c_void_p),
        _ptr(starts, C.c_int64), _ptr(ends, C.c_int64), P,
        _ptr(meta, C.c_int32),
        _ptr(posts, C.c_int32),
        _ptr(step2, C.c_uint8),
        _ptr(used, C.c_uint8),
        _ptr(f0_coeffs, C.c_float),
        _ptr(f0_amp, C.c_int32),
        _ptr(ys, C.c_int16),
        _ptr(cls, C.c_uint8),
        _ptr(syms, C.c_uint16),
        _ptr(slots, C.c_uint16),
        _ptr(sym_counts, C.c_int32),
        _ptr(pair_counts, C.c_int32),
        layout.pt_max, layout.sym_cap, layout.n_groups, layout.n_sp,
        int(n_threads),
        None if cpu_ns is None else C.byref(cpu_ns),
    )
    if rc != 0:
        raise RuntimeError(f"vp_decode_packets_sym failed: {rc}")
    return {
        "meta": meta,
        "posts": posts,
        "step2": step2,
        "used": used,
        "f0_coeffs": f0_coeffs,
        "f0_amp": f0_amp,
        "ys": ys,
        "cls": cls,
        "syms": syms,
        "slots": slots,
        "sym_counts": sym_counts,
        "pair_counts": pair_counts,
    }
