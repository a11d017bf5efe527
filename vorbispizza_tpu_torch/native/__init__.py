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
        # plan and gather: every array by its address (c_void_p)
        ptr, i64 = C.c_void_p, C.c_int64
        lib.vp_plan_scan.restype = C.c_int
        lib.vp_plan_scan.argtypes = [
            ptr, i64, ptr, ptr, ptr,          # blob, offs, granules, flags
            i64, i64, i64, i64, ptr, ptr,     # packets .. block_flag, win
            *[ptr] * 9,                       # per frame
            ptr, ptr, ptr, ptr, ptr, ptr,     # perm .. counts
        ]
        lib.vp_gather_buckets.restype = C.c_int
        lib.vp_gather_buckets.argtypes = [
            i64, i64, ptr, ptr, ptr, ptr, i64,  # frames .. buckets
            ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # plan in, per bucket out
            i64, ptr, ptr,                      # floor jobs
            ptr, ptr, ptr, ptr, ptr, i64, ptr,  # dense floors
            ptr, ptr, ptr, ptr, ptr, ptr,       # floor outputs
            ptr, ptr, ptr, i64, i64, ptr, ptr,  # symbols in
            ptr, ptr, ptr, i64, ptr, ptr,       # symbols out, bad frame
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


def _addr(a: np.ndarray) -> int:
    return a.ctypes.data


def plan_scan(blob, offs, granules, flags, first_audio, mode_bits,
              block_flag, win):
    """Pass 1 in C++ (frontend.cpp vp_plan_scan) over scan_ogg_arrays'
    arrays; ``block_flag`` u8 [modes] and ``win`` i64 [modes * 4, 4] (n,
    left_start, left_end, right_end of combo mode*4 + prev*2 + next).

    Returns a dict: ``start``, ``end`` (each frame's packet span in
    ``blob``), ``n``, ``left_start``, ``left_end``, ``right_end``,
    ``offset`` (i64 [F]), ``prime``, ``final`` (bool [F]), ``perm`` (i64
    [F], the frames bucket after bucket), ``bstart`` (i64 [buckets + 1]),
    ``bcombo`` (i32 [buckets]), ``chain`` (i64 [chains + 1], chain k is
    frames chain[k]:chain[k+1]), ``seg`` (i64 [chains, 2], chain k's kept
    range, none where empty) and ``total_len``. None where a chain needs
    the exact per-frame layout. Raises InvalidDataError for an audio
    packet's mode index out of bounds."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native front end unavailable: {_build_error}")
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    granules = np.ascontiguousarray(granules, dtype=np.int64)
    flags = np.ascontiguousarray(flags, dtype=np.uint8)
    block_flag = np.ascontiguousarray(block_flag, dtype=np.uint8)
    win = np.ascontiguousarray(win, dtype=np.int64)
    n_modes = len(block_flag)
    n_pkts = len(granules)
    if (len(offs) != n_pkts + 1 or len(flags) != n_pkts
            or win.shape != (4 * n_modes, 4)):
        raise ValueError("plan_scan: mismatched scan or mode tables")
    P = max(n_pkts - first_audio, 0)
    cap = max(P, 1)
    rows = np.empty((8, cap), dtype=np.int64)  # start .. offset, perm
    marks = np.empty((2, cap), dtype=bool)     # prime, final
    chain = np.empty(cap + 1, dtype=np.int64)
    seg = np.empty((cap, 2), dtype=np.int64)
    bstart = np.empty(4 * n_modes + 1, dtype=np.int64)
    bcombo = np.empty(4 * n_modes, dtype=np.int32)
    counts = np.empty(4, dtype=np.int64)
    r0, m0, row = _addr(rows), _addr(marks), 8 * cap
    rc = lib.vp_plan_scan(
        _addr(blob), blob.nbytes, _addr(offs), _addr(granules),
        _addr(flags), n_pkts, first_audio, mode_bits, n_modes,
        _addr(block_flag), _addr(win),
        *[r0 + i * row for i in range(7)], m0, m0 + cap,
        r0 + 7 * row, _addr(bstart), _addr(bcombo), _addr(chain),
        _addr(seg), _addr(counts),
    )
    if rc == 1:
        return None
    if rc == -1:
        from ..errors import InvalidDataError

        raise InvalidDataError("mode index out of bounds")
    if rc != 0:
        raise RuntimeError(f"vp_plan_scan failed: {rc}")
    F, n_chains, nb, total_len = counts.tolist()
    start, end, n, ls, le, re, off, perm = rows[:, :F]
    return {
        "start": start, "end": end, "n": n, "left_start": ls,
        "left_end": le, "right_end": re, "offset": off,
        "prime": marks[0, :F], "final": marks[1, :F], "perm": perm,
        "bstart": bstart[: nb + 1], "bcombo": bcombo[:nb],
        "chain": chain[: n_chains + 1], "seg": seg[:n_chains],
        "total_len": total_len,
    }


def gather_buckets(dec, perm, bstart, bmode, offset, prime, final, jobs,
                   chs, out, sym=None):
    """The per-bucket gather in C++ (frontend.cpp vp_gather_buckets) of a
    decode_packet_spans[_sym] result ``dec``: bucket k is frames
    perm[bstart[k]:bstart[k+1]] of mode bmode[k]; ``offset``, ``prime``,
    ``final`` are the plan's per-frame arrays. ``jobs`` i64 [J, 7] and
    ``chs`` describe the floor groups (see vp_gather_buckets). ``out``
    holds the caller's output arrays: ``offsets`` i32, ``prime``,
    ``final`` bool (each [F], bucket after bucket), ``audio_bits`` i64
    [F], ``posts`` i32, ``step2`` bool, ``ys`` i16, ``f0c`` f32, ``used``
    bool, ``f0a`` i32; with ``sym`` = (groups i64 [buckets], nsym i64
    [buckets, n_groups]) also ``pc`` i32, ``syms``, ``slots`` u16 and
    ``lens`` i64 [buckets, n_groups, 2], which gets each group stream's
    length. Raises RuntimeError where the decode disagrees with the plan
    or a symbol stream is not partition-aligned."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native front end unavailable: {_build_error}")
    F, channels = dec["used"].shape
    bstart = np.ascontiguousarray(bstart, dtype=np.int64)
    n_buckets = len(bstart) - 1
    args = [perm, bmode, offset, prime, final, jobs, chs]
    if not (len(perm) == bstart[-1] <= F == len(offset) == len(prime)
            == len(final) == len(out["audio_bits"]) and len(bmode)
            == n_buckets and jobs.shape[1:] == (7,)):
        raise ValueError("gather_buckets: mismatched plan arrays")
    for a, dt in zip(args, (np.int64, np.int64, np.int64, np.bool_,
                            np.bool_, np.int64, np.int64)):
        if a.dtype != dt:
            raise ValueError(f"gather_buckets: {a.dtype} where {dt} is due")
    for a in (*args, *dec.values(), *out.values()):
        if not a.flags.c_contiguous:
            raise ValueError("gather_buckets: arrays must be contiguous")
    if sym is None:
        syms = slots = counts = groups = nsym = None
        sym_cap = n_groups = cap = 0
    else:
        groups, nsym = sym
        syms, slots, counts = dec["syms"], dec["slots"], dec["sym_counts"]
        sym_cap, n_groups = syms.shape[1], counts.shape[1]
        cap = min(len(out["syms"]), len(out["slots"]))
        if nsym.shape != (n_buckets, n_groups):
            raise ValueError("gather_buckets: mismatched symbol tables")

    def addr(a):
        return None if a is None else a.ctypes.data

    bad = np.zeros(1, dtype=np.int64)
    rc = lib.vp_gather_buckets(
        F, channels, addr(dec["meta"]), addr(perm), addr(bstart),
        addr(bmode), n_buckets, addr(offset), addr(prime), addr(final),
        addr(out["offsets"]), addr(out["prime"]), addr(out["final"]),
        addr(out["audio_bits"]), len(jobs), addr(jobs), addr(chs),
        addr(dec["posts"]), addr(dec["step2"]), addr(dec["ys"]),
        addr(dec["used"]), addr(dec["f0_coeffs"]),
        dec["f0_coeffs"].shape[2], addr(dec["f0_amp"]),
        addr(out["posts"]), addr(out["step2"]), addr(out["ys"]),
        addr(out["used"]), addr(out["f0c"]), addr(out["f0a"]),
        addr(syms), addr(slots), addr(counts), sym_cap, n_groups,
        addr(groups), addr(nsym), addr(out.get("pc")), addr(out.get("syms")),
        addr(out.get("slots")), cap, addr(out.get("lens")), addr(bad),
    )
    if rc == 1:
        raise RuntimeError(
            f"native front end disagrees with plan at frame {int(bad[0])}")
    if rc == 2:
        raise RuntimeError("symbol stream not partition-aligned")
    if rc == 4:
        raise OverflowError("frame offset out of int32 range")
    if rc != 0:
        raise RuntimeError(f"vp_gather_buckets failed: {rc}")
