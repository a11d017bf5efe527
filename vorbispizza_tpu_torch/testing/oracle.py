"""ctypes oracle: decode with the system's native libvorbisfile.

The reference's test strategy is differential testing against libvorbis via
P/Invoke (NVorbis.Tests/Bindings/Vorbisfile.cs, NativeDecoder.cs); this is
the same oracle through ctypes. Test-only — the framework itself never links
native vorbis code. Where ``libvorbisfile.so.3`` does not load, opening an
``OracleDecoder`` raises ``OracleUnavailable``; ``available()`` says which
case holds.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

_lib = None


class OracleUnavailable(OSError):
    """libvorbisfile.so.3 does not load on this machine."""


def available() -> bool:
    """Whether libvorbisfile.so.3 loads here."""
    try:
        _load()
    except OracleUnavailable:
        return False
    return True


def _load():
    global _lib
    if _lib is None:
        try:
            lib = C.CDLL("libvorbisfile.so.3")
        except OSError as e:
            raise OracleUnavailable(
                f"the libvorbisfile oracle needs libvorbisfile.so.3: {e}"
            ) from None
        _lib = lib
        _lib.ov_fopen.argtypes = [C.c_char_p, C.c_void_p]
        _lib.ov_fopen.restype = C.c_int
        _lib.ov_read_float.argtypes = [
            C.c_void_p, C.POINTER(C.POINTER(C.POINTER(C.c_float))),
            C.c_int, C.POINTER(C.c_int),
        ]
        _lib.ov_read_float.restype = C.c_long
        _lib.ov_read.argtypes = [
            C.c_void_p, C.c_char_p, C.c_int, C.c_int, C.c_int, C.c_int,
            C.POINTER(C.c_int),
        ]
        _lib.ov_read.restype = C.c_long
        _lib.ov_info.argtypes = [C.c_void_p, C.c_int]
        _lib.ov_info.restype = C.POINTER(_VorbisInfo)
        _lib.ov_pcm_total.argtypes = [C.c_void_p, C.c_int]
        _lib.ov_pcm_total.restype = C.c_int64
        _lib.ov_pcm_seek.argtypes = [C.c_void_p, C.c_int64]
        _lib.ov_pcm_seek.restype = C.c_int
        _lib.ov_streams.argtypes = [C.c_void_p]
        _lib.ov_streams.restype = C.c_long
        _lib.ov_clear.argtypes = [C.c_void_p]
    return _lib


class _VorbisInfo(C.Structure):
    _fields_ = [
        ("version", C.c_int), ("channels", C.c_int), ("rate", C.c_long),
        ("bitrate_upper", C.c_long), ("bitrate_nominal", C.c_long),
        ("bitrate_lower", C.c_long), ("bitrate_window", C.c_long),
        ("codec_setup", C.c_void_p),
    ]


class OracleDecoder:
    """Native libvorbisfile decode of one physical file."""

    def __init__(self, path: str):
        lib = _load()
        self._vf = (C.c_byte * 2048)()  # OggVorbis_File is ~940 bytes
        rc = lib.ov_fopen(str(path).encode(), C.byref(self._vf))
        if rc != 0:
            raise RuntimeError(f"ov_fopen failed: {rc}")
        self._lib = lib
        self._open = True

    @property
    def channels(self) -> int:
        return self._lib.ov_info(C.byref(self._vf), -1).contents.channels

    @property
    def rate(self) -> int:
        return int(self._lib.ov_info(C.byref(self._vf), -1).contents.rate)

    @property
    def total(self) -> int:
        return int(self._lib.ov_pcm_total(C.byref(self._vf), -1))

    @property
    def n_streams(self) -> int:
        return int(self._lib.ov_streams(C.byref(self._vf)))

    def seek(self, pcm_pos: int) -> None:
        rc = self._lib.ov_pcm_seek(C.byref(self._vf), pcm_pos)
        if rc != 0:
            raise RuntimeError(f"ov_pcm_seek failed: {rc}")

    def read_all_float(self, max_samples: int | None = None):
        """Decode the whole file -> list of (bitstream_index, planar float32
        [ch, n]) segments; a new tuple per logical-bitstream change."""
        lib = self._lib
        pcm = C.POINTER(C.POINTER(C.c_float))()
        sec = C.c_int(0)
        segments: list[tuple[int, list[np.ndarray]]] = []
        total = 0
        while True:
            n = lib.ov_read_float(C.byref(self._vf), C.byref(pcm), 4096, C.byref(sec))
            if n == 0:
                break
            if n < 0:
                # hole / bad data: libvorbis signals and continues
                continue
            ch = self.channels
            block = np.empty((ch, n), dtype=np.float32)
            for c in range(ch):
                block[c] = np.ctypeslib.as_array(pcm[c], shape=(n,))
            if not segments or segments[-1][0] != sec.value:
                segments.append((sec.value, []))
            segments[-1][1].append(block)
            total += n
            if max_samples is not None and total >= max_samples:
                break
        return [(idx, np.concatenate(blocks, axis=1)) for idx, blocks in segments]

    def read_float_n(self, n: int) -> np.ndarray:
        """Read up to ``n`` samples from the current position -> planar
        float32 [ch, m] (m <= n; stops early at stream boundaries)."""
        lib = self._lib
        pcm = C.POINTER(C.POINTER(C.c_float))()
        sec = C.c_int(0)
        blocks: list[np.ndarray] = []
        got = 0
        while got < n:
            want = min(4096, n - got)
            r = lib.ov_read_float(C.byref(self._vf), C.byref(pcm), want, C.byref(sec))
            if r <= 0:
                break
            ch = self.channels
            block = np.empty((ch, r), dtype=np.float32)
            for c in range(ch):
                block[c] = np.ctypeslib.as_array(pcm[c], shape=(r,))
            blocks.append(block)
            got += r
        if not blocks:
            return np.zeros((self.channels, 0), dtype=np.float32)
        return np.concatenate(blocks, axis=1)

    def read_float(self) -> np.ndarray:
        """Whole file as one planar float32 array (first logical stream)."""
        segs = self.read_all_float()
        if not segs:
            return np.zeros((self.channels, 0), dtype=np.float32)
        return np.concatenate([s[1] for s in segs], axis=1)

    def close(self) -> None:
        if self._open:
            self._lib.ov_clear(C.byref(self._vf))
            self._open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
