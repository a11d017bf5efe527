"""The benchmark's inputs: each configuration's pool of Ogg Vorbis members,
checked against recorded sha256 digests, and the Ogg arithmetic the
harness needs on its own (audio length from the last granule, a cut to the
first pages). Imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import struct

from .reference.ogg.crc import ogg_crc

ROOT = pathlib.Path(__file__).resolve().parent


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _files(corpus: dict) -> list[bytes]:
    """Members committed under ``corpus["dir"]``, in MANIFEST order."""
    root = ROOT.parent / corpus["dir"]
    manifest = json.loads((root / "MANIFEST.json").read_text())
    out = []
    for name, digest in manifest["sha256"].items():
        data = (root / name).read_bytes()
        if _sha(data) != digest:
            raise ValueError(f"{root / name}: sha256 differs from MANIFEST.json")
        out.append(data)
    return out


def load(config: dict) -> list[bytes]:
    """The configuration's pool, each member checked."""
    corpus = config["corpus"]
    if corpus["kind"] == "files":
        return _files(corpus)
    raise ValueError(f"corpus kind {corpus['kind']!r}")


def pages(data: bytes) -> list[tuple[int, int]]:
    """(offset, size) of each page of a well-formed physical stream."""
    out, pos = [], 0
    while pos + 27 <= len(data) and data[pos : pos + 4] == b"OggS":
        nseg = data[pos + 26]
        size = 27 + nseg + sum(data[pos + 27 : pos + 27 + nseg])
        out.append((pos, size))
        pos += size
    return out


def cut(data: bytes, n_pages: int) -> bytes:
    """``data`` cut to its first ``n_pages`` pages, the last one flagged
    end-of-stream and its CRC recomputed (the others are unchanged)."""
    kept = pages(data)[:n_pages]
    off, size = kept[-1]
    last = bytearray(data[off : off + size])
    last[5] |= 4
    last[22:26] = b"\0\0\0\0"
    last[22:26] = struct.pack("<I", ogg_crc(bytes(last)))
    return data[:off] + bytes(last)


def audio_shape(data: bytes) -> tuple[int, int, int]:
    """(channels, samples per channel, sample rate) of a stream that
    starts at granule 0: the channels and rate from the identification
    header (first page), the samples from the last page's granule."""
    pg = pages(data)
    off, _ = pg[0]
    nseg = data[off + 26]
    ident = off + 27 + nseg
    if data[ident : ident + 7] != b"\x01vorbis":
        raise ValueError("first page holds no Vorbis identification header")
    channels = data[ident + 11]
    rate = struct.unpack("<I", data[ident + 12 : ident + 16])[0]
    last, _ = pg[-1]
    granule = struct.unpack("<q", data[last + 6 : last + 14])[0]
    return channels, granule, rate
