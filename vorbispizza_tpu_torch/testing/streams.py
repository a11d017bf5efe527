"""Small deterministic test streams, built the way the JAX package's
``__graft_entry__.entry()`` builds its example chunk (libvorbisenc music
signals), plus spec-corner raw streams (testing/rawstream.py).

Groups:
  stereo   two 1 s stereo streams at q0.3 and q0.5 (two setups, one chunk)
  mono     one 1 s mono stream at q0.4
  surround one 0.5 s 5.1 stream at q0.4 (three coupling steps)
  oddbooks a mono raw stream with many bucket keys and odd codebooks
  floor0   a mono raw stream with floor0 and a residue-0 (format 0) submap
  values   a stereo raw stream with two submaps that symbol transport
           cannot carry (value-transport residues, two floor groups)
"""

from __future__ import annotations

from functools import lru_cache


def vorbisenc_available() -> bool:
    import ctypes

    try:
        ctypes.CDLL("libvorbisenc.so.2")
    except OSError:
        return False
    return True


@lru_cache(maxsize=None)
def make_streams(group: str) -> tuple[bytes, ...]:
    from . import rawstream
    from .encode import encode_vorbis, make_signal

    if group == "stereo":
        return tuple(
            encode_vorbis(make_signal(2, 1.0, kind="music", seed=s), quality=q)
            for s, q in ((0, 0.3), (1, 0.5))
        )
    if group == "mono":
        return (encode_vorbis(make_signal(1, 1.0, kind="music", seed=5),
                              quality=0.4),)
    if group == "surround":
        return (encode_vorbis(make_signal(6, 0.5, kind="music", seed=100),
                              quality=0.4),)
    if group == "oddbooks":
        return (rawstream.make_oddbooks_stream(),)
    if group == "floor0":
        return (rawstream.make_floor0_stream(n_packets=8),)
    if group == "values":
        return (rawstream.make_multisubmap_stream(),)
    raise KeyError(group)
