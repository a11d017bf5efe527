"""The plain reference of the benchmark: a frozen copy of the float64
scalar Vorbis decoder (Ogg demux, header parsing, floors, residues,
coupling, an FFT-based float64 IMDCT, overlap-add), numpy only.

It imports nothing of the program under test and takes only the input
bytes. ``decode`` gives the planar PCM [channels, samples] as float32,
clipped (unless told not to), as a decode of the whole stream delivers
it.
"""

from __future__ import annotations

import numpy as np

from .reader import VorbisReader


def decode(data: bytes, clip: bool = True) -> np.ndarray:
    """Planar float32 PCM [channels, samples] of the first Vorbis stream,
    clipped to full scale where ``clip``."""
    r = VorbisReader(bytes(data), clip_samples=clip)
    r.initialize()
    return r.read_all(planar=True)
