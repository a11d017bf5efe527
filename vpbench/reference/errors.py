"""Error types for the framework.

Parity with the reference's failure surface: malformed streams raise
``InvalidDataError`` (reference: System.IO.InvalidDataException, thrown
throughout NVorbis/StreamDecoder.cs and Ogg/*), seeking failures raise
``SeekOutOfRangeError`` (reference: NVorbis/SeekOutOfRangeException.cs:5) or
``PrerollPacketError`` (reference: NVorbis/PreRollPacketException.cs:5).
"""

from __future__ import annotations


class VorbisError(Exception):
    """Base class for all framework errors."""


class InvalidDataError(VorbisError):
    """The stream violates the Ogg or Vorbis I specification."""


class EndOfStreamError(VorbisError):
    """Attempted to read past the logical end of stream."""


class SeekOutOfRangeError(VorbisError):
    """The requested seek position is outside the stream bounds."""


class PrerollPacketError(VorbisError):
    """Could not read the preroll packet required to re-prime lapping state."""


class NotSeekableError(VorbisError):
    """The operation (seek, total_samples on a long stream) needs a seekable
    source; on forward-only streams evicted pages cannot be re-read
    (reference: forward-only providers do not implement seeking)."""
