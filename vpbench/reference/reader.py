"""VorbisReader: the user-facing facade over container + decoders.

Behavior parity with reference NVorbis/VorbisReader.cs:11 (IVorbisReader):
multi-stream management, NewStream event with veto, stream switching,
chained-file FindNextStream, interleaved/planar reads, time/sample seek.
"""

from __future__ import annotations

import io
from typing import Callable

import numpy as np

from .decoder import StreamDecoder
from .errors import InvalidDataError
from .ogg.container import OggContainer


class VorbisReader:
    def __init__(self, source, *, clip_samples: bool = True,
                 skip_tags: bool = False,
                 new_stream_callback: Callable[[StreamDecoder], bool] | None = None,
                 leave_open: bool = False):
        """``source``: file path or binary stream (seekable or forward-only)."""
        if isinstance(source, (str, bytes)) and not isinstance(source, bytes):
            self._file = open(source, "rb")
            self._owns = True
        elif isinstance(source, (bytes, bytearray)):
            self._file = io.BytesIO(source)
            self._owns = True
        else:
            self._file = source
            self._owns = not leave_open
        self._clip = clip_samples
        self._skip_tags = skip_tags
        self._user_cb = new_stream_callback
        self.streams: list[StreamDecoder] = []
        self._stream_idx = -1
        self._container = OggContainer(self._file, new_stream_callback=self._on_new_stream)

    # -- stream management (reference VorbisReader.cs:56-85,191-217) ----------------

    def initialize(self) -> None:
        if not self._container.try_init():
            raise InvalidDataError("could not find a Vorbis stream")
        if self._stream_idx < 0 and self.streams:
            self._stream_idx = 0

    def _on_new_stream(self, provider) -> bool:
        decoder = StreamDecoder(
            provider, clip_samples=self._clip, skip_tags=self._skip_tags
        )
        # initialize() pulls header packets, which can discover further
        # multiplexed streams reentrantly; remember our slot so streams stay
        # in discovery order (reference VorbisReader.ProcessNewStream:68)
        slot = len(self.streams)
        try:
            decoder.initialize()
        except InvalidDataError:
            return False  # not Vorbis: ignore this logical stream
        if self._user_cb is not None and not self._user_cb(decoder):
            return False
        self.streams.insert(slot, decoder)
        return True

    def find_next_stream(self) -> bool:
        """Scan for another logical stream (chained/multiplexed files;
        reference FindNextStream:191)."""
        known = len(self.streams)
        while len(self.streams) == known:
            if self._container.find_next_stream() is None:
                return False
        return True

    def switch_streams(self, index: int) -> bool:
        """Returns True if the new stream's format differs (reference
        SwitchStreams:197)."""
        if index < 0 or index >= len(self.streams):
            raise IndexError(index)
        old = self.stream_decoder if self._stream_idx >= 0 else None
        self._stream_idx = index
        new = self.streams[index]
        if old is None:
            return True
        return old.channels != new.channels or old.sample_rate != new.sample_rate

    @property
    def stream_decoder(self) -> StreamDecoder:
        if self._stream_idx < 0:
            raise InvalidDataError("reader not initialized")
        return self.streams[self._stream_idx]

    @property
    def stream_index(self) -> int:
        return self._stream_idx

    # -- delegated properties (reference VorbisReader.cs:113-183) --------------------

    @property
    def channels(self) -> int:
        return self.stream_decoder.channels

    @property
    def sample_rate(self) -> int:
        return self.stream_decoder.sample_rate

    @property
    def tags(self):
        return self.stream_decoder.tags

    @property
    def total_samples(self) -> int:
        return self.stream_decoder.total_samples

    @property
    def total_time(self) -> float:
        return self.stream_decoder.total_time

    @property
    def sample_position(self) -> int:
        return self.stream_decoder.sample_position

    @property
    def time_position(self) -> float:
        return self.sample_position / self.sample_rate

    @property
    def nominal_bitrate(self) -> int:
        """Reference IVorbisReader.NominalBitrate."""
        return self.stream_decoder.nominal_bitrate

    @property
    def upper_bitrate(self) -> int:
        """Reference IVorbisReader.UpperBitrate."""
        return self.stream_decoder.upper_bitrate

    @property
    def lower_bitrate(self) -> int:
        """Reference IVorbisReader.LowerBitrate."""
        return self.stream_decoder.lower_bitrate

    @property
    def streams_count(self) -> int:
        return len(self.streams)

    @property
    def is_end_of_stream(self) -> bool:
        return self.stream_decoder.is_end_of_stream

    @property
    def stats(self):
        return self.stream_decoder.stats

    @property
    def container_overhead_bits(self) -> int:
        return self._container.container_bits

    @property
    def container_waste_bits(self) -> int:
        return self._container.waste_bits

    @property
    def clip_samples(self) -> bool:
        return self.stream_decoder.clip_samples

    @clip_samples.setter
    def clip_samples(self, v: bool) -> None:
        self.stream_decoder.clip_samples = v

    @property
    def has_clipped(self) -> bool:
        return self.stream_decoder.has_clipped

    # -- reads / seeks ------------------------------------------------------------------

    def read_samples(self, count: int, planar: bool = False) -> np.ndarray:
        """Read up to ``count`` samples per channel of float32 PCM
        (reference ReadSamples:232; always whole-frame aligned by design)."""
        return self.stream_decoder.read(count, planar=planar)

    def read_all(self, planar: bool = False) -> np.ndarray:
        return self.stream_decoder.read_all(planar=planar)

    def seek_to(self, position, *, seconds: bool = False) -> None:
        if seconds:
            position = int(round(position * self.sample_rate))
        self.stream_decoder.seek_to(position)

    # -- lifecycle ------------------------------------------------------------------------

    def close(self) -> None:
        if self._owns:
            self._file.close()

    def __enter__(self):
        self.initialize()
        return self

    def __exit__(self, *exc) -> None:
        self.close()
