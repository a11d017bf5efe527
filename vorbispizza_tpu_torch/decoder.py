"""StreamDecoder: header state machine, packet decode loop, lapping,
position/granule tracking, seek with preroll.

Behavior parity with reference NVorbis/StreamDecoder.cs:18 — the scalar
(host) decode engine. The batch pipeline (models/pipeline.py) shares the
same front end (setup/*) but runs the synthesis stages on device; this class
is the streaming API and the correctness anchor.
"""

from __future__ import annotations

import numpy as np

from .bitstream import BitReader
from .errors import (
    EndOfStreamError,
    InvalidDataError,
    PrerollPacketError,
    SeekOutOfRangeError,
)
from .ogg.logical import Packet, PacketProvider
from .setup.header import (
    detect_codec,
    parse_comments,
    parse_ident,
    parse_setup_cached,
)
from .setup.mode import WindowInfo
from .dsp.imdct import imdct
from .dsp.window import window_for
from .stats import StreamStats
from .tags import TagData

# float32 clip ceiling (reference Utils.cs:43: 0.99999994f)
CLIP_MAX = np.float32(0.99999994)


class StreamDecoder:
    """Decodes one logical Vorbis stream to float PCM.

    Public surface parity with reference Contracts/IStreamDecoder.cs:9:
    read (interleaved + planar), seek, tags, stats, clip control.
    """

    def __init__(self, packet_provider: PacketProvider, *, clip_samples: bool = True,
                 skip_tags: bool = False):
        self._provider = packet_provider
        self.clip_samples = clip_samples
        self.has_clipped = False
        self._stats = StreamStats()
        self._tags: TagData | None = None
        self._ident = None
        self._setup = None
        self._skip_tags = skip_tags
        # decode state
        self._prev_tail: np.ndarray | None = None  # [ch, tail_len] windowed
        self._position: int | None = None  # sample pos after emitted samples
        self._pending: list[np.ndarray] = []  # decoded [ch, n] blocks to hand out
        self._pending_offset = 0
        # blocks are handed out only once "committed" by a granule anchor or
        # EOS: encoder end-trims can span several packets of the final page
        # (reference :657-666), and trimming can only retract samples still
        # held here
        self._committed = 0  # committed block count within _pending
        self._eos = False
        self._total_samples: int | None = None
        self._base: int | None = None  # granule of the first decodable sample
        self._unanchored = 0  # samples emitted while position is unknown

    # -- headers -----------------------------------------------------------------

    def initialize(self) -> None:
        """Read ident/comment/setup packets (reference ProcessHeaderPackets:125)."""
        pkt = self._provider.get_next_packet()
        if pkt is None:
            raise InvalidDataError("no packets in stream")
        codec = detect_codec(pkt.data)
        if codec:
            raise InvalidDataError(f"not a Vorbis stream (detected {codec})")
        self._ident = parse_ident(pkt.data)
        self._stats.sample_rate = self._ident.sample_rate
        self._stats.header_bits += 8 * len(pkt.data)
        self._stats.container_bits += pkt.container_bits

        pkt = self._provider.get_next_packet()
        if pkt is None:
            raise InvalidDataError("missing comment header")
        if self._skip_tags:
            if pkt.data[:7] != b"\x03vorbis":
                raise InvalidDataError("invalid comment header signature")
            self._tags = TagData()
        else:
            ch = parse_comments(pkt.data)
            self._tags = TagData(ch.vendor, ch.comments)
        self._stats.header_bits += 8 * len(pkt.data)
        self._stats.container_bits += pkt.container_bits

        pkt = self._provider.get_next_packet()
        if pkt is None:
            raise InvalidDataError("missing setup header")
        self._setup = parse_setup_cached(pkt.data, self._ident)
        self._stats.header_bits += 8 * len(pkt.data)
        self._stats.container_bits += pkt.container_bits
        # audio begins on the page after the one the setup packet started on
        s = self._provider._s
        s.first_data_page = pkt.page_index + (
            1 if pkt.packet_index + 1 >= s.pages[pkt.page_index].n_starts else 0
        )

    # -- properties ----------------------------------------------------------------

    @property
    def channels(self) -> int:
        return self._ident.channels

    @property
    def sample_rate(self) -> int:
        return self._ident.sample_rate

    @property
    def nominal_bitrate(self) -> int:
        return self._ident.bitrate_nominal

    @property
    def upper_bitrate(self) -> int:
        return self._ident.bitrate_upper

    @property
    def lower_bitrate(self) -> int:
        return self._ident.bitrate_lower

    @property
    def tags(self) -> TagData:
        return self._tags

    @property
    def stats(self) -> StreamStats:
        return self._stats

    @property
    def blocksizes(self) -> tuple[int, int]:
        return self._ident.blocksizes

    @property
    def total_samples(self) -> int:
        if self._total_samples is None:
            self._total_samples = self._provider.get_granule_count(
                self.get_packet_blocksize
            )
        return self._total_samples

    @property
    def total_time(self) -> float:
        return self.total_samples / self.sample_rate

    @property
    def sample_position(self) -> int:
        pending = sum(len(b[0]) for b in self._pending) - self._pending_offset
        return (self._position or 0) - (self._base or 0) - pending

    @property
    def is_end_of_stream(self) -> bool:
        return self._eos and not self._pending

    # -- packet measurement (reference GetPacketGranuleCount:882) --------------------

    def get_packet_blocksize(self, packet: Packet) -> int:
        """Blocksize of an audio packet from its mode header alone; 0 if the
        packet is not decodable audio."""
        br = BitReader(packet.data)
        if not packet.data or br.read_bit():
            return 0  # not an audio packet
        mode_idx = br.read_bits(self._setup.mode_bits)
        if mode_idx >= len(self._setup.modes) or br.overrun:
            return 0
        mode = self._setup.modes[mode_idx]
        # a long-block packet truncated before its window flags is
        # undecodable (_decode_packet returns None) — anchor parity
        mode.read_window_flags(br)
        if br.overrun:
            return 0
        return mode.n

    # -- packet decode ----------------------------------------------------------------

    def _record_bad_packet(self, packet: Packet) -> None:
        """Stats for an undecodable packet: every bit is waste (reference
        ReadNextPacket:650 records the failed decode's bits)."""
        self._stats.add_packet(
            samples=0,
            audio_bits=0,
            waste_bits=8 * len(packet.data),
            container_bits=packet.container_bits,
        )

    def _decode_packet(self, packet: Packet):
        """Full spectral decode + synthesis of one packet.

        Returns (windowed_time [ch, n], WindowInfo) or None for undecodable
        packets (reference DecodeNextPacket:696)."""
        br = BitReader(packet.data)
        if not packet.data or br.read_bit():
            self._record_bad_packet(packet)
            return None
        setup = self._setup
        mode_idx = br.read_bits(setup.mode_bits)
        if mode_idx >= len(setup.modes):
            raise InvalidDataError("mode index out of bounds")
        mode = setup.modes[mode_idx]
        prev_flag, next_flag = mode.read_window_flags(br)
        if br.overrun:
            self._record_bad_packet(packet)
            return None
        info = mode.window_info(prev_flag, next_flag)
        mapping = setup.mappings[mode.mapping_idx]
        frame = mapping.decode_packet(br, mode.n)
        # floor curve x residue -> spectrum; zero channels keep zero floor
        half = mode.n // 2
        spectra = np.zeros((self.channels, half), dtype=np.float64)
        for c in range(self.channels):
            fd = frame.floor_data[c]
            if fd.unused:
                continue
            curve = frame.floors[c].synthesize(fd, mode.n)
            spectra[c] = frame.residues[c] * curve
        time = imdct(spectra, mode.n)
        time *= window_for(info)[None, :]
        # reference ReadNextPacket:686 — audio = bits actually consumed,
        # waste = trailing bits never read, container = Ogg framing share
        self._stats.add_packet(
            samples=info.sample_count,
            audio_bits=br.bits_read,
            waste_bits=br.bits_remaining,
            container_bits=packet.container_bits,
        )
        return time, info

    # -- lapping + position (reference Read:418 / OverlapBuffers:764) -----------------

    def _next_block(self) -> bool:
        """Decode one packet and append finished samples to the pending list.
        Returns False at end of stream."""
        while True:
            packet = self._provider.get_next_packet()
            if packet is None:
                self._eos = True
                self._committed = len(self._pending)
                return False
            if packet.is_resync:
                # lost data: position lock drops (reference :719-722); no
                # later anchor can retract the blocks decoded before the gap
                self._prev_tail = None
                self._position = None
                self._unanchored = 0
                self._committed = len(self._pending)
            result = self._decode_packet(packet)
            if result is None:
                continue  # undecodable packet: skip (reference keeps looping)
            time, info = result
            emitted = self._overlap(time, info)
            granule = packet.granule
            n_emit = emitted.shape[1]
            if n_emit:
                self._pending.append(emitted)
            if self._position is None:
                self._unanchored += n_emit
                new_pos = None
            else:
                new_pos = self._position + n_emit
            if granule >= 0:
                if new_pos is None:
                    # first anchor: a negative implied start means the stream
                    # carries fewer samples than decoded -> end trim; positive
                    # means a start offset (issue6test)
                    implied_start = granule - self._unanchored
                    if implied_start < 0:
                        self._cut_pending_tail(-implied_start)
                    elif self._base is None:
                        # remember the start offset so sample_position is
                        # base-relative from the first read, matching seeks
                        self._base = implied_start
                    self._unanchored = 0
                    new_pos = granule
                if granule < new_pos:
                    # end trim: the encoder recorded fewer samples than the
                    # window math implies; drop the excess from the tail of
                    # not-yet-consumed output. May span several packets on
                    # the final page (reference :657-666 + libvorbis page
                    # semantics, verified vs oracle on 1test.ogg).
                    self._cut_pending_tail(new_pos - granule)
                self._position = granule
            else:
                self._position = new_pos
            if packet.is_end_of_stream:
                self._eos = True
            if granule >= 0 or self._eos:
                # anchor seen: trims can no longer retract earlier blocks
                self._committed = len(self._pending)
            return True

    def _cut_pending_tail(self, excess: int) -> None:
        try:
            self._cut_pending_tail_inner(excess)
        finally:
            self._committed = min(self._committed, len(self._pending))

    def _cut_pending_tail_inner(self, excess: int) -> None:
        while excess > 0 and self._pending:
            block = self._pending[-1]
            avail = block.shape[1]
            if self._pending[-1] is self._pending[0]:
                avail -= self._pending_offset
            cut = min(excess, avail)
            if cut <= 0:
                break
            if cut == block.shape[1]:
                self._pending.pop()
            else:
                self._pending[-1] = block[:, : block.shape[1] - cut]
            excess -= cut

    def _overlap(self, time: np.ndarray, info: WindowInfo) -> np.ndarray:
        """Overlap-add with the previous frame's tail; returns the finished
        samples.

        Emission boundary is the window CENTER (libvorbis convention): each
        packet emits (prev_n + n)/4 samples, so page granule positions match
        the running count at every page boundary — including long->short
        transitions, where the reference's right_start convention transiently
        disagrees with encoder granules (StreamDecoder.cs:658 ignores them;
        we rely on them for seeks and batch framing, so we match libvorbis).
        The carried tail is frame[center:right_end] — the decaying slope plus
        any flat region beyond the center.
        """
        center = info.n // 2
        cur = time[:, info.left_start : center]
        new_tail = time[:, center : info.right_end].copy()
        if self._prev_tail is None:
            self._prev_tail = new_tail
            return time[:, :0]  # first packet (or post-seek/resync): primes only
        tail = self._prev_tail
        tl = tail.shape[1]
        out_len = tl + center - info.left_end
        out = np.zeros((time.shape[0], max(out_len, 0)), dtype=time.dtype)
        k = min(tl, out.shape[1])
        out[:, :k] += tail[:, :k]
        cw = cur.shape[1]
        if cw and out.shape[1] >= cw:
            out[:, out.shape[1] - cw :] += cur
        self._prev_tail = new_tail
        return out

    # -- reading -------------------------------------------------------------------

    def read(self, count: int, planar: bool = False) -> np.ndarray:
        """Read up to ``count`` samples per channel as float32.

        interleaved: shape [frames, channels] (reference StoreInterleaved:515)
        planar: shape [channels, frames] (reference StoreContiguous:594)
        """
        chunks: list[np.ndarray] = []
        got = 0
        while got < count:
            while self._committed == 0:
                if self._eos or not self._next_block():
                    break
            if self._committed == 0:
                break
            block = self._pending[0]
            avail = block.shape[1] - self._pending_offset
            take = min(avail, count - got)
            chunks.append(block[:, self._pending_offset : self._pending_offset + take])
            got += take
            self._pending_offset += take
            if self._pending_offset >= block.shape[1]:
                self._pending.pop(0)
                self._committed -= 1
                self._pending_offset = 0
        if chunks:
            data = np.concatenate(chunks, axis=1)
        else:
            data = np.zeros((self.channels, 0), dtype=np.float64)
        pcm = data.astype(np.float32)
        if self.clip_samples:
            clipped = np.abs(pcm) > CLIP_MAX
            if clipped.any():
                self.has_clipped = True
                pcm = np.clip(pcm, -CLIP_MAX, CLIP_MAX)
        return pcm if planar else pcm.T.copy()

    def read_all(self, planar: bool = False) -> np.ndarray:
        out = []
        while True:
            chunk = self.read(65536, planar=planar)
            n = chunk.shape[1] if planar else chunk.shape[0]
            if n == 0:
                break
            out.append(chunk)
        if not out:
            shape = (self.channels, 0) if planar else (0, self.channels)
            return np.zeros(shape, dtype=np.float32)
        return np.concatenate(out, axis=1 if planar else 0)

    # -- seeking (reference SeekTo:817) ------------------------------------------------

    def seek_to(self, sample_position: int) -> None:
        if sample_position < 0 or sample_position > self.total_samples:
            raise SeekOutOfRangeError(str(sample_position))
        base = self._base_granule()
        target_start = self._provider.seek_to_granule(
            sample_position + base, preroll=1, blocksize_of=self.get_packet_blocksize
        )
        self._reset_decoder()
        # preroll packet primes lapping; then roll forward inside the target
        if not self._next_block():
            raise PrerollPacketError("stream ended during preroll")
        self._pending.clear()
        self._pending_offset = 0
        self._committed = 0
        self._position = target_start
        skip = sample_position + base - target_start
        if skip > 0:
            # discard without clip accounting: these samples are never
            # delivered, so they must not set has_clipped
            saved_clip = self.clip_samples
            self.clip_samples = False
            try:
                self.read(skip, planar=True)
            finally:
                self.clip_samples = saved_clip

    def _base_granule(self) -> int:
        """Granule of the first decodable sample (nonzero for start-trimmed
        streams like issue6test)."""
        if self._base is None:
            table = self._provider.build_granule_table(self.get_packet_blocksize)
            self._base = table.start[0] if table.start else 0
        return self._base

    def _reset_decoder(self) -> None:
        self._prev_tail = None
        self._position = None
        self._unanchored = 0
        self._pending.clear()
        self._pending_offset = 0
        self._committed = 0
        self._eos = False

    @property
    def sample_position_absolute(self) -> int:
        return self.sample_position
