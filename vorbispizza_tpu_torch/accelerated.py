"""Device-accelerated StreamDecoder: the streaming read/seek surface served
from a batch-decoded PCM buffer.

Port of vorbispizza_tpu/accelerated.py, plus ``device``. Drop-in for
decoder.StreamDecoder behind VorbisReader(accelerated=True): headers parse
eagerly (channels/tags/events available immediately); the first read or
seek runs the whole stream through the batch pipeline on ``device``
(models/pipeline.py BatchSynthesizer.assemble) and subsequent reads slice
the result on the host — random access becomes free. Falls back to the
scalar decoder for stream shapes the batch planner does not model.
"""

from __future__ import annotations

import bisect

import numpy as np

from .decoder import CLIP_MAX, StreamDecoder
from .errors import SeekOutOfRangeError
from .device import resolve_device
from .frames import BatchUnsupported, build_plan, extract_batch


class AcceleratedStreamDecoder:
    """StreamDecoder-compatible facade over the batch pipeline."""

    def __init__(self, provider, *, clip_samples: bool = True,
                 skip_tags: bool = False, device="cuda"):
        self._device = resolve_device(device)
        self._dec = StreamDecoder(
            provider, clip_samples=clip_samples, skip_tags=skip_tags
        )
        self._provider = provider
        self.clip_samples = clip_samples
        self.has_clipped = False
        self._pcm: np.ndarray | None = None  # planar float32, unclipped
        self._cursor = 0

    def initialize(self) -> None:
        self._dec.initialize()

    # -- decode-on-first-use ------------------------------------------------------

    def _ensure_decoded(self) -> np.ndarray:
        if self._pcm is None:
            from .models.pipeline import BatchSynthesizer, OlaUnsupported

            # build_plan consumes the provider's packet cursor; remember it
            # so the scalar fallback can replay the stream from here
            cursor = (
                self._provider._page_cursor,
                self._provider._packet_cursor,
                self._provider._pending_resync,
            )
            try:
                plan = build_plan(self._provider, self._dec._setup)
                buckets = extract_batch(
                    plan, self._dec._setup, self._dec.channels,
                    ident=self._dec._ident,
                )
                synth = BatchSynthesizer(self._dec._setup, self._dec.channels)
                self._pcm = synth.assemble(
                    plan, buckets, device=self._device).cpu().numpy()
                for i, fr in enumerate(plan.frames):
                    if plan.audio_bits is not None:
                        # exact bits consumed, recorded by the C++ front
                        # end (frontend.cpp decode_one meta[4]) — matches
                        # the scalar decoder's BitReader accounting
                        # (reference StreamStats.cs:94-122)
                        ab = int(plan.audio_bits[i])
                        wb = 8 * len(fr.packet.data) - ab
                    else:
                        # Python extract path doesn't track bits-read;
                        # whole-packet bits approximate audio
                        ab = 8 * len(fr.packet.data)
                        wb = 0
                    self._dec.stats.add_packet(
                        samples=fr.info.sample_count,
                        audio_bits=ab,
                        waste_bits=wb,
                        container_bits=fr.packet.container_bits,
                    )
            except (BatchUnsupported, OlaUnsupported):
                # scalar fallback keeps exact streaming semantics; read
                # UNCLIPPED so the facade's own clip/has_clipped logic (and
                # later clip_samples toggles) behave identically to the
                # batch-decoded buffer
                (
                    self._provider._page_cursor,
                    self._provider._packet_cursor,
                    self._provider._pending_resync,
                ) = cursor
                saved_clip = self._dec.clip_samples
                self._dec.clip_samples = False
                try:
                    self._pcm = self._dec.read_all(planar=True)
                finally:
                    self._dec.clip_samples = saved_clip
        return self._pcm

    # -- streaming surface (reference IStreamDecoder parity) ------------------------

    def read(self, count: int, planar: bool = False) -> np.ndarray:
        pcm = self._ensure_decoded()
        take = pcm[:, self._cursor : self._cursor + count]
        self._cursor += take.shape[1]
        out = np.array(take, dtype=np.float32)
        if self.clip_samples:
            if np.any(np.abs(out) > CLIP_MAX):
                self.has_clipped = True
            np.clip(out, -CLIP_MAX, CLIP_MAX, out=out)
        return out if planar else out.T.copy()

    def read_all(self, planar: bool = False) -> np.ndarray:
        # StreamDecoder.read_all semantics: the REMAINDER from the current
        # position, not a rewind
        pcm = self._ensure_decoded()
        return self.read(pcm.shape[1] - self._cursor, planar=planar)

    def seek_to(self, sample_position: int) -> None:
        total = self.total_samples
        if sample_position < 0 or sample_position > total:
            raise SeekOutOfRangeError(str(sample_position))
        pcm = self._ensure_decoded()
        self._cursor = min(self._granule_to_index(sample_position), pcm.shape[1])

    # -- granule <-> PCM-buffer index -------------------------------------------------
    #
    # Positions in the streaming API are GRANULE space (reference
    # StreamDecoder.SeekTo:817); the batch-decoded buffer is gap-free
    # EMITTED space. On resync/gap streams granules jump forward while the
    # buffer stays contiguous, so seeks map through the granule table:
    # packet idx containing the target, then cumulative emitted counts +
    # in-packet roll-forward — exactly the scalar decoder's
    # position-at-target-start + skip semantics.

    def _granule_map(self):
        """(table, D, next_anchor): D = cumulative DELIVERED samples per
        packet — raw emission counts minus the end-trims/cuts the streaming
        decoder applies at each page anchor (granule budget per anchored
        span, excess dropped from the span's tail; resync spans never cut,
        decoder._next_block)."""
        if getattr(self, "_gmap", None) is None:
            table = self._provider.build_granule_table(
                self._dec.get_packet_blocksize
            )
            n = len(table.count)
            d = list(table.count)
            prev_anchor = None
            s = 0
            span_sum = 0
            for j in range(n):
                span_sum += table.count[j]
                if table.anchor[j] < 0:
                    continue
                if prev_anchor is None:
                    budget = table.anchor[j] - (table.start[0] if table.start else 0)
                else:
                    budget = table.anchor[j] - prev_anchor
                has_resync = any(
                    table.count[i] == 0 and table.blocksize[i] > 0 and i > 0
                    for i in range(s, j + 1)
                )
                overflow = 0 if has_resync else max(0, span_sum - max(budget, 0))
                i = j
                while overflow > 0 and i >= s:
                    drop = min(d[i], overflow)
                    d[i] -= drop
                    overflow -= drop
                    i -= 1
                prev_anchor = table.anchor[j]
                s = j + 1
                span_sum = 0
            D = [0]
            for c in d:
                D.append(D[-1] + c)
            # next_anchor[i] = first packet >= i completing an anchored page
            # (the packet whose commit snaps the streaming decoder's position)
            next_anchor = [n] * (n + 1)
            for i in range(n - 1, -1, -1):
                next_anchor[i] = i if table.anchor[i] >= 0 else next_anchor[i + 1]
            self._gmap = (table, D, next_anchor)
        return self._gmap

    def _granule_to_index(self, sample_position: int) -> int:
        table, D, _ = self._granule_map()
        if not table.end:
            return 0
        g = sample_position + table.start[0]
        idx = bisect.bisect_right(table.end, g)
        if idx >= len(table.end):
            idx = len(table.end) - 1
        return D[idx] + max(0, g - table.start[idx])

    def _index_to_granule(self, index: int) -> int:
        table, D, next_anchor = self._granule_map()
        n = len(table.count)
        if not table.end:
            return index
        idx = bisect.bisect_right(D, index) - 1
        if idx >= n:
            idx = n - 1
        # the streaming decoder commits blocks at page granule anchors and
        # counts pending samples back from them, so a sample's position is
        # (next anchor) - (samples delivered from here through that anchor);
        # gaps before the anchor shift the whole region forward
        j = next_anchor[idx]
        if j >= n:
            return table.start[idx] + (index - D[idx]) - table.start[0]
        return table.anchor[j] - (D[j + 1] - index) - table.start[0]

    # -- delegated metadata ----------------------------------------------------------

    @property
    def channels(self) -> int:
        return self._dec.channels

    @property
    def sample_rate(self) -> int:
        return self._dec.sample_rate

    @property
    def nominal_bitrate(self) -> int:
        return self._dec.nominal_bitrate

    @property
    def upper_bitrate(self) -> int:
        return self._dec.upper_bitrate

    @property
    def lower_bitrate(self) -> int:
        return self._dec.lower_bitrate

    @property
    def tags(self):
        return self._dec.tags

    @property
    def stats(self):
        return self._dec.stats

    @property
    def blocksizes(self):
        return self._dec.blocksizes

    @property
    def total_samples(self) -> int:
        # always granule-based (scalar-decoder semantics, stable across the
        # lazy decode; equals the PCM length except on gap streams)
        return self._dec.total_samples

    @property
    def total_time(self) -> float:
        return self.total_samples / self.sample_rate

    @property
    def sample_position(self) -> int:
        # granule space (scalar-decoder parity); identical to the buffer
        # cursor except past gaps on resync streams
        if self._pcm is None:
            return self._cursor
        return self._index_to_granule(self._cursor)

    @property
    def is_end_of_stream(self) -> bool:
        return self._pcm is not None and self._cursor >= self._pcm.shape[1]
