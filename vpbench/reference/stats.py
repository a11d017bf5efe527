"""Stream bit-accounting statistics.

Behavior parity with reference NVorbis/StreamStats.cs:5 (IStreamStats):
audio/header/container/waste bits, packet count, effective and instantaneous
(last-two-packet) bitrate.
"""

from __future__ import annotations


class StreamStats:
    def __init__(self, sample_rate: int = 0):
        self.sample_rate = sample_rate
        self.audio_bits = 0
        self.header_bits = 0
        self.container_bits = 0
        self.waste_bits = 0
        self.overhead_bits = 0
        self.packet_count = 0
        self.total_samples = 0
        self._last2 = []  # (bits, samples) of the last two packets

    def add_packet(self, samples: int, audio_bits: int, waste_bits: int, container_bits: int) -> None:
        # reference StreamStats.AddPacket:94-122
        self.audio_bits += audio_bits
        self.waste_bits += waste_bits
        self.container_bits += container_bits
        self.total_samples += samples
        self.packet_count += 1
        self._last2.append((audio_bits, samples))
        if len(self._last2) > 2:
            self._last2.pop(0)

    @property
    def effective_bit_rate(self) -> int:
        if self.total_samples <= 0:
            return 0
        total = self.audio_bits + self.header_bits + self.container_bits + self.waste_bits
        return int(total / self.total_samples * self.sample_rate)

    @property
    def instant_bit_rate(self) -> int:
        bits = sum(b for b, _ in self._last2)
        samples = sum(s for _, s in self._last2)
        if samples <= 0:
            return 0
        return int(bits / samples * self.sample_rate)

    def reset_stats(self) -> None:
        self._last2.clear()
        self.packet_count = 0
        self.audio_bits = 0
        self.total_samples = 0
        self.waste_bits = 0
        self.container_bits = 0
