"""Bytes copied from the device to the host (stats["d2h_bytes"]) per
audio second."""


def read(run):
    moved = run.stats_sum("d2h_bytes")
    return None if moved is None or run.audio_s <= 0 else moved / run.audio_s
