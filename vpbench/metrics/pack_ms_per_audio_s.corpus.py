"""Merge and wire packing (stats["stage_s"] merge + prepare), in
milliseconds per audio second."""

from vpbench.readers import per_audio_ms


def read(run):
    return per_audio_ms(run, "merge", "prepare")
