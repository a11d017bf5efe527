"""Host side of H2D and launch (stats["stage_s"] h2d + dispatch), in
milliseconds per audio second."""

from vpbench.readers import per_audio_ms


def read(run):
    return per_audio_ms(run, "h2d", "dispatch")
