"""Host unpack of the pulled output (stats["stage_s"]["unpack"]), in
milliseconds per audio second."""

from vpbench.readers import per_audio_ms


def read(run):
    return per_audio_ms(run, "unpack")
