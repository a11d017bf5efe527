"""CPU of the C++ entropy decode's own threads (the counter native_cpu_ns
on front.entropy spans, summed over the threads the native call starts),
in milliseconds per audio second."""

from vpbench.spans import counter_ms_per_audio_s


def read(run):
    return counter_ms_per_audio_s(run, "front.entropy", "native_cpu_ns")
