"""The front end's work with the interpreter lock held: thread CPU of the
spans front.headers, front.plan, front.gather and front.python (the
header parses, the plan, the numpy after the C++ entropy decode, the
Python path), in milliseconds per audio second."""

from vpbench.spans import cpu_ms_per_audio_s

NAMES = {"front.headers", "front.plan", "front.gather", "front.python"}


def read(run):
    return cpu_ms_per_audio_s(run, NAMES)
