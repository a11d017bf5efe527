"""Process CPU time (user + system, every thread) over the window, in
milliseconds per audio second decoded."""


def read(run):
    return 1e3 * run.cpu_s / run.audio_s if run.audio_s > 0 else None
