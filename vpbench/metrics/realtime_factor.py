"""Audio seconds decoded by the window's calls over the wall from the
first call's start to the last call's end."""


def read(run):
    return run.audio_s / run.wall_s if run.wall_s > 0 else None
