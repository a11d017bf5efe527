"""Set-up: process start to the first timed call (imports, CUDA start,
kernel library load or build, pool load and check, warm-up)."""


def read(run):
    return run.setup_s
