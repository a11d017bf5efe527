"""Share of the wall of the front end's lock-holding spans (front.headers,
front.plan, front.gather, front.python) in which their threads did not
run: waiting for the interpreter lock or a core, in percent."""

from vpbench.spans import offcpu_share

NAMES = {"front.headers", "front.plan", "front.gather", "front.python"}


def read(run):
    return offcpu_share(run, NAMES)
