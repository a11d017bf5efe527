"""Device idle share of the traced window, in percent."""

from vpbench.readers import idle_share


def read(run):
    return idle_share(run)
