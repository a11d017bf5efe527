"""95th percentile of the window's requests, each timed from call (or,
in an open loop, from its due time) to return."""

from vpbench.readers import latencies_ms, quantile


def read(run):
    return quantile(latencies_ms(run), 95)
