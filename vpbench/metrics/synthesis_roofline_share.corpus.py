"""Least time of the forward's work (vpbench/roofline.py: the wire in and
the output out once, the synthesis operations at FFT cost) over the
device's busy time in compute operations (copies and fills left out), in
percent."""

from vpbench import roofline


def read(run):
    if run.trace is None or run.trace["compute_s"] <= 0:
        return None
    moved = run.stats_sum("h2d_bytes", "d2h_bytes")
    if moved is None:
        return None
    flops = {}
    for c in run.calls:
        for m in c.members:
            if m not in flops:
                flops[m] = roofline.stream_flops(run.pool[m])
    work = sum(flops[m] for c in run.calls for m in c.members)
    least = roofline.least_seconds(moved, work)
    return 100.0 * least / (run.trace["compute_s"] * run.trace["devices"])
