"""The card's wait at each call's start: from the call span's start to
the end of the call's first launch span, in milliseconds, the median
over the window's calls (calls that launched nothing left out)."""

from vpbench.spans import call_spans, median


def read(run):
    calls = call_spans(run)
    if calls is None:
        return None
    waits = []
    for _, spans in calls:
        start = [sp.t0_ns for sp in spans if sp.name == "call"]
        ends = [sp.t1_ns for sp in spans if sp.name == "launch"]
        if start and ends:
            waits.append((min(ends) - start[0]) / 1e6)
    return median(waits)
