"""Arithmetic shared by the metric readers in ``metrics/``. Each reader
is a file of its own, ``metrics/<name>.py``, whose ``read(run)`` returns
the metric's value, or None when the run holds nothing to read it from
(then the harness leaves the metric out of the line)."""

from __future__ import annotations

import statistics


def per_audio_ms(run, *stages) -> float | None:
    """Milliseconds of the program's host stages (``stats["stage_s"]``)
    per audio second decoded."""
    total = run.stats_sum(*stages)
    if total is None or run.audio_s <= 0:
        return None
    return 1e3 * total / run.audio_s


def idle_share(run) -> float | None:
    """100 x (1 - device busy / traced window), busy being the union of
    the device's operations, averaged over the cards used."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def latencies_ms(run) -> list[float]:
    """Each call's latency in milliseconds: from the call (closed loop),
    or from the time it was due (open loop), to its return."""
    return [1e3 * (c.t1 - (c.t0 if c.due is None else c.due))
            for c in run.calls]


def quantile(values, q: int) -> float:
    """The q-th percentile (statistics.quantiles, inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]
