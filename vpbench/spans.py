"""Arithmetic over the program's spans and counters, shared by the
readers in ``metrics/`` that read them: each traced call's
``DecodeTimer.spans`` (name, key, cause, thread, ``perf_counter_ns`` at
both ends, the thread's CPU nanoseconds, counters) and its
``stats["builds"]``. A program whose timer keeps no spans, or whose
stats count no builds, gives None: the metric is left out of the line."""

from __future__ import annotations

import statistics


def call_spans(run) -> list | None:
    """[(call, its spans)] of the window, or None where a call kept
    none."""
    out = []
    for c in run.calls:
        spans = getattr(c.timer, "spans", None)
        if not spans:
            return None
        out.append((c, spans))
    return out


def named(run, names) -> list | None:
    """Every span of the window whose name is in ``names``, or None."""
    calls = call_spans(run)
    if calls is None:
        return None
    return [sp for _, spans in calls for sp in spans if sp.name in names]


def cpu_ms_per_audio_s(run, names) -> float | None:
    """Thread CPU milliseconds of the spans ``names`` per audio second."""
    spans = named(run, names)
    if not spans or run.audio_s <= 0:
        return None
    return sum(sp.cpu_ns for sp in spans) / 1e6 / run.audio_s


def offcpu_share(run, names) -> float | None:
    """100 x (1 - their threads' CPU / wall) over the spans ``names``:
    the share of their wall their threads did not run (waiting for the
    interpreter lock, a core or a lock of the program)."""
    spans = named(run, names)
    if not spans:
        return None
    wall = sum(sp.t1_ns - sp.t0_ns for sp in spans)
    cpu = sum(sp.cpu_ns for sp in spans)
    return None if wall <= 0 else 100.0 * (1.0 - cpu / wall)


def counter_ms_per_audio_s(run, name, counter) -> float | None:
    """Milliseconds of the nanosecond ``counter`` attached to the spans
    ``name``, per audio second."""
    spans = named(run, {name})
    if not spans or run.audio_s <= 0:
        return None
    return sum(sp.counters.get(counter, 0) for sp in spans) / 1e6 / run.audio_s


def outermost(spans) -> list:
    """The spans of one thread that no other of its spans contains."""
    out, end = [], None
    for sp in sorted(spans, key=lambda s: (s.t0_ns, -s.t1_ns)):
        if end is None or sp.t0_ns >= end:
            out.append(sp)
            end = sp.t1_ns
    return out


def median(values) -> float | None:
    return statistics.median(values) if values else None
