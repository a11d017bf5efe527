"""Reduction of a ``torch.profiler`` trace of the measured window to the
numbers the readers and the result line need: the device's busy time
(the union of its operations' intervals), the busy time of its compute
operations (copies and fills left out), the top device operations and
the longest idle gaps, each labelled with what the host was doing.

The profiler's own host overhead lies inside the window, so the idle
share read from it is an upper bound.
"""

from __future__ import annotations

import contextlib
import time

WINDOW = "vpbench.window"


class Tracer:
    """Profiles the window; ``window`` marks it on the host side and maps
    the host clock (``time.perf_counter``) onto the trace's clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.anchor = None  # perf_counter seconds at the window span's start

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function(WINDOW):
            self.anchor = t
            yield


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith(("memcpy", "memset")) or "memcpy" in low


def reduce(tracer: Tracer, host_phases: list, chips: int,
           top: int = 10) -> dict | None:
    """-> {window_s, busy_s (averaged over the ``chips`` used), compute_s
    (the same, compute operations only), devices, device_ops, idle_gaps}
    or None when the trace holds no window or no device operation.

    ``host_phases``: [(label, start, end)] on the host clock, what the
    host was doing (the harness's calls and the program's own marks); an
    idle gap is named by the phases that overlap it most."""
    from torch.autograd import DeviceType

    events = tracer.prof.profiler.kineto_results.events()
    win, dev = None, {}
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW:
                win = (e.start_ns(), e.start_ns() + e.duration_ns())
            continue
        annotation = getattr(e, "is_user_annotation", lambda: False)()
        if e.name() == WINDOW or annotation:
            continue
        dev.setdefault(e.device_index(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    if win is None or not dev or tracer.anchor is None:
        return None
    t0, t1 = win
    span = (t1 - t0) / 1e9
    busy, compute, by_name, all_ops = [], [], {}, []
    for ops in dev.values():
        clipped = [(max(s, t0), min(e, t1), n) for s, e, n in ops]
        busy.append(sum(e - s for s, e in _union((s, e) for s, e, _ in clipped)))
        compute.append(sum(e - s for s, e in _union(
            (s, e) for s, e, n in clipped if not _is_copy(n))))
        for s, e, n in clipped:
            if e > s:
                by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
                all_ops.append((s, e))
    n_dev = max(chips, len(dev))
    # gaps between device work (any device), named by host phases
    offset = t0 - tracer.anchor * 1e9  # trace ns = perf_counter ns + offset
    phases = [(lab, s * 1e9 + offset, e * 1e9 + offset)
              for lab, s, e in host_phases]
    merged = _union(all_ops)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for gs, ge in gaps[:top]:
        cover = {}
        for lab, s, e in phases:
            o = min(e, ge) - max(s, gs)
            if o > 0:
                cover[lab] = cover.get(lab, 0.0) + o
        label = "+".join(sorted(cover, key=lambda k: -cover[k])[:3]) or "other host work"
        named.append([f"idle during {label}", (ge - gs) / 1e9])
    tops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": span,
        "busy_s": sum(busy) / n_dev / 1e9,
        "compute_s": sum(compute) / n_dev / 1e9,
        "devices": n_dev,
        "device_ops": [[n[:120], s] for n, s in tops],
        "idle_gaps": named,
    }
