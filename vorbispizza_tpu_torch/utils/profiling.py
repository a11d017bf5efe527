"""Profiling hooks: stage timing of the corpus pipeline and a device trace.

Port of vorbispizza_tpu/utils/profiling.py. ``DecodeTimer`` is a copy;
``device_trace`` records with ``torch.profiler`` (host and, where CUDA is
present, device activity) instead of the JAX profiler:

    with device_trace("/tmp/vorbis-trace"):
        decode_corpus(paths)

writes a Chrome trace (chrome://tracing, Perfetto) of every kernel, copy
and host op of the block into that directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block; on exit write ``trace-<pid>-<ns>.json`` into
    ``log_dir``. Yields the ``torch.profiler.profile`` object."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@dataclass
class DecodeTimer:
    """Wall-clock accounting of pipeline stages (host front end vs device),
    the batch analog of the reference's StreamStats bitrate accounting.
    ``counters`` accumulates quantities (e.g. h2d/d2h bytes) alongside the
    stage walls. Stages may overlap (the corpus pipeline dispatches chunks
    while front ends still run), so stage walls need not sum to the total."""

    stages: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    #: optional event timeline [(name, t_rel_s)] — mark() is a no-op until
    #: the first mark of a run establishes t0, so steady-state users pay
    #: one lock + append per event only when a caller asked for a timeline
    events: list = field(default_factory=list)
    _t0: float = 0.0
    # stages run concurrently (the corpus collector pool finishes chunks on
    # worker threads); accumulation must be atomic
    _lock: object = field(default_factory=__import__("threading").Lock)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.stages[name] = self.stages.get(name, 0.0) + dt

    def mark(self, name: str) -> None:
        """Append a timestamped event (seconds since the timer's first
        mark). The corpus pipeline marks dispatch/pull boundaries per
        chunk, giving the overlap timeline that aggregate stage walls
        (which overlap) cannot show."""
        t = time.perf_counter()
        with self._lock:
            if not self.events:
                self._t0 = t
            self.events.append((name, round(t - self._t0, 4)))

    def count(self, name: str, value) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def report(self) -> dict:
        out = dict(self.stages)
        out.update(self.counters)
        return out
