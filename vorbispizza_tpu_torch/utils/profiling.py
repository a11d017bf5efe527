"""Profiling hooks: stage timing and spans of the corpus pipeline, and a
device trace.

Port of vorbispizza_tpu/utils/profiling.py. ``DecodeTimer`` keeps the
reference's stage walls, counters and marks, and adds spans (``span``):
each a named, keyed interval of one thread with that thread's CPU time.
``CallSpans`` is one decode call's one recorder: at each boundary of its
work the span on the call's timer and the boundary's host wall in the
call's ``stats["stage_s"]``; the timer's marks, counters and whole-stage
walls; nothing on a timer where the call has none. ``device_trace`` records with
``torch.profiler`` (host and, where CUDA is present, device activity)
instead of the JAX profiler:

    timer = DecodeTimer()
    with device_trace("/tmp/vorbis-trace", timer=timer):
        decode_corpus(paths, timer=timer)

writes a Chrome trace (chrome://tracing, Perfetto) of every kernel, copy
and host op of the block into that directory, with the timer's spans on
threads of their own beside them.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

import torch

#: span name -> (its ``stats["stage_s"]`` entry (models/corpus.STAGES),
#: its DecodeTimer stage): the boundaries whose walls the call's stats
#: and the timer's stages sum. The timer's "prepare" holds prepare_host
#: and the H2D staging, as the reference's does.
SPAN_STAGES = {
    "front.wait": ("front_end", None),
    "front.split": ("split", None),
    "merge": ("merge", "merge"),
    "prepare": ("prepare", "prepare"),
    "h2d": ("h2d", "prepare"),
    "launch": ("dispatch", "dispatch"),
    "wait": ("device", None),
    "pull": ("d2h", "collect_pull"),
    "unpack": ("unpack", "collect_unpack"),
    "stitch": ("stitch", None),
}

#: kinds of table build counted in a call's ``stats["builds"]``
BUILDS = ("setup", "synth", "layout", "k1", "tables")

#: the context every span resolves to where nothing is recorded
_NOOP = contextlib.nullcontext()
_NO_STAGE = (None, None)


@dataclass(slots=True)
class Span:
    """One interval of one thread: its name, key (``s<i>`` a stream of
    the call, ``c<k>`` a chunk, ``shard<k>``), cause (the key that set it
    off), thread name, ``time.perf_counter_ns`` at both ends, the
    thread's CPU nanoseconds inside it (``time.thread_time_ns``; None
    where the timer reads no thread clock) and counters read inside it."""

    name: str
    key: str | None
    cause: str | None
    thread: str
    t0_ns: int
    t1_ns: int = 0
    cpu_ns: int | None = None
    counters: dict = field(default_factory=dict)

    @property
    def wall_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def _trace_offset_ns(reads: int = 8) -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the wall-clock
    read that two counter reads bracket most tightly: a thread switch
    between two reads would shift the offset by the switch."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def _spans_to_chrome(path: str, timer) -> None:
    """Append ``timer``'s spans to the Chrome trace at ``path`` as complete
    events on the profiler's clock, one trace thread a program thread."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    tids: dict = {}
    events = trace.setdefault("traceEvents", [])
    with timer._lock:
        spans = list(timer.spans)
    for sp in spans:
        tid = tids.get(sp.thread)
        if tid is None:
            tid = tids[sp.thread] = (1 << 30) + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": f"spans {sp.thread}"}})
        args = {"key": sp.key, "cause": sp.cause, "cpu_ns": sp.cpu_ns}
        args.update(sp.counters)
        events.append({
            "ph": "X", "cat": "span", "name": sp.name, "pid": pid,
            "tid": tid,
            "ts": (sp.t0_ns + timer.trace_offset_ns - base) / 1e3,
            "dur": (sp.t1_ns - sp.t0_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(log_dir: str, timer=None):
    """Profile the block; on exit write ``trace-<pid>-<ns>.json`` into
    ``log_dir``, with ``timer``'s spans (a DecodeTimer) appended on the
    profiler's clock. Yields the ``torch.profiler.profile`` object."""
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
        path = os.path.join(log_dir,
                            f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        if timer is not None and getattr(timer, "spans", None):
            _spans_to_chrome(path, timer)


@dataclass
class DecodeTimer:
    """Wall-clock accounting of pipeline stages (host front end vs device),
    the batch analog of the reference's StreamStats bitrate accounting.
    ``counters`` accumulates quantities (e.g. h2d/d2h bytes) alongside the
    stage walls. Stages may overlap (the corpus pipeline dispatches chunks
    while front ends still run), so stage walls need not sum to the total.
    ``spans`` holds every closed span (``span``), in closing order;
    ``trace_offset_ns`` (``time.time_ns() - time.perf_counter_ns()`` when
    the timer was made) puts a span on the profiler's clock."""

    stages: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    #: optional event timeline [(name, t_rel_s)] — mark() is a no-op until
    #: the first mark of a run establishes t0, so steady-state users pay
    #: one lock + append per event only when a caller asked for a timeline
    events: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    trace_offset_ns: int = field(default_factory=_trace_offset_ns)
    _t0: float = 0.0
    # stages run concurrently (the corpus collector pool finishes chunks on
    # worker threads); accumulation must be atomic
    _lock: object = field(default_factory=threading.Lock)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.stages[name] = self.stages.get(name, 0.0) + dt

    @contextlib.contextmanager
    def span(self, name: str, key=None, cause=None, stage=None):
        """Record the block as a Span of this thread (yielded, so counters
        can be attached); with ``stage``, add its wall to that stage. The
        thread clock is read inside the wall clock's reads, so a span's
        CPU time never exceeds its wall by more than the clocks' grain."""
        sp = Span(name, key, cause, threading.current_thread().name,
                  time.perf_counter_ns())
        cpu0 = time.thread_time_ns()
        try:
            yield sp
        finally:
            sp.cpu_ns = time.thread_time_ns() - cpu0
            sp.t1_ns = time.perf_counter_ns()
            with self._lock:
                self.spans.append(sp)
                if stage is not None:
                    self.stages[stage] = (self.stages.get(stage, 0.0)
                                          + sp.wall_s)

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


class _Adapter:
    """A caller's timer without ``span`` or ``mark`` (an older,
    DecodeTimer-shaped object), wrapped rather than mutated: a slotted or
    frozen timer type would reject the attributes anyway. Its spans feed
    the wrapped timer's stages and are not kept; a missing ``mark`` does
    nothing."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def mark(self, name):
        mark = getattr(self._inner, "mark", None)
        if mark is not None:
            mark(name)

    @contextlib.contextmanager
    def span(self, name, key=None, cause=None, stage=None):
        sp = Span(name, key, cause, threading.current_thread().name,
                  time.perf_counter_ns())
        with self._inner.stage(stage) if stage is not None else _NOOP:
            try:
                yield sp
            finally:
                sp.t1_ns = time.perf_counter_ns()


def adapt(timer):
    """``timer`` itself when it has ``span`` and ``mark``, else wrapped."""
    if hasattr(timer, "span") and hasattr(timer, "mark"):
        return timer
    return _Adapter(timer)


class _Wall:
    """A boundary's wall where the call has no timer: added to its stage
    on exit and kept as ``wall_s``, as a span keeps its own."""

    __slots__ = ("rec", "stage", "t0", "wall_s")

    def __init__(self, rec, stage):
        self.rec = rec
        self.stage = stage

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self.t0
        with self.rec.lock:
            self.rec.stage_s[self.stage] += self.wall_s


class CallSpans:
    """One decode call's one recorder.

    ``rec(name, key, cause)`` is a boundary's context: with a timer
    (DecodeTimer, or a caller's timer passed through ``adapt``) it records
    the span there, yielding it; and where SPAN_STAGES names the span's
    stage, the span's wall goes into ``stats["stage_s"]``. Without a timer
    it is only that wall (yielded, as ``wall_s``), or the shared no-op: no
    span, no thread clock. ``stage``, ``mark`` (None marks nothing) and
    ``count`` are the timer's whole-stage walls, marks and counters, or
    nothing without one. ``tally`` counts into ``stats``
    (``stats["builds"]`` for the kinds of BUILDS)."""

    def __init__(self, timer=None, stats=None, lock=None):
        self.timer = None if timer is None else adapt(timer)
        self.stats = stats
        self.stage_s = None if stats is None else stats.get("stage_s")
        self.lock = threading.Lock() if lock is None else lock

    def __call__(self, name: str, key=None, cause=None):
        stage, tstage = SPAN_STAGES.get(name, _NO_STAGE)
        if self.stage_s is None:
            stage = None
        if self.timer is not None:
            return self._span(name, key, cause, stage, tstage)
        return _NOOP if stage is None else _Wall(self, stage)

    def stage(self, name: str):
        return _NOOP if self.timer is None else self.timer.stage(name)

    def mark(self, name) -> None:
        if self.timer is not None and name is not None:
            self.timer.mark(name)

    def count(self, name: str, value) -> None:
        if self.timer is not None:
            self.timer.count(name, value)

    @contextlib.contextmanager
    def _span(self, name, key, cause, stage, tstage):
        sp = None
        try:
            with self.timer.span(name, key, cause, stage=tstage) as sp:
                yield sp
        finally:
            # the span has closed: its wall is the stage's, exactly
            if stage is not None and sp is not None:
                with self.lock:
                    self.stage_s[stage] += sp.wall_s

    def tally(self, name: str, n: int = 1) -> None:
        if self.stats is None:
            return
        with self.lock:
            builds = self.stats.get("builds")
            if builds is not None and name in builds:
                builds[name] += n
            elif name in self.stats:
                self.stats[name] += n


#: the call (CallSpans) and task key the current thread works for
_bound = threading.local()


def bind(rec: CallSpans, key=None) -> None:
    """Make ``rec`` this thread's call and ``key`` its task, so code below
    (front-end stages, table caches) records into them without being
    handed them. Only for a pool thread that the call owns: the binding
    lasts until the next one."""
    _bound.rec = rec
    _bound.key = key


def sub(name: str):
    """The span ``name`` of this thread's task (``bind``), or the shared
    no-op where no call is bound or the call has no timer."""
    rec = getattr(_bound, "rec", None)
    if rec is None or rec.timer is None:
        return _NOOP
    return rec(name, _bound.key)


def tally(name: str, n: int = 1) -> None:
    """Count ``n`` of ``name`` (a table build of BUILDS, or a stats
    counter) to the call this thread works for; nothing where none is
    bound."""
    rec = getattr(_bound, "rec", None)
    if rec is not None:
        rec.tally(name, n)
