"""Share of the window's process CPU that no span accounts for, in
percent: 100 x (1 - (thread CPU of each thread's outermost spans + the
C++ entropy decode's threads, native_cpu_ns) / process CPU). An upper
bound: the profiler's own CPU is in the process CPU. A native decode run
on its calling thread alone (one packet) counts in both terms."""

from vpbench.spans import call_spans, outermost


def read(run):
    calls = call_spans(run)
    if calls is None or run.cpu_s <= 0:
        return None
    traced = 0
    for _, spans in calls:
        threads = {}
        for sp in spans:
            threads.setdefault(sp.thread, []).append(sp)
            traced += sp.counters.get("native_cpu_ns", 0)
        for own in threads.values():
            traced += sum(sp.cpu_ns for sp in outermost(own))
    return 100.0 * (1.0 - traced / 1e9 / run.cpu_s)
