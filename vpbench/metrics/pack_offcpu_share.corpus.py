"""Share of the wall of the dispatch thread's merge and prepare spans
(merge_streams, prepare_host) in which the thread did not run: waiting
for the interpreter lock or a core, in percent."""

from vpbench.spans import offcpu_share


def read(run):
    return offcpu_share(run, {"merge", "prepare"})
