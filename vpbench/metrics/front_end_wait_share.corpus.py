"""Share of the calls' wall in which the caller waited on the front ends
(stats["stage_s"]["front_end"]), in percent."""


def read(run):
    wait = run.stats_sum("front_end")
    wall = sum(c.t1 - c.t0 for c in run.calls)
    return None if wait is None or wall <= 0 else 100.0 * wait / wall
