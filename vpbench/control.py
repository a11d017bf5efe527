"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's (its DCT-IV
product in TF32, ``refworker.imdct_tf32``), held to the reference by the
same numbers and limits as a run.

    python3 -m vpbench.control --workload <cell> --calls <n> --seeds <s> ...

For each seed it takes the answers a run of that seed keeps from its
first ``--calls`` calls (the cell's own inputs, at the cell's own size)
and prints one JSON line: the worst of each number, its limit, and
whether the control passed (it must not). A last line gives the numbers
of each distinct input. The program is not run: the control needs no
card, and a run's own lines give the program's readings.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import check, pool, traffic as traffic_mod
from .run import REPO


def readings(cell_name: str, seeds: list, calls: int, workers: int = 8,
             bench: dict | None = None, pool_limit: int | None = None):
    """-> ([(seed, passed, {number: worst})], {input: {number: value}})."""
    bench = bench or json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / cfg["file"]).read_text())
    traffic = traffic_mod.load(cell["traffic"])
    s16 = traffic.get("kwargs", {}).get("output") == "s16"
    limits = config["limits"]["s16" if s16 else "f32"]
    clip = traffic_mod.clipped(traffic)
    members = pool.load(config)[:pool_limit]
    kept = {}
    for seed in seeds:
        keys = []
        for k in range(calls):
            for m, n, keep in traffic_mod.call(traffic, seed, k, len(members)):
                if keep:
                    keys.append((m, n))
        kept[seed] = keys
    distinct = sorted({key for keys in kept.values() for key in keys},
                      key=lambda t: (t[0], t[1] or 0))
    inputs = {key: members[key[0]] if key[1] is None
              else pool.cut(members[key[0]], key[1]) for key in distinct}
    refs = check.reference_pcm(inputs, workers=workers, clip=clip)
    ctls = check.reference_pcm(inputs, control=True, workers=workers,
                               clip=clip)
    if s16:
        ctls = {k: np.clip(np.rint(v.astype(np.float64) * 32768.0), -32768,
                           32767).astype(np.int16) for k, v in ctls.items()}
    per_input = {key: check.numbers(ctls[key], refs[key]) for key in distinct}
    out = []
    for seed, keys in kept.items():
        passed, table = check.compare([(k, ctls[k]) for k in keys], refs,
                                      limits)
        out.append((seed, passed, {n: table[n]["value"] for n in limits}))
    return out, per_input


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    rows, per_input = readings(args.workload, args.seeds, args.calls,
                               args.workers)
    for seed, passed, worst in rows:
        print(json.dumps({"seed": seed, "control_passed": passed,
                          "numbers": worst}), flush=True)
    print(json.dumps({"per_input": {f"{m}:{n}": v for (m, n), v
                                    in per_input.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
