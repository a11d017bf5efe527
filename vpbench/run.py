"""Run one cell of the benchmark once and print its result line.

    python3 -m vpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name from
``BENCHMARK.json``; the metrics by name in ``metrics/``. The run loads
and checks the configuration's pool, warms up every path the traffic
takes, drives the program's entry point in the traffic mix's loop for
``--seconds`` (calls start while the window lasts; each started call
completes), then holds a seeded sample of the answers to the plain
reference. With
``--trace 1`` the window runs under ``torch.profiler`` and the line holds
the per-layer metrics, the device's busy time and a breakdown; with
``--trace 0`` the end-to-end metrics.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
#: top-level module names that may not be loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "vorbispizza_tpu")


@dataclasses.dataclass
class Call:
    """One call of the window: its host-clock span, the audio seconds of
    its inputs, how many answers it owed and how many failed, the
    program's stats, (traced runs) its DecodeTimer and (open loops) the
    time it was due."""

    t0: float
    t1: float
    audio_s: float
    items: int
    failed: int
    members: list
    stats: dict | None
    timer: object = None
    rss_mb: float = 0.0
    due: float | None = None


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    calls: list
    setup_s: float
    cpu_s: float
    trace: dict | None
    pool: list

    @property
    def wall_s(self) -> float:
        return self.calls[-1].t1 - self.calls[0].t0

    @property
    def audio_s(self) -> float:
        return sum(c.audio_s for c in self.calls)

    def stats_sum(self, *keys) -> float | None:
        """Sum over the calls of stats[key] or stats["stage_s"][key];
        None when a call has no stats."""
        total = 0.0
        for c in self.calls:
            if c.stats is None:
                return None
            for k in keys:
                src = c.stats if k in c.stats else c.stats.get("stage_s", {})
                total += src.get(k, 0)
        return total


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded in the run's process."""


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(name: str):
    """The ``read(run)`` function of metrics/<name>.py."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vpbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_names(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    metrics (a metric without ``workloads`` belongs to every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def _host_phases(calls: list) -> list:
    """(label, start, end) on the host clock: each call's wait for the
    front ends (call start to its first chunk's merge), and per chunk its
    packing (merge, prepare_host, H2D), launch and pull, from the
    program's DecodeTimer marks (a call without them is one "call"
    phase); and the gaps between calls."""
    out = []
    for k, c in enumerate(calls):
        if k:
            out.append(("between calls", calls[k - 1].t1, c.t0))
        if c.timer is None or not c.timer.events:
            out.append(("call", c.t0, c.t1))
            continue
        base = c.timer._t0
        marks = {name: base + t for name, t in c.timer.events}
        firsts = [t for n, t in marks.items() if n.endswith(".merge0")]
        if firsts:
            out.append(("front ends", c.t0, min(firsts)))
        for name, t in marks.items():
            cid, _, what = name.partition(".")
            for start, end, label in (("merge0", "dispatch0", "pack"),
                                      ("dispatch0", "dispatched", "launch"),
                                      ("pull0", "pull_done", "pull")):
                if what == start and f"{cid}.{end}" in marks:
                    out.append((label, t, marks[f"{cid}.{end}"]))
    return out


def _rss_mb() -> float:
    """Resident memory of the process, MiB (Linux)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20
    except OSError:
        return 0.0


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def execute(cell_name: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", bench: dict | None = None,
            traffic_overrides: dict | None = None, pool_limit: int | None = None,
            ref_workers: int = 8) -> tuple[dict, Run]:
    """One run of the cell -> (the result line, the Run its metrics were
    read from).

    ``device="cpu"`` drives the program's plain twins (tests): the result
    then holds no device numbers. ``traffic_overrides``, ``pool_limit``
    and ``ref_workers`` shrink the run for tests."""
    import numpy as np
    import torch

    from . import check, pool, traffic as traffic_mod
    from .trace import Tracer, reduce

    bench = bench or json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / cfg_entry["file"]).read_text())
    traffic = {**traffic_mod.load(cell["traffic"]), **(traffic_overrides or {})}
    chips = cell["chips"]
    on_card = device != "cpu"
    trace = trace and on_card

    from vorbispizza_tpu_torch.config import VorbisConfig

    for key, value in config["vorbis_config"].items():
        setattr(VorbisConfig.default, key, value)
    members = pool.load(config)[:pool_limit]
    if "pages" in traffic:
        lo, hi = traffic["pages"]
        sources = {(m, n): pool.cut(d, n) for m, d in enumerate(members)
                   for n in range(lo, hi + 1)}
    else:
        sources = {(m, None): d for m, d in enumerate(members)}
    expected = {}  # input -> (output shape, audio seconds)
    for key, data in sources.items():
        ch, samples, rate = pool.audio_shape(data)
        expected[key] = ((ch, samples), samples / rate)

    run_call = traffic_mod.driver(traffic, device)

    def sync():
        # an answer left on a card counts when the card has made it
        if on_card:
            for i in range(chips):
                torch.cuda.synchronize(i)

    # warm-up: one call of the window's size drawn from the seed (lists
    # of draws) or one request of each size (page cuts); builds the
    # kernels and the program's tables, warms cuBLAS and grows the pinned
    # and caching pools to the window's needs
    if "pages" in traffic:
        lo, hi = traffic["pages"]
        for n in range(lo, hi + 1):
            run_call([sources[((n - lo) % len(members), n)]], None)
    else:
        spec = traffic_mod.call(traffic, seed, traffic_mod.WARMUP,
                                len(members))
        run_call([sources[(m, n)] for m, n, _ in spec], None)
    sync()
    gc.collect()

    timer_cls = None
    if trace:
        from vorbispizza_tpu_torch import DecodeTimer as timer_cls
    due = traffic_mod.due_times(
        traffic, seed, int(2 * traffic.get("arrivals_per_s", 0) * seconds)
        + 16)
    tracer = Tracer() if trace else None
    calls, kept = [], []
    with contextlib.ExitStack() as stack:
        if tracer is not None:
            stack.enter_context(tracer)
            stack.enter_context(tracer.window())
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        opened = time.perf_counter()
        deadline = opened + seconds
        k = 0
        while k == 0 or time.perf_counter() < deadline:
            due_k = None
            if due is not None:
                if k == len(due) or opened + due[k] >= deadline and k:
                    break
                due_k = opened + due[k]
                time.sleep(max(0.0, due_k - time.perf_counter()))
            spec = traffic_mod.call(traffic, seed, k, len(members))
            srcs = [sources[(m, n)] for m, n, _ in spec]
            timer = timer_cls() if timer_cls else None
            t0 = time.perf_counter()
            try:
                outs, stats = run_call(srcs, timer)
                sync()
                error = None
            except Exception:  # a failed call fails its answers; go on
                outs, stats = [None] * len(spec), None
                error = traceback.format_exc()
            t1 = time.perf_counter()
            outs = list(outs) + [None] * (len(spec) - len(outs))
            failed, audio = 0, 0.0
            for (m, n, keep), out in zip(spec, outs):
                shape, secs = expected[(m, n)]
                if out is None or tuple(out.shape) != shape:
                    failed += 1
                    continue
                audio += secs
                if keep:
                    if isinstance(out, torch.Tensor):
                        out = out.cpu()
                    kept.append(((m, n), np.array(out, copy=True)))
            if error is not None:
                print(f"call {k} raised:\n{error}", file=sys.stderr)
            calls.append(Call(t0, t1, audio, len(spec), failed,
                              [m for m, _, _ in spec], stats, timer,
                              _rss_mb(), due_k))
            k += 1
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)

    device_info = None
    if on_card:
        device_info = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips)),
        }
    summary = None
    if tracer is not None:
        summary = reduce(tracer, _host_phases(calls), chips)
        tracer = None
    # the program's state goes before the reference runs
    run_call = outs = stats = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        device_info["power"] = _power_limit()

    cpu_s = (ru1.ru_utime + ru1.ru_stime) - (ru0.ru_utime + ru0.ru_stime)
    run = Run(calls, calls[0].t0 - T0, cpu_s, summary,
              members)
    metrics = {}
    for m in metric_names(bench, cell_name, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    inputs = {key: sources[key] for key, _ in kept}
    refs = check.reference_pcm(inputs, workers=ref_workers,
                               clip=traffic_mod.clipped(traffic))
    kind = next((check.kind(o) for _, o in kept), "f32")
    ok, compared = check.compare(kept, refs, config["limits"][kind])
    attempted = sum(c.items for c in calls)
    failed = sum(c.failed for c in calls)
    compared["failed"] = {"value": failed, "limit": 0}
    # answers the program made off the card, on its float64 scalar
    # decoder (the reference's twin), are not the timed path's answers
    scalar = sum((c.stats or {}).get("scalar", 0) for c in calls)
    compared["scalar"] = {"value": scalar, "limit": 0}
    ok = ok and failed == 0 and scalar == 0 and attempted > 0
    result = {"correct": bool(ok),
              "attempted": attempted, "failed": failed, "metrics": metrics}
    if device_info is not None:
        if summary is not None:
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
        result["device"] = device_info
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["compared"] = compared
    return result, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache of the run stays inside the checkout
    cache = ROOT / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['chips']} cards needed, "
              f"{torch.cuda.device_count()} present: no result",
              file=sys.stderr)
        return 3
    try:
        result, run = execute(args.workload, args.seed, args.seconds,
                              bool(args.trace), bench=bench)
    except ForbiddenImport as e:
        print(f"forbidden modules loaded: {', '.join(e.args[0])}: no result",
              file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}: no result",
              file=sys.stderr)
        return 4
    for k, c in enumerate(run.calls):
        print(f"call {k}: {c.t1 - c.t0:.4f} s, {c.audio_s:.3f} audio s, "
              f"{c.items} answers, {c.failed} failed, rss {c.rss_mb:.0f} MiB",
              file=sys.stderr)
    print(f"setup_s {run.setup_s}", file=sys.stderr)
    for name, row in result["compared"].items():
        print(f"compared {name}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
