"""The one traffic generator and the one driver of the program's entry
points.

A traffic mix is a data file, ``traffic/<mix>.json``, that this module
reads; a new mix is a new file. Its keys:

- ``entry``: the public function of ``vorbispizza_tpu_torch`` the calls
  go to, by its dotted name below the package (``decode_corpus``,
  ``decode_file_batch``, ``parallel.corpus.decode_corpus_sharded``...);
- ``takes``: ``"sources"`` (a call passes the list of its inputs and
  gets one answer each back) or ``"source"`` (a call passes one input
  and gets its answer back);
- ``kwargs``: keyword arguments passed to the entry as given (``output``,
  ``devices``, ``max_frames``...); the harness adds ``device``, and
  ``timer`` (a DecodeTimer) in traced runs where the entry takes one;
- ``draws``: inputs per call, drawn with replacement from the pool; or
  ``pages``: [least, most], each call one member cut to its first k
  pages, every k of the range once in each block of calls, in a seeded
  order;
- ``keep_share``: the share of answers kept for the comparison with the
  reference, drawn from the seed (a ``pages`` mix also keeps every
  answer of the most pages, the longest requests);
- ``arrivals_per_s`` (optional): an open loop. Call k is due at a seeded
  Poisson arrival time after the window opens; the one caller starts it
  when it is due or, if the previous call is still running, when that
  one returns, and its latency runs from the due time. Without the key
  the loop is closed: the next call starts when the last one returned.

Call k's inputs and due time depend on the seed and k alone, so a run of
any length sees the same calls in the same order.
"""

from __future__ import annotations

import importlib
import inspect
import json
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
PROGRAM = "vorbispizza_tpu_torch"
#: call index of the warm-up call: drawn like a window's call, never one
WARMUP = 1 << 40
#: stream of the seeded arrival gaps, apart from the inputs' draws
ARRIVALS = 1 << 41


def load(mix: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{mix}.json").read_text())


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *keys])


def call(traffic: dict, seed: int, k: int, pool_size: int) -> list:
    """Call k of the loop: [(member, pages or None, kept)]."""
    if "draws" in traffic:
        rng = _rng(seed, k)
        members = rng.integers(0, pool_size, traffic["draws"])
        kept = rng.random(traffic["draws"]) < traffic["keep_share"]
        return [(int(m), None, bool(c)) for m, c in zip(members, kept)]
    lo, hi = traffic["pages"]
    block, j = divmod(k, hi - lo + 1)
    rng = _rng(seed, block)
    pages = rng.permutation(np.arange(lo, hi + 1))
    members = rng.integers(0, pool_size, hi - lo + 1)
    kept = rng.random(hi - lo + 1) < traffic["keep_share"]
    n = int(pages[j])
    return [(int(members[j]), n, bool(kept[j]) or n == hi)]


def due_times(traffic: dict, seed: int, n: int) -> np.ndarray | None:
    """Seconds after the window opens at which calls 0..n-1 are due (an
    open loop), or None (a closed loop)."""
    rate = traffic.get("arrivals_per_s")
    if rate is None:
        return None
    gaps = _rng(seed, ARRIVALS).exponential(1.0 / rate, n)
    return np.cumsum(gaps) - gaps[0]


def clipped(traffic: dict) -> bool:
    """Whether the entry clips its float answers to full scale, as the
    reference does unless told not to (``output="device"`` leaves them
    unclipped, as ``clip_samples=False`` does)."""
    kw = traffic.get("kwargs", {})
    return kw.get("output") != "device" and kw.get("clip_samples", True)


def entry(traffic: dict):
    """The program's function named by ``traffic["entry"]``."""
    path, _, name = f"{PROGRAM}.{traffic['entry']}".rpartition(".")
    return getattr(importlib.import_module(path), name)


def driver(traffic: dict, device: str):
    """-> run(sources, timer) -> (answers in input order, the call's stats
    or None)."""
    fn = entry(traffic)
    kwargs = {"device": device, **traffic.get("kwargs", {})}
    takes_timer = "timer" in inspect.signature(fn).parameters

    def run(srcs, timer):
        kw = dict(kwargs, timer=timer) if takes_timer and timer else kwargs
        if traffic["takes"] == "source":
            return [fn(s, **kw) for s in srcs], None
        outs = fn(srcs, **kw)
        return list(outs), getattr(outs, "stats", None)

    return run
