"""How ``correct`` is decided: the outputs the timed calls returned, held to
the plain reference (``reference/``, float64) on the same input bytes.

The reference runs once per distinct input, after the window, on a pool
of spawned worker processes (``refworker``), so it shares nothing with the
program's process but the bytes. Each number compared has its limit in the
configuration's file (``limits``, keyed by the kind of answer that
reaches the host, ``kind``: ``s16`` for int16 PCM, ``f32`` for float32);
``PERF.md`` gives the readings each limit was set from.

Numbers (a float32 output is quantized as the program quantizes s16:
round to nearest, times 32768, clipped to int16):

- ``max_lsb``: the widest gap, in s16 steps, between an output sample and
  the quantized reference;
- ``off_share``: the largest share, over the outputs compared, of an
  output's samples that differ from the quantized reference at all;
- ``over2_share``: the same share of samples more than 2 steps off;
- ``max_abs``: the widest gap of a float32 output from the reference.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import os

import numpy as np

_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def reference_pcm(inputs: dict, *, control: bool = False,
                  workers: int = 8, clip: bool = True) -> dict:
    """{key: bytes} -> {key: planar float32 PCM} of the reference (or the
    control), clipped to full scale where ``clip``, decoded on ``workers``
    spawned processes."""
    from . import refworker

    keys = list(inputs)
    if workers <= 1 or len(keys) <= 1:
        return {k: refworker.decode(inputs[k], control, clip) for k in keys}
    # one BLAS thread a worker: the workers already fill the cores
    saved = {v: os.environ.get(v) for v in _THREAD_VARS}
    os.environ.update(dict.fromkeys(_THREAD_VARS, "1"))
    try:
        with cf.ProcessPoolExecutor(min(workers, len(keys)),
                                    mp_context=mp.get_context("spawn")) as pool:
            pcms = pool.map(refworker.decode, [inputs[k] for k in keys],
                            [control] * len(keys), [clip] * len(keys))
            return dict(zip(keys, pcms))
    finally:
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old


def kind(answer: np.ndarray) -> str:
    """The key of an answer's limits: "s16" (int16 PCM) or "f32"."""
    return "s16" if answer.dtype == np.int16 else "f32"


def _quantize(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x.astype(np.float64) * 32768.0), -32768, 32767)


def numbers(got: np.ndarray, ref: np.ndarray) -> dict:
    """The numbers of one output against its reference (same shape)."""
    ref_q = _quantize(ref)
    if got.dtype == np.int16:
        gap = np.abs(got.astype(np.float64) - ref_q)
        out = {}
    else:
        gap = np.abs(_quantize(got) - ref_q)
        out = {"max_abs": float(np.abs(got.astype(np.float64)
                                       - ref.astype(np.float64)).max(
                                           initial=0.0))}
    out["max_lsb"] = float(gap.max(initial=0.0))
    n = max(gap.size, 1)
    out["off_share"] = float(np.count_nonzero(gap) / n)
    out["over2_share"] = float(np.count_nonzero(gap > 2) / n)
    return out


def compare(kept: list, refs: dict, limits: dict) -> tuple[bool, dict]:
    """``kept``: [(key, output)]; ``refs``: {key: reference PCM};
    ``limits``: {number: limit}. -> (every number within its limit and
    every output of the reference's shape, {number: {value, limit}}).
    Each number is the worst over the outputs compared."""
    worst = dict.fromkeys(limits, 0.0)
    ok = bool(kept)
    for key, got in kept:
        ref = refs[key]
        if got is None or got.shape != ref.shape:
            ok = False
            continue
        for name, v in numbers(got, ref).items():
            if name in worst:
                worst[name] = max(worst[name], v)
    table = {}
    for name, limit in limits.items():
        table[name] = {"value": worst[name], "limit": limit}
        ok = ok and worst[name] <= limit
    table["outputs"] = {"value": len(kept), "limit": "> 0"}
    return ok, table
