"""A run's control flow on the CPU (the program's plain twins, tiny
sizes): it decides ``correct`` and prints no device number. Then the
same run with the timed path broken underneath, once for each fault a
cell of this benchmark can have, must come out not correct; and the
control (the reference with its DCT-IV in TF32) must fail each
configuration's limits on a small input."""

import json
import pathlib

import numpy as np
import pytest

from vpbench import check, pool, refworker, run, traffic

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
#: BENCHMARK.json's cells, and a cell for each traffic mix that none of
#: them runs (the s16 wire, one request at a time), so that the harness's
#: paths for those mixes stay driven
MIXES = {"music.corpus-s16": "corpus-s16",
         "music.file-requests": "file-requests"}
CELLS = BENCH["workloads"] + [
    {"name": name, "config": BENCH["configs"][0]["name"], "traffic": mix,
     "chips": 1, "why": "a mix that no cell of BENCHMARK.json runs"}
    for name, mix in MIXES.items()
    if name not in {w["name"] for w in BENCH["workloads"]}]
TEST_BENCH = {**BENCH, "workloads": CELLS}
SEED = 2**31 + 7
TINY = {
    "music.corpus-s16": {"draws": 2, "keep_share": 1.0},
    "music.corpus-f32": {"draws": 2, "keep_share": 1.0},
    "music.file-requests": {"pages": [6, 7], "keep_share": 1.0},
}


def dry(cell, monkeypatch=None, broken=None, seconds=0, **overrides):
    if broken is not None:
        good = traffic.driver

        def factory(t, device):
            inner = good(t, device)
            return lambda srcs, timer: broken(*inner(srcs, timer))

        monkeypatch.setattr(traffic, "driver", factory)
    return run.execute(cell, SEED, seconds, False, device="cpu",
                       bench=TEST_BENCH,
                       traffic_overrides={**TINY[cell], **overrides},
                       pool_limit=2, ref_workers=1)[0]


@pytest.mark.parametrize("cell", list(TINY))
def test_dry_run_is_correct_and_prints_no_device_number(cell):
    result = dry(cell)
    assert result["correct"] and result["failed"] == 0
    assert "device" not in result and "breakdown" not in result
    assert set(result["metrics"]) <= {"setup_s", "realtime_factor",
                                      "request_p95_ms",
                                      "host_cpu_ms_per_audio_s"}
    assert result["compared"]["scalar"] == {"value": 0, "limit": 0}
    assert list(result)[-1] == "compared"


def test_scalar_fallback_is_not_correct(monkeypatch):
    """A stream the program sends to its float64 scalar decoder (the
    reference's twin) is not an answer of the timed path."""
    from vorbispizza_tpu_torch.frames import BatchUnsupported
    from vorbispizza_tpu_torch.models import corpus

    good, seen = corpus._front_end, []

    def every_other(source):
        seen.append(source)
        if len(seen) % 2:
            raise BatchUnsupported("planted: this stream goes scalar")
        return good(source)

    monkeypatch.setattr(corpus, "_front_end", every_other)
    result = dry("music.corpus-s16")
    assert result["compared"]["scalar"]["value"] >= 1
    assert result["failed"] == 0 and not result["correct"]


def test_open_loop_times_from_the_due_time():
    """An open loop (``arrivals_per_s``): calls start when due, and a
    request's latency runs from its due time."""
    result, rec = run.execute(
        "music.file-requests", SEED, 1.0, False, device="cpu",
        bench=TEST_BENCH,
        traffic_overrides={**TINY["music.file-requests"],
                           "arrivals_per_s": 1000.0},
        pool_limit=2, ref_workers=1)
    assert result["correct"] and len(rec.calls) >= 2
    assert all(c.due is not None and c.t0 >= c.due for c in rec.calls)
    # far over what a CPU sustains: the queue grows, so each request
    # waits longer than it runs
    assert rec.calls[-1].t1 - rec.calls[-1].due > (rec.calls[-1].t1
                                                   - rec.calls[-1].t0)


def test_device_output_is_compared_on_the_host():
    """``output="device"`` answers (tensors, unclipped) are moved to the
    host and held to the unclipped reference under the f32 limits."""
    result = dry("music.corpus-f32", kwargs={"output": "device"})
    assert result["correct"] and "max_abs" in result["compared"]


def _half_left_out(outs, stats):
    """The second half of the call's answers never computed: zeros."""
    half = len(outs) // 2
    return outs[:half] + [np.zeros_like(o) for o in outs[half:]], stats


def _answer_altered(outs, stats):
    """One sample of every answer altered where it is produced."""
    out = []
    for o in outs:
        o = np.array(o, copy=True)
        flat = o.reshape(-1)
        mid = flat.size // 2
        if o.dtype == np.int16:
            flat[mid] = flat[mid] + (8192 if flat[mid] < 0 else -8192)
        else:
            flat[mid] += np.float32(0.25 if flat[mid] < 0 else -0.25)
        out.append(o)
    return out, stats


def _answer_missing(outs, stats):
    """The last answer never comes."""
    return outs[:-1] + [None], stats


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered,
                                   _answer_missing])
@pytest.mark.parametrize("cell", ["music.corpus-s16", "music.file-requests"])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    if cell == "music.file-requests" and fault is _half_left_out:
        # one answer a call: leaving half of it out is the altered answer
        fault = _answer_altered
    result = dry(cell, monkeypatch, fault)
    assert not result["correct"]


def _limits(cell):
    w = next(x for x in CELLS if x["name"] == cell)
    c = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    config = json.loads((REPO / c["file"]).read_text())
    s16 = traffic.load(w["traffic"])["kwargs"].get("output") == "s16"
    return config, config["limits"]["s16" if s16 else "f32"]


@pytest.mark.parametrize("cell", [w["name"] for w in CELLS])
def test_control_fails_the_limits(cell):
    """The control at a size a test run holds: one short input."""
    config, limits = _limits(cell)
    data = pool.cut((REPO / config["corpus"]["dir"] / "s00.ogg")
                    .read_bytes(), 6)
    ref = refworker.decode(data)
    ctl = refworker.decode(data, control=True)
    if "max_lsb" in limits and "max_abs" not in limits:  # an s16 cell
        ctl = np.clip(np.rint(ctl.astype(np.float64) * 32768), -32768,
                      32767).astype(np.int16)
    ok, table = check.compare([("x", ctl)], {"x": ref}, limits)
    assert not ok
    ok_ref, _ = check.compare([("x", ref)], {"x": ref}, limits)
    assert ok_ref


@pytest.mark.card
def test_cell_on_the_card():
    """One short traced run of the first cell on a card, when one is
    present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    result = run.execute(BENCH["workloads"][0]["name"], SEED, 1, True)[0]
    assert result["correct"] and result["device"]["busy_s"] > 0

