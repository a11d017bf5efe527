"""The readers of the program's spans and counters (``vpbench/spans.py``
and the seven metrics that use it), on a Run made of CPU decode_corpus
calls with a DecodeTimer: each reads a finite value in its range, and
each gives None, without raising, for a program whose timer keeps no
spans and whose stats count no builds."""

import json
import math
import pathlib
import resource
import time

import pytest

from vpbench import pool, run

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SHARES = ["front_end_offcpu_share.corpus", "pack_offcpu_share.corpus",
          "untraced_cpu_share.corpus"]
OTHERS = ["front_end_python_ms_per_audio_s.corpus",
          "native_entropy_cpu_ms_per_audio_s.corpus",
          "first_launch_ms.corpus", "table_builds_per_call.corpus"]


def cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


@pytest.fixture(scope="module")
def window():
    """A Run of one traced decode_corpus call of four pool members, made
    after a warm-up call of the same members."""
    from vorbispizza_tpu_torch import DecodeTimer, decode_corpus

    config = json.loads((REPO / BENCH["configs"][0]["file"]).read_text())
    members = pool.load(config)[:4]
    audio = 0.0
    for data in members:
        _, samples, rate = pool.audio_shape(data)
        audio += samples / rate
    decode_corpus(members, device="cpu")
    c0 = cpu_s()
    timer = DecodeTimer()
    t0 = time.perf_counter()
    outs = decode_corpus(members, device="cpu", timer=timer)
    t1 = time.perf_counter()
    call = run.Call(t0, t1, audio, len(members), 0, list(range(4)),
                    outs.stats, timer)
    return run.Run([call], 0.0, cpu_s() - c0, None, members)


def test_the_new_metrics_are_benchmark_entries():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SHARES + OTHERS:
        assert entries[name]["workloads"] == ["music.corpus-f32"]
        assert entries[name]["moves"] == "realtime_factor"
    assert {entries[n]["unit"] for n in SHARES} == {"%"}


@pytest.mark.parametrize("name", SHARES)
def test_shares_lie_in_range(window, name):
    value = run.reader(name)(window)
    assert value is not None and math.isfinite(value)
    assert 0.0 <= value <= 100.0


@pytest.mark.parametrize("name", OTHERS)
def test_others_are_finite(window, name):
    value = run.reader(name)(window)
    assert value is not None and math.isfinite(value) and value >= 0.0
    if name == "table_builds_per_call.corpus":
        assert value == 0  # the warm-up call built every table
    if name in ("first_launch_ms.corpus",
                "native_entropy_cpu_ms_per_audio_s.corpus",
                "front_end_python_ms_per_audio_s.corpus"):
        assert value > 0


@pytest.mark.parametrize("name", SHARES + OTHERS)
def test_a_program_without_spans_reads_nothing(window, name):
    """The parent's program: a timer with marks and stages only, stats
    without builds."""

    class OldTimer:
        stages, counters, events, _t0 = {}, {}, [], 0.0

    call = window.calls[0]
    stats = {k: v for k, v in call.stats.items() if k != "builds"}
    old = run.Run([run.Call(call.t0, call.t1, call.audio_s, call.items, 0,
                            call.members, stats, OldTimer())],
                  0.0, window.cpu_s, None, window.pool)
    assert run.reader(name)(old) is None
