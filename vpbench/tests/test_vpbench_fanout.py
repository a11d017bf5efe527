"""The reader of native_threads_per_decode.corpus on synthetic runs: the
mean threads a C++ entropy decode, None where the program does not count
them (the parent) or a call has no stats, and on a dry run of the music
cell's traffic on the CPU."""

import pytest

from vpbench import run

NAME = "native_threads_per_decode.corpus"


def synthetic(stats_list, audio_s=15.0):
    calls = [run.Call(float(k), k + 1.0, audio_s, 4, 0, [0], stats)
             for k, stats in enumerate(stats_list)]
    return run.Run(calls, 1.0, 1.0, None, [])


@pytest.mark.parametrize("stats_list, want", [
    ([{"native_decodes": 128, "native_threads": 128},
      {"native_decodes": 128, "native_threads": 128}], 1.0),
    ([{"native_decodes": 128, "native_threads": 1024},
      {"native_decodes": 2, "native_threads": 8}], 1032 / 130),
    ([{"native_decodes": 0, "native_threads": 0}], None),
    ([{"stage_s": {}}, {"stage_s": {}}], None),  # no counters: the parent
    ([{"native_decodes": 8, "native_threads": 8}, None], None),
])
def test_reader(stats_list, want):
    got = run.reader(NAME)(synthetic(stats_list))
    assert got == (want if want is None else pytest.approx(want))
