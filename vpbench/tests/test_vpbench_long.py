"""The audiobook cell on the CPU (the program's plain twins, a short
input): a dry run of its traffic mix with the split into pieces taken,
its three readers on synthetic runs, and the control failing its
configuration's limits."""

import json
import pathlib

import pytest

from vpbench import check, pool, refworker, run

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "audiobook.corpus-f32"
SEED = 2**31 + 16
MIB = 1 << 20


def config():
    w = next(x for x in BENCH["workloads"] if x["name"] == CELL)
    c = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    return json.loads((REPO / c["file"]).read_text())


def s00() -> bytes:
    return (REPO / config()["corpus"]["dir"] / "s00.ogg").read_bytes()


def test_dry_run_splits_and_is_correct(monkeypatch):
    """The first 16 pages of s00.ogg (about 2 MB of dense spectrum) at a
    1 MiB chunk: each call's member goes in pieces, and the answers hold
    to the reference."""
    from vorbispizza_tpu_torch.config import VorbisConfig

    for key in config()["vorbis_config"]:  # the run sets them: restore
        monkeypatch.setattr(VorbisConfig.default, key,
                            getattr(VorbisConfig.default, key))
    short = pool.cut(s00(), 16)
    monkeypatch.setattr(pool, "load", lambda cfg: [short])
    result, rec = run.execute(
        CELL, SEED, 0, False, device="cpu", bench=BENCH,
        traffic_overrides={"draws": 2, "keep_share": 1.0,
                           "kwargs": {"output": "f32",
                                      "max_batch_bytes": MIB}},
        ref_workers=1)
    assert result["correct"] and result["failed"] == 0
    assert result["compared"]["scalar"] == {"value": 0, "limit": 0}
    stats = rec.calls[0].stats
    assert stats["split_streams"] == 2 and stats["pieces"] >= 4
    assert 0 < stats["chunk_bytes_max"] <= MIB
    for name in ("split_ms_per_audio_s.long", "stitch_ms_per_audio_s.long"):
        assert run.reader(name)(rec) > 0
    assert run.reader("largest_chunk_mb.long")(rec) == (
        stats["chunk_bytes_max"] / 1e6)


def synthetic(stats_list, audio_s=10.0):
    calls = [run.Call(float(k), k + 1.0, audio_s, 4, 0, [0], stats)
             for k, stats in enumerate(stats_list)]
    return run.Run(calls, 1.0, 1.0, None, [])


def test_readers_on_synthetic_runs():
    with_counters = synthetic([
        {"stage_s": {"split": 0.02, "stitch": 0.004},
         "chunk_bytes_max": 25_000_000},
        {"stage_s": {"split": 0.03, "stitch": 0.006},
         "chunk_bytes_max": 24_000_000},
    ])
    read = {m: run.reader(m) for m in ("split_ms_per_audio_s.long",
                                       "stitch_ms_per_audio_s.long",
                                       "largest_chunk_mb.long")}
    assert read["split_ms_per_audio_s.long"](with_counters) == (
        pytest.approx(1e3 * 0.05 / 20.0))
    assert read["stitch_ms_per_audio_s.long"](with_counters) == (
        pytest.approx(1e3 * 0.01 / 20.0))
    assert read["largest_chunk_mb.long"](with_counters) == 25.0
    # a program without the stages and the counter (the parent): None
    without = synthetic([{"stage_s": {"merge": 0.1}}, {"stage_s": {}}])
    assert all(r(without) is None for r in read.values())
    # a call that failed whole has no stats: nothing to read
    failed = synthetic([{"stage_s": {"split": 0.0, "stitch": 0.0},
                         "chunk_bytes_max": 1}, None])
    assert all(r(failed) is None for r in read.values())


def test_control_fails_the_audiobook_limits():
    """The reference with its DCT-IV in TF32 on a 6-page cut of s00.ogg
    breaks a limit of the configuration; the reference itself keeps
    them."""
    limits = config()["limits"]["f32"]
    data = pool.cut(s00(), 6)
    ref = refworker.decode(data)
    ok, table = check.compare([("x", refworker.decode(data, control=True))],
                              {"x": ref}, limits)
    assert not ok
    assert any(table[n]["value"] > limits[n] for n in limits)
    assert check.compare([("x", ref)], {"x": ref}, limits)[0]
