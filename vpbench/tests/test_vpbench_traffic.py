"""The one traffic generator: deterministic in the seed, with the set of
sizes each seed sees fixed (file requests: every page count once a
block), and the page cut and audio shape the harness reads itself."""

import json
import pathlib

import pytest

from vpbench import pool, traffic
from vpbench.reference.ogg.crc import ogg_crc

REPO = pathlib.Path(__file__).resolve().parents[2]
MIXES = sorted(p.stem for p in (REPO / "vpbench" / "traffic").glob("*.json"))
BIG = 2**31 + 11


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_calls(mix):
    t = traffic.load(mix)
    first = [traffic.call(t, BIG, k, 32) for k in range(40)]
    again = [traffic.call(t, BIG, k, 32) for k in range(40)]
    other = [traffic.call(t, BIG + 2, k, 32) for k in range(40)]
    assert first == again and first != other
    assert traffic.call(t, BIG, traffic.WARMUP, 32) != first[0]
    assert all(0 <= m < 32 for c in first for m, _, _ in c)


def test_corpus_call_size():
    t = traffic.load("corpus-s16")
    spec = traffic.call(t, BIG, 3, 32)
    assert len(spec) == t["draws"] and all(n is None for _, n, _ in spec)
    kept = sum(k for _, _, k in spec)
    assert 0 < kept < len(spec)


def test_file_requests_cover_every_size_each_block():
    t = traffic.load("file-requests")
    lo, hi = t["pages"]
    width = hi - lo + 1
    for seed in (0, BIG):
        for block in range(3):
            sizes = [traffic.call(t, seed, block * width + j, 32)[0][1]
                     for j in range(width)]
            assert sorted(sizes) == list(range(lo, hi + 1))
    longest = [traffic.call(t, BIG, k, 32)[0] for k in range(4 * width)]
    assert all(kept for _, n, kept in longest if n == hi)


def test_cut_and_shape():
    data = (REPO / "vpbench" / "data" / "music" / "s00.ogg").read_bytes()
    manifest = json.loads(
        (REPO / "vpbench" / "data" / "music" / "MANIFEST.json").read_text())
    assert len(manifest["sha256"]) == 32
    assert pool.audio_shape(data) == (2, 661500, 44100)
    clip = pool.cut(data, 6)
    assert len(pool.pages(clip)) == 6
    assert clip[: pool.pages(clip)[-1][0]] == data[: pool.pages(clip)[-1][0]]
    ch, samples, rate = pool.audio_shape(clip)
    assert ch == 2 and rate == 44100 and 0 < samples < 661500
    off, size = pool.pages(clip)[-1]
    page = bytearray(clip[off : off + size])
    assert page[5] & 4
    crc = int.from_bytes(page[22:26], "little")
    page[22:26] = b"\0\0\0\0"
    assert ogg_crc(bytes(page)) == crc
