"""The thread fan-out of the C++ entropy decode on decode_corpus's and
decode_corpus_sharded's front-end pools: each decode takes the cores (at
most 16) shared among the decodes the pool runs at once
(models/corpus.decode_threads); a front end run on the caller's own
thread keeps the C++ default. A spy on the two native decode entries
records each call's thread count and packets."""

import collections
import concurrent.futures as cf
import importlib.util
import pathlib
import threading
import types

import numpy as np
import pytest

from vorbispizza_tpu_torch import decode_corpus, native
from vorbispizza_tpu_torch.config import VorbisConfig
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.parallel.corpus import decode_corpus_sharded
from vorbispizza_tpu_torch.parallel.mesh import Mesh
from vorbispizza_tpu_torch.testing.corpus32 import load_corpus
from vorbispizza_tpu_torch.testing.encode import encode_vorbis, make_signal

REPO = pathlib.Path(__file__).resolve().parents[1]

#: the chunk size at which the 7 s mono member (1.2 MB of dense spectrum)
#: goes in 2 pieces
MIB = 1 << 20
WORKERS = 8


@pytest.fixture
def spy(monkeypatch):
    """[(n_threads, packets)] of every C++ entropy decode, in the order
    they ran; the native front end required."""
    if not native.available():
        pytest.skip("native front end unavailable")
    calls, lock = [], threading.Lock()

    def wrap(fn):
        def spied(blob, sblob, starts, ends, *args, n_threads=None, **kw):
            with lock:
                calls.append((n_threads, len(starts)))
            return fn(blob, sblob, starts, ends, *args, n_threads=n_threads,
                      **kw)
        return spied

    for name in ("decode_packet_spans", "decode_packet_spans_sym"):
        monkeypatch.setattr(native, name, wrap(getattr(native, name)))
    return calls


def cores(monkeypatch, n):
    monkeypatch.setattr(torch_corpus, "_cores", lambda: n)


def tallies(calls, stats):
    """The call's counters hold every spied decode and its threads."""
    assert stats["native_decodes"] == len(calls)
    assert stats["native_threads"] == sum(t for t, _ in calls)


@pytest.fixture(scope="module")
def corpus():
    """The fewest corpus32 members that fill more than one chunk at the
    default corpus_batch_bytes (5 fill the first)."""
    return load_corpus()[:6]


@pytest.fixture(scope="module")
def long7():
    """A 7 s mono member at q0: 2 pieces at a 1 MiB chunk."""
    return encode_vorbis(make_signal(1, 7.0, kind="music", seed=6),
                         quality=0.0)


@pytest.fixture(scope="module")
def shorts():
    """10 stereo 0.4 s members, each well under a 1 MiB chunk."""
    return [encode_vorbis(make_signal(2, 0.4, kind="music", seed=s),
                          quality=0.3) for s in range(10)]


@pytest.mark.parametrize("n_cores, workers, units, want", [
    (8, 8, 128, 1), (8, 8, 8, 1), (16, 8, 8, 2), (16, 8, 2, 8),
    (8, 8, 2, 4), (64, 8, 1, 16), (64, 8, 128, 2), (3, 8, 8, 1),
    (8, 1, 128, 8), (8, 8, 0, 8), (16, 8, 5, 3), (8, 8, 9, 1),
    (12, 8, 3, 4), (1, 8, 8, 1),
])
def test_decode_threads_rule(monkeypatch, n_cores, workers, units, want):
    cores(monkeypatch, n_cores)
    assert torch_corpus.decode_threads(workers, units) == want


@pytest.mark.parametrize("n_cores, n_sources, want", [
    (8, 10, 1),   # the card's host: 8 // 8
    (16, 10, 2),  # min(16, 16) // 8
    (16, 2, 8),   # fewer sources than workers: // 2
    (8, 2, 4),
    (64, 1, 16),  # never more than the C++ default's 16
])
def test_whole_streams_take_the_pool_share(shorts, spy, monkeypatch,
                                           n_cores, n_sources, want):
    cores(monkeypatch, n_cores)
    outs = decode_corpus(shorts[:n_sources], device="cpu",
                         n_workers=WORKERS)
    assert outs.stats["batched"] == n_sources
    assert [t for t, _ in spy] == [want] * n_sources
    assert all(t <= 16 for t, _ in spy)
    tallies(spy, outs.stats)


@pytest.mark.parametrize("n_short, n_cores, want", [
    (0, 16, 8),   # one source in 2 pieces: 2 decodes, 16 // 2
    (0, 8, 4),
    (8, 16, 2),   # 9 sources, the pieces among them: 16 // 8
    (8, 8, 1),
])
def test_pieces_follow_the_rule(shorts, long7, spy, monkeypatch, n_short,
                                n_cores, want):
    cores(monkeypatch, n_cores)
    outs = decode_corpus([long7] + shorts[:n_short], device="cpu",
                         n_workers=WORKERS, max_batch_bytes=MIB)
    s = outs.stats
    assert (s["split_streams"], s["pieces"], s["batched"]) == (
        1, 2, 1 + n_short)
    # the pieces, not the whole stream: the call's sources and the
    # stream's one extra piece
    assert [t for t, _ in spy] == [want] * (2 + n_short)
    tallies(spy, s)


@pytest.mark.parametrize("long_at", [0, 3])
def test_whole_streams_keep_their_share_beside_pieces(shorts, long7, spy,
                                                      monkeypatch, long_at):
    """Whole streams take the share of the call's sources wherever the long
    one stands, before or after it is split: 16 // 4; its 2 pieces take
    16 // 5."""
    cores(monkeypatch, 16)
    sources = shorts[:3]
    sources.insert(long_at, long7)
    outs = decode_corpus(sources, device="cpu", n_workers=WORKERS,
                         max_batch_bytes=MIB)
    assert (outs.stats["pieces"], outs.stats["batched"]) == (2, 4)
    assert collections.Counter(t for t, _ in spy) == {4: 3, 3: 2}
    tallies(spy, outs.stats)


@pytest.mark.parametrize("n_cores, n_sources, want", [
    (8, 4, 2), (16, 9, 2), (64, 1, 16),
])
def test_sharded_pool_follows_the_rule(shorts, spy, monkeypatch, n_cores,
                                       n_sources, want):
    cores(monkeypatch, n_cores)
    monkeypatch.setattr(VorbisConfig.default, "corpus_workers", WORKERS)
    outs = decode_corpus_sharded(shorts[:n_sources],
                                 Mesh(["cpu"] * 2, ("stream",)),
                                 output="f32")
    assert outs.stats["batched"] == n_sources
    assert [t for t, _ in spy] == [want] * n_sources
    tallies(spy, outs.stats)


def test_front_end_on_the_callers_thread_keeps_the_default(corpus, spy,
                                                           monkeypatch):
    """No pool of a decode_corpus call: the C++ default (None), on the
    caller's thread and on a thread of a pool of its own."""
    cores(monkeypatch, 16)
    torch_corpus._front_end(corpus[0])
    with cf.ThreadPoolExecutor(2) as pool:
        pool.submit(torch_corpus._front_end, corpus[1]).result()
    assert [t for t, _ in spy] == [None, None]


def test_fan_out_is_bit_neutral(corpus, monkeypatch):
    """corpus32's members, over two chunks, decode to the same PCM and
    stats at the pool's share of the cores as at the C++ default's
    fan-out, forced; only the threads differ."""
    share = torch_corpus.decode_threads(VorbisConfig.default.corpus_workers,
                                        len(corpus))
    ours = decode_corpus(corpus, device="cpu")
    assert ours.stats["chunks"] > 1
    monkeypatch.setattr(torch_corpus, "decode_threads", lambda w, u: None)
    default = decode_corpus(corpus, device="cpu")
    assert len(ours) == len(default) == len(corpus)
    for a, b in zip(ours, default):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the first call's table builds are the second's cache hits; a decode
    # left to the C++ default is given no share and counts in neither
    skip = ("stage_s", "builds", "native_decodes", "native_threads")
    left, right = ({k: v for k, v in o.stats.items() if k not in skip}
                   for o in (ours, default))
    assert left == right
    assert ours.stats["native_decodes"] == len(corpus)
    assert ours.stats["native_threads"] == len(corpus) * share
    assert default.stats["native_decodes"] == 0


def _reader():
    path = REPO / "vpbench" / "metrics" / "native_threads_per_decode.corpus.py"
    spec = importlib.util.spec_from_file_location("native_threads_per_decode",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("n_cores, want", [(8, 1.0), (16, 2.0), (64, 2.0)])
def test_native_threads_per_decode_metric(shorts, monkeypatch, n_cores,
                                          want):
    """The benchmark's reader over two calls' stats: the threads a decode,
    the pool's share of the cores; None for a program without the
    counters."""
    cores(monkeypatch, n_cores)
    calls = [types.SimpleNamespace(stats=decode_corpus(
        shorts[:8], device="cpu", n_workers=WORKERS).stats)
        for _ in range(2)]
    assert _reader()(types.SimpleNamespace(calls=calls)) == want
    for c in calls:
        del c.stats["native_decodes"]
    assert _reader()(types.SimpleNamespace(calls=calls)) is None
