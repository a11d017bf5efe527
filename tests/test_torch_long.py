"""PyTorch port, long streams on the CPU: frames.split_plan on streams
with granule trims, resyncs and no coupling, and decode_corpus cutting a
stream larger than its chunk into pieces (frames.plan_piece), each a unit
of the chunks, their PCM placed into the stream's answer.

Tolerances: the pieces against the unsplit decode, and decode_corpus's
split against ``batched=False`` (one program a stream), bit for bit; f32
within 2e-6 of the benchmark's plain float64 reference (the CPU's
allowance)."""

import io
import re
import threading

import numpy as np
import pytest

from vorbispizza_tpu_torch import DecodeTimer, decode_corpus, decode_file_batch
from vorbispizza_tpu_torch.decoder import StreamDecoder
from vorbispizza_tpu_torch.errors import InvalidDataError
from vorbispizza_tpu_torch.frames import BatchUnsupported, build_plan, split_plan
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.ogg.container import OggContainer
from vorbispizza_tpu_torch.testing import pagecraft, rawstream
from vorbispizza_tpu_torch.testing.encode import encode_vorbis, make_signal
from vorbispizza_tpu_torch.testing.streams import make_streams
from vorbispizza_tpu_torch.utils.profiling import SPAN_STAGES

TOL = 2e-6
#: the chunk size of these tests: the 20 s mono member (3.5 MB of dense
#: spectrum) goes in 4 pieces, the 7 s one (1.2 MB) in 2
MIB = 1 << 20


def plan_of(data: bytes):
    c = OggContainer(io.BytesIO(data))
    assert c.try_init()
    provider = c.providers[0]
    dec = StreamDecoder(provider)
    dec.initialize()
    return build_plan(provider, dec._setup)


def regranule(data: bytes, fn) -> bytes:
    """``data`` repaged with each audio packet's end granule g (packet k of
    n) replaced by fn(k, n, g)."""
    headers, audio, serial = pagecraft.extract_packets(data)
    n = len(audio)
    audio = [(d, fn(k, n, g)) for k, (d, g) in enumerate(audio)]
    return rawstream.page_stream(headers + audio, serial=serial)


def chained_with_cut() -> bytes:
    """Stereo, one page's CRC broken (a resync: two chains) and the last
    quarter's granules 300 behind (a cut inside the second chain)."""
    data = encode_vorbis(make_signal(2, 4.0, kind="music", seed=2),
                         quality=0.3)
    raw = bytearray(regranule(data, lambda k, n, g: g - 300
                              if k > 3 * n // 4 else g))
    pages = [m.start() for m in re.finditer(b"OggS", bytes(raw))]
    raw[pages[3] + 40] ^= 0xFF
    return bytes(raw)


SPLIT_CASES = {
    # libvorbisenc's own stream: its EOS granule trims the end
    "end_trim": lambda: encode_vorbis(
        make_signal(2, 1.2, kind="music", seed=11), quality=0.4),
    # mono at q0: residue type 1, no coupling step
    "mono_uncoupled": lambda: encode_vorbis(
        make_signal(1, 3.0, kind="music", seed=7), quality=0.0),
    "chained_cut": chained_with_cut,
    # every granule 300 behind: the first anchor trims the start
    "start_trim": lambda: regranule(make_streams("stereo")[1],
                                    lambda k, n, g: g - 300),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_plan_pieces_decode_to_the_unsplit_pcm(name):
    """Pieces of a third and of a half of the frames decode, one after
    another, to the unsplit PCM bit for bit, their segments the plan's."""
    data = SPLIT_CASES[name]()
    plan = plan_of(data)
    trims = sum(e - s for s, e in plan.segments) < plan.total_len
    assert trims  # every case carries a granule trim or cut
    if name == "chained_cut":
        assert len(plan.chains) == 2 and len(plan.chain_segments[1]) == 2
    whole = decode_file_batch(data, device="cpu")
    for max_frames, pieces in ((plan.n_frames // 3, 4),
                               (plan.n_frames // 2 + 1, 2)):
        parts = split_plan(plan, max_frames)
        assert len(parts) == pieces
        assert all(p.n_frames <= max_frames for p in parts)
        assert sum(p.pcm_length for p in parts) == plan.pcm_length
        got = decode_file_batch(data, device="cpu", max_frames=max_frames)
        assert got.shape == whole.shape
        np.testing.assert_array_equal(got, whole)


# --------------------------------------------------------- decode_corpus


@pytest.fixture(scope="module")
def sources():
    """Stereo, a 20 s and a 7 s mono member at q0 with a short mono
    member between them, stereo: the mono pieces share chunks with the
    short member and with each other."""
    stereo = make_streams("stereo")
    long20 = encode_vorbis(make_signal(1, 20.0, kind="music", seed=5),
                           quality=0.0)
    long7 = encode_vorbis(make_signal(1, 7.0, kind="music", seed=6),
                          quality=0.0)
    return [stereo[0], long20, make_streams("mono")[0], long7, stereo[1]]


@pytest.fixture(scope="module")
def unsplit(sources):
    return {out: decode_corpus(sources, device="cpu", output=out,
                               batched=False)
            for out in ("f32", "s16", "device")}


def host(x):
    return x.numpy() if hasattr(x, "numpy") else x


@pytest.mark.parametrize("output", ["f32", "s16", "device"])
def test_split_matches_one_program_a_stream(sources, unsplit, output):
    outs = decode_corpus(sources, device="cpu", output=output,
                         max_batch_bytes=MIB)
    s = outs.stats
    assert (s["split_streams"], s["pieces"]) == (2, 6)
    assert s["batched"] == len(sources) and s["scalar"] == s["failed"] == 0
    assert s["chunk_bytes_max"] <= MIB
    for got, want in zip(outs, unsplit[output]):
        got, want = host(got), host(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_split_matches_the_plain_reference(sources):
    from vpbench import refworker

    outs = decode_corpus(sources[1:4], device="cpu", max_batch_bytes=MIB)
    assert outs.stats["split_streams"] == 2
    for data, got in zip(sources[1:4], outs):
        want = refworker.decode(data)
        assert got.shape == want.shape
        assert np.abs(got.astype(np.float64) - want).max() <= TOL


def spy_chunks(monkeypatch):
    """Record each merged chunk: [(dense bytes, is a piece)] a unit."""
    chunks, pieces, lock = [], set(), threading.Lock()
    real_piece, real_merge = torch_corpus.plan_piece, torch_corpus.merge_streams

    def plan_piece(plan, a, b):
        piece = real_piece(plan, a, b)
        with lock:
            pieces.add(id(piece))
        return piece

    def merge_streams(items):
        chunk = []
        for plan, buckets in items:
            with lock:  # a piece is merged once: its id may come again
                is_piece = id(plan) in pieces
                pieces.discard(id(plan))
            chunk.append((sum(b.batch_cost for b in buckets), is_piece))
        chunks.append(chunk)
        return real_merge(items)

    monkeypatch.setattr(torch_corpus, "plan_piece", plan_piece)
    monkeypatch.setattr(torch_corpus, "merge_streams", merge_streams)
    return chunks


@pytest.mark.parametrize("n_workers", [1, 8])
def test_chunks_are_deterministic_and_bounded(sources, monkeypatch,
                                              n_workers):
    """Chunk order and membership are the same on every run and at any
    worker count; no chunk holds more than max_batch_bytes besides its
    last unit where that is a whole stream; pieces share chunks with a
    whole stream and with the next long stream's first piece."""
    chunks = spy_chunks(monkeypatch)
    first = decode_corpus(sources, device="cpu", max_batch_bytes=MIB,
                          n_workers=n_workers)
    runs = [list(chunks)]
    chunks.clear()
    decode_corpus(sources, device="cpu", max_batch_bytes=MIB)
    runs.append(list(chunks))
    assert runs[0] == runs[1]
    units = [u for c in runs[0] for u in c]
    assert sum(is_piece for _, is_piece in units) == first.stats["pieces"]
    for chunk in runs[0]:
        last, last_is_piece = chunk[-1]
        total = sum(n for n, _ in chunk)
        assert total - (0 if last_is_piece else last) <= MIB
    assert first.stats["chunk_bytes_max"] == max(
        sum(n for n, _ in c) for c in runs[0])
    mixed = [[p for _, p in c] for c in runs[0] if len(c) > 1]
    assert [True, False, True] in mixed  # 20 s's last, short, 7 s's first
    assert len(runs[0]) == first.stats["chunks"]


def test_malformed_member_between_the_pieces(sources, unsplit):
    srcs = [sources[1], b"\0" * 4096, sources[3]]
    outs = decode_corpus(srcs, device="cpu", max_batch_bytes=MIB,
                         on_error="none")
    assert outs[1] is None
    s = outs.stats
    assert (s["failed"], s["batched"], s["split_streams"]) == (1, 2, 2)
    np.testing.assert_array_equal(outs[0], unsplit["f32"][1])
    np.testing.assert_array_equal(outs[2], unsplit["f32"][3])


@pytest.mark.parametrize("error", [InvalidDataError, BatchUnsupported])
def test_a_failing_piece_fails_its_stream_once(sources, unsplit,
                                               monkeypatch, error):
    """A piece whose extract raises takes its whole stream off its
    pieces: failed (on_error="none") or the scalar decoder, counted once;
    the other streams keep their pieces."""
    real, calls = torch_corpus.extract_batch, []

    def extract(plan, *args, **kw):
        calls.append(plan.n_frames)
        if len(calls) == 3:  # one worker: the short stream's, then the
            # first long stream's pieces
            raise error("planted")
        return real(plan, *args, **kw)

    monkeypatch.setattr(torch_corpus, "extract_batch", extract)
    outs = decode_corpus(sources[1:4], device="cpu", max_batch_bytes=MIB,
                         on_error="none", n_workers=1)
    s = outs.stats
    assert s["split_streams"] == 2 and s["batched"] == 2
    if error is InvalidDataError:
        assert outs[0] is None and (s["failed"], s["scalar"]) == (1, 0)
    else:
        assert (s["failed"], s["scalar"]) == (0, 1)
        assert np.abs(outs[0].astype(np.float64)
                      - unsplit["f32"][1]).max() <= TOL
    np.testing.assert_array_equal(outs[2], unsplit["f32"][3])


def test_split_and_stitch_spans(sources):
    timer = DecodeTimer()
    outs = decode_corpus(sources[1:4], device="cpu", max_batch_bytes=MIB,
                         timer=timer)
    splits = [sp for sp in timer.spans if sp.name == "front.split"]
    stitches = [sp for sp in timer.spans if sp.name == "stitch"]
    assert len(splits) == len(stitches) == outs.stats["pieces"] == 6
    assert {sp.key for sp in splits} == {sp.key for sp in stitches} == {
        "s0", "s2"}
    assert all(sp.thread.startswith("vp-front") for sp in splits)
    assert all(sp.thread.startswith("vp-collect") for sp in stitches)
    fronts = [sp for sp in timer.spans if sp.name == "front"]
    for sp in splits:  # each inside a front span of its thread
        assert any(f.thread == sp.thread and f.t0_ns <= sp.t0_ns
                   and sp.t1_ns <= f.t1_ns for f in fronts)
    for stage, name in (("split", "front.split"), ("stitch", "stitch")):
        assert SPAN_STAGES[name][0] == stage
        walls = sum(sp.wall_s for sp in timer.spans if sp.name == name)
        assert outs.stats["stage_s"][stage] == pytest.approx(walls, rel=1e-6)


def test_a_stream_under_the_limit_is_not_split(sources):
    outs = decode_corpus(sources, device="cpu")
    s = outs.stats
    assert (s["split_streams"], s["pieces"]) == (0, 0)
    assert s["stage_s"]["split"] == s["stage_s"]["stitch"] == 0.0
