"""PyTorch port, its drivers on the CPU: the stream drivers
(decode_stream_batch, decode_file_batch), the accelerated reader and the
decode CLI against the JAX package's on the same bytes, and the
overlapped decode_corpus (one dispatch thread, a collector pool,
``batched=``, ``devices=``, ``timer=``) against a serial decode of the
same chunks.

Tolerances: f32 within 2e-6 of the JAX package (its own CPU allowance;
the IMDCT products sum in another order on each backend), s16 within 1
LSB of it; the port against itself (split plans, chunk order, threads,
devices) bit for bit; StreamStats fields exactly."""

import contextlib
import io
import threading

import numpy as np
import pytest
import torch

from vorbispizza_tpu.models import pipeline as jax_pipeline
from vorbispizza_tpu.ogg.container import OggContainer as JaxContainer
from vorbispizza_tpu.reader import VorbisReader as JaxReader
from vorbispizza_tpu.stats import StreamStats as JaxStats
from vorbispizza_tpu.tools import decode as jax_cli
from vorbispizza_tpu_torch import (
    DecodeTimer,
    VorbisReader,
    decode_corpus,
    decode_file_batch,
    decode_stream_batch,
)
from vorbispizza_tpu_torch.decoder import CLIP_MAX, StreamDecoder
from vorbispizza_tpu_torch.frames import build_plan, split_plan
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.models import launch as torch_launch
from vorbispizza_tpu_torch.models.pipeline import BatchSynthesizer
from vorbispizza_tpu_torch.ogg.container import OggContainer
from vorbispizza_tpu_torch.stats import StreamStats
from vorbispizza_tpu_torch.testing.encode import encode_vorbis, make_signal
from vorbispizza_tpu_torch.testing.streams import make_streams
from vorbispizza_tpu_torch.tools import decode as cli
from vorbispizza_tpu_torch.utils.profiling import device_trace

TOL = 2e-6
GROUPS = ["stereo", "mono", "surround", "oddbooks", "floor0", "values"]
STATS_FIELDS = ("sample_rate", "audio_bits", "header_bits", "container_bits",
                "waste_bits", "overhead_bits", "packet_count",
                "total_samples", "effective_bit_rate", "instant_bit_rate")
TIMER_STAGES = {"front_end", "merge", "prepare", "dispatch", "collect",
                "collect_pull", "collect_unpack"}
MARKS = ("merge0", "dispatch0", "dispatched", "pull_wait", "pull0",
         "pull_done")


def provider(container, data):
    c = container(io.BytesIO(data))
    assert c.try_init()
    return c.providers[0]


@pytest.mark.parametrize("group", GROUPS)
def test_stream_batch_matches_jax(group):
    """The port's decode_stream_batch against the JAX package's on the
    group's first stream: f32 PCM within TOL, every StreamStats field
    equal; decode_file_batch on the bytes is the stream driver."""
    data = make_streams(group)[0]
    js, ts = JaxStats(), StreamStats()
    want = jax_pipeline.decode_stream_batch(provider(JaxContainer, data),
                                            stats=js)
    got = decode_stream_batch(provider(OggContainer, data), device="cpu",
                              stats=ts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= TOL
    for name in STATS_FIELDS:
        assert getattr(ts, name) == getattr(js, name), name
    assert np.array_equal(decode_file_batch(data, device="cpu"), got)


@pytest.fixture(scope="module")
def long_stream():
    """The stream of the JAX package's split test (tests/test_batch.py):
    1.2 s of stereo music, with block switches."""
    return encode_vorbis(make_signal(2, 1.2, kind="music", seed=11),
                         quality=0.4)


@pytest.fixture(scope="module")
def long_unsplit(long_stream):
    return decode_file_batch(long_stream, device="cpu")


@pytest.mark.parametrize("max_frames", [7, 16, 50])
def test_max_frames_split_is_identical(long_stream, long_unsplit, max_frames):
    """split_plan pieces (at least two: the stream's 81 frames carry its
    EOS end trim) decode one after another to the unsplit PCM, bit for
    bit, across block-switch boundaries."""
    c = OggContainer(io.BytesIO(long_stream))
    assert c.try_init()
    dec = StreamDecoder(c.providers[0])
    dec.initialize()
    plan = build_plan(c.providers[0], dec._setup)
    assert plan.pcm_length < plan.total_len  # the end trim
    assert len(split_plan(plan, max_frames)) >= 2
    got = decode_file_batch(long_stream, device="cpu", max_frames=max_frames)
    assert got.shape == long_unsplit.shape
    np.testing.assert_array_equal(got, long_unsplit)


def test_assemble_dpack_wire_unpacks_to_the_quantized_f32():
    """BatchSynthesizer.assemble's dpack return, as the reference's run
    gives it ("dpack", wire, nbt, out_len, total): pulled and unpacked,
    the host quantization of the same plan's f32."""
    from vorbispizza_tpu_torch.ops import pcm_pack

    synth, plan, buckets = stream_plan(make_streams("stereo")[1])
    pcm = synth.assemble(plan, buckets, device="cpu").numpy()
    tag, wire, nbt, out_len, total = synth.assemble(plan, buckets, "s16df",
                                                    device="cpu")
    assert tag == "dpack" and total == pcm.shape[1]
    assert nbt == pcm_pack.wire_rows(out_len, synth.channels)
    payload, widx, ch_ubit, _ = torch_launch.pull_dpack(
        wire, synth.channels, out_len)
    q = pcm_pack.unpack_pcm(payload, widx, synth.channels, out_len, ch_ubit)
    want = np.clip(np.rint(pcm * np.float32(32768.0)), -32768, 32767)
    assert np.array_equal(q[:, :total], want.astype(np.int16))
    empty = synth.assemble(plan, [], device="cpu")
    assert empty.shape == (synth.channels, 0)


def stream_plan(data):
    """(synthesizer, plan, buckets) of one stream, as decode_stream_batch
    makes them."""
    from vorbispizza_tpu_torch.decoder import StreamDecoder
    from vorbispizza_tpu_torch.frames import build_plan, extract_batch

    prov = provider(OggContainer, data)
    dec = StreamDecoder(prov)
    dec.initialize()
    plan = build_plan(prov, dec._setup)
    buckets = extract_batch(plan, dec._setup, dec.channels, ident=dec._ident)
    return BatchSynthesizer(dec._setup, dec.channels), plan, buckets


def test_batch_unsupported_raises_as_in_the_reference():
    """No Ogg stream in the bytes: both packages raise BatchUnsupported."""
    from vorbispizza_tpu.frames import BatchUnsupported as JaxUnsupported
    from vorbispizza_tpu_torch.frames import BatchUnsupported

    junk = b"\0" * 4096
    with pytest.raises(JaxUnsupported):
        jax_pipeline.decode_file_batch(junk)
    with pytest.raises(BatchUnsupported):
        decode_file_batch(junk, device="cpu")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here")
    data = make_streams("values")[0]
    for call in (lambda: decode_file_batch(data),
                 lambda: decode_stream_batch(provider(OggContainer, data)),
                 lambda: VorbisReader(data, accelerated=True).initialize(),
                 lambda: decode_corpus([data])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    r = VorbisReader(data)  # the scalar reader needs no device
    r.initialize()
    assert r.read_all().shape[0] > 0


def read_pieces(reader, n=3001):
    parts = []
    while True:
        c = reader.read_samples(n)
        if c.shape[0] == 0:
            return np.concatenate(parts, axis=0)
        parts.append(c)


def test_accelerated_reader_matches_scalar_and_jax():
    """VorbisReader(accelerated=True, device="cpu") read in pieces and
    after three seeks: within TOL of the port's scalar reader and of the
    JAX package's accelerated reader, with the same positions; its stats
    bits (the C++ front end's exact audio bits) equal both."""
    data = make_streams("mono")[0]
    acc = VorbisReader(data, accelerated=True, device="cpu")
    scalar = VorbisReader(data)
    jacc = JaxReader(data, accelerated=True)
    for r in (acc, scalar, jacc):
        r.initialize()
    got, want, jgot = read_pieces(acc), scalar.read_all(), read_pieces(jacc)
    assert got.shape == want.shape == jgot.shape
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - jgot).max() <= TOL
    for name in ("audio_bits", "waste_bits", "container_bits",
                 "header_bits", "packet_count"):
        assert (getattr(acc.stats, name) == getattr(scalar.stats, name)
                == getattr(jacc.stats, name)), name
    total = scalar.total_samples
    assert acc.total_samples == total
    for pos in (5000, 0, total // 2):
        outs = []
        for r in (acc, scalar, jacc):
            r.seek_to(pos)
            outs.append(r.read_samples(1024, planar=True))
        assert outs[0].shape == outs[1].shape == outs[2].shape, pos
        assert np.abs(outs[0] - outs[1]).max() <= TOL, pos
        assert np.abs(outs[0] - outs[2]).max() <= TOL, pos
        assert acc.sample_position == scalar.sample_position, pos


def test_cli_wav_matches_jax_cli(tmp_path):
    """The port's CLI and the JAX package's on one stereo stream, --s16:
    the same 44 header bytes and int16 data within 1 LSB."""
    src = tmp_path / "values.ogg"
    src.write_bytes(make_streams("values")[0])
    (tmp_path / "jax").mkdir()
    assert jax_cli.main(["--s16", "--out", str(tmp_path / "jax"),
                         str(src)]) == 0
    assert cli.main(["--s16", "--device", "cpu", "--out",
                     str(tmp_path / "port"), str(src)]) == 0
    want = (tmp_path / "jax" / "values.wav").read_bytes()
    got = (tmp_path / "port" / "values.wav").read_bytes()
    assert len(got) == len(want) and got[:44] == want[:44]
    a = np.frombuffer(got[44:], dtype="<i2").astype(np.int64)
    b = np.frombuffer(want[44:], dtype="<i2").astype(np.int64)
    assert np.abs(a - b).max() <= 1


# -- the overlapped corpus driver ----------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    """Stereo (two setups, one chunk), mono and 5.1 streams."""
    return [s for g in ("stereo", "mono", "surround", "values")
            for s in make_streams(g)]


def serial_decode(srcs, batched=True, max_batch_bytes=24 << 20):
    """The driver's chunks, decoded one after another on this thread: the
    same grouping by channel count, merge, prepare_host and forward.
    Returns (f32 outputs, sigs in chunk order)."""
    fronts = [torch_corpus._front_end(s) for s in srcs]
    acc, chunks = {}, []
    for i, f in enumerate(fronts):
        rec = acc.setdefault(f[1], [[], 0])
        rec[0].append(i)
        rec[1] += sum(b.batch_cost for b in f[3])
        if not batched or rec[1] >= max_batch_bytes:
            chunks.append(rec[0])
            acc[f[1]] = [[], 0]
    chunks += [idx for idx, _ in acc.values() if idx]
    outs, sigs = [None] * len(srcs), []
    for idx in chunks:
        synth = torch_corpus._synthesizer_for(*fronts[idx[0]][:2])
        for i in idx:
            synth.add_setup(fronts[i][0])
        if batched:
            plan, buckets, lengths = torch_corpus.merge_streams(
                [fronts[i][2:4] for i in idx])
        else:
            plan, buckets = fronts[idx[0]][2:4]
            lengths = [plan.pcm_length]
        sig, host, total = synth.prepare_host(plan, buckets, "f32")
        pcm = synth(sig, [torch.from_numpy(a) for a in host])[:, :total]
        pcm = pcm.numpy().clip(-CLIP_MAX, CLIP_MAX)
        sigs.append(sig)
        c = 0
        for i, ln in zip(idx, lengths):
            outs[i] = pcm[:, c : c + ln]
            c += ln
    return outs, sigs


@pytest.fixture
def sigs_seen(monkeypatch):
    """Every sig prepare_host makes, in call order."""
    seen = []
    prepare = BatchSynthesizer.prepare_host

    def spy(self, *args, **kwargs):
        out = prepare(self, *args, **kwargs)
        seen.append(out[0])
        return out

    monkeypatch.setattr(BatchSynthesizer, "prepare_host", spy)
    return seen


@pytest.mark.parametrize("batched", [True, False])
def test_overlapped_matches_serial(corpus, sigs_seen, batched):
    """The overlapped driver gives the serial decode's outputs bit for bit
    and makes the same sigs in the same order: merged chunks, or with
    batched=False one program per stream."""
    outs = decode_corpus(corpus, device="cpu", batched=batched)
    sigs = list(sigs_seen)
    want, want_sigs = serial_decode(corpus, batched=batched)
    assert sigs == want_sigs
    for got, ref in zip(outs, want):
        assert got.dtype == np.float32 and np.array_equal(got, ref)
    s = outs.stats
    assert s["batched"] == len(corpus) and not s["scalar"]
    assert s["chunks"] == (3 if batched else len(corpus))
    assert set(s["stage_s"]) == set(torch_corpus.STAGES)


def test_devices_round_robin_is_bit_equal(corpus):
    """devices=["cpu", "cpu"] (chunks alternate over the list) gives the
    one-device output, one stream a chunk."""
    one = decode_corpus(corpus, device="cpu", max_batch_bytes=1)
    two = decode_corpus(corpus, devices=["cpu", "cpu"], max_batch_bytes=1)
    assert two.stats["chunks"] == one.stats["chunks"] == len(corpus)
    for a, b in zip(one, two):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("output", ["f32", "s16"])
def test_timer_stages_marks_and_counters(corpus, output):
    """A DecodeTimer gets the JAX stage names, each chunk's six marks in
    order, and h2d/d2h byte counters equal to stats."""
    timer = DecodeTimer()
    outs = decode_corpus(corpus, device="cpu", output=output, timer=timer)
    s = outs.stats
    assert set(timer.stages) == TIMER_STAGES
    assert timer.counters == {"h2d_bytes": s["h2d_bytes"],
                              "d2h_bytes": s["d2h_bytes"]}
    assert s["h2d_bytes"] > 0 and s["d2h_bytes"] > 0
    names = [n for n, _ in timer.events]
    assert len(names) == len(MARKS) * s["chunks"]
    for cid in range(s["chunks"]):
        at = [names.index(f"c{cid}.{m}") for m in MARKS]
        assert at == sorted(at), cid
    assert all(dt >= 0 for dt in timer.report().values())


def test_timer_without_mark_not_mutated(corpus):
    """A caller's timer lacking mark() (a slotted, older DecodeTimer
    shape) is wrapped, not patched: it gains no attribute and its stages
    still flow."""

    class SlimTimer:
        __slots__ = ("stages",)

        def __init__(self):
            self.stages = {}

        @contextlib.contextmanager
        def stage(self, name):
            yield
            self.stages[name] = True

        def count(self, name, v=1):
            pass

    t = SlimTimer()
    outs = decode_corpus(corpus[:1], device="cpu", output="s16", timer=t)
    assert outs[0] is not None and not hasattr(t, "mark")
    assert set(t.stages) == TIMER_STAGES


@pytest.mark.parametrize("batched", [True, False])
def test_on_error_none_with_a_junk_source(batched):
    srcs = [b"not an ogg stream at all"] + list(make_streams("values"))
    outs = decode_corpus(srcs, device="cpu", on_error="none",
                         batched=batched, n_workers=2)
    assert outs[0] is None and outs[1] is not None
    assert outs.stats["failed"] == 1 and outs.stats["batched"] == 1
    with pytest.raises(Exception):
        decode_corpus(srcs, device="cpu", batched=batched)


def test_counters_hold_under_thread_switching(corpus):
    """Stats and timer counters updated from the dispatch thread and three
    collectors at once, with a thread switch forced every microsecond and
    more front-end workers than cores: no update is lost."""
    import sys

    srcs = corpus * 3
    timer = DecodeTimer()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = decode_corpus(srcs, device="cpu", max_batch_bytes=1,
                             n_workers=32, timer=timer)
    finally:
        sys.setswitchinterval(interval)
    s = outs.stats
    assert s["batched"] == s["chunks"] == len(srcs)
    assert s["d2h_bytes"] == timer.counters["d2h_bytes"] == sum(
        o.nbytes for o in outs)
    assert s["h2d_bytes"] == timer.counters["h2d_bytes"]
    assert len(timer.events) == len(MARKS) * len(srcs)


def pool_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("vp-") and t.is_alive()]


@pytest.mark.parametrize("where", ["dispatch", "collector"])
def test_a_raising_stage_propagates_and_stops_the_pools(corpus, monkeypatch,
                                                        where):
    """An error in the dispatch thread (prepare_host) or in a collector
    (the pull) comes out of decode_corpus, and no pool thread is left."""

    def boom(*args, **kwargs):
        raise RuntimeError(f"boom in the {where}")

    if where == "dispatch":
        monkeypatch.setattr(BatchSynthesizer, "prepare_host", boom)
    else:
        monkeypatch.setattr(torch_launch, "to_host", boom)
    with pytest.raises(RuntimeError, match=f"boom in the {where}"):
        decode_corpus(corpus, device="cpu")
    assert not pool_threads()


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert prof is not None
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
