"""PyTorch port, the front end's plan and gather in C++
(frontend.cpp vp_plan_scan, vp_gather_buckets): on every stream the C++
plan takes, its plan is the numpy plan's (build_plan_from_scan), array
for array and list for list; a stream whose chains need the exact layout
declines to the numpy plan; and each package's own front end gives the
same buckets, the JAX package's through its numpy _gather_buckets. Also
the front_native counter and the benchmark metric that reads it."""

import concurrent.futures as cf
import dataclasses
import importlib.util
import io
import pathlib
import sys
import types

import numpy as np
import pytest

from vorbispizza_tpu import frames as jax_frames
from vorbispizza_tpu.models import corpus as jax_corpus
from vorbispizza_tpu.ogg.container import OggContainer as JaxContainer
from vorbispizza_tpu.decoder import StreamDecoder as JaxDecoder
from vorbispizza_tpu_torch import decode_corpus, native
from vorbispizza_tpu_torch.config import VorbisConfig
from vorbispizza_tpu_torch.decoder import StreamDecoder
from vorbispizza_tpu_torch.errors import InvalidDataError
from vorbispizza_tpu_torch.frames import (BatchUnsupported, FrameSoA,
                                         build_plan, build_plan_from_scan,
                                         build_plan_native, extract_batch)
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.ogg.container import OggContainer
from vorbispizza_tpu_torch.setup.header import parse_ident, parse_setup_cached
from vorbispizza_tpu_torch.testing import pagecraft, rawstream
from vorbispizza_tpu_torch.testing.streams import make_streams
from vorbispizza_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parent.parent
GROUPS = ["stereo", "mono", "surround", "oddbooks", "floor0", "values"]
MEMBERS = [f"s{i:02d}.ogg" for i in range(32)]


@pytest.fixture(autouse=True)
def _native():
    if not native.available():
        pytest.skip(f"native front end not built: {native.build_error()}")


def member(name: str) -> bytes:
    return (REPO / "vpbench" / "data" / "music" / name).read_bytes()


def scan(data: bytes):
    """(blob, offs, granules, flags, setup) of a stream's native scan."""
    blob, offs, granules, flags, _ = native.scan_ogg_arrays(data)
    ident = parse_ident(blob[offs[0] : offs[1]].tobytes())
    setup = parse_setup_cached(blob[offs[2] : offs[3]].tobytes(), ident)
    return blob, offs, granules.copy(), flags.copy(), setup


def same_array(a, b, path):
    assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert a.tobytes() == b.tobytes(), path


def assert_plans_match(want, got):
    """``got`` (the C++ plan) is ``want`` (the numpy plan), bar the
    FrameEntry objects the C++ plan does not make."""
    assert got.frames == []
    for f in dataclasses.fields(FrameSoA):
        same_array(getattr(want.soa(), f.name), getattr(got.soa(), f.name),
                   f.name)
    assert got.chains == want.chains
    assert got.chain_segments == want.chain_segments
    assert (got.total_len, got.pcm_length, got.n_frames) == (
        want.total_len, want.pcm_length, want.n_frames)
    assert list(got.buckets.items()) == list(want.buckets.items())
    assert got.scan[0] is want.scan[0]
    for a, b in zip(want.scan[1:], got.scan[1:]):
        same_array(a, b, "scan")


def key_of(key):
    return key.mode_idx, key.prev_flag, key.next_flag


def assert_buckets_match(want, got):
    """Two packages' buckets: equal arrays in dtype, shape and bytes."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert key_of(w.key) == key_of(g.key) and w.n == g.n
        for name in ("frame_indices", "offsets", "prime", "final"):
            same_array(getattr(w, name), getattr(g, name), name)
        assert (w.residues is None) == (g.residues is None)
        if w.residues is not None:
            same_array(w.residues, g.residues, "residues")
        assert len(w.floor_groups) == len(g.floor_groups)
        for wf, gf in zip(w.floor_groups, g.floor_groups):
            assert wf.channels == gf.channels
            assert wf.floor.floor_type == gf.floor.floor_type
            for name in ("used", "posts", "step2", "ys", "coefficients",
                         "amplitude"):
                a, b = getattr(wf, name), getattr(gf, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    same_array(a, b, name)
        assert (w.sym is None) == (g.sym is None)
        if w.sym is not None:
            assert [dataclasses.astuple(x) for x in w.sym.groups] == [
                dataclasses.astuple(x) for x in g.sym.groups]
            assert len(w.sym.syms) == len(g.sym.syms)
            for name in ("syms", "slots"):
                for a, b in zip(getattr(w.sym, name), getattr(g.sym, name)):
                    same_array(a, b, name)
            same_array(w.sym.part_counts, g.sym.part_counts, "part_counts")


def front_ends(data: bytes):
    """Each package's own front end on ``data``, and the streams the
    port's counted in front_native (0 or 1)."""
    stats = {"front_native": 0, "front_python": 0}
    profiling.bind(profiling.CallSpans(None, stats), "s0")
    try:
        got = torch_corpus._front_end(data)
    finally:
        profiling.bind(None)
    return jax_corpus._front_end(data), got, stats["front_native"]


def assert_front_ends_match(data: bytes) -> int:
    (_, jc, jplan, jbuckets), (_, tc, tplan, tbuckets), n = front_ends(data)
    assert jc == tc
    for f in dataclasses.fields(FrameSoA):
        same_array(getattr(jplan.soa(), f.name), getattr(tplan.soa(), f.name),
                   f.name)
    assert tplan.chains == jplan.chains
    assert tplan.chain_segments == jplan.chain_segments
    assert (tplan.total_len, tplan.pcm_length) == (jplan.total_len,
                                                   jplan.pcm_length)
    same_array(jplan.audio_bits, tplan.audio_bits, "audio_bits")
    assert_buckets_match(jbuckets, tbuckets)
    return n


# ------------------------------------------------------------ whole streams


def streams():
    """name -> (data, whether the C++ plan takes it)."""
    out = {f"{g}{i}": (data, g != "mono")  # mono: its only anchor trims
           for g in GROUPS for i, data in enumerate(make_streams(g))}
    base = make_streams("stereo")[1]
    taken = {
        "zero_length_packets": pagecraft.make_zero_length_packets(base),
        "partial_granule": pagecraft.make_partial_granule(base),
        "empty_page": pagecraft.make_empty_page(base),
        "long_first_packet": pagecraft.make_long_first_packet(base),
        "end_trim": regranule(base, lambda k, n, g: g - 300 if k == n - 1
                              else g),
        "mid_eos": mid_eos(base),
        "extreme_blocksizes": rawstream.make_extreme_blocksize_stream(),
        "lookup2": rawstream.make_lookup2_stream(),
    }
    raw = bytearray(base)
    raw[len(raw) // 2] ^= 0xFF  # one page fails its CRC: a resync
    declined = {
        "start_trim": regranule(base, lambda k, n, g: g - 300),
        "start_offset": regranule(base, lambda k, n, g: g + 300),
        "granule_gap": regranule(base, lambda k, n, g: g + 128
                                 if k > n // 2 else g),
        "forward_jump_end": regranule(base, lambda k, n, g: g + 4096
                                      if k == n - 1 else g),
        "resync": bytes(raw),
    }
    out.update({k: (v, True) for k, v in taken.items()})
    out.update({k: (v, False) for k, v in declined.items()})
    return out


def regranule(data: bytes, fn) -> bytes:
    """``data`` repaged with each audio packet's end granule g (packet k of
    n) replaced by fn(k, n, g)."""
    headers, audio, serial = pagecraft.extract_packets(data)
    n = len(audio)
    audio = [(d, fn(k, n, g)) for k, (d, g) in enumerate(audio)]
    return rawstream.page_stream(headers + audio, serial=serial)


def mid_eos(data: bytes) -> bytes:
    """An EOS flag on a middle page: the stream ends there."""
    def hook(seq, granule, flags, fresh):
        return (granule, flags | 0x04) if seq == 4 else (granule, flags)

    return pagecraft._reframe(data, body_cap=1000, page_hooks=(hook,))


STREAMS = streams()


def fast_layout(blob, offs, granules, flags, setup) -> bool:
    """Whether the JAX package's build_plan_from_scan lays out every chain
    with its vectorized fast layout (_lay_out_chain_fast), which the C++
    plan follows; else a chain needs the exact per-frame layout."""
    fast = []
    real = jax_frames._lay_out_chain_fast

    def spy(*args):
        out = real(*args)
        fast.append(out is not None)
        return out

    jax_frames._lay_out_chain_fast = spy
    try:
        jax_frames.build_plan_from_scan(blob, offs, granules, flags, setup)
    finally:
        jax_frames._lay_out_chain_fast = real
    return all(fast)


def check_plan(blob, offs, granules, flags, setup) -> bool:
    """The C++ plan declines exactly where the fast layout does, and
    elsewhere is the numpy plan. Returns whether it took."""
    got = build_plan_native(blob, offs, granules, flags, setup)
    assert (got is not None) == fast_layout(blob, offs, granules, flags,
                                            setup)
    if got is not None:
        assert_plans_match(
            build_plan_from_scan(blob, offs, granules, flags, setup), got)
    return got is not None


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_plan_matches_numpy(name):
    data, taken = STREAMS[name]
    assert check_plan(*scan(data)) == taken


@pytest.mark.parametrize("name", MEMBERS)
def test_bench_member_plan_matches_numpy(name):
    assert check_plan(*scan(member(name)))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_front_end_matches_reference(name):
    """The port's front end (the C++ plan, or the numpy plan where it
    declines, and the C++ gather) against the JAX package's numpy plan
    and gather; counted in front_native where the C++ planned."""
    data, taken = STREAMS[name]
    assert assert_front_ends_match(data) == int(taken)


@pytest.mark.parametrize("name", MEMBERS)
def test_bench_member_front_end_matches_reference(name):
    assert assert_front_ends_match(member(name)) == 1


@pytest.mark.parametrize("group", ["stereo", "surround"])
def test_value_transport_gather(group, monkeypatch):
    """Under residue_transport="values" the gather leaves the residues to
    numpy and gathers the floors in C++: the JAX package's buckets."""
    from vorbispizza_tpu.config import VorbisConfig as JaxConfig

    for cfg in (JaxConfig.default, VorbisConfig.default):
        monkeypatch.setattr(cfg, "residue_transport", "values")
    for data in make_streams(group):
        assert assert_front_ends_match(data) == 1


# -------------------------------------------- plans made from edited scans


def edited(fn, data=None):
    """A stream's scan (a bench member's by default) with its granules,
    flags or bytes edited by fn(granules, flags, blob, offs, anchors), the
    anchors being the audio packets with a granule."""
    blob, offs, granules, flags, setup = scan(data or member("s00.ogg"))
    blob = blob.copy()
    anchors = np.nonzero(granules[3:] >= 0)[0] + 3
    fn(granules, flags, blob, offs, anchors)
    return blob, offs, granules, flags, setup


def _resync(g, f, blob, offs, a):
    g[3:] = -1
    f[300] |= 1  # a resync: a second chain, no granule to check


def _eos(g, f, blob, offs, a):
    f[a[4] + 7] |= 2  # the plan ends there


def _header_like(g, f, blob, offs, a):
    g[3:] = -1
    for p in (10, 11, 250):
        blob[offs[p]] |= 1  # not an audio packet: skipped


def _empty(g, f, blob, offs, a):
    g[3:] = -1
    offs[20] = offs[19]  # packet 19 empty (its bytes join packet 20's)


EDITS_TAKEN = {"resync_without_anchors": _resync, "eos_mid_stream": _eos,
               "header_like_packets": _header_like, "empty_packet": _empty}


def _start_offset(g, f, blob, offs, a):
    g[a] += 64


def _gap(g, f, blob, offs, a):
    g[a[3]] += 64


def _jump(g, f, blob, offs, a):
    g[a[-1]] += 4096


def _trim_before_final(g, f, blob, offs, a):
    g[a[-2]] -= 64
    g[a[-1]] = -1


def _regression_past_cut(g, f, blob, offs, a):
    g[a[3]] -= 2000
    g[a[6]] = g[a[3]] - 50000


EDITS_DECLINED = {"start_offset": _start_offset, "granule_gap": _gap,
                  "forward_jump": _jump,
                  "trim_before_final": _trim_before_final,
                  "regression_past_cut": _regression_past_cut}


@pytest.mark.parametrize("name", sorted(EDITS_TAKEN))
def test_edited_scan_plan_matches_numpy(name):
    blob, offs, granules, flags, setup = edited(EDITS_TAKEN[name])
    assert check_plan(blob, offs, granules, flags, setup)
    got = build_plan_native(blob, offs, granules, flags, setup)
    if name == "resync_without_anchors":
        assert len(got.chains) == 2
    if name == "eos_mid_stream":
        assert got.n_frames < len(granules) / 2


@pytest.mark.parametrize("name", sorted(EDITS_DECLINED))
def test_edited_scan_declines(name):
    blob, offs, granules, flags, setup = edited(EDITS_DECLINED[name])
    if name == "regression_past_cut":
        assert build_plan_native(blob, offs, granules, flags, setup) is None
        with pytest.raises(BatchUnsupported):
            build_plan_from_scan(blob, offs, granules, flags, setup)
    else:
        assert not check_plan(blob, offs, granules, flags,
                              setup)


def test_out_of_range_mode_raises():
    """An audio packet whose mode index names no mode (33 modes, 6 mode
    bits): both plans raise InvalidDataError."""
    def bad_mode(g, f, blob, offs, a):
        blob[offs[6]] = 40 << 1

    blob, offs, granules, flags, setup = edited(
        bad_mode, make_streams("oddbooks")[0])
    assert len(setup.modes) == 33
    with pytest.raises(InvalidDataError):
        build_plan_native(blob, offs, granules, flags, setup)
    with pytest.raises(InvalidDataError):
        build_plan_from_scan(blob, offs, granules, flags, setup)


def test_truncated_window_flags_are_skipped():
    """With six mode bits and long-block modes a one-byte packet cannot
    hold its window flags: both plans skip it (a setup of 40 copies of the
    stereo stream's long mode)."""
    blob, offs, granules, flags, setup = scan(make_streams("stereo")[1])
    fake = types.SimpleNamespace(mode_bits=6, modes=[setup.modes[1]] * 40)
    lens = np.diff(offs)
    # one-byte packets of mode 5 and two-byte ones of mode 7
    data = bytearray()
    new_offs = [0]
    for k in range(len(granules)):
        body = bytes([5 << 1]) if k % 3 == 1 else bytes([7 << 1, 0xFF])
        if k < 3:
            body = blob[offs[k] : offs[k] + lens[k]].tobytes()
        data += body
        new_offs.append(len(data))
    blob2 = np.frombuffer(bytes(data), dtype=np.uint8)
    offs2 = np.asarray(new_offs, dtype=np.int64)
    granules[:] = -1
    assert check_plan(blob2, offs2, granules, flags, fake)
    got = build_plan_native(blob2, offs2, granules, flags, fake)
    assert got.n_frames < len(granules) - 3


# ------------------------------------------------------ the gather alone


def provider_plan(data: bytes):
    c = OggContainer(io.BytesIO(data))
    assert c.try_init()
    dec = StreamDecoder(c.providers[0])
    dec.initialize()
    return build_plan(c.providers[0], dec._setup), dec


@pytest.mark.parametrize("group", ["stereo", "floor0", "values"])
def test_gather_of_provider_plans(group):
    """A provider plan (decode_file_batch, the accelerated reader): the
    C++ gather reads its frames through plan.soa() and gives the JAX
    package's buckets from its provider plan."""
    for data in make_streams(group):
        plan, dec = provider_plan(data)
        got = extract_batch(plan, dec._setup, dec.channels, ident=dec._ident)
        c = JaxContainer(io.BytesIO(data))
        assert c.try_init()
        jdec = JaxDecoder(c.providers[0])
        jdec.initialize()
        jplan = jax_frames.build_plan(c.providers[0], jdec._setup)
        want = jax_frames.extract_batch(jplan, jdec._setup, jdec.channels,
                                 ident=jdec._ident)
        assert_buckets_match(want, got)
        same_array(jplan.audio_bits, plan.audio_bits, "audio_bits")


def gather_inputs():
    """The arguments native.gather_buckets got for a stereo stream."""
    seen = {}
    real = native.gather_buckets

    def spy(*args):
        seen["args"] = args
        return real(*args)

    native.gather_buckets = spy
    try:
        torch_corpus._front_end(make_streams("stereo")[1])
    finally:
        native.gather_buckets = real
    return list(seen["args"])


def test_gather_names_the_first_frame_that_disagrees():
    """A frame decoded in another mode than its bucket's, or a frame in
    no bucket: the gather raises, naming the lowest such frame."""
    args = gather_inputs()
    dec, perm, bstart = args[0], args[1], args[2]
    meta = dec["meta"].copy()
    meta[[17, 5], 1] ^= 1
    with pytest.raises(RuntimeError, match="plan at frame 5$"):
        native.gather_buckets(dict(dec, meta=meta), *args[1:])
    shorter = bstart.copy()
    shorter[-1] -= 1  # the last bucket's last frame in no bucket
    with pytest.raises(RuntimeError, match=f"plan at frame {perm[-1]}$"):
        native.gather_buckets(dec, perm[:-1], shorter, *args[3:])


def test_gather_checks_partition_alignment():
    args = gather_inputs()
    dec = dict(args[0])
    counts = dec["sym_counts"].copy()
    groups, nsym = args[10]
    g = int(np.argmax(nsym[0] > 1))
    assert nsym[0, g] > 1
    frame = int(args[1][0])  # the first bucket's first frame
    counts[frame, g] += 1
    dec["sym_counts"] = counts
    args[0] = dec
    with pytest.raises(RuntimeError, match="not partition-aligned"):
        native.gather_buckets(*args)


def test_concurrent_front_ends_match_serial():
    """Eight threads share the setups' memoized tables: each stream's
    plan and buckets are those of a serial run, under a short switch
    interval."""
    datas = [member(n) for n in MEMBERS[:8]] + list(make_streams("stereo"))
    want = [torch_corpus._front_end(d) for d in datas]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            got = list(pool.map(torch_corpus._front_end, datas * 3))
    finally:
        sys.setswitchinterval(old)
    for k, g in enumerate(got):
        w = want[k % len(datas)]
        for f in dataclasses.fields(FrameSoA):
            same_array(getattr(w[2].soa(), f.name), getattr(g[2].soa(),
                                                            f.name), f.name)
        assert_buckets_match(w[3], g[3])


# ------------------------------------------------ the counter and metric


def test_decode_corpus_counts_front_native():
    """stats["front_native"] counts the streams the C++ planned, and not
    the ones that declined to the numpy plan."""
    srcs = [*make_streams("stereo"), STREAMS["start_trim"][0],
            *make_streams("floor0"), STREAMS["granule_gap"][0]]
    outs = decode_corpus(srcs, device="cpu")
    assert outs.stats["front_native"] == 3
    assert outs.stats["front_python"] == 0
    assert outs.stats["streams"] == 5


def _reader():
    path = REPO / "vpbench" / "metrics" / "front_native_share.corpus.py"
    spec = importlib.util.spec_from_file_location("front_native_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("stats,want", [
    ([{"streams": 128, "front_native": 128}], 100.0),
    ([{"streams": 128, "front_native": 96}, {"streams": 128,
                                              "front_native": 128}], 87.5),
    ([{"streams": 128, "front_python": 0}], None),
    ([None], None),
])
def test_front_native_share_metric(stats, want):
    """The benchmark's reader: 100 x front_native / streams over the
    window's calls; None for a program that does not count them."""
    run = types.SimpleNamespace(
        calls=[types.SimpleNamespace(stats=s) for s in stats])
    assert _reader()(run) == want
