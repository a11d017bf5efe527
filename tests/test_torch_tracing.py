"""PyTorch port, its spans and counters on the CPU: the spans a
DecodeTimer gets from decode_corpus (nesting, keys and causes, thread CPU
within wall, stage_s as their summed walls), the untraced path (no thread
clock, no span, a null CPU pointer to the C++), the native decode's CPU
counter, the table-build and Python-path counters, the sharded path's
per-shard prepare spans and the spans in device_trace's Chrome trace."""

import ctypes
import json
import re

import numpy as np
import pytest
import torch

from vorbispizza_tpu_torch import DecodeTimer, decode_corpus, native
from vorbispizza_tpu_torch.frames import (_sym_layout_cached,
                                         build_plan_from_scan)
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.native.serialize import serialize_setup
from vorbispizza_tpu_torch.parallel.corpus import decode_corpus_sharded
from vorbispizza_tpu_torch.parallel.mesh import Mesh
from vorbispizza_tpu_torch.setup import header
from vorbispizza_tpu_torch.setup.header import parse_ident, parse_setup_cached
from vorbispizza_tpu_torch.testing.streams import make_streams
from vorbispizza_tpu_torch.utils import profiling
from vorbispizza_tpu_torch.utils.profiling import SPAN_STAGES, device_trace

CHUNK_SPANS = {"merge", "prepare", "h2d", "launch", "wait", "pull", "unpack"}
FRONT_CHILDREN = {"front.scan", "front.headers", "front.plan",
                  "front.native", "front.entropy", "front.gather",
                  "front.python"}


@pytest.fixture(scope="module")
def corpus():
    """Stereo (two setups), mono, 5.1 and value-transport streams."""
    return [s for g in ("stereo", "mono", "surround", "values")
            for s in make_streams(g)]


@pytest.fixture(scope="module", params=[True, False], ids=["batched",
                                                            "per_stream"])
def traced(request, corpus):
    """(outputs, timer) of one traced decode, merged chunks or a chunk a
    stream, with more front-end workers than streams."""
    timer = DecodeTimer()
    outs = decode_corpus(corpus, device="cpu", batched=request.param,
                         n_workers=8, timer=timer)
    return outs, timer


def by_thread(spans):
    out = {}
    for sp in spans:
        out.setdefault(sp.thread, []).append(sp)
    return out


def test_spans_nest_on_each_thread(traced):
    """On every thread two spans are disjoint or one holds the other, and
    each front-end stage lies inside its stream's ``front`` span."""
    outs, timer = traced
    for spans in by_thread(timer.spans).values():
        for a in spans:
            for b in spans:
                if a is b:
                    continue
                disjoint = a.t1_ns <= b.t0_ns or b.t1_ns <= a.t0_ns
                a_in_b = b.t0_ns <= a.t0_ns and a.t1_ns <= b.t1_ns
                b_in_a = a.t0_ns <= b.t0_ns and b.t1_ns <= a.t1_ns
                assert disjoint or a_in_b or b_in_a, (a, b)
    fronts = {sp.key: sp for sp in timer.spans if sp.name == "front"}
    assert len(fronts) == outs.stats["streams"]
    for sp in timer.spans:
        if sp.name in FRONT_CHILDREN:
            parent = fronts[sp.key]
            assert parent.thread == sp.thread
            assert parent.t0_ns <= sp.t0_ns and sp.t1_ns <= parent.t1_ns
    call = [sp for sp in timer.spans if sp.name == "call"]
    assert len(call) == 1
    for sp in timer.spans:
        assert call[0].t0_ns <= sp.t0_ns and sp.t1_ns <= call[0].t1_ns


def test_keys_and_causes(traced, corpus):
    """Every front span names a stream of the call (s<i>); every chunk
    span names its chunk (c<k>) and, as its cause, one stream; the spans
    of one chunk share their cause, and a chunk of one stream names that
    stream."""
    outs, timer = traced
    n = len(corpus)
    streams = {f"s{i}" for i in range(n)}
    causes = {}
    for sp in timer.spans:
        if sp.name.startswith("front"):
            assert sp.key in streams, sp
        elif sp.name in CHUNK_SPANS:
            assert re.fullmatch(r"c\d+", sp.key), sp
            assert int(sp.key[1:]) < outs.stats["chunks"]
            assert sp.cause in streams, sp
            assert causes.setdefault(sp.key, sp.cause) == sp.cause
    assert len(causes) == outs.stats["chunks"]
    if outs.stats["chunks"] == n:  # a chunk a stream, in stream order
        assert causes == {f"c{i}": f"s{i}" for i in range(n)}


def test_thread_cpu_within_wall(traced):
    """A span's thread CPU never exceeds its wall (+1 ms of clock grain),
    and the native decode's threads ran."""
    _, timer = traced
    for sp in timer.spans:
        assert sp.cpu_ns is not None and sp.cpu_ns >= 0
        assert sp.cpu_ns <= sp.t1_ns - sp.t0_ns + 1_000_000, sp
    entropy = [sp for sp in timer.spans if sp.name == "front.entropy"]
    assert entropy and all(sp.counters["native_cpu_ns"] > 0
                           for sp in entropy)


def test_stage_s_is_the_summed_span_walls(traced):
    """Each stats["stage_s"] entry is its spans' summed walls (within
    1%), and each timer stage a span feeds holds at least their walls."""
    outs, timer = traced
    for stage in torch_corpus.STAGES:
        walls = sum(sp.wall_s for sp in timer.spans
                    if SPAN_STAGES.get(sp.name, (None,))[0] == stage)
        assert outs.stats["stage_s"][stage] == pytest.approx(walls,
                                                             rel=0.01)
    assert outs.stats["stage_s"]["front_end"] > 0
    for name in ("merge", "collect_pull", "collect_unpack", "dispatch"):
        walls = sum(sp.wall_s for sp in timer.spans
                    if SPAN_STAGES.get(sp.name, (None, None))[1] == name)
        assert timer.stages.get(name, 0.0) == pytest.approx(walls,
                                                            rel=0.01)


@pytest.mark.parametrize("output", ["f32", "s16"])
def test_untraced_reads_no_thread_clock(corpus, monkeypatch, output):
    """Without a timer: no thread clock is read, no span made, and the
    C++ decode gets a null CPU pointer; the outputs are a traced call's."""
    reads = []
    real_clock = profiling.time.thread_time_ns

    def clock():
        reads.append(1)
        return real_clock()

    monkeypatch.setattr(profiling.time, "thread_time_ns", clock)

    def no_span(*args, **kwargs):
        raise AssertionError("a span was made")

    monkeypatch.setattr(profiling, "Span", no_span)
    pointers = []
    for name in ("decode_packet_spans", "decode_packet_spans_sym"):
        real = getattr(native, name)

        def spy(*args, real=real, **kwargs):
            pointers.append(kwargs.get("cpu_ns"))
            return real(*args, **kwargs)

        monkeypatch.setattr(native, name, spy)
    outs = decode_corpus(corpus, device="cpu", output=output)
    assert not reads
    assert pointers and all(p is None for p in pointers)
    monkeypatch.undo()
    traced = decode_corpus(corpus, device="cpu", output=output,
                           timer=DecodeTimer())
    for a, b in zip(outs, traced):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def scan_inputs(group):
    """A stream's native decode inputs: setup blob, packet spans, ident,
    setup."""
    data = make_streams(group)[0]
    blob, offs, granules, flags, _ = native.scan_ogg_arrays(data)
    ident = parse_ident(blob[offs[0] : offs[1]].tobytes())
    setup = parse_setup_cached(blob[offs[2] : offs[3]].tobytes(), ident)
    plan = build_plan_from_scan(blob, offs, granules, flags, setup)
    return serialize_setup(setup, ident), plan.scan, ident, setup


class _ZeroedNumpy:
    """numpy, with ``empty`` zero-filled: the decode's outputs are then
    defined past what it writes, and compare whole."""

    def __getattr__(self, name):
        return np.zeros if name == "empty" else getattr(np, name)


@pytest.mark.parametrize("mode", ["values", "symbols"])
@pytest.mark.parametrize("n_threads", [1, 4])
def test_native_cpu_counter(mode, n_threads, monkeypatch):
    """The C++ decode with a CPU pointer counts its threads' CPU (the
    caller's too, on one thread) and writes the same bytes as without."""
    if not native.available():
        pytest.skip(f"native front end not built: {native.build_error()}")
    monkeypatch.setattr(native, "np", _ZeroedNumpy())
    sblob, (data, starts, ends), ident, setup = scan_inputs("stereo")
    c = ident.channels
    if mode == "values":
        def run(cpu):
            return native.decode_packet_spans(
                sblob, data, starts, ends, c, ident.blocksizes[1] // 2, 0,
                n_threads=n_threads, cpu_ns=cpu)
    else:
        layout = _sym_layout_cached(setup, ident)
        assert layout is not None

        def run(cpu):
            return native.decode_packet_spans_sym(
                sblob, data, starts, ends, c, 0, layout,
                n_threads=n_threads, cpu_ns=cpu)
    cpu = ctypes.c_int64(0)
    with_ptr, without = run(cpu), run(None)
    assert cpu.value > 0
    assert with_ptr.keys() == without.keys()
    for k in with_ptr:
        a, b = with_ptr[k], without[k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_a_repeated_call_builds_nothing(corpus, monkeypatch):
    """From empty caches a call counts each kind of table build; the same
    call again counts none; a traced call counts the same as an untraced
    one."""
    monkeypatch.setattr(header, "_SETUP_CACHE", {})
    monkeypatch.setattr(torch_corpus, "_SYNTH_CACHE", {})
    first = decode_corpus(corpus, device="cpu").stats["builds"]
    assert set(first) == set(profiling.BUILDS)
    assert first["setup"] >= 2 and first["synth"] == 3
    assert first["layout"] >= 3 and first["tables"] >= 3
    assert first["k1"] >= 1
    again = decode_corpus(corpus, device="cpu").stats["builds"]
    assert again == dict.fromkeys(profiling.BUILDS, 0)
    timed = decode_corpus(corpus, device="cpu", timer=DecodeTimer())
    assert timed.stats["builds"] == again


def test_python_path_is_counted(corpus, monkeypatch):
    """A stream the native front end declines takes the Python path: it
    counts in stats["front_python"], is a front.python span of its
    stream, and decodes as before."""
    real = torch_corpus._front_end_native
    monkeypatch.setattr(torch_corpus, "_front_end_native",
                        lambda data: None if data == corpus[0] else real(data))
    timer = DecodeTimer()
    outs = decode_corpus(corpus, device="cpu", timer=timer)
    assert outs.stats["front_python"] == 1
    keys = {sp.key for sp in timer.spans if sp.name == "front.python"}
    assert keys == {"s0"}
    monkeypatch.undo()
    want = decode_corpus(corpus, device="cpu")
    assert want.stats["front_python"] == 0
    for a, b in zip(outs, want):
        assert np.array_equal(a, b)


def test_sharded_prepare_spans(corpus):
    """The sharded path keeps shard_prepare_s, read from one prepare span
    a shard (key shard<k>), and stage_s as its spans' walls."""
    timer = DecodeTimer()
    outs = decode_corpus_sharded(corpus, Mesh(["cpu"] * 4, ("stream",)),
                                 output="s16", timer=timer)
    secs = outs.stats["shard_prepare_s"]
    prepares = [sp for sp in timer.spans if sp.name == "prepare"]
    assert len(secs) == 4 * outs.stats["groups"]
    assert {sp.key for sp in prepares} == {f"shard{k}" for k in range(4)}
    assert sum(secs) == pytest.approx(sum(sp.wall_s for sp in prepares),
                                      rel=1e-9)
    if len(prepares) == len(secs):  # no group prepared twice
        assert secs == [sp.wall_s for sp in prepares]
    for stage in ("merge", "prepare", "h2d", "dispatch", "d2h", "unpack"):
        walls = sum(sp.wall_s for sp in timer.spans
                    if SPAN_STAGES.get(sp.name, (None,))[0] == stage)
        assert outs.stats["stage_s"][stage] == pytest.approx(walls,
                                                             rel=0.01)
    plain = decode_corpus_sharded(corpus, Mesh(["cpu"] * 4, ("stream",)),
                                  output="s16")
    assert len(plain.stats["shard_prepare_s"]) == len(secs)
    for a, b in zip(outs, plain):
        assert np.array_equal(a, b)


def test_device_trace_holds_the_spans(tmp_path, corpus):
    """device_trace(timer=) writes every span into the Chrome trace on the
    profiler's clock: a record_function event inside a span on the main
    thread lies within the span, to 1 ms."""
    timer = DecodeTimer()
    with torch.profiler.record_function("warm"):
        torch.ones(4).sum()
    with device_trace(str(tmp_path), timer=timer):
        with timer.span("block"):
            with torch.profiler.record_function("block"):
                torch.ones(1 << 16).sum()
        decode_corpus(corpus[:2], device="cpu", timer=timer)
    (path,) = tmp_path.glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    assert len(spans) == len(timer.spans)
    assert {e["name"] for e in spans} >= {"call", "front", "merge", "pull"}
    names = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert "spans MainThread" in names
    ours = next(e for e in spans if e["name"] == "block")
    theirs = next(e for e in events if e.get("name") == "block"
                  and e.get("cat") != "span")
    assert ours["ts"] - 1000.0 <= theirs["ts"]
    assert theirs["ts"] + theirs["dur"] <= ours["ts"] + ours["dur"] + 1000.0
