"""PyTorch port, scale-out on the CPU: the sharded corpus decode
(parallel/corpus.py), its sig unification (pipeline.sig_pads/merge_pads)
and the ('stream', 'frame') mesh step (parallel/mesh.py), held to the JAX
package's on the same inputs and to the port's own single-device decode.

A port mesh on the CPU repeats the CPU device; the JAX package's runs on
the virtual CPU devices of tests/conftest.py. s16 is held within 1 LSB
and f32 within 2e-6 of the JAX package (its CPU allowance: the IMDCT
products sum in another order on each backend); against the port's own
decode_corpus the sharded decode is bit-equal."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tests.test_torch_host import plain
from vorbispizza_tpu.models import corpus as jax_corpus
from vorbispizza_tpu.models import pipeline as jax_pipeline
from vorbispizza_tpu.parallel import corpus as jax_parallel
from vorbispizza_tpu.parallel import mesh as jax_mesh
from vorbispizza_tpu_torch.config import VorbisConfig
from vorbispizza_tpu_torch.dsp.window import full_window
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.models import pipeline
from vorbispizza_tpu_torch.parallel import corpus as pc
from vorbispizza_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    shard_inputs,
    sharded_decode_step,
)
from vorbispizza_tpu_torch.testing.encode import encode_vorbis, make_signal

TOL = 2e-6
S16_TOL = 1  # LSB


@pytest.fixture(scope="module")
def prod_corpus():
    """tests/test_parallel.py's recipe: 5 stereo 0.4 s q0.3 streams."""
    return [
        encode_vorbis(make_signal(2, 0.4, kind="music", seed=s), quality=0.3)
        for s in range(5)
    ]


@pytest.fixture(scope="module")
def mixed_corpus():
    """tests/test_parallel.py's mixed-setup recipe, one stream of each of
    its three qualities (three setups)."""
    return [
        encode_vorbis(make_signal(2, 0.4, kind="music", seed=60 + s),
                      quality=(0.2, 0.5, 0.8)[s])
        for s in range(3)
    ]


def cpu_mesh(n):
    return Mesh(["cpu"] * n, ("stream",))


def jax_mesh_of(n):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip("not enough virtual devices")
    return JaxMesh(np.array(devs[:n]), axis_names=("stream",))


def same_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# -- the host half: partition, pads, unified buckets ---------------------


@pytest.mark.parametrize("seed", range(4))
def test_partition_indices_matches_reference(seed):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 500, size=int(rng.integers(1, 20))).tolist()
    for n in (1, 2, 4, 7, 32):
        assert pc.partition_indices(costs, n) == \
            jax_parallel.partition_indices(costs, n)


def shard_preps(mod, pmod, srcs, n_shards, output, pads=None):
    """Each package's shards of ``srcs`` over ``n_shards``: the unified
    bucket lists and each shard's prepare_host (with ``pads``, or the
    merged pads of the shards' own sigs when ``pads`` is "merge")."""
    fronts = [mod._front_end(s) for s in srcs]
    synth = mod._synthesizer_for(fronts[0][0], fronts[0][1])
    for f in fronts:
        synth.add_setup(f[0])
    parts = pc.partition_indices([f[2].n_frames for f in fronts], n_shards)
    merged = [mod.merge_streams([fronts[j][2:4] for j in part]) if part
              else (pmod._empty_plan(), [], []) for part in parts]
    blists = pmod._unify_buckets(merged)

    def prep(p):
        return [synth.prepare_host(plan, bl, output, pads=p)
                for (plan, _, _), bl in zip(merged, blists)]

    preps = prep({})
    if pads == "merge":
        merge = (jax_pipeline if mod is jax_corpus else pipeline).merge_pads
        preps = prep(merge([p[0] for p in preps]))
    return blists, preps


def norm_pads(pads):
    """A pads dict with its BucketKeys in plain form, for comparison
    across the two packages (setup ids by order of first appearance)."""
    sids = {}
    return sorted(((plain(k, sids), v) for k, v in pads.items()), key=repr)


@pytest.fixture
def rice_off(monkeypatch):
    from vorbispizza_tpu.config import VorbisConfig as JaxConfig

    for cfg in (JaxConfig.default, VorbisConfig.default):
        monkeypatch.setattr(cfg, "s16_rice", "off")


@pytest.mark.parametrize("pads", [None, "merge"])
@pytest.mark.parametrize("output", ["f32", "s16d"])
def test_shard_buffers_match_reference(prod_corpus, output, pads, rice_off):
    """Same shards, unified buckets, prepare_host (quantized pads and the
    merged maximum pads): the same sigs and byte-identical nine buffers
    as the JAX package's; sig_pads and merge_pads agree too."""
    jb, jp = shard_preps(jax_corpus, jax_parallel, prod_corpus, 4, output,
                         pads)
    tb, tp = shard_preps(torch_corpus, pc, prod_corpus, 4, output, pads)
    assert [len(b) for b in jb] == [len(b) for b in tb]
    for (jsig, jhost, jtot), (tsig, thost, ttot) in zip(jp, tp):
        assert plain(tsig) == plain(jsig)
        assert ttot == jtot
        for a, b in zip(thost, jhost):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert norm_pads(pipeline.sig_pads(tsig)) == \
            norm_pads(jax_pipeline.sig_pads(jsig))
    assert norm_pads(pipeline.merge_pads([p[0] for p in tp])) == \
        norm_pads(jax_pipeline.merge_pads([p[0] for p in jp]))
    if pads == "merge":
        assert len({p[0] for p in tp}) == 1  # one sig for every shard


def test_empty_clone_keeps_ys(mixed_corpus, rice_off):
    """The fuzz seed 9003 shape: a shard missing a bucket key gets a
    zero-frame clone that keeps the coded-ys floor wire where the key's
    frames have it, so its sig unifies with the others' (both packages,
    byte-identical). Three setups over three shards: each shard lacks the
    other two setups' keys."""
    srcs = mixed_corpus[:3]
    jb, jp = shard_preps(jax_corpus, jax_parallel, srcs, 3, "f32", "merge")
    tb, tp = shard_preps(torch_corpus, pc, srcs, 3, "f32", "merge")
    full = {b.key: b for bl in tb for b in bl if len(b.frame_indices)}
    clones = [b for bl in tb for b in bl if not len(b.frame_indices)]
    assert clones, "no shard lacks a bucket key"
    ys = 0
    for b in clones:
        for g, ref in zip(b.floor_groups, full[b.key].floor_groups):
            assert (g.ys is None) == (ref.ys is None)
            ys += g.ys is not None and g.ys.shape[0] == 0
    assert ys, "no clone carries the coded-ys wire"
    assert len({p[0] for p in tp}) == 1
    for (jsig, jhost, _), (tsig, thost, _) in zip(jp, tp):
        assert plain(tsig) == plain(jsig)
        for a, b in zip(thost, jhost):
            assert a.tobytes() == b.tobytes()


# -- decode_corpus_sharded ------------------------------------------------


@pytest.mark.parametrize("output", ["s16", "f32"])
def test_sharded_matches_reference(prod_corpus, output):
    """The port's sharded decode (4-entry CPU mesh) against the JAX
    package's (4 virtual CPU devices), with a malformed member under
    on_error="none": the same None slot and shapes."""
    srcs = prod_corpus[:2] + [b"OggS not a stream"] + prod_corpus[2:]
    want = jax_parallel.decode_corpus_sharded(srcs, jax_mesh_of(4),
                                              output=output, on_error="none")
    got = pc.decode_corpus_sharded(srcs, cpu_mesh(4), output=output,
                                   on_error="none")
    assert [None if o is None else o.shape for o in got] == \
        [None if o is None else np.asarray(o).shape for o in want]
    for a, b in zip(got, want):
        if a is None:
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
        assert diff <= (S16_TOL if output == "s16" else TOL)
    s = got.stats
    assert (s["streams"], s["groups"], s["shards"], s["batched"]) == (6, 1,
                                                                       4, 5)
    assert s["failed"] == 1 and got[2] is None
    assert s["scalar"] == s["mismatch_fallbacks"] == 0
    if output == "s16":
        assert 0 < s["wire_bytes"] < s["d2h_bytes"]
    with pytest.raises(Exception):
        pc.decode_corpus_sharded(srcs, cpu_mesh(4), output=output)


@pytest.mark.parametrize("output", ["s16", "f32", "device"])
def test_sharded_equals_decode_corpus(prod_corpus, output):
    got = pc.decode_corpus_sharded(prod_corpus, cpu_mesh(4), output=output)
    want = torch_corpus.decode_corpus(prod_corpus, device="cpu",
                                      output=output)
    for a, b in zip(got, want):
        if output == "device":
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert same_arrays(a, b)


@pytest.mark.parametrize("output", ["s16", "f32", "device"])
def test_both_drivers_share_the_front_end_stage(prod_corpus, monkeypatch,
                                                output):
    """A malformed source, one the batch planner rejects and good ones,
    through decode_corpus and decode_corpus_sharded with on_error="none":
    the same failed, scalar and batched counts, and the same PCM, the
    scalar decoder's too."""
    from vorbispizza_tpu_torch.frames import BatchUnsupported

    rejected, real = prod_corpus[1], torch_corpus._front_end

    def front_end(source):
        if source is rejected:
            raise BatchUnsupported("planted: this stream goes scalar")
        return real(source)

    monkeypatch.setattr(torch_corpus, "_front_end", front_end)
    srcs = [b"not an ogg stream at all", *prod_corpus]
    want = torch_corpus.decode_corpus(srcs, device="cpu", output=output,
                                      on_error="none")
    got = pc.decode_corpus_sharded(srcs, cpu_mesh(2), output=output,
                                   on_error="none")
    counts = ("failed", "scalar", "batched")
    assert ([got.stats[k] for k in counts] == [want.stats[k] for k in counts]
            == [1, 1, len(prod_corpus) - 1])
    assert got[0] is None and want[0] is None
    # the sharded driver's stage walls: decode_corpus's keys, and nonzero
    # for the stages it runs (front_end from the front.wait spans)
    stage_s = got.stats["stage_s"]
    assert list(stage_s) == list(want.stats["stage_s"]) == list(
        torch_corpus.STAGES)
    ran = {"front_end", "merge", "prepare", "h2d", "dispatch"}
    if output != "device":
        ran |= {"d2h", "unpack"}
    assert {k for k, v in stage_s.items() if v > 0} == ran
    assert stage_s["prepare"] == pytest.approx(
        sum(got.stats["shard_prepare_s"]))
    for a, b in zip(got[1:], want[1:]):
        if output == "device":
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert same_arrays(a, b)


def test_sharded_mixed_setups_equal_decode_corpus(mixed_corpus):
    got = pc.decode_corpus_sharded(mixed_corpus, cpu_mesh(2), output="s16")
    want = torch_corpus.decode_corpus(mixed_corpus, device="cpu",
                                      output="s16")
    assert all(same_arrays(a, b) for a, b in zip(got, want))
    assert got.stats["mismatch_fallbacks"] == 0


def test_more_shards_than_streams(prod_corpus):
    """4 shards for 3 streams: one shard holds no stream and is not
    launched."""
    srcs = prod_corpus[:3]
    got = pc.decode_corpus_sharded(srcs, cpu_mesh(4), output="s16")
    want = torch_corpus.decode_corpus(srcs, device="cpu", output="s16")
    assert all(same_arrays(a, b) for a, b in zip(got, want))
    assert got.stats["shards"] == 3


def test_mismatch_takes_per_device_dispatch(prod_corpus, monkeypatch):
    """On ShardMismatch the group goes through the reference's per-device
    dispatch (counted): the same kernels a stream at a time, bit-equal."""
    def boom(*a, **k):
        raise pc.ShardMismatch("injected")

    monkeypatch.setattr(pc, "sharded_chunk_run", boom)
    got = pc.decode_corpus_sharded(prod_corpus, cpu_mesh(4), output="s16")
    want = torch_corpus.decode_corpus(prod_corpus, device="cpu",
                                      output="s16")
    assert all(same_arrays(a, b) for a, b in zip(got, want))
    assert got.stats["mismatch_fallbacks"] == 1
    assert got.stats["scalar"] == 0


def test_batch_unsupported_degrades_to_scalar(prod_corpus, monkeypatch):
    """A planner rejection in the sharded run and again per stream ends in
    the scalar decoder, within 1 LSB of the batch path."""
    from vorbispizza_tpu_torch.frames import BatchUnsupported

    def boom(*a, **k):
        raise BatchUnsupported("injected")

    monkeypatch.setattr(pc, "sharded_chunk_run", boom)
    monkeypatch.setattr(pipeline.BatchSynthesizer, "prepare_host", boom)
    got = pc.decode_corpus_sharded(prod_corpus, cpu_mesh(4), output="s16")
    monkeypatch.undo()
    want = torch_corpus.decode_corpus(prod_corpus, device="cpu",
                                      output="s16")
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    assert got.stats["scalar"] == len(prod_corpus)


def test_all_zero_frame_group_goes_scalar():
    from tests.test_corpus import _headers_only_stream

    empty = _headers_only_stream()
    outs = pc.decode_corpus_sharded([empty, empty], cpu_mesh(2),
                                    output="s16")
    assert [o.shape for o in outs] == [(2, 0), (2, 0)]
    assert outs.stats["scalar"] == 2 and outs.stats["groups"] == 0


def test_sharded_needs_a_one_axis_mesh(prod_corpus):
    """A 2-D mesh cannot carry the stream axis alone: ShardMismatch, then
    per-device dispatch, as in the reference."""
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("stream", "frame"))
    got = pc.decode_corpus_sharded(prod_corpus[:2], mesh, output="s16")
    want = torch_corpus.decode_corpus(prod_corpus[:2], device="cpu",
                                      output="s16")
    assert all(same_arrays(a, b) for a, b in zip(got, want))
    assert got.stats["mismatch_fallbacks"] == 1


# -- the ('stream', 'frame') step ----------------------------------------

N = 256
C = 2
XS = (0, 128, 16, 32, 64, 96, 8, 112)  # a valid floor1 X list
MULT = 2
STEPS = ((0, 1),)


def _random_inputs(rng, S, F):
    """tests/test_parallel.py's recipe."""
    P = len(XS)
    residues = rng.standard_normal((S, F, C, N // 2)).astype(np.float32)
    posts = rng.integers(0, 128, size=(S, F, C, P)).astype(np.int32)
    step2 = rng.random((S, F, C, P)) < 0.7
    step2[..., :2] = True
    used = rng.random((S, F, C)) < 0.9
    return residues, posts, step2, used


@pytest.mark.parametrize("streams", [2, 1])
def test_mesh_step_matches_reference(streams):
    """2x2 and 1x4 meshes against the JAX package's step on 4 virtual CPU
    devices, same numpy inputs; and against the port's one-shard run."""
    if len(jax.devices("cpu")) < 4:
        pytest.skip("not enough virtual devices")
    rng = np.random.default_rng(42)
    S, F = streams * 2, (4 // streams) * 4
    inputs = _random_inputs(rng, S, F)
    window = full_window(N, 0, N // 2, N // 2, N)
    kw = dict(n=N, channels=C, xs=XS, multiplier=MULT, coupling_steps=STEPS,
              window=window)
    jm = jax_mesh.make_mesh(4, streams=streams)
    want, want_clip = jax_mesh.sharded_decode_step(jm, **kw)(
        *jax_mesh.shard_inputs(jm, *inputs))
    mesh = make_mesh(4, streams=streams, device="cpu")
    assert mesh.shape == {"stream": streams, "frame": 4 // streams}
    got, clip = sharded_decode_step(mesh, **kw)(*shard_inputs(mesh, *inputs))
    assert tuple(got.shape) == (S, F * N // 2, C)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    assert bool(clip) == bool(want_clip)
    one, one_clip = sharded_decode_step(make_mesh(1, device="cpu"), **kw)(
        *inputs)
    assert torch.equal(one, got) and bool(one_clip) == bool(clip)


def test_mesh_shards_must_divide():
    mesh = make_mesh(4, streams=2, device="cpu")
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):
        shard_inputs(mesh, *_random_inputs(rng, 3, 8))
    with pytest.raises(ValueError):
        make_mesh(4, streams=3, device="cpu")


def test_cuda_mesh_raises_without_cuda(prod_corpus):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError):
        make_mesh(device="cuda")
    with pytest.raises(RuntimeError):
        Mesh(["cuda:0"] * 2, ("stream",))
    with pytest.raises(RuntimeError):
        pc.decode_corpus_sharded(prod_corpus, Mesh(["cuda"], ("stream",)))
