"""PyTorch port, end to end on the CPU: decode_corpus against the JAX
package's decode_corpus(output="f32") and against the float64 scalar
anchor, both within 2e-6 max-abs (the CPU allowance of the JAX package's
own tests: the IMDCT products sum in another order on each backend).

s16: within 1 LSB of the JAX package's decode_corpus(output="s16") (the
2e-6 PCM difference can flip a rounding), bit-equal to the host
quantization of the port's own f32, and identical over every wire."""

import numpy as np
import pytest
import torch

from vorbispizza_tpu.models.corpus import decode_corpus as jax_decode_corpus
from vorbispizza_tpu.reader import VorbisReader
from vorbispizza_tpu_torch import decode_corpus
from vorbispizza_tpu_torch.config import VorbisConfig
from vorbispizza_tpu_torch.testing.streams import make_streams

TOL = 2e-6
S16_TOL = 1  # LSB
GROUPS = ("stereo", "mono", "surround", "oddbooks")


@pytest.fixture(scope="module")
def corpus():
    """Every group's streams as one corpus: stereo, mono and 5.1 chunks."""
    return [s for g in GROUPS for s in make_streams(g)]


@pytest.fixture(scope="module")
def port(corpus):
    return decode_corpus(corpus, device="cpu", output="f32")


@pytest.fixture(scope="module")
def reference(corpus):
    return jax_decode_corpus(corpus, output="f32")


def test_matches_jax_decode_corpus(port, reference):
    assert len(port) == len(reference)
    for got, want in zip(port, reference):
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= TOL


def test_matches_float64_anchor(corpus, port):
    for data, got in zip(corpus, port):
        r = VorbisReader(data)
        r.initialize()
        want = r.read_all(planar=True)
        assert got.shape == want.shape
        assert np.abs(got.astype(np.float64) - want).max() <= TOL


def test_stats(corpus, port):
    s = port.stats
    assert s["streams"] == s["batched"] == len(corpus)
    assert s["scalar"] == s["failed"] == 0
    # one chunk per channel count: stereo, mono (+ the mono raw stream), 5.1
    assert s["chunks"] == 3
    assert set(s["stage_s"]) == {"front_end", "split", "merge", "prepare",
                                 "h2d", "dispatch", "device", "d2h",
                                 "unpack", "stitch"}
    assert s["stage_s"]["split"] == s["stage_s"]["stitch"] == 0.0
    assert s["d2h_bytes"] == sum(4 * p.size for p in port)
    assert s["h2d_bytes"] > 0


def test_device_output(corpus, port):
    outs = decode_corpus(corpus, device="cpu", output="device")
    for got, want in zip(outs, port):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        # "device" output is unclipped, as in the reference
        clipped = got.numpy().clip(-0.99999994, 0.99999994)
        assert np.array_equal(clipped, want)


def test_one_stream_per_chunk(corpus, port):
    """Chunking changes nothing but the merge: every stream alone."""
    outs = decode_corpus(corpus, device="cpu", max_batch_bytes=1)
    assert outs.stats["chunks"] == len(corpus)
    for got, want in zip(outs, port):
        assert np.abs(got - want).max() <= TOL


def test_on_error_none_isolates_a_bad_file():
    srcs = [b"not an ogg stream at all"] + list(make_streams("mono"))
    outs = decode_corpus(srcs, device="cpu", on_error="none", n_workers=2)
    assert outs[0] is None and outs[1] is not None
    assert outs.stats["failed"] == 1 and outs.stats["batched"] == 1
    with pytest.raises(Exception):
        decode_corpus(srcs, device="cpu")


def test_unported_output_raises():
    """Every output and wire of the reference is ported: floor0 and the
    value-transport residues decode, within the JAX package's own floor0
    budget of it (5e-4, tests/test_rawstream.py) and within TOL, and
    their s16 is the host quantization of their f32; an unknown output
    raises."""
    for group, tol in (("floor0", 5e-4), ("values", TOL)):
        srcs = list(make_streams(group))
        got = decode_corpus(srcs, device="cpu")
        want = jax_decode_corpus(srcs, output="f32")
        assert got.stats["batched"] == len(srcs) and not got.stats["scalar"]
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.abs(g - w).max() <= tol
        s16 = decode_corpus(srcs, device="cpu", output="s16")
        for q, pcm in zip(s16, got):
            assert np.array_equal(q, host_quantize(pcm))
    with pytest.raises(ValueError, match="s24"):
        decode_corpus(list(make_streams("mono")), device="cpu", output="s24")


@pytest.fixture(scope="module")
def port_s16(corpus):
    """The main path under the default config: the dpack wire, rice
    resolved from the link (+inf on the CPU: width-only)."""
    return decode_corpus(corpus, device="cpu", output="s16")


def host_quantize(pcm):
    return np.clip(np.rint(pcm * np.float32(32768.0)), -32768,
                   32767).astype(np.int16)


def test_s16_matches_jax_decode_corpus(corpus, port_s16):
    want = jax_decode_corpus(corpus, output="s16")
    assert len(port_s16) == len(want)
    for got, ref in zip(port_s16, want):
        assert got.dtype == np.int16 and got.shape == ref.shape
        diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        assert diff.max() <= S16_TOL


def test_s16_is_the_host_quantization_of_f32(port, port_s16):
    for got, pcm in zip(port_s16, port):
        assert np.array_equal(got, host_quantize(pcm))
    s = port_s16.stats
    assert s["scalar"] == 0 and s["chunks"] == 3
    # the dpack wire moves well under the raw s16 bytes
    assert 0 < s["d2h_bytes"] < sum(2 * p.size for p in port)


@pytest.mark.parametrize("wire,rice", [("dpack", "on"), ("dpack", "off"),
                                       ("raw", "auto"), ("planes", "auto")])
def test_s16_wires_decode_identically(corpus, port_s16, monkeypatch, wire,
                                      rice):
    monkeypatch.setattr(VorbisConfig.default, "s16_wire", wire)
    monkeypatch.setattr(VorbisConfig.default, "s16_rice", rice)
    outs = decode_corpus(corpus, device="cpu", output="s16")
    for got, want in zip(outs, port_s16):
        assert np.array_equal(got, want)
    raw = sum(2 * p.size for p in port_s16)
    if wire == "dpack":
        assert outs.stats["d2h_bytes"] < raw
    else:
        assert outs.stats["d2h_bytes"] == raw


def test_s16_scalar_route_quantizes_the_anchor():
    from vorbispizza_tpu_torch.models.corpus import _scalar_fallback

    data = make_streams("mono")[0]
    got = _scalar_fallback(data, "s16", True)
    r = VorbisReader(data)
    r.initialize()
    want = np.clip(np.rint(r.read_all(planar=True).astype(np.float64)
                           * 32768.0), -32768, 32767).astype(np.int16)
    assert got.dtype == np.int16 and np.array_equal(got, want)
