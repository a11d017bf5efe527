"""PyTorch port, end to end on the CPU: decode_corpus against the JAX
package's decode_corpus(output="f32") and against the float64 scalar
anchor, both within 2e-6 max-abs (the CPU allowance of the JAX package's
own tests: the IMDCT products sum in another order on each backend)."""

import numpy as np
import pytest
import torch

from vorbispizza_tpu.models.corpus import decode_corpus as jax_decode_corpus
from vorbispizza_tpu.reader import VorbisReader
from vorbispizza_tpu_torch import decode_corpus
from vorbispizza_tpu_torch.testing.streams import make_streams

TOL = 2e-6
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
    assert set(s["stage_s"]) == {"front_end", "prepare", "h2d", "device",
                                 "d2h"}


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
    with pytest.raises(NotImplementedError, match="s16"):
        decode_corpus(list(make_streams("mono")), device="cpu", output="s16")
