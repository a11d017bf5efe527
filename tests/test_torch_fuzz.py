"""PyTorch port, the fuzzer on the CPU (vorbispizza_tpu_torch/tools/fuzz.py).

The fuzzer's trials are the JAX package's, on a device: batch against
scalar within 2e-6 on the CPU. Where libvorbisenc does not load (the
card's machine), its base streams are the port's spec-corner generators
and the committed corpus's members cut short; both pools are tried here."""

import numpy as np
import pytest

from vorbispizza_tpu_torch.reader import VorbisReader
from vorbispizza_tpu_torch.tools import fuzz

SHAPES = sorted(set(fuzz.SHAPES))


@pytest.fixture(params=["vorbisenc", "stock"])
def pool(request, monkeypatch):
    """The fuzzer's base-stream pool: libvorbisenc encodes, or the stock
    pool of a machine without libvorbisenc."""
    if request.param == "stock":
        monkeypatch.setattr(fuzz, "_vorbisenc", lambda: False)
    return request.param


def test_fuzz_regression_shard_ys_clone():
    """The JAX package's fuzz regression (seed 9003): a sharded corpus
    where a shard is missing a bucket key gets a zero-frame clone that
    keeps the coded-ys wire (tests/test_fuzz.py)."""
    info = {}
    status = fuzz._one_trial(np.random.default_rng(9003), device="cpu",
                             info=info)
    assert status in ("ok", "skip", "reject"), status
    assert info["shape"] == "sharded"


@pytest.mark.parametrize("shape", SHAPES)
def test_fuzz_trials(shape, pool):
    """Two seeded trials of each shape from each pool keep the contract."""
    for seed in (1, 2):
        status = fuzz._one_trial(np.random.default_rng(seed), (shape,),
                                 device="cpu")
        assert status in ("ok", "skip", "reject"), status


def test_fuzz_run_counts_by_shape(pool):
    res = fuzz.run(1.0, seed0=7, shapes=("single", "corrupt"), device="cpu")
    assert res["trials"] >= 1 and not res["failed"]
    assert sum(res["stats"][k] for k in ("ok", "skip", "reject", "fail")) \
        == res["trials"]
    assert sum(sum(v.values()) for v in res["by_shape"].values()) \
        == res["trials"]
    assert set(res["by_shape"]) <= {"single", "corrupt"}


def test_fuzz_exit_status_on_failure(monkeypatch, capsys):
    def broken(*a, **k):
        raise AssertionError("contract violated")

    monkeypatch.setattr(fuzz, "_one_trial", broken)
    assert fuzz.main(["0.2", "5", "single", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL seed=5 (repro: tools.fuzz 1 5 single --device cpu)" in out


def test_stock_streams_decode(monkeypatch):
    """The stock pool's streams (corpus cuts and spec-corner generators)
    carry the trial's serial and decode."""
    monkeypatch.setattr(fuzz, "_vorbisenc", lambda: False)
    rng = np.random.default_rng(3)
    for serial in range(20, 26):
        data = fuzz._random_stream(rng, serial=serial)
        assert all(int.from_bytes(data[off + 14 : off + 18], "little")
                   == serial for off, _ in fuzz._pages(data))
        r = VorbisReader(data)
        r.initialize()
        assert r.read_all(planar=True).shape[1] > 0


def test_reserial_cut_ends_the_stream():
    from vorbispizza_tpu_torch.testing.corpus32 import load_corpus

    data = load_corpus()[0]
    cut = fuzz.reserial(data, 99, n_pages=10)
    pages = fuzz._pages(cut)
    assert len(pages) == 10 and sum(s for _, s in pages) == len(cut)
    assert cut[pages[-1][0] + 5] & 4  # end of stream
    whole = VorbisReader(data)
    whole.initialize()
    part = VorbisReader(cut)
    part.initialize()
    a, b = whole.read_all(planar=True), part.read_all(planar=True)
    assert 0 < b.shape[1] < a.shape[1]
    assert np.array_equal(b[:, : b.shape[1] - 4096],
                          a[:, : b.shape[1] - 4096])
