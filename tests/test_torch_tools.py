"""PyTorch port, entry points and tooling on the CPU: ``entry`` and
``dryrun_multichip`` (vorbispizza_tpu_torch/entry.py), the stage ablation
and the wire-size sweep (vorbispizza_tpu_torch/tools); the fuzzer is in
tests/test_torch_fuzz.py."""

import numpy as np
import pytest
import torch

from vorbispizza_tpu_torch import entry as E
from vorbispizza_tpu_torch.testing import oracle
from vorbispizza_tpu_torch.tools import ablate, fuzz, wiresweep


def test_entry_runs_on_cpu():
    fn, args = E.entry(device="cpu")
    assert len(args) == 9 and all(a.device.type == "cpu" for a in args)
    out = fn(*args)
    assert out.dtype == torch.uint8 and out.dim() == 1
    nbytes = int(out[:4].numpy().view("<u4")[0])
    assert 0 < nbytes <= out.numel()
    assert torch.equal(fn(*args), out)


@pytest.mark.parametrize("n", [4, 2])
def test_dryrun_multichip_on_cpu(n):
    res = E.dryrun_multichip(n, device="cpu")
    assert res["s16_differing_samples"] == 0
    assert res["step_max_abs"] == 0.0
    streams = 2 if n == 4 else 1
    assert res["step_shape"] == (streams * 2, (n // streams) * 4 * 1024, 2)


def test_ablation_table_on_cpu():
    srcs = E.example_streams(1, 0.3)
    res = ablate.run_ablation(reps=1, device="cpu", corpus=srcs,
                              log=lambda m: None)
    assert list(res) == [v[0] for v in ablate.variants()]
    assert res["full_s16df"]["delta_ms"] == 0.0
    assert all(r["ms"] > 0 and r["realtime"] > 0 for r in res.values())


def test_ablation_restores_the_pipeline():
    from vorbispizza_tpu_torch.models import pipeline as pl

    before = (pl.ola_assemble, pl.couple_spectrum_chunk,
              pl.BatchSynthesizer.residues)
    with pytest.raises(RuntimeError):
        with ablate._patched({(pl, "ola_assemble"): ablate._slice_ola}):
            assert pl.ola_assemble is ablate._slice_ola
            raise RuntimeError
    assert (pl.ola_assemble, pl.couple_spectrum_chunk,
            pl.BatchSynthesizer.residues) == before


def test_wiresweep_one_short_stream(capsys):
    wiresweep.main(["1", "0.3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("decoder: ")
    names = [ln.split()[0] for ln in lines[2:]]
    assert {"current", "LANDED", "entropy0"} <= set(names)


def test_wiresweep_decodes_without_the_oracle(monkeypatch):
    """Without libvorbisfile the sweep decodes with the float64 reader,
    within 1 LSB of the oracle's s16."""
    if not oracle.available():
        pytest.skip("libvorbisfile.so.3 does not load")
    want = wiresweep.decoded_s16(1, 0.3)
    monkeypatch.setattr(oracle, "available", lambda: False)
    assert wiresweep.decoder_name().startswith("the port's float64")
    got = wiresweep.decoded_s16(1, 0.3)
    assert got[0].shape == want[0].shape
    assert np.abs(got[0] - want[0]).max() <= 1


def test_tools_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError):
        E.entry()
    with pytest.raises(RuntimeError):
        E.dryrun_multichip(4)
    with pytest.raises(RuntimeError):
        fuzz.run(1.0)
    with pytest.raises(RuntimeError):
        ablate.run_ablation(reps=1, corpus=[b""])
