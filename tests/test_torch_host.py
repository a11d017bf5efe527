"""PyTorch port, host side: the carried-over prepare_host, the device
tables, the committed corpus, the import boundary and device resolution.

The port's host half is a numpy copy of the JAX package's; it must give
the SAME sig and byte-identical wire buffers for the same merged chunk."""

import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from vorbispizza_tpu.models import corpus as jax_corpus
from vorbispizza_tpu.ops.imdct import dct_iv_matrix
from vorbispizza_tpu_torch.device import check_fp32_matmul, resolve_device
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.models.pipeline import device_tables
from vorbispizza_tpu_torch.testing import corpus32
from vorbispizza_tpu_torch.testing.streams import make_streams, vorbisenc_available

REPO = pathlib.Path(__file__).resolve().parent.parent


def plain(x, sids=None):
    """``x`` with every dataclass (each package has its own BucketKey
    class) replaced by its class name and fields, for comparison across
    the two packages. Setup ids (``sid``) are numbered per process by each
    package, so they are replaced by their order of first appearance."""
    sids = {} if sids is None else sids
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, *(
            sids.setdefault(getattr(x, f.name), len(sids)) if f.name == "sid"
            else plain(getattr(x, f.name), sids)
            for f in dataclasses.fields(x)))
    if isinstance(x, (tuple, list)):
        return tuple(plain(v, sids) for v in x)
    return x


def port_pads(pads, jax_buckets, port_buckets):
    """The JAX package's pads with its BucketKeys as the port's (the two
    bucket lists of one chunk are in the same order)."""
    keys = {jb.key: tb.key for jb, tb in zip(jax_buckets, port_buckets)}

    def conv(k):
        if isinstance(k, tuple):
            return tuple(conv(v) for v in k)
        return keys.get(k, k) if dataclasses.is_dataclass(k) else k

    return {conv(k): v for k, v in pads.items()}


def prepared(mod, srcs):
    """(synth, plan, buckets) of one merged chunk through ``mod``'s front
    end, merge and synthesizer (``mod``: either package's models.corpus)."""
    fronts = [mod._front_end(s) for s in srcs]
    synth = mod._synthesizer_for(fronts[0][0], fronts[0][1])
    for f in fronts:
        synth.add_setup(f[0])
    plan, buckets, _ = mod.merge_streams([f[2:4] for f in fronts])
    return synth, plan, buckets


@pytest.mark.parametrize("group", ["stereo", "mono", "surround", "oddbooks",
                                   "floor0", "values"])
def test_prepare_host_matches_reference(group, monkeypatch):
    """Every output, with the dpack rice flag (sig[6]) forced on and off
    (each package reads its own config): the same sig and byte-identical
    buffers."""
    from vorbispizza_tpu.config import VorbisConfig as JaxConfig
    from vorbispizza_tpu_torch.config import VorbisConfig

    srcs = make_streams(group)
    js, jp, jb = prepared(jax_corpus, srcs)
    ts, tp, tb = prepared(torch_corpus, srcs)
    for output in ("f32", "s16", "s16p", "s16d", "s16df"):
        for rice in ("on", "off"):
            monkeypatch.setattr(JaxConfig.default, "s16_rice", rice)
            monkeypatch.setattr(VorbisConfig.default, "s16_rice", rice)
            sig_j, host_j, total_j = js.prepare_host(jp, jb, output)
            sig_t, host_t, total_t = ts.prepare_host(tp, tb, output)
            assert plain(sig_t) == plain(sig_j)
            dpack = output in ("s16d", "s16df")
            assert sig_t[6] is (rice == "on" if dpack else True)
            assert total_t == total_j
            assert len(host_t) == len(host_j) == 9
            for a, b in zip(host_t, host_j):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()


def test_prepare_host_pads_match_reference():
    """Forced pads (the reference's cross-shard unification) pack alike."""
    from vorbispizza_tpu.models.pipeline import merge_pads

    srcs = make_streams("stereo")
    js, jp, jb = prepared(jax_corpus, srcs)
    ts, tp, tb = prepared(torch_corpus, srcs)
    pads = merge_pads([js.prepare_host(jp, jb, "f32")[0]])
    pads = {k: (v * 2 if isinstance(v, int) else v) for k, v in pads.items()}
    sig_j, host_j, _ = js.prepare_host(jp, jb, "f32", pads=pads)
    sig_t, host_t, _ = ts.prepare_host(tp, tb, "f32",
                                       pads=port_pads(pads, jb, tb))
    assert sig_t != ts.prepare_host(tp, tb, "f32")[0]  # the pads applied
    assert plain(sig_t) == plain(sig_j)
    for a, b in zip(host_t, host_j):
        assert a.tobytes() == b.tobytes()


def test_device_tables_match_reference():
    srcs = make_streams("stereo")
    js, jp, jb = prepared(jax_corpus, srcs)
    ts, tp, tb = prepared(torch_corpus, srcs)
    for b, jbk in zip(tb, jb):
        key = b.key
        t = device_tables(ts, key, "cpu")
        n, window, steps = js._bucket_static(jbk.key)
        hi, lo = dct_iv_matrix(n // 2)
        assert np.array_equal(t["dct"][0].numpy(), hi)
        assert np.array_equal(t["dct"][1].numpy(), lo)
        assert np.array_equal(t["window"].numpy(), window)
        assert t["steps"].tolist() == [list(s) for s in steps]
        ref_subs = js._sym_static(jbk.key)["subs"]
        assert len(t["subs"]) == len(ref_subs)
        for sub, ref in zip(t["subs"], ref_subs):
            assert sub["ch_list"] == ref["ch_list"]
            assert len(sub["vqs"]) == len(ref["vqs"])
            for v, r in zip(sub["vqs"], ref["vqs"]):
                assert v.dtype == torch.float32
                assert np.array_equal(v.numpy(), r)
        # cached per (key, device)
        assert device_tables(ts, key, "cpu") is t


def test_corpus32_manifest():
    corpus = corpus32.load_corpus()  # checks every sha256
    manifest = json.loads((corpus32.ROOT / "MANIFEST.json").read_text())
    assert manifest["recipe"] == corpus32.RECIPE
    assert len(corpus) == corpus32.RECIPE["streams"] == 32
    for seed, data in enumerate(corpus):
        name = corpus32.member_name(seed)
        assert hashlib.sha256(data).hexdigest() == manifest["sha256"][name]
    assert corpus32.audio_seconds() == 480.0


def test_corpus32_reencodes_seed0():
    if not vorbisenc_available():
        pytest.skip("libvorbisenc is not installed")
    data = corpus32.encode_member(0)
    assert data == (corpus32.ROOT / corpus32.member_name(0)).read_bytes()


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import vorbispizza_tpu_torch.models.corpus\n"
        "import vorbispizza_tpu_torch.kernels.build\n"
        "import vorbispizza_tpu_torch.ops.pcm_pack\n"
        "import vorbispizza_tpu_torch.utils.link\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_corpus.decode_corpus(list(make_streams("mono")), device="cuda")


def test_device_is_required():
    """resolve_device takes no default; decode_corpus defaults to "cuda",
    which raises where CUDA is absent (it never falls back to the CPU)."""
    with pytest.raises(ValueError):
        resolve_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_corpus.decode_corpus([])  # no device= given: "cuda"
    assert resolve_device("cpu") == torch.device("cpu")


def test_fp32_matmul_check():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="fp32 matmul"):
            check_fp32_matmul()
        torch.backends.cuda.matmul.allow_tf32 = False
        check_fp32_matmul()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
