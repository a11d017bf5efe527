"""PyTorch port, standalone: the port imports nothing of JAX and nothing of
the JAX package, and its own copies of the host modules (Ogg, setup
parsing, the frame planner, the C++ front end, the float64 anchor, the
test-stream generators) give bit-identical results to the JAX package's.

The copies are the same code (bar the front end's build directory, the
reader's and the accelerated decoder's ``device`` argument and a
pure-Python Ogg pager in place of libogg's), so every comparison here is
exact."""

import ast
import os
import pathlib
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

from vorbispizza_tpu.config import VorbisConfig as JaxConfig
from vorbispizza_tpu.models import corpus as jax_corpus
from vorbispizza_tpu.reader import VorbisReader as JaxReader
from vorbispizza_tpu.testing import rawstream as jax_rawstream
from vorbispizza_tpu_torch.config import VorbisConfig
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.reader import VorbisReader
from vorbispizza_tpu_torch.testing import rawstream
from vorbispizza_tpu_torch.testing.streams import make_streams

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "vorbispizza_tpu_torch"
GROUPS = ["stereo", "mono", "surround", "oddbooks", "floor0", "values"]


def test_port_imports_nothing_of_jax():
    """Every module of the port, imported in a fresh process, and
    chip_smoke.py: neither jax nor the JAX package is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vorbispizza_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,\n"
        "                                               p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'vorbispizza_tpu')\n"
        "       or m.startswith(('jax.', 'vorbispizza_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert len(names) > 30, names\n"
        "new = {'entry', 'parallel.corpus', 'parallel.mesh', 'tools.ablate',\n"
        "       'tools.fuzz', 'tools.wiresweep', 'testing.oracle',\n"
        "       'testing.pagecraft'}\n"
        "assert {p.__name__ + '.' + n for n in new} <= set(names), names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


IMPORT_RE = re.compile(
    r"^\s*(import\s+(vorbispizza_tpu|jax)(\s|\.|,|$)"
    r"|from\s+(vorbispizza_tpu|jax)[. ])"
)


def test_sources_have_no_jax_package_import():
    """No import line of the port's sources or of chip_smoke.py names the
    JAX package or jax, lazily inside a function or not."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = [
        f"{f.relative_to(REPO)}:{i}: {line.strip()}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if IMPORT_RE.match(line)
    ]
    assert not bad, bad


CORPUS = "vorbispizza_tpu_torch.models.corpus"


def _imported(f: pathlib.Path, node: ast.ImportFrom) -> str:
    """The absolute module an import-from line of ``f`` names."""
    if not node.level:
        return node.module or ""
    package = f.relative_to(REPO).parts[:-1]
    base = package[: len(package) - node.level + 1]
    return ".".join((*base, *([node.module] if node.module else [])))


def test_no_private_name_of_the_corpus_driver_is_imported():
    """parallel/, tools/ and entry.py reach models/corpus.py through its
    public names alone: no import of a _-prefixed name of it, and no
    _-prefixed attribute read off the module where it is imported whole."""
    files = (sorted((PKG / "parallel").rglob("*.py"))
             + sorted((PKG / "tools").rglob("*.py")) + [PKG / "entry.py"])
    bad = []
    for f in files:
        tree = ast.parse(f.read_text())
        names = set()  # the names the corpus module is bound to in f
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                module = _imported(f, node)
                for alias in node.names:
                    if module == CORPUS and alias.name.startswith("_"):
                        bad.append(f"{f.name}:{node.lineno}: {alias.name}")
                    if f"{module}.{alias.name}" == CORPUS:
                        names.add(alias.asname or alias.name)
            elif isinstance(node, ast.Import):
                names.update(a.asname for a in node.names
                             if a.name == CORPUS and a.asname)
        bad += [f"{f.name}:{node.lineno}: {node.value.id}.{node.attr}"
                for node in ast.walk(tree)
                if isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in names and node.attr.startswith("_")]
    assert len(files) > 8
    assert not bad, bad


def attributes(x) -> dict:
    """An object's attributes, from its __dict__ and its __slots__."""
    out = dict(vars(x)) if hasattr(x, "__dict__") else {}
    for cls in type(x).__mro__:
        slots = getattr(cls, "__slots__", ())
        for name in (slots,) if isinstance(slots, str) else slots:
            if hasattr(x, name):
                out[name] = getattr(x, name)
    out.pop("_lock", None)
    return out


#: attributes holding a setup id, which each package numbers per process
SID_NAMES = ("sid", "_vp_sid")


def same(a, b, path="", seen=None, sids=None):
    """Assert ``a`` (the JAX package's) and ``b`` (the port's) are the same
    structure: equal values, arrays equal in dtype and content, objects of
    the same class name with the same attributes, recursively; setup ids
    need only map one to one."""
    seen = set() if seen is None else seen
    sids = {} if sids is None else sids
    if id(a) in seen:
        return
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
        return
    if isinstance(a, (int, float, str, bytes, bool, type(None), np.generic)):
        assert type(a).__name__ == type(b).__name__, path
        assert a == b or (a != a and b != b), path
        return
    if isinstance(a, (set, frozenset)):
        a, b = sorted(a, key=repr), sorted(b, key=repr)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]", seen, sids)
        return
    if isinstance(a, dict):
        assert len(a) == len(b), path
        for (ka, va), (kb, vb) in zip(sorted(a.items(), key=lambda kv: repr(kv[0])),
                                      sorted(b.items(), key=lambda kv: repr(kv[0]))):
            same(ka, kb, f"{path}.key", seen, sids)
            same(va, vb, f"{path}[{ka!r}]", seen, sids)
        return
    if callable(a) or isinstance(a, type(threading.Lock())):
        return
    seen.add(id(a))
    assert type(a).__name__ == type(b).__name__, path
    fa, fb = attributes(a), attributes(b)
    assert sorted(fa) == sorted(fb), path
    for k in fa:
        if k in SID_NAMES:
            assert sids.setdefault(fa[k], fb[k]) == fb[k], path
            assert list(sids.values()).count(fb[k]) == 1, path
        else:
            same(fa[k], fb[k], f"{path}.{k}", seen, sids)


@pytest.mark.parametrize("group", GROUPS)
def test_front_end_copies_match(group):
    """Each package's own front end on the same stream: the parsed setup
    structures, the frame plan and every bucket array are identical."""
    for data in make_streams(group):
        js, jc, jplan, jbuckets = jax_corpus._front_end(data)
        ts, tc, tplan, tbuckets = torch_corpus._front_end(data)
        assert jc == tc
        for part in ("codebooks", "floors", "residues", "mappings", "modes"):
            same(getattr(js, part), getattr(ts, part), part)
        same(jplan.soa(), tplan.soa(), "soa")
        assert jplan.chains == tplan.chains
        assert jplan.chain_segments == tplan.chain_segments
        assert (jplan.total_len, jplan.pcm_length) == (tplan.total_len,
                                                       tplan.pcm_length)
        assert len(jbuckets) == len(tbuckets)
        for jb, tb in zip(jbuckets, tbuckets):
            same(jb, tb, "bucket")


def test_same_sees_differences():
    """``same`` fails on two different setups and on two different plans
    (so the exact comparisons above compare something)."""
    a, b = make_streams("stereo")
    ja, ta = jax_corpus._front_end(a), torch_corpus._front_end(b)
    for part in ("codebooks", "floors", "mappings"):
        with pytest.raises(AssertionError):
            same(getattr(ja[0], part), getattr(ta[0], part), part)
    with pytest.raises(AssertionError):
        same(ja[3], ta[3], "buckets")


@pytest.mark.parametrize("group", GROUPS)
def test_anchor_copy_matches(group):
    """The port's float64 scalar anchor gives the JAX package's PCM."""
    for data in make_streams(group):
        want = JaxReader(data)
        want.initialize()
        got = VorbisReader(data)
        got.initialize()
        a, b = want.read_all(planar=True), got.read_all(planar=True)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("group", ["stereo", "floor0", "values"])
def test_prepare_host_copies_match_fallback(group, monkeypatch):
    """prepare_host on each package's own front-end output under the
    fallback wires (each package reads its own config): byte-identical
    buffers and the same sig."""
    for cfg in (JaxConfig.default, VorbisConfig.default):
        monkeypatch.setattr(cfg, "floor1_wire", "posts")
        monkeypatch.setattr(cfg, "residue_transport", "values")
    srcs = make_streams(group)
    out = []
    for mod in (jax_corpus, torch_corpus):
        fronts = [mod._front_end(s) for s in srcs]
        synth = mod._synthesizer_for(fronts[0][0], fronts[0][1])
        for f in fronts:
            synth.add_setup(f[0])
        plan, buckets, _ = mod.merge_streams([f[2:4] for f in fronts])
        out.append(synth.prepare_host(plan, buckets, "f32"))
    (jsig, jhost, jtotal), (tsig, thost, ttotal) = out
    assert all(pn[2] != "sym" for pn in tsig[1])
    same(jsig, tsig, "sig")
    assert jtotal == ttotal
    for a, b in zip(jhost, thost):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(
    n for n in dir(rawstream) if n.startswith("make_") and n.endswith("stream")
))
def test_raw_streams_page_like_libogg(name):
    """The port's pure-Python pager gives the bytes libogg gives."""
    assert getattr(rawstream, name)() == getattr(jax_rawstream, name)()


def test_pager_matches_libogg_on_long_and_spanning_packets():
    rng = np.random.default_rng(3)
    sizes = rng.integers(0, 3000, size=120)
    packets = [(bytes(rng.integers(0, 256, size=int(n), dtype=np.uint8)),
                100 * i) for i, n in enumerate(sizes)]
    packets[4] = (bytes(70000), 400)  # more than 255 lacing values
    assert rawstream.page_stream(packets) == jax_rawstream.page_stream(packets)
    for k in (1, 2, 3, 4, 5):
        assert (rawstream.page_stream(packets[:k])
                == jax_rawstream.page_stream(packets[:k]))


#: the pagecraft vectors and their extra arguments
PAGECRAFT = {"make_long_first_packet": (), "make_empty_page": (),
             "make_partial_granule": (), "make_bad_continued_flag": (),
             "make_zero_length_packets": (), "make_max_lacing_page": (),
             "make_multipage_continued": (),
             "corrupt_interior_continuation": (),
             "make_multipage_setup_header": (), "make_sample_rate": (22050,),
             "make_serial_reuse_chain": ()}


@pytest.mark.parametrize("name", sorted(PAGECRAFT))
def test_pagecraft_copy_matches(name):
    """The port's page-level anomaly vectors are the JAX package's, byte
    for byte, on the same healthy stream."""
    from vorbispizza_tpu.testing import pagecraft as jax_pagecraft
    from vorbispizza_tpu_torch.testing import pagecraft

    data = make_streams("stereo")[0]
    if name == "corrupt_interior_continuation":  # needs a continued packet
        data = jax_pagecraft.make_multipage_continued(data)
    args = PAGECRAFT[name]
    assert getattr(pagecraft, name)(data, *args) == \
        getattr(jax_pagecraft, name)(data, *args)


def test_pagecraft_vectors_all_compared():
    from vorbispizza_tpu_torch.testing import pagecraft

    made = {n for n in dir(pagecraft)
            if n.startswith(("make_", "corrupt_"))}
    assert made == set(PAGECRAFT)


@pytest.mark.parametrize("group", ["stereo", "surround"])
def test_oracle_copy_matches(group, tmp_path):
    """The port's libvorbisfile oracle decodes like the JAX package's."""
    from vorbispizza_tpu.testing.oracle import OracleDecoder as JaxOracle
    from vorbispizza_tpu_torch.testing import oracle

    if not oracle.available():
        pytest.skip("libvorbisfile.so.3 does not load")
    for i, data in enumerate(make_streams(group)):
        path = tmp_path / f"{group}{i}.ogg"
        path.write_bytes(data)
        want, got = JaxOracle(str(path)), oracle.OracleDecoder(str(path))
        assert (got.channels, got.rate, got.total) == (want.channels,
                                                       want.rate, want.total)
        a, b = want.read_float(), got.read_float()
        assert a.dtype == b.dtype and np.array_equal(a, b)
        got.seek(1000)
        want.seek(1000)
        assert np.array_equal(got.read_float_n(700), want.read_float_n(700))


def test_oracle_says_when_it_cannot_load(monkeypatch, tmp_path):
    import ctypes

    from vorbispizza_tpu_torch.testing import oracle

    def missing(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(oracle, "_lib", None)
    monkeypatch.setattr(ctypes, "CDLL", missing)
    assert not oracle.available()
    with pytest.raises(oracle.OracleUnavailable, match="libvorbisfile"):
        oracle.OracleDecoder(str(tmp_path / "none.ogg"))
