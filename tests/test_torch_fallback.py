"""PyTorch port, the fallback wires and floor0 on the CPU: K2's posts mode,
K9 (value-transport residues) and K8 (floor0), each through its wrapper
(the plain twin for CPU tensors), against the JAX package on the same
numpy inputs; then the decodes that run them.

Tolerances: the posts curves and the value residues are integer
arithmetic, a table product or a cast, so they match BIT FOR BIT. Floor0
is float32 LSP synthesis whose cos/exp roundings differ between the two
backends, so it is held to 2e-4 relative where |curve| < 1e4 (the bound
of tests/test_floor0_device.py); its decodes to 5e-4 max-abs (the JAX
package's own floor0 budget, tests/test_rawstream.py). The fallback
config's decode carries the same posts and the same residue values as
the default one, so it is bit-equal to it, and within 2e-6 of JAX (the
CPU allowance of the IMDCT product's summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorbispizza_tpu.config import VorbisConfig as JaxConfig
from vorbispizza_tpu.models.corpus import decode_corpus as jax_decode_corpus
from vorbispizza_tpu.ops.floor import floor0_curves as jax_floor0_curves
from vorbispizza_tpu.ops.floor import floor1_curves
from vorbispizza_tpu.reader import VorbisReader
from vorbispizza_tpu_torch import decode_corpus
from vorbispizza_tpu_torch.config import VorbisConfig
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.ops import floor, residue_values
from vorbispizza_tpu_torch.reader import VorbisReader as PortReader
from vorbispizza_tpu_torch.setup.floor import Floor0
from vorbispizza_tpu_torch.testing import rawstream
from vorbispizza_tpu_torch.testing.streams import make_streams

TOL = 2e-6
FLOOR0_REL = 2e-4
FLOOR0_RANGE = 1e4
FLOOR0_TOL = 5e-4
FALLBACK = {"floor1_wire": "posts", "residue_transport": "values"}


def configure(mp, **settings):
    """Set ``settings`` on both packages' VorbisConfig.default (each
    package reads only its own) through the monkeypatch ``mp``."""
    for cfg in (VorbisConfig.default, JaxConfig.default):
        for k, v in settings.items():
            mp.setattr(cfg, k, v)


def wire(srcs, pads=None, **settings):
    """(synth, sig, CPU tensors of the nine host arrays) of one merged
    chunk of ``srcs`` under ``settings``; ``pads`` maps each bucket key
    to extra pads (the wire dtypes to force)."""
    with pytest.MonkeyPatch.context() as mp:
        configure(mp, **settings)
        fronts = [torch_corpus._front_end(s) for s in srcs]
        synth = torch_corpus._synthesizer_for(fronts[0][0], fronts[0][1])
        for f in fronts:
            synth.add_setup(f[0])
        plan, buckets, _ = torch_corpus.merge_streams([f[2:4] for f in fronts])
        full = None
        if pads:
            full = {(k, b.key): v for b in buckets for k, v in pads.items()}
        sig, host, _ = synth.prepare_host(plan, buckets, "f32", pads=full)
    return synth, sig, [torch.from_numpy(a) for a in host]


def step2_jax(s2b, P):
    """models/pipeline.py:737-741: the packed step2 bits, LSB-first."""
    s2b = jnp.asarray(s2b)
    return ((jnp.repeat(s2b, 8, axis=-1)[..., :P]
             >> (jnp.arange(P, dtype=jnp.uint8) % 8)) & 1).astype(bool)


@pytest.mark.parametrize("group", ["stereo", "oddbooks", "values"])
def test_floor1_posts_bit_exact(group):
    """K2's posts twin against JAX floor1_curves on the posts wire, and
    against the coded-ys wire's curves of the same streams."""
    srcs = list(make_streams(group))
    synth, sig, bufs = wire(srcs, floor1_wire="posts")
    ysynth, ysig, ybufs = wire(srcs)
    n = 0
    for bk, ybk in zip(synth.buckets(sig, bufs), ysynth.buckets(ysig, ybufs)):
        calls = synth.floor_calls(bk)
        ycalls = ysynth.floor_calls(ybk)
        for (ch, w, args), (_, yw, yargs) in zip(calls, ycalls):
            assert w == "posts"
            posts, s2b, used, tab, ab, P, mult, half = args
            meta = [m for m in bk["metas"] if list(m["channels"]) == ch][0]
            G = used.numel()
            got = floor.floor1_from_posts(*args).numpy()
            want = np.asarray(floor1_curves(
                jnp.asarray(posts.numpy().reshape(G, P).astype(np.int32)),
                step2_jax(s2b.numpy().reshape(G, -1), P),
                jnp.asarray(used.numpy().reshape(G).astype(bool)),
                xs=meta["xs"], multiplier=mult, half=half,
            ))
            assert np.array_equal(got, want)
            if yw == "ys":
                assert np.array_equal(got, floor.floor1_from_ys(*yargs).numpy())
            n += int(used.sum())
    assert n > 0


def jax_gather(packed, gmap, ptag, gtag, shape):
    """models/pipeline.py:789-804 on the same wire."""
    g = jnp.asarray(gmap.numpy())
    if gtag == "u16":
        g = jax.lax.bitcast_convert_type(g, jnp.uint16).astype(jnp.int32)
    res = (jnp.take(jnp.asarray(packed.numpy()), g, axis=0).reshape(shape)
           .astype(jnp.float32))
    return np.asarray(res - 128.0 if ptag == "u8b" else res)


#: row type -> a stream group whose residues ship as that type under
#: value transport: floor0's residues are -1..1, the encoder's are
#: integers up to a few hundred, the "values" group's are not integers
PTAG_GROUPS = {"u8b": "floor0", "i16": "stereo", "f32": "values"}


@pytest.mark.parametrize("gtag", ["u16", "i32"])
@pytest.mark.parametrize("ptag", ["u8b", "i16", "f32"])
def test_residue_gather_bit_exact(ptag, gtag):
    """K9's twin against the JAX gather for every row type, on streams
    whose residues ship as it or narrower (raised through ``pads``), and
    both map types (i32 forced through ``pads``); and the same residues as
    the symbol wire's, or as the natural wire's."""
    srcs = list(make_streams(PTAG_GROUPS[ptag]))
    synth, sig, bufs = wire(srcs, pads={"ptag": ptag, "gtag": gtag},
                            residue_transport="values")
    nat, nsig, nbufs = wire(srcs)
    n = 0
    for bk, nbk in zip(synth.buckets(sig, bufs), nat.buckets(nsig, nbufs)):
        args = synth.value_call(bk)
        assert args[2:4] == (ptag, gtag)
        got = residue_values.residue_gather(*args)
        assert got.dtype == torch.float32
        want = jax_gather(*args)
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(got, nat.residues(nbk))
        n += int(np.count_nonzero(want))
    assert n > 0


def test_residue_gather_u16_reads_unsigned():
    """A u16 row number past 32767 rides the int16 buffer as a negative
    value; it must be read unsigned, as the JAX gather reads it. A row
    past the packed rows is refused."""
    rng = np.random.default_rng(7)
    Kp = 40000
    packed = torch.from_numpy(rng.integers(0, 256, (Kp, 32), dtype=np.uint8))
    rows = np.array([0, 1, 32767, 32768, 39999, 12345, 20000, 39998],
                    dtype=np.uint16)
    gmap = torch.from_numpy(rows.view(np.int16))
    got = residue_values.residue_gather(packed, gmap, "u8b", "u16",
                                        (2, 1, 128))
    assert np.array_equal(got.numpy(),
                          jax_gather(packed, gmap, "u8b", "u16", (2, 1, 128)))
    assert np.array_equal(got.numpy().reshape(8, 32),
                          packed.numpy()[rows].astype(np.float32) - 128)
    past = torch.from_numpy(np.array([Kp], dtype=np.uint16).view(np.int16))
    with pytest.raises(IndexError):
        residue_values.residue_gather(packed, past, "u8b", "u16", (1, 1, 32))


def make_floor0(order, rate=8000, bark_map_size=128, amplitude_bits=6,
                amplitude_offset=160, blocksizes=(256, 2048)):
    """A floor0 config without a bitstream (tests/test_floor0_device.py)."""
    f = object.__new__(Floor0)
    f.order, f.rate, f.bark_map_size = order, rate, bark_map_size
    f.amplitude_bits, f.amplitude_offset = amplitude_bits, amplitude_offset
    f.books, f._book_bits = [], 1
    f._maps = {n: f._bark_map(n) for n in blocksizes}
    return f


@pytest.mark.parametrize("order", [4, 9, 24])
@pytest.mark.parametrize("n", [256, 2048])
def test_floor0_twin_matches_jax(order, n):
    """K8's twin against JAX floor0_curves on the same random LSP rows."""
    fl = make_floor0(order)
    rng = np.random.default_rng(order * 1000 + n)
    G = 7
    gaps = rng.uniform(0.3, 1.0, size=(G, order + 1))
    coeffs = (np.cumsum(gaps, axis=1)[:, :-1]
              / np.sum(gaps, axis=1, keepdims=True) * (np.pi - 0.2)
              + 0.1).astype(np.float32)
    amp = rng.integers(1, 64, size=G).astype(np.int32)
    used = np.ones(G, dtype=np.uint8)
    used[3] = 0
    tab = torch.from_numpy(floor.floor0_tables(fl._maps[n], fl.bark_map_size,
                                               order))
    got = floor.floor0_curves(
        torch.from_numpy(coeffs), torch.from_numpy(amp),
        torch.from_numpy(used), tab, order, fl.amplitude_bits,
        fl.amplitude_offset).numpy()
    want = np.asarray(jax_floor0_curves(
        coeffs, amp, used.astype(bool), order=order,
        bark_map=tuple(int(v) for v in fl._maps[n]),
        bark_map_size=fl.bark_map_size, amplitude_bits=fl.amplitude_bits,
        amplitude_offset=fl.amplitude_offset))
    assert got.shape == want.shape == (G, n // 2)
    assert np.isfinite(got).all() and not got[3].any()
    ok = np.abs(want) < FLOOR0_RANGE
    rel = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1e-6)
    assert rel.max() <= FLOOR0_REL


def test_floor0_tables_match_reference_constants():
    """cos_w made in float64 then cast; the tails in float32 from it."""
    fl = make_floor0(5)
    m = fl._maps[256].astype(np.float64)
    cos_w = np.cos(np.pi * m / fl.bark_map_size).astype(np.float32)
    odd = floor.floor0_tables(fl._maps[256], fl.bark_map_size, 5)
    even = floor.floor0_tables(fl._maps[256], fl.bark_map_size, 4)
    assert odd.dtype == np.float32 and odd.shape == (3, 128)
    assert np.array_equal(odd[0], cos_w) and np.array_equal(even[0], cos_w)
    assert np.array_equal(odd[1], np.float32(1) - cos_w * cos_w)
    assert np.all(odd[2] == np.float32(0.25))
    assert np.array_equal(even[1], (np.float32(1) - cos_w) * np.float32(0.5))
    assert np.array_equal(even[2], (np.float32(1) + cos_w) * np.float32(0.5))


@pytest.fixture(scope="module")
def music():
    """Stereo, mono and 5.1 encoder streams plus the odd-books raw one."""
    return [s for g in ("stereo", "mono", "surround", "oddbooks")
            for s in make_streams(g)]


def test_fallback_config_decodes_alike(music, monkeypatch):
    """decode_corpus under floor1_wire="posts" + residue_transport="values":
    every stream batched, on both fallback wires, bit-equal to the default
    config's f32 and int16; the stereo streams within TOL of JAX
    decode_corpus under the same config (one JAX chunk keeps its compile
    time down)."""
    base = decode_corpus(music, device="cpu")
    base16 = decode_corpus(music, device="cpu", output="s16")
    stereo = list(make_streams("stereo"))
    synth, sig, _ = wire(stereo, **FALLBACK)
    assert all(pn[2] != "sym" for pn in sig[1])
    assert all("wire" not in dict(m) for _, metas in sig[0] for m in metas)
    configure(monkeypatch, **FALLBACK)
    got = decode_corpus(music, device="cpu")
    got16 = decode_corpus(music, device="cpu", output="s16")
    want = jax_decode_corpus(stereo, output="f32")
    assert got.stats["batched"] == len(music) and not got.stats["scalar"]
    for g, b in zip(got, base):
        assert np.array_equal(g, b)
    for g, w in zip(got, want):  # the stereo streams come first
        assert g.shape == w.shape and np.abs(g - w).max() <= TOL
    for g, b in zip(got16, base16):
        assert np.array_equal(g, b)


def anchor(data):
    r = VorbisReader(data)
    r.initialize()
    return r.read_all(planar=True)


@pytest.mark.parametrize("n_packets", [None, 24])
def test_floor0_stream_decodes(n_packets, monkeypatch):
    """A floor0 raw stream (the JAX fixture's defaults, then 24 packets)
    within FLOOR0_TOL of JAX decode_corpus and of the float64 anchor; the
    value-transport wire bit-equal to the symbol wire's."""
    kw = {} if n_packets is None else {"n_packets": n_packets}
    srcs = [rawstream.make_floor0_stream(**kw)]
    got = decode_corpus(srcs, device="cpu")
    assert got.stats["batched"] == 1 and not got.stats["scalar"]
    want = jax_decode_corpus(srcs, output="f32")
    ref = anchor(srcs[0])
    assert got[0].shape == want[0].shape == ref.shape
    assert np.abs(got[0] - want[0]).max() <= FLOOR0_TOL
    assert np.abs(got[0].astype(np.float64) - ref).max() <= FLOOR0_TOL
    configure(monkeypatch, residue_transport="values")
    vals = decode_corpus(srcs, device="cpu")
    synth, sig, _ = wire(srcs)
    assert sig[1][0][2] != "sym"
    assert np.array_equal(vals[0], got[0])


def test_floor0_corpus_member():
    """Member 0 of the floor0 corpus matches its recorded sha256, decodes
    on the batch path and is within the 2-LSB budget of the anchor."""
    import hashlib

    from vorbispizza_tpu_torch.testing import floor0_32

    data = floor0_32.member(0)
    assert hashlib.sha256(data).hexdigest() == floor0_32.SHA256[0]
    assert len(floor0_32.SHA256) == floor0_32.RECIPE["streams"] == 32
    got = decode_corpus([data], device="cpu", output="s16")
    assert got.stats["batched"] == 1
    ref = np.clip(np.rint(anchor(data) * 32768.0), -32768, 32767)
    diff = np.abs(got[0].astype(np.int64) - ref)
    assert got[0].shape[1] == 128 * (floor0_32.RECIPE["n_packets"] - 1)
    assert (diff > 2).mean() <= 1e-3


def test_floor0_worst_member_is_float32_rounding(monkeypatch):
    """Member 14 of the floor0 corpus is the one furthest from the float64
    anchor. The JAX package's own CPU decode misses the anchor at the same
    sample by the same order, and the two packages' float32 curves of the
    frames that overlap there agree within FLOOR0_REL on every bin, the
    curve's peak (over FLOOR0_RANGE) included: the miss is float32 LSP
    synthesis, not the port. ``pytest -s`` prints the numbers."""
    from vorbispizza_tpu_torch.testing import floor0_32

    seen = []
    unpack = Floor0.unpack

    def record(self, br):
        seen.append((self, unpack(self, br)))
        return seen[-1][1]

    data = floor0_32.member(14)
    monkeypatch.setattr(Floor0, "unpack", record)
    r = PortReader(data)  # the port's anchor: its Floor0 is recorded
    r.initialize()
    ref = r.read_all(planar=True)
    monkeypatch.undo()
    got = decode_corpus([data], device="cpu")[0]
    want = jax_decode_corpus([data], output="f32")[0]
    err_port = np.abs(got.astype(np.float64) - ref)
    err_jax = np.abs(want.astype(np.float64) - ref)
    at = int(err_port.argmax())
    print(f"\nmember 14: port max abs {err_port.max():.4e} at sample {at}; "
          f"JAX max abs {err_jax.max():.4e} at sample {int(err_jax.argmax())}")
    assert int(err_jax.argmax()) == at
    assert err_jax.max() > 1e-2 and err_port.max() < 10 * err_jax.max()
    fl = seen[0][0]
    half = fl._maps[256].shape[0]
    tab = torch.from_numpy(floor.floor0_tables(fl._maps[256], fl.bark_map_size,
                                               fl.order))
    peak = 0.0
    for k in (at // half, at // half + 1):  # the two frames that overlap
        fd = seen[k][1]
        c = fd.coefficients[None]
        amp = np.array([fd.amplitude], dtype=np.int32)
        port = floor.floor0_curves(
            torch.from_numpy(c), torch.from_numpy(amp),
            torch.ones(1, dtype=torch.uint8), tab, fl.order,
            fl.amplitude_bits, fl.amplitude_offset).numpy()[0]
        jax_c = np.asarray(jax_floor0_curves(
            c, amp, np.ones(1, dtype=bool), order=fl.order,
            bark_map=tuple(int(v) for v in fl._maps[256]),
            bark_map_size=fl.bark_map_size, amplitude_bits=fl.amplitude_bits,
            amplitude_offset=fl.amplitude_offset))[0]
        f64 = fl.synthesize(fd, 256)
        rel = np.abs(port - jax_c) / np.abs(jax_c)
        print(f"frame {k}: curve peak {f64.max():.4e}; port-JAX relative "
              f"{rel.max():.3e}; port-f64 "
              f"{(np.abs(port - f64) / f64).max():.3e}; JAX-f64 "
              f"{(np.abs(jax_c - f64) / f64).max():.3e}")
        assert rel.max() <= FLOOR0_REL
        peak = max(peak, f64.max())
    assert peak > FLOOR0_RANGE
