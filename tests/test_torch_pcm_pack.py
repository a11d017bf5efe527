"""PyTorch port, the dpack s16 wire on the CPU (ops/pcm_pack.py): the port's
wire against the JAX package's pack_pcm for the same int32 q, byte for
byte in every field below nbytes (bytes past nbytes are not part of the
wire: the reference's compaction reads other columns there), in both rice
modes and under the full, soft and a truncating capacity; the quantize,
the partner table, both unpackers, the link probe and the wire checks.

The q cases are made from a numpy seed, apart from the decoded music,
which is the port's own f32 decode of the stereo test streams, quantized.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorbispizza_tpu.decoder import CLIP_MAX
from vorbispizza_tpu.ops import pcm_pack as ref
from vorbispizza_tpu_torch import decode_corpus
from vorbispizza_tpu_torch.config import VorbisConfig
from vorbispizza_tpu_torch.models.pipeline import BatchSynthesizer
from vorbispizza_tpu_torch.ops import pcm_pack as pp
from vorbispizza_tpu_torch.testing.streams import make_streams
from vorbispizza_tpu_torch.utils import link


def tone(C, L, seed, noise=40.0):
    """Correlated tones with a little noise: smooth, d3- and inter-
    friendly content (channel c is a scaled, phase-shifted copy)."""
    rng = np.random.default_rng(seed)
    t = np.arange(L, dtype=np.float64)
    base = 9000 * np.sin(2 * np.pi * 220 * t / 44100) + 3000 * np.sin(
        2 * np.pi * 663 * t / 44100)
    chans = [(1 - 0.1 * c) * base + noise * rng.standard_normal(L)
             for c in range(C)]
    return np.stack(chans).round().clip(-32768, 32767).astype(np.int32)


def make_q(case):
    rng = np.random.default_rng(7)
    if case == "silence":
        return np.zeros((2, 300), dtype=np.int32)
    if case == "music":
        pcm = decode_corpus(list(make_streams("stereo"))[:1], device="cpu")[0]
        q = np.clip(np.rint(pcm * np.float32(32768.0)), -32768, 32767)
        return q[:, :6000].astype(np.int32)
    if case == "noise":  # full scale: width 18, and rice where it wins
        return rng.integers(-32768, 32768, size=(2, 700)).astype(np.int32)
    if case == "square":  # clipped square wave: rails and steps
        t = np.arange(1000)
        sq = np.where((t // 37) % 2 == 0, 40000, -40000)
        return np.stack([sq, -sq // 3]).clip(-32768, 32767).astype(np.int32)
    if case.startswith("ch"):
        return tone(int(case[2:]), 1000 + int(case[2:]), seed=int(case[2:]))
    raise KeyError(case)


CASES = ["silence", "music", "noise", "square", "ch1", "ch2", "ch3", "ch5",
         "ch6", "ch7", "ch8"]

_Q: dict = {}


def q_of(case):
    if case not in _Q:
        _Q[case] = make_q(case)
    return _Q[case]


def caps_of(nbt, cap):
    if cap == "trunc":  # half a 16-byte group and 4 unary words a block
        return nbt // 2, 4 * nbt, pp.UNARY_ROW_WORDS_SOFT
    return pp.wire_caps(nbt, cap == "full")


def sections(payload, nb_plane, ub, cap, ucap):
    """The wire bytes that carry data: the kept plane section, then the
    kept unary section where the reference places it."""
    plane = min(nb_plane, 16 * cap)
    start = min(nb_plane, 16 * cap)
    return payload[:plane], payload[start : start + min(ub, 4 * ucap)]


@pytest.mark.parametrize("rice", [False, True])
@pytest.mark.parametrize(
    "case,cap",
    [(c, "soft") for c in CASES]
    + [(c, "full") for c in ("music", "noise", "square", "ch1", "ch8")]
    + [("noise", "trunc"), ("music", "trunc")],
)
def test_wire_matches_pack_pcm(case, cap, rice):
    q = q_of(case)
    C, L = q.shape
    nbt = pp.wire_rows(L, C)
    cap_g, cap_u, urow = caps_of(nbt, cap)
    payload, nbytes, widx, cuts = jax.jit(
        lambda a: ref.pack_pcm(a, cap_g, cap_u, urow, rice=rice)
    )(jnp.asarray(q))
    payload, widx, cuts = map(np.asarray, (payload, widx, cuts))
    wire = pp.dpack_wire(torch.from_numpy(q), cap_g, cap_u, urow, rice)
    assert wire.dtype == torch.uint8
    w = wire.numpy()
    assert w.shape[0] == pp.wire_bytes(C, nbt, cap_g, cap_u, rice)
    nb, plane_cap, got_cuts, got_widx = pp.parse_header(w, nbt, C)
    assert nb == int(nbytes)
    assert plane_cap == 16 * cap_g
    assert np.array_equal(got_widx, widx)
    assert np.array_equal(got_cuts, cuts)
    if not rice:
        assert not (got_widx & 0x80).any() and not got_cuts.any()
    got_pay = w[pp.wire_header_bytes(C) + nbt :]
    assert got_pay.shape == payload.shape
    if nb == pp.ROW_OVER_NBYTES:
        return  # a block's unary row overflowed: only the header counts
    nb_plane = pp.plane_bytes_of(widx)
    ub = 4 * ((int(cuts[-1]) + 31) // 32)
    assert nb == nb_plane + ub
    for g, r in zip(sections(got_pay, nb_plane, ub, cap_g, cap_u),
                    sections(payload, nb_plane, ub, cap_g, cap_u)):
        assert np.array_equal(g, r)
    if cap == "trunc":
        assert nb_plane > 16 * cap_g  # the case really truncates
    else:
        assert np.array_equal(got_pay[:nb], payload[:nb])


@pytest.mark.parametrize("rice", [False, True])
@pytest.mark.parametrize("case", ["music", "noise", "ch1", "ch5", "ch8"])
def test_select_candidate_matches_reference(case, rice):
    q = q_of(case)
    got = pp.select_candidate_plain(torch.from_numpy(q), rice)
    want = jax.jit(lambda a: ref.select_candidate(a, rice=rice))(
        jnp.asarray(q))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))
    wbyte, ubits = pp.dpack_select_plain(torch.from_numpy(q), rice)
    assert np.array_equal(wbyte.numpy(), (np.asarray(want[1])
                                          | np.asarray(want[2])).astype(np.uint8))
    assert np.array_equal(ubits.numpy(), np.asarray(want[3]).sum(axis=1))


def test_quantize_matches_reference():
    ties = (np.arange(-6, 6) + 0.5) / 32768.0  # half-LSB ties
    x = np.concatenate([
        [CLIP_MAX, -CLIP_MAX, 1.0, -1.0, 1.5, -1.5, 0.0, -0.0],
        ties, -ties,
        np.random.default_rng(3).uniform(-1.2, 1.2, 4000),
    ]).astype(np.float32)
    clipped = jnp.clip(jnp.asarray(x), -CLIP_MAX, CLIP_MAX)
    want = jnp.clip(jnp.round(clipped * 32768.0), -32768.0, 32767.0).astype(
        jnp.int32)
    got = pp.quantize_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[:6].tolist() == [32767, -32768, 32767, -32768, 32767, -32768]
    u = (np.asarray(want) + 32768).astype(np.uint32)
    planes = np.stack([u & 0xFF, u >> 8]).astype(np.uint8)
    assert np.array_equal(pp.planes_plain(got).numpy(), planes)


@pytest.mark.parametrize("C", range(1, 10))
def test_pair_partner_matches_reference(C):
    assert np.array_equal(pp.pair_partner(C), ref.pair_partner(C))


def test_constants_match_reference():
    for name in ("WIDTHS", "BLOCK", "WORDS", "RICE_K_IDX", "G_PER",
                 "SOFT_GROUPS_PER_BLOCK", "UNARY_WORDS_FULL_PER_BLOCK",
                 "UNARY_ROW_WORDS_SOFT", "SOFT_UNARY_WORDS_PER_BLOCK"):
        assert getattr(pp, name) == getattr(ref, name), name
    for C in (1, 2, 6):
        assert pp.wire_header_bytes(C) == ref.wire_header_bytes(C)
        assert pp.wire_rows(1000, C) == ref.wire_rows(1000, C)
    widx = np.arange(len(pp.WIDTHS), dtype=np.uint8) | 0xE0
    assert pp.plane_bytes_of(widx) == ref.plane_bytes_of(widx)


@pytest.mark.parametrize("rice", [False, True])
@pytest.mark.parametrize("case", ["music", "noise", "square", "ch3", "ch8"])
def test_unpack_roundtrip(case, rice):
    """The port's wire unpacks to q exactly through both unpackers."""
    q = q_of(case)
    C, L = q.shape
    nbt = pp.wire_rows(L, C)
    cap_g, cap_u, urow = pp.wire_caps(nbt, True)
    w = pp.dpack_wire(torch.from_numpy(q), cap_g, cap_u, urow, rice).numpy()
    nb, plane_cap, cuts, widx = pp.parse_header(w, nbt, C)
    head = pp.wire_header_bytes(C) + nbt
    pp.check_sections(nb, plane_cap, cuts, widx, w.shape[0] - head)
    data = w[head : head + nb]
    assert np.array_equal(pp.unpack_pcm(data, widx, C, L, cuts), q)
    assert np.array_equal(pp._unpack_pcm_numpy(data, widx, C, L, cuts), q)


def rice_wire():
    q = tone(1, 20_000, seed=1, noise=0.0)
    nbt = pp.wire_rows(q.shape[1], 1)
    w = pp.dpack_wire(torch.from_numpy(q), *pp.wire_caps(nbt, True),
                      rice=True).numpy()
    nb, _, cuts, widx = pp.parse_header(w, nbt, 1)
    head = pp.wire_header_bytes(1) + nbt
    assert (widx >> 7).any(), "content must pick rice blocks"
    return q, w[head : head + nb].copy(), widx.copy(), cuts


def malformed(kind):
    """(payload, widx, C, L, ch_ubit) of a wire broken one way."""
    L, C = 4 * pp.BLOCK, 2
    empty = np.zeros(0, dtype=np.uint8)
    if kind == "short":
        return empty, np.zeros(C * 3, dtype=np.uint8), C, L, None
    if kind == "width-class":
        widx = np.zeros(C * 4, dtype=np.uint8)
        widx[1] = len(pp.WIDTHS)
        return empty, widx, C, L, None
    if kind == "geometry":
        return empty, np.zeros(C * 4 + 1, dtype=np.uint8), C, L, None
    q, data, widx, cuts = rice_wire()
    L = q.shape[1]
    if kind == "no-cuts":
        return data, widx, 1, L, None
    plane = pp.plane_bytes_of(widx)
    if kind == "unary-byte":
        bad = data.copy()
        bad[plane + int(np.flatnonzero(data[plane:])[0])] = 0
        return bad, widx, 1, L, cuts
    if kind == "unary-truncated":
        return data[: plane + 4], widx, 1, L, cuts
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["short", "width-class", "geometry",
                                  "no-cuts", "unary-byte", "unary-truncated"])
@pytest.mark.parametrize("unpacker", ["unpack_pcm", "_unpack_pcm_numpy"])
def test_malformed_wire_raises(kind, unpacker):
    with pytest.raises(ValueError):
        getattr(pp, unpacker)(*malformed(kind))


def test_header_checks_raise():
    q, data, widx, cuts = rice_wire()
    nb = data.shape[0]
    plane = pp.plane_bytes_of(widx)
    h = np.zeros(pp.wire_header_bytes(1) + widx.size, dtype=np.uint8)
    h[:4] = np.array([nb], np.int32).view(np.uint8)
    h[4:8] = np.array([plane], np.uint32).view(np.uint8)
    h[8:12] = cuts.view(np.uint8)
    h[12:] = widx
    got = pp.parse_header(h, widx.size, 1)
    assert got[0] == nb and got[1] == plane
    assert pp.check_sections(*got, payload_cap=nb) == (plane, nb - plane)
    with pytest.raises(ValueError, match="needs"):
        pp.parse_header(h[:-1], widx.size, 1)
    with pytest.raises(ValueError, match="size mismatch"):
        pp.check_sections(nb + 4, plane, cuts, widx, payload_cap=2 * nb)
    with pytest.raises(pp.PackOverflow, match="plane"):
        pp.check_sections(nb, plane - 16, cuts, widx, payload_cap=2 * nb)
    with pytest.raises(pp.PackOverflow, match="unary"):
        pp.check_sections(nb, plane, cuts, widx, payload_cap=nb - 4)
    h2 = np.zeros(pp.wire_header_bytes(2) + 2 * widx.size, dtype=np.uint8)
    h2[8:16] = np.array([64, 32], np.uint32).view(np.uint8)
    with pytest.raises(ValueError, match="monotonic"):
        pp.parse_header(h2, 2 * widx.size, 2)


def test_cuda_wrappers_refuse_cpu_tensors():
    """K6 and K7 have no twin behind their wrappers: a CPU tensor raises."""
    q = torch.zeros((1, 256), dtype=torch.int16)
    wbyte, ubits = pp.dpack_select(q, True)  # CPU: the twin
    scan = pp.dpack_scan(wbyte, ubits, pp.UNARY_ROW_WORDS_SOFT, True, 1)
    wire = torch.zeros(pp.wire_bytes(1, 2, 36, 144, True), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        pp.dpack_pack(q, wire, ubits, 36, pp.UNARY_ROW_WORDS_SOFT, True)
    with pytest.raises(ValueError, match="CUDA"):
        pp.dpack_unary(q, wire, scan, 36, 144, 72)


def test_link_rate_and_rice_resolution(monkeypatch):
    monkeypatch.setattr(link, "_cached", {})
    assert link.d2h_rate_estimate("cpu") == float("inf")
    cfg = VorbisConfig.default
    monkeypatch.setattr(cfg, "s16_rice", "auto")
    assert BatchSynthesizer._resolve_rice("cpu") is False
    link.d2h_rate_estimate("cuda:0", force=30e6)  # tunnel-class link
    assert BatchSynthesizer._resolve_rice("cuda:0") is True
    link.d2h_rate_estimate("cuda:0", force=20e9)  # PCIe-class link
    assert BatchSynthesizer._resolve_rice("cuda:0") is False
    monkeypatch.setattr(cfg, "s16_rice", "on")
    assert BatchSynthesizer._resolve_rice("cpu") is True
    monkeypatch.setattr(cfg, "s16_rice", "off")
    assert BatchSynthesizer._resolve_rice("cuda:0") is False


def test_link_probe_failure_raises(monkeypatch):
    """A probe that cannot run raises and caches nothing (no 0.0 rate that
    would force rice for the rest of the process)."""
    monkeypatch.setattr(link, "_cached", {})
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the probe would run")
    with pytest.raises((RuntimeError, AssertionError)):
        link.d2h_rate_estimate("cuda:0")
    assert link._cached == {}
