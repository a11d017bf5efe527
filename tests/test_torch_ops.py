"""PyTorch port, device stages on the CPU: every stage that holds a kernel
(its wrapper runs the plain twin for CPU tensors) against the JAX package's
stage on the same wire.

Tolerances: residues, coupling inputs (floor curves, unwrap posts/step2)
and spectra are integer arithmetic or single float32 roundings in the
same order as the reference, so they must match BIT FOR BIT; the IMDCT is
a float32 matrix product whose summation order differs between the two
CPU backends, held to 2e-6 (the CPU allowance of the JAX package's own
tests); the OLA is a pure selection given the same windowed frames, so it
matches bit for bit, and so do its s16 quantization and the dpack wire of
the same PCM."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorbispizza_tpu.decoder import CLIP_MAX
from vorbispizza_tpu.ops.coupling import inverse_couple_batch
from vorbispizza_tpu.ops.floor import floor0_curves as jax_floor0_curves
from vorbispizza_tpu.ops.floor import floor1_curves, floor1_unwrap
from vorbispizza_tpu.ops.imdct import imdct_window_batch
from vorbispizza_tpu.ops.ola import block_assemble_wide
from vorbispizza_tpu.ops.pcm_pack import pack_pcm
from vorbispizza_tpu.ops.residue_sym import expand_submap as jax_expand_submap
from vorbispizza_tpu.ops.residue_sym import unpack_bits as jax_unpack_bits
from vorbispizza_tpu_torch.models import corpus as torch_corpus
from vorbispizza_tpu_torch.ops import (
    coupling,
    floor,
    imdct,
    ola,
    pcm_pack,
    residue_sym,
)
from vorbispizza_tpu_torch.testing.streams import make_streams

IMDCT_TOL = 2e-6
#: floor0 against the JAX package's floor0_curves, relative where |curve|
#: < FLOOR0_RANGE (the bound of tests/test_floor0_device.py): the two
#: backends' cos/exp differ by a few ulp
FLOOR0_REL = 2e-4
FLOOR0_RANGE = 1e4


def wire(group):
    """(synth, sig, CPU tensors of the nine host arrays, buckets) of one
    merged chunk of the group's streams."""
    srcs = make_streams(group)
    fronts = [torch_corpus._front_end(s) for s in srcs]
    synth = torch_corpus._synthesizer_for(fronts[0][0], fronts[0][1])
    for f in fronts:
        synth.add_setup(f[0])
    plan, buckets, _ = torch_corpus.merge_streams([f[2:4] for f in fronts])
    sig, host, _total = synth.prepare_host(plan, buckets, "f32")
    bufs = [torch.from_numpy(a) for a in host]
    return synth, sig, bufs, buckets


@pytest.fixture(scope="module")
def stereo():
    return wire("stereo")


def np_(t):
    return t.numpy()


def test_unpack_bits_matches_reference():
    rng = np.random.default_rng(0)
    for w in (1, 3, 8, 11, 17):
        vals = rng.integers(0, 1 << w, size=97)
        packed = residue_sym.pack_bits(vals, w)
        got = residue_sym.unpack_bits(torch.from_numpy(packed), w, 97)
        want = np.asarray(jax_unpack_bits(jnp.asarray(packed), w, 97))
        assert np.array_equal(got.numpy(), vals)
        assert np.array_equal(got.numpy(), want)


def residues_both(synth, bk):
    """[(port, reference)] residue vectors per coded submap of a bucket:
    the port's per-submap reference form, and K1's bucket twin (what the
    wrapper runs for CPU tensors) at the submap's channels."""
    out = []
    bucket = synth.residues(bk)
    for ch, args in synth.residue_calls(bk):
        if args is None:
            continue
        sub_sig, syms, idx, vqs, Fp = args
        got = residue_sym.expand_submap_plain(*args)
        assert torch.equal(bucket[:, ch], got)
        # one jitted program per submap (op-by-op dispatch is far slower)
        want = jax.jit(
            lambda s, x: jax_expand_submap(sub_sig, s, x,
                                           [np_(v) for v in vqs], Fp)
        )([jnp.asarray(np_(s)) for s in syms], [jnp.asarray(np_(x)) for x in idx])
        out.append((got, np.asarray(want)))
    return out


@pytest.mark.parametrize("group", ["stereo", "surround", "oddbooks"])
def test_residues_bit_exact(group, stereo):
    synth, sig, bufs, _ = stereo if group == "stereo" else wire(group)
    n = 0
    for bk in synth.buckets(sig, bufs):
        for got, want in residues_both(synth, bk):
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy(), want)
            n += 1
    assert n > 0


def floor0_rel_err(got, want):
    """Largest relative difference where |want| < FLOOR0_RANGE."""
    ok = np.abs(want) < FLOOR0_RANGE
    return float(np.max(np.abs(got[ok] - want[ok])
                        / np.maximum(np.abs(want[ok]), 1e-6), initial=0.0))


def test_residues_format0_bit_exact():
    """The floor0 raw stream's residue-0 submap (format 0: strided
    symbols), bit for bit; its floor0 curves against the JAX package's
    floor0_curves, within FLOOR0_REL."""
    synth, sig, bufs, _ = wire("floor0")
    n = n_floor0 = 0
    for bk in synth.buckets(sig, bufs):
        assert sig[1][0][2] == "sym"
        for got, want in residues_both(synth, bk):
            assert np.array_equal(got.numpy(), want)
            n += int(np.count_nonzero(want))
        for ch, w, args in synth.floor_calls(bk):
            assert w == "floor0"
            coeffs, amp, used, tab, order, bits, off = args
            meta = [m for m in bk["metas"] if list(m["channels"]) == ch][0]
            got = floor.floor0_curves(*args).numpy()
            want = np.asarray(jax_floor0_curves(
                jnp.asarray(coeffs.numpy().reshape(-1, order)),
                jnp.asarray(amp.numpy().reshape(-1)),
                jnp.asarray(used.numpy().reshape(-1).astype(bool)),
                order=order, bark_map=meta["bark_map"],
                bark_map_size=meta["bark_map_size"], amplitude_bits=bits,
                amplitude_offset=off,
            ))
            assert got.shape == want.shape and np.isfinite(got).all()
            assert floor0_rel_err(got, want) <= FLOOR0_REL
            n_floor0 += int(used.sum())
    assert n > 0 and n_floor0 > 0


def floors_both(synth, bk, buckets):
    """Per floor group: port stages and the reference's on the same wire."""
    out = []
    for ch, w, args in synth.floor_calls(bk):
        assert w == "ys"
        ys01, ysmask, ysnz, used, tab, ab, P, mult, half, _lev = args
        meta = [m for m in bk["metas"] if list(m["channels"]) == ch][0]
        ys = floor.rebuild_ys(ys01, ysmask, ysnz, P)
        posts, step2 = floor.floor1_unwrap_plain(ys, tab, P, mult)
        jposts, jstep2 = floor1_unwrap(
            jnp.asarray(ys.numpy().astype(np.int32)), xs=meta["xs"],
            multiplier=mult,
        )
        curves = floor.floor1_curves_plain(posts, step2, used, tab, ab, P,
                                           mult, half)
        jcurves = floor1_curves(
            jposts, jstep2, jnp.asarray(used.numpy().reshape(-1).astype(bool)),
            xs=meta["xs"], multiplier=mult, half=half,
        )
        fused = floor.floor1_from_ys(*args)
        out.append(dict(ch=ch, ys=ys, posts=posts, step2=step2,
                        jposts=np.asarray(jposts), jstep2=np.asarray(jstep2),
                        curves=curves, jcurves=np.asarray(jcurves),
                        fused=fused))
    return out


@pytest.mark.parametrize("group", ["stereo", "surround", "oddbooks"])
def test_floor1_stages_bit_exact(group, stereo):
    synth, sig, bufs, buckets = stereo if group == "stereo" else wire(group)
    for bk, b in zip(synth.buckets(sig, bufs), buckets):
        for r in floors_both(synth, bk, buckets):
            # the rebuilt coded values are the front end's own
            g = [g for g in b.floor_groups if list(g.channels) == r["ch"]][0]
            F, nc, P = g.ys.shape
            ys = r["ys"].numpy().reshape(bk["Fp"], nc, P)
            assert np.array_equal(ys[:F], g.ys.astype(np.int64))
            assert not ys[F:].any()
            assert np.array_equal(r["posts"].numpy(), r["jposts"])
            assert np.array_equal(r["step2"].numpy(), r["jstep2"])
            assert np.array_equal(r["curves"].numpy(), r["jcurves"])
            assert np.array_equal(r["fused"].numpy(), r["jcurves"])


def stage_inputs(synth, bk):
    """Port residues and floors [Fp, C, half] of a bucket."""
    return synth.residues(bk), synth.floors(bk)


@pytest.mark.parametrize("group", ["stereo", "surround"])
def test_spectra_bit_exact(group, stereo):
    synth, sig, bufs, _ = stereo if group == "stereo" else wire(group)
    for bk in synth.buckets(sig, bufs):
        res, flo = stage_inputs(synth, bk)
        steps = bk["tables"]["steps"]
        got = coupling.couple_spectrum(res, flo, steps)
        want = np.asarray(
            inverse_couple_batch(jnp.asarray(res.numpy()),
                                 tuple(map(tuple, steps.tolist())))
        ) * flo.numpy()
        assert np.array_equal(got.numpy(), want)


def test_imdct_window_frames(stereo):
    """DCT-IV product + reflection + window + masks vs imdct_window_batch
    and the reference's prime/final masks."""
    synth, sig, bufs, _ = stereo
    worst = 0.0
    for bk in synth.buckets(sig, bufs):
        res, flo = stage_inputs(synth, bk)
        spectra = coupling.couple_spectrum(res, flo, bk["tables"]["steps"])
        d, window, prime, final = synth.ola_bucket(bk, synth.dct(bk, spectra))
        got = imdct.imdct_window(d, window, prime, final).numpy()
        n = bk["n"]
        frames = np.asarray(imdct_window_batch(jnp.asarray(spectra.numpy()),
                                               jnp.asarray(window.numpy())))
        j = np.arange(n)[None, :]
        pr = prime.numpy().astype(bool)[:, None]
        fi = final.numpy().astype(bool)[:, None]
        keep = np.where(pr, j >= n // 2, True) & np.where(fi, j < n // 2, True)
        want = frames * keep[:, None, :]
        worst = max(worst, float(np.abs(got - want).max()))
    assert worst <= IMDCT_TOL


def test_ola_bit_exact_given_flat(stereo):
    """expand_assemble (the twin of K4's selection) vs block_assemble_wide
    on the same windowed frames; and ola_assemble through its wrapper."""
    synth, sig, bufs, _ = stereo
    obks = []
    for bk in synth.buckets(sig, bufs):
        res, flo = stage_inputs(synth, bk)
        spectra = coupling.couple_spectrum(res, flo, bk["tables"]["steps"])
        obks.append(synth.ola_bucket(bk, synth.dct(bk, spectra)))
    flat = ola.flat_frames(obks)
    evs = bufs[4:9]
    L = sig[3]
    got = ola.expand_assemble(flat, evs, L)
    want = np.asarray(block_assemble_wide(
        jnp.asarray(flat.numpy()), tuple(jnp.asarray(e.numpy()) for e in evs), L
    ))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(ola.ola_assemble(obks, evs, L), got)


def test_forward_runs_every_stage(stereo):
    synth, sig, bufs, _ = stereo
    pcm = synth(sig, bufs)
    assert pcm.shape == (synth.channels, sig[3])
    assert pcm.dtype == torch.float32 and torch.isfinite(pcm).all()


def test_unported_outputs_raise(stereo):
    """Every output and wire runs now: an unknown output raises, and the
    value-transport residue wire gives the residues the JAX package's
    gather (pipeline.py:789-804) gives, bit for bit."""
    synth, sig, bufs, _ = stereo
    with pytest.raises(ValueError, match="s24"):
        synth((*sig[:5], "s24", True), bufs)
    vsynth, vsig, vbufs, _ = wire("values")
    n = 0
    for bk in vsynth.buckets(vsig, vbufs):
        packed, gmap, ptag, gtag, shape = vsynth.value_call(bk)
        g = jnp.asarray(gmap.numpy())
        if gtag == "u16":
            g = jax.lax.bitcast_convert_type(g, jnp.uint16).astype(jnp.int32)
        want = np.asarray(jnp.take(jnp.asarray(packed.numpy()), g, axis=0)
                          .reshape(shape).astype(jnp.float32))
        if ptag == "u8b":
            want = want - 128.0
        assert np.array_equal(vsynth.residues(bk).numpy(), want)
        n += int(np.count_nonzero(want))
    assert n > 0
    pcm = vsynth(vsig, vbufs)
    assert pcm.shape == (vsynth.channels, vsig[3])
    assert torch.isfinite(pcm).all()


def jax_quantize(pcm):
    """models/pipeline.py:819-826 (s16) and 883-889 (s16p planes)."""
    clipped = jnp.clip(jnp.asarray(pcm), -CLIP_MAX, CLIP_MAX)
    q = jnp.clip(jnp.round(clipped * 32768.0), -32768.0, 32767.0).astype(
        jnp.int32)
    u = (q + 32768).astype(jnp.uint32)
    planes = jnp.stack([(u & 0xFF).astype(jnp.uint8),
                        (u >> 8).astype(jnp.uint8)])
    return np.asarray(q.astype(jnp.int16)), np.asarray(planes)


@pytest.mark.parametrize("mode", ["s16", "s16p"])
def test_ola_quantize_modes(stereo, mode):
    """K4's s16/s16p modes (their twins on the CPU) are the reference's
    quantization of the f32 mode's PCM, bit for bit."""
    synth, sig, bufs, _ = stereo
    obks = []
    for bk in synth.buckets(sig, bufs):
        res, flo = stage_inputs(synth, bk)
        spectra = coupling.couple_spectrum(res, flo, bk["tables"]["steps"])
        obks.append(synth.ola_bucket(bk, synth.dct(bk, spectra)))
    evs, L = bufs[4:9], sig[3]
    pcm = ola.ola_assemble(obks, evs, L, "f32")
    q16, planes = jax_quantize(pcm.numpy())
    got = ola.ola_assemble(obks, evs, L, mode)
    want = q16 if mode == "s16" else planes
    assert got.numpy().dtype == want.dtype
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), ola.ola_assemble_plain(
        obks, evs, L, mode).numpy())


@pytest.mark.parametrize("output", ["s16", "s16p", "s16d", "s16df"])
def test_forward_s16_outputs(stereo, output):
    """forward for each s16 output: raw int16 and planes are the quantized
    f32 forward; the dpack wires unpack to the same int16, and are the
    JAX package's pack_pcm of that q below nbytes."""
    synth, sig, bufs, _ = stereo
    C, L = synth.channels, sig[3]
    q16, planes = jax_quantize(synth(sig, bufs).numpy())
    out = synth((*sig[:5], output, False), bufs)
    if output == "s16":
        assert np.array_equal(out.numpy(), q16)
        return
    if output == "s16p":
        assert np.array_equal(out.numpy(), planes)
        return
    nbt = pcm_pack.wire_rows(L, C)
    h = out.numpy()
    nb, plane_cap, cuts, widx = pcm_pack.parse_header(h, nbt, C)
    head = pcm_pack.wire_header_bytes(C) + nbt
    cap, ucap, urow = pcm_pack.wire_caps(nbt, output == "s16df")
    assert plane_cap == 16 * cap and h.shape[0] == head + 16 * cap
    pcm_pack.check_sections(nb, plane_cap, cuts, widx, h.shape[0] - head)
    got = pcm_pack.unpack_pcm(h[head : head + nb], widx, C, L, cuts)
    assert np.array_equal(got, q16)
    payload, jnb, jwidx, jcuts = jax.jit(
        lambda q: pack_pcm(q, cap, ucap, urow, rice=False)
    )(jnp.asarray(q16.astype(np.int32)))
    assert nb == int(jnb)
    assert np.array_equal(widx, np.asarray(jwidx))
    assert np.array_equal(cuts, np.asarray(jcuts))
    assert np.array_equal(h[head : head + nb], np.asarray(payload)[:nb])
