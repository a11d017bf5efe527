"""PyTorch port, the tiled K4 on the CPU (no card needed): the schemes
csrc/ola_assemble.cu follows, in plain numpy, held against the port's
references and the JAX package on the same inputs.

- The chain-state scan: int32 inclusive sums of the events in steps with a
  carry (uint32 sums that may wrap on the way) equal the int64
  ``torch.cumsum`` glue the wrapper ran before, and the validity bits
  equal the int64 levels' signs.
- The tiled assembly: a tile of consecutive samples finds its first and
  last events once, stages them with the state before the first, and each
  sample reads its event from the tile's list; the flat index splits into
  frame and offset by a shift and a mask. At several tile sizes, on the
  test wires and on the committed corpus's first chunk, that equals the
  port's ``expand_assemble`` and JAX ``block_assemble_wide`` /
  ``expand_assemble``, with tiles that start on an event, tiles with no
  event, the padding events at L and an L that is not a multiple of the
  tile.
- The dpack mode's select: from a tile's q in a buffer with the 4 samples
  before the tile (0 before sample 0), each (channel, 128-sample block)
  costs its candidates as the kernel does (the width rung from the block
  max's bit length). That equals ``dpack_select_plain`` and JAX
  ``select_candidate`` for 1, 2, 3, 6 and 8 channels, rice on and off, and
  the dpack mode's twin equals the JAX quantize and select on the wires.

Tolerances: none. The assembly is a selection and the same float32
products in the same order; the rest is integer arithmetic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorbispizza_tpu.decoder import CLIP_MAX
from vorbispizza_tpu.ops import pcm_pack as jax_pcm_pack
from vorbispizza_tpu.ops.ola import block_assemble_wide
from vorbispizza_tpu.ops.ola import expand_assemble as jax_expand_assemble
from vorbispizza_tpu_torch.ops import coupling, ola
from vorbispizza_tpu_torch.ops import pcm_pack as pp
from vorbispizza_tpu_torch.testing.chunks import first_chunk
from vorbispizza_tpu_torch.testing.corpus32 import load_corpus
from vorbispizza_tpu_torch.testing.streams import make_streams

#: events a step of the scan kernel (1024 threads x 8)
SCAN_STEP = 8192
#: samples before a tile that the dpack mode remakes
HALO = 4
#: rung of a block max of b bits (csrc/ola_assemble.cu vp_rung_of_bits)
RUNG_OF_BITS = np.array([0, 1, 2, 3, 4, 5, 6, 7, 7, 8, 8, 9, 9, 10, 10, 10]
                        + [11] * 17)
#: the rice k rungs (WIDTHS up to 15 bits)
RICE_WIDTHS = np.asarray(pp.WIDTHS, dtype=np.int64)[list(pp.RICE_K_IDX)]


# -- inputs --------------------------------------------------------------------


_OPERANDS: dict = {}


def operands(group):
    """(K4's bucket operands, the events, L) of a group's first chunk,
    through the port's stages before K4 (their twins on the CPU)."""
    if group not in _OPERANDS:
        srcs = load_corpus() if group == "corpus32" else make_streams(group)
        synth, sig, host, _ = first_chunk(srcs)
        bufs = [torch.from_numpy(a) for a in host]
        obks = [synth.ola_bucket(bk, synth.dct(bk, coupling.couple_spectrum(
            synth.residues(bk), synth.floors(bk), bk["tables"]["steps"])))
            for bk in synth.buckets(sig, bufs)]
        _OPERANDS[group] = (obks, bufs[4:9], sig[3])
    return _OPERANDS[group]


# -- the plain schemes -----------------------------------------------------------


def scan_int32(evs, step=SCAN_STEP):
    """K4's chain-state scan: int32 (DA, DB, V) with V bit 0 = VA > 0 and
    bit 1 = VB > 0; uint32 sums a step at a time with a carry."""
    sums = []
    for e in evs[1:]:
        x = e.numpy().astype(np.uint32)
        out = np.empty_like(x)
        carry = np.uint32(0)
        for base in range(0, len(x), step):
            part = np.cumsum(x[base : base + step], dtype=np.uint32) + carry
            out[base : base + step] = part
            carry = part[-1]
        sums.append(out.view(np.int32))
    bits = (sums[2] > 0).astype(np.int32) | ((sums[3] > 0).astype(np.int32) << 1)
    return sums[0], sums[1], bits


def bucket_rows(obks):
    """Per bucket: (base, end, log2 n, d [Fp, C, n/2], window, prime,
    final) as the C entry's table has them."""
    rows, base = [], 0
    for d, window, prime, final in obks:
        Fp, _, m = d.shape
        n = 2 * m
        rows.append((base, base + Fp * n, n.bit_length() - 1, d.numpy(),
                     window.numpy(), prime.numpy().astype(bool),
                     final.numpy().astype(bool)))
        base += Fp * n
    return rows, base


def flat_values(rows, Tf, C, a):
    """[C, len(a)] windowed-frame values at flat indices a (0 outside
    [0, Tf)): frame and offset by shift and mask, the IMDCT reflection,
    x window, x keep, in the reference's order."""
    out = np.zeros((C, a.shape[0]), dtype=np.float32)
    for base, end, lg, d, window, prime, final in rows:
        sel = np.nonzero((a >= 0) & (a < Tf) & (a >= base) & (a < end))[0]
        if not sel.size:
            continue
        r = (a[sel] - base).astype(np.int32)
        f = r >> lg
        j = r & ((1 << lg) - 1)
        m = 1 << (lg - 1)
        h = m >> 1
        idx = np.where(j < h, h + j,
                       np.where(j < h + m, m - 1 - (j - h), j - h - m))
        y = d[f, :, idx].T  # [C, nsel]
        y = np.where(j < h, y, -y).astype(np.float32)
        y = y * window[j]
        keep = (~prime[f] | (j >= m)) & (~final[f] | (j < m))
        out[:, sel] = y * keep.astype(np.float32)
    return out


def last_le(ev_j, x):
    """The last k with ev_j[k] <= x (-1: none), as the kernel's ballot
    search finds it."""
    return int(np.searchsorted(ev_j, x, side="right")) - 1


def tiled_assemble(obks, evs, L, tile):
    """The tiled K4 in plain form -> (pcm [C, L] f32, counts of tiles that
    start on an event and of tiles with no event)."""
    rows, Tf = bucket_rows(obks)
    C = obks[0][0].shape[1]
    ej = evs[0].numpy()
    DA, DB, V = scan_int32(evs)
    out = np.zeros((C, L), dtype=np.float32)
    on_event = empty = 0
    for t0 in range(0, L, tile):
        last = min(t0 + tile, L) - 1
        k0, k1 = last_le(ej, t0), last_le(ej, last)
        # the tile's events k0+1..k1, and the state at k0 (none before 0)
        init = (DA[k0], DB[k0], V[k0]) if k0 >= 0 else (0, 0, 0)
        tj, tda, tdb, tv = (x[k0 + 1 : k1 + 1] for x in (ej, DA, DB, V))
        on_event += int(k0 >= 0 and ej[k0] == t0)
        empty += int(k1 == k0)
        i = np.arange(t0, last + 1, dtype=np.int32)
        e = np.searchsorted(tj, i, side="right") - 1
        da = np.where(e >= 0, tda[np.maximum(e, 0)] if tj.size else 0, init[0])
        db = np.where(e >= 0, tdb[np.maximum(e, 0)] if tj.size else 0, init[1])
        v = np.where(e >= 0, tv[np.maximum(e, 0)] if tj.size else 0, init[2])
        fa = flat_values(rows, Tf, C, i + da.astype(np.int32))
        fb = flat_values(rows, Tf, C, i + db.astype(np.int32))
        va = (v & 1).astype(np.float32)
        vb = ((v >> 1) & 1).astype(np.float32)
        out[:, t0 : last + 1] = fa * va + fb * vb
    return out, on_event, empty


def select_tiled(q, tile, rice):
    """The dpack mode's select in plain form: per tile a buffer of its q
    with the HALO samples before it, then per (channel, 128-sample block)
    the candidates' costs as the kernel makes them -> (widx|flags u8
    [NBt], unary bits int32 [NBt])."""
    C, L = q.shape
    B = pp.BLOCK
    NB = -(-L // B)
    partner = pp.pair_partner(C)
    widths = np.asarray(pp.WIDTHS, dtype=np.int64)
    wbyte = np.zeros(C * NB, dtype=np.uint8)
    ubits = np.zeros(C * NB, dtype=np.int32)
    for t0 in range(0, L, tile):
        buf = np.zeros((C, HALO + tile), dtype=np.int64)
        n = min(tile, L - t0)
        buf[:, HALO : HALO + n] = q[:, t0 : t0 + n]
        if t0:
            buf[:, :HALO] = q[:, t0 - HALO : t0]
        x = HALO + np.arange(tile)
        d2 = buf[:, x] - 2 * buf[:, x - 1] + buf[:, x - 2]
        d3 = d2 - (buf[:, x - 1] - 2 * buf[:, x - 2] + buf[:, x - 3])
        inside = (t0 + np.arange(tile)) < L
        cands = [d2, d3]
        if C >= 2:
            cands += [d2 - d2[partner], d3 - d3[partner]]
        zs = [np.where(inside, (c << 1) ^ (c >> 63), 0).reshape(C, -1, B)
              for c in cands]
        blocks = np.arange(tile // B)
        gb = t0 // B + blocks
        ok = gb < NB
        best_cost = best_byte = best_ub = None
        for k, z in enumerate(zs):
            mx = z.max(axis=2)
            bits = sum((mx >= (1 << b)).astype(np.int64) for b in range(33))
            wi = RUNG_OF_BITS[bits]
            cost = np.where(bits > pp.MAX_W, pp.INF, widths[wi] * B)
            rung, ub = wi, np.zeros_like(wi)
            is_rice = np.zeros_like(wi)
            if rice:
                hs = np.stack([(z >> w).sum(axis=2) for w in RICE_WIDTHS])
                rc = B * RICE_WIDTHS[:, None, None] + ((hs + B + 31) & ~31)
                rbest = rc.argmin(axis=0)  # first minimum: smallest k
                rcost = rc.min(axis=0)
                rsum = np.take_along_axis(hs, rbest[None], axis=0)[0]
                use = rcost < cost  # ties -> width
                cost = np.where(use, rcost, cost)
                rung = np.where(use, rbest, wi)
                is_rice = use.astype(np.int64)
                ub = np.where(use, rsum + B, 0)
            if k >= 2:
                cost = np.where((partner != np.arange(C))[:, None], cost,
                                pp.INF)
            byte = rung | ((k & 1) << 5) | ((k >> 1) << 6) | (is_rice << 7)
            if k == 0:
                best_cost, best_byte, best_ub = cost, byte, ub
            else:
                better = cost < best_cost  # ties -> the earlier candidate
                best_cost = np.where(better, cost, best_cost)
                best_byte = np.where(better, byte, best_byte)
                best_ub = np.where(better, ub, best_ub)
        for c in range(C):
            rows = c * NB + gb[ok]
            wbyte[rows] = best_byte[c, ok]
            ubits[rows] = best_ub[c, ok]
    return wbyte, ubits


def tone(C, L, seed):
    """Channel c a scaled copy of one signal and its noise, plus a little
    noise of its own (inter candidates win), with a loud 3 kHz tone in the
    first quarter (d3 wins), a stretch of full-scale noise (width 18) and
    sparse spikes (rice), as int32 in the s16 range."""
    rng = np.random.default_rng(seed)
    t = np.arange(L, dtype=np.float64)
    base = 9000 * np.sin(2 * np.pi * 220 * t / 44100) + 3000 * np.sin(
        2 * np.pi * 663 * t / 44100) + 40 * rng.standard_normal(L)
    base[: L // 4] = 12000 * np.sin(2 * np.pi * 3000 * t[: L // 4] / 44100)
    chans = [(1 - 0.1 * c) * base + 2 * rng.standard_normal(L)
             for c in range(C)]
    q = np.stack(chans)
    q[:, L // 3 : L // 3 + 200] = rng.integers(-32768, 32768, size=(C, 200))
    q[:, L // 2 : L // 2 + 256 : 16] += 6000
    return q.round().clip(-32768, 32767).astype(np.int32)


def jax_select(q, rice):
    """JAX select_candidate -> (widx|flags u8, unary bits int32)."""
    _, widx, flags, ulen = jax.jit(
        lambda a: jax_pcm_pack.select_candidate(a, rice=rice))(jnp.asarray(q))
    return ((np.asarray(widx) | np.asarray(flags)).astype(np.uint8),
            np.asarray(ulen).sum(axis=1).astype(np.int32))


# -- the scan --------------------------------------------------------------------


@pytest.mark.parametrize("group", ["stereo", "surround", "floor0", "corpus32"])
def test_scan_matches_int64_cumsum(group):
    """On the wires' own events."""
    _, evs, _ = operands(group)
    DA, DB, V = scan_int32(evs)
    da, db, va, vb = (torch.cumsum(e.to(torch.int64), 0).numpy()
                      for e in evs[1:])
    assert np.array_equal(DA.astype(np.int64), da)
    assert np.array_equal(DB.astype(np.int64), db)
    assert np.array_equal(V, (va > 0) | ((vb > 0) << 1))


@pytest.mark.parametrize("Ep", [1, 8191, 8192, 8193, 3 * 8192 + 77])
def test_scan_carries_across_steps(Ep):
    """Drawn events over several scan steps, with partial sums that leave
    the int32 range on the way (the uint32 sums wrap; the final ones are
    in range) and validity deltas of +-1."""
    rng = np.random.default_rng(Ep)
    big = rng.integers(-2**30, 2**30, size=Ep)
    big[1::2] = -big[::2][: Ep // 2]  # keep every other partial sum small
    evs = [torch.zeros(Ep, dtype=torch.int32),
           torch.from_numpy(big.astype(np.int32)),
           torch.from_numpy(rng.integers(-5, 6, size=Ep).astype(np.int32)),
           torch.from_numpy(rng.integers(-1, 2, size=Ep).astype(np.int32)),
           torch.from_numpy(rng.integers(-1, 2, size=Ep).astype(np.int32))]
    DA, DB, V = scan_int32(evs)
    da, db, va, vb = (torch.cumsum(e.to(torch.int64), 0).numpy()
                      for e in evs[1:])
    assert np.abs(da).max() < 2**31
    assert np.array_equal(DA.astype(np.int64), da)
    assert np.array_equal(DB.astype(np.int64), db)
    assert np.array_equal(V, (va > 0) | ((vb > 0) << 1))


# -- the tiled assembly ----------------------------------------------------------


_JAX_FULL: dict = {}


def jax_full(group):
    """JAX block_assemble_wide on the group's chunk (computed once)."""
    if group not in _JAX_FULL:
        obks, evs, L = operands(group)
        flat = ola.flat_frames(obks)
        _JAX_FULL[group] = np.asarray(block_assemble_wide(
            jnp.asarray(flat.numpy()),
            tuple(jnp.asarray(e.numpy()) for e in evs), L))
    return _JAX_FULL[group]


CASES = [(g, t) for g in ("stereo", "surround", "floor0")
         for t in (128, 512, 2048, 8192)] + [("corpus32", 2048),
                                             ("corpus32", 8192)]
_EDGES: dict = {}


@pytest.mark.parametrize("group,tile", CASES)
def test_tiled_scheme_matches_references(group, tile):
    """Over the whole chunk: the port's expand_assemble and JAX
    block_assemble_wide; over an L cut to a length that is not a multiple
    of the tile: the port's and JAX's expand_assemble."""
    obks, evs, L = operands(group)
    got, on_event, empty = tiled_assemble(obks, evs, L, tile)
    flat = ola.flat_frames(obks)
    assert np.array_equal(got, ola.expand_assemble(flat, evs, L).numpy())
    assert np.array_equal(got, jax_full(group))
    cut = L - tile // 3 - 1001
    assert cut % tile
    got_cut, _, _ = tiled_assemble(obks, evs, cut, tile)
    assert np.array_equal(got_cut, ola.expand_assemble(flat, evs, cut).numpy())
    if group != "corpus32":
        want = np.asarray(jax_expand_assemble(
            jnp.asarray(flat.numpy()),
            tuple(jnp.asarray(e.numpy()) for e in evs), cut))
        assert np.array_equal(got_cut, want)
    seen = _EDGES.setdefault(group, [0, 0])
    seen[0] += on_event
    seen[1] += empty


@pytest.mark.parametrize("group", ["stereo", "surround", "floor0", "corpus32"])
def test_tiled_scheme_meets_the_edges(group):
    """The wires hold what the tiled search must get right: padding events
    at ev_j = L (never reached), tiles that start on an event and tiles
    with no event of their own, and the tile's events fit the kernel's
    shared buffer at the kernel's tile."""
    obks, evs, L = operands(group)
    ej = evs[0].numpy()
    assert (ej == L).any() and np.all(np.diff(ej) >= 0)
    on_event = empty = 0
    for tile in (128, 512):
        _, a, b = tiled_assemble(obks, evs, L, tile)
        on_event, empty = on_event + a, empty + b
    assert on_event > 0 and empty > 0
    C = obks[0][0].shape[1]
    tile = 1 << 13
    while tile > 128 and C * tile > 8192:
        tile //= 2
    real = ej[ej < L]
    assert np.bincount(real // tile).max() <= 128


def test_k4_cpu_wrapper_is_its_twin():
    """For CPU tensors the wrapper runs the twin in every mode; the dpack
    mode writes its select into a given widx view."""
    obks, evs, L = operands("stereo")
    pcm = ola.ola_assemble(obks, evs, L, "f32")
    assert torch.equal(pcm, ola.ola_assemble_plain(obks, evs, L, "f32"))
    C = pcm.shape[0]
    wire, widx = pp.wire_buffer(C, L, 8, 8, False, "cpu")
    q, wbyte, ubits = ola.ola_assemble(obks, evs, L, "dpack", wbyte=widx)
    assert wbyte is widx
    assert torch.equal(q, ola.ola_assemble(obks, evs, L, "s16"))
    want = pp.dpack_select_plain(q, False)
    assert torch.equal(wbyte, want[0]) and torch.equal(ubits, want[1])
    with pytest.raises(ValueError, match="mode"):
        ola.ola_assemble(obks, evs, L, "s24")
    with pytest.raises(ValueError, match="wbyte"):
        ola.ola_assemble(obks, evs, L, "dpack", wbyte=widx[:-1])


# -- the dpack mode's select -----------------------------------------------------


@pytest.mark.parametrize("rice", [False, True])
@pytest.mark.parametrize("C", [1, 2, 3, 6, 8])
def test_tiled_select_matches_references(C, rice):
    """L not a multiple of 128; tiles of 128 and 256 put a tile edge
    before most blocks, so each block's first differences come from the
    halo."""
    L = 1000 + 37 * C
    q = tone(C, L, seed=C)
    want = pp.dpack_select_plain(torch.from_numpy(q), rice)
    jwant = jax_select(q, rice)
    assert np.array_equal(want[0].numpy(), jwant[0])
    assert np.array_equal(want[1].numpy(), jwant[1])
    for tile in (128, 256, 1024):
        wbyte, ubits = select_tiled(q, tile, rice)
        assert np.array_equal(wbyte, jwant[0])
        assert np.array_equal(ubits, jwant[1])
    if C >= 2:
        assert (jwant[0] & 0x40).any()  # inter candidates are picked
    assert (jwant[0] & 0x20).any()
    if rice:
        assert (jwant[0] & 0x80).any()


@pytest.mark.parametrize("rice", [False, True])
@pytest.mark.parametrize("group", ["stereo", "surround", "floor0"])
def test_dpack_mode_twin_on_the_wires(group, rice):
    """The dpack mode's twin: q is the reference's quantize of the f32
    mode's PCM, and its select is JAX select_candidate of that q and the
    tiled select at the kernel's tile."""
    obks, evs, L = operands(group)
    pcm = ola.ola_assemble_plain(obks, evs, L, "f32").numpy()
    clipped = jnp.clip(jnp.asarray(pcm), -CLIP_MAX, CLIP_MAX)
    jq = np.asarray(jnp.clip(jnp.round(clipped * 32768.0), -32768.0,
                             32767.0).astype(jnp.int32))
    q, wbyte, ubits = ola.ola_assemble_plain(obks, evs, L, "dpack", rice)
    assert q.dtype == torch.int16
    assert np.array_equal(q.numpy().astype(np.int32), jq)
    jw, ju = jax_select(jq, rice)
    assert np.array_equal(wbyte.numpy(), jw)
    assert np.array_equal(ubits.numpy(), ju)
    C = q.shape[0]
    tile = 1 << 13
    while tile > 128 and C * tile > 8192:
        tile //= 2
    tw, tu = select_tiled(jq, tile, rice)
    assert np.array_equal(tw, jw) and np.array_equal(tu, ju)
