"""PyTorch port, K7 dpack_unary and K8 floor0_synth on the CPU (no card
needed): the schemes csrc/dpack_unary.cu and csrc/floor0_synth.cu follow,
in plain numpy, held against the port's twins and the JAX package on the
same inputs.

- K7: a CTA a tile of 32 block rows of a channel, a warp 4 consecutive
  rows side by side, skipping its width rows; per rice row 4 samples a
  lane, the 3 samples before a lane's run from the lane before (lane 0's
  from the row's halo), the winners' zigzags and unary lengths, their
  lane-local inclusive sums and a scan of the lane totals; each lane ORs
  its terminators of one word together and deposits one OR a word it
  touches into its row's slot of cap_urow words; the warp's rows' words,
  back to back from its first row's offset (K6's scan, ``dpack_scan``),
  go out in one pass by the payload offset's alignment (16-byte groups
  between up to 3 words at each end, words, or bytes), words past a row's
  cap_urow as 0 and words at or past cap_uwords dropped. For C in {1, 2,
  3} (odd NBt among them), payload offsets that are 16-aligned, 4-aligned
  and not, tones with full-scale steps made from a seed, under the full,
  soft and a truncating capacity,
  the section equals ``dpack_unary_plain`` byte for byte, and JAX
  ``pack_pcm``'s unary section on the select's own wires. No select's rice
  row reaches the soft row cap (32 words), so the row cap is held to the
  twin on a wire whose rice rows take lower rungs than the select gave
  them.
- K8: a warp a row, 4 consecutive bins a lane in steps of 128 bins, the
  coefficients' cosines put into the warp's slab 32 at a time and read 4
  at a time, even j into q and odd j into p, j ascending. For orders 1,
  4, 31, 32, 33 and 255, halves 32, 128 and 1024 and unused rows, it
  equals ``floor0_curves_plain`` bit for bit and, up to order 33, JAX
  ``floor0_curves`` within FLOOR0_REL. The wrapper's operand checks refuse
  any ``tab`` but a contiguous float32 [3, half] one and operands off a
  16-byte boundary.

Tolerances: none for K7 (integer arithmetic) and for K8 against its twin
(the same float32 operations in the same order, the cosines, square
roots and exponentials from the twin's own library calls). K8 against JAX: 2e-4
relative where |curve| < 1e4, the bound of tests/test_torch_fallback.py,
because the two backends' cos and exp round differently."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorbispizza_tpu.ops import pcm_pack as ref
from vorbispizza_tpu.ops.floor import floor0_curves as jax_floor0_curves
from vorbispizza_tpu_torch.ops import floor
from vorbispizza_tpu_torch.ops import pcm_pack as pp
from vorbispizza_tpu_torch.setup.floor import Floor0

WIDTHS = np.asarray(pp.WIDTHS, dtype=np.int64)
U32 = 0xFFFFFFFF
#: K7: warps a CTA (a tile of K6's scan), consecutive block rows a warp
UNARY_WARPS = 8
UNARY_ROWS = 4
#: K8: floats a lane takes, lanes a warp
BINS = 4
LANES = 32
FLOOR0_REL = 2e-4
FLOOR0_RANGE = 1e4


# -- K7: inputs ---------------------------------------------------------------


def tone_steps(C, L, seed):
    """Tones and noise made from a seed, with a full-scale step a channel
    (width 18 blocks, and rice blocks with long unary parts beside them)."""
    rng = np.random.default_rng(seed)
    t = np.arange(L, dtype=np.float64)
    q = np.stack([(9000 - 1500 * c) * np.sin(t * (0.031 + 0.007 * c))
                  + 40 * rng.standard_normal(L) for c in range(C)])
    for c in range(C):
        a = int(rng.integers(0, max(L - 300, 1)))
        q[c, a : a + 300] = 32000.0 if c % 2 == 0 else -32768.0
    return q.round().clip(-32768, 32767).astype(np.int32)


#: (C, L, payload-offset class of HDR + NBt: 16, 4 or 1)
CASES = [
    (1, 128 * 37 - 5, 1),   # odd NBt, odd offset, L % 4 == 3
    (1, 128 * 36, 16),      # two tiles, the second of 4 rows
    (2, 128 * 34, 4),
    (2, 128 * 40 - 64, 16),
    (3, 128 * 33 - 51, 1),  # odd NBt
    (3, 128 * 36, 16),
]


def case_id(case):
    return f"C{case[0]}-L{case[1]}"


_SEL: dict = {}


def select_of(C, L):
    """q and the twin's select (which test_torch_pcm_pack.py holds to JAX's
    select_candidate) with rice on."""
    key = (C, L)
    if key not in _SEL:
        q = tone_steps(C, L, seed=C * 100 + L % 97)
        wbyte, ubits = pp.dpack_select_plain(torch.from_numpy(q), True)
        _SEL[key] = q, wbyte.numpy(), ubits.numpy()
    return _SEL[key]


def caps_of(nbt, cap):
    if cap == "trunc":  # half a 16-byte group and 4 unary words a block
        return nbt // 2, 4 * nbt, pp.UNARY_ROW_WORDS_SOFT
    return pp.wire_caps(nbt, cap == "full")


def lowered(q, wbyte):
    """``pcm_pack.lowered_rungs`` of the select, as numpy."""
    cut, ubits = pp.lowered_rungs(torch.from_numpy(q), torch.from_numpy(wbyte))
    return cut.numpy(), ubits.numpy()


# -- K7: the model of the kernel ----------------------------------------------


def zigzag(v):
    return ((v << 1) ^ (v >> 63)) & U32


def diffs(x, third):
    """The candidate at a lane's 4 samples from its window x[:, 0..6] =
    q[i-3 .. i+3]: the second difference, or (third) the third."""
    d2 = x[:, 3:7] - 2 * x[:, 2:6] + x[:, 1:5]
    d3 = x[:, 3:7] - 3 * x[:, 2:6] + 3 * x[:, 1:5] - x[:, 0:4]
    return d3 if third else d2


def window(qc, b, L):
    """Each lane's x[0..6] around its run of row b: its own 4 samples (0 at
    or past L), the 3 before from the lane before (__shfl_up_sync), lane
    0's from the row's halo (0 before the channel's first sample)."""
    i = b * pp.BLOCK + 4 * np.arange(LANES)[:, None] + np.arange(4)
    run = np.where(i < L, qc[np.minimum(i, L - 1)], 0)
    h = b * pp.BLOCK - 3 + np.arange(3)
    x = np.zeros((LANES, 7), dtype=np.int64)
    x[:, 3:] = run
    x[1:, 0:3] = run[:-1, 1:4]
    x[0, 0:3] = np.where(h >= 0, qc[np.maximum(h, 0)], 0)
    return x


def put_word(wire, at, v):
    wire[at : at + 4] = np.array([v], dtype="<u4").view(np.uint8)


def row_lengths(qc, qp, b, wb, L):
    """A rice row's lane-local inclusive sums of the unary lengths, [32, 4]:
    each lane's 4 winners' zigzags from its window (and the partner's)."""
    w = int(WIDTHS[wb & 31])
    cand = ((wb >> 5) & 1) | (((wb >> 6) & 1) << 1)
    v = diffs(window(qc, b, L), cand & 1)
    if cand & 2:
        v = v - diffs(window(qp, b, L), cand & 1)
    i = b * pp.BLOCK + 4 * np.arange(LANES)[:, None] + np.arange(4)
    z = np.where(i < L, zigzag(v), 0)
    return np.cumsum((z >> w) + 1, axis=1)


def unary_model(q, wire, scan, cap_groups, cap_uwords, cap_urow):
    """dpack_unary_kernel in numpy, into ``wire`` (u8, its widx table
    written): a CTA a tile, a warp UNARY_ROWS consecutive rows side by
    side, 4 samples a lane; each rice row's deposit into its slot, then one
    store pass over the warp's rows' words, back to back from its first
    row's offset. Returns the store mode and the shared ORs a row issued
    (at most one a lane and word it touches)."""
    C, L = q.shape
    NB = -(-L // pp.BLOCK)
    nbt = C * NB
    hdr = pp.wire_header_bytes(C)
    pay = hdr + nbt
    store = 16 if pay % 16 == 0 else 4 if pay % 4 == 0 else 1
    partner = pp.pair_partner(C)
    f = pp.scan_fields(scan, C, NB, True)
    sec = pay + min(16 * int(f["groups"][0]), 16 * cap_groups)
    T = -(-NB // pp.TILE_ROWS)
    ors = []
    for c in range(C):
        qc, qp = q[c].astype(np.int64), q[partner[c]].astype(np.int64)
        for tile in range(T):  # a CTA
            for warp in range(UNARY_WARPS):
                b0 = (tile * UNARY_WARPS + warp) * UNARY_ROWS
                rows = [b for b in range(b0, b0 + UNARY_ROWS) if b < NB]
                wbs = [int(wire[hdr + c * NB + b]) for b in rows]
                if not any(wb & 0x80 for wb in wbs):
                    continue  # a warp of width rows returns at once
                words = []  # the warp's rows' words, back to back
                for b, wb in zip(rows, wbs):
                    if not wb & 0x80:
                        continue  # a width row: q not read, no words
                    e = row_lengths(qc, qp, b, wb, L)
                    s = e[:, 3]
                    before = np.cumsum(s) - s  # the warp's shuffle scan
                    slot = np.zeros(pp.UNARY_WORDS_FULL_PER_BLOCK, np.int64)
                    n_or = 0
                    for lane in range(LANES):
                        pos = before[lane] + e[lane] - 1
                        for wd in np.unique(pos >> 5):  # one OR a word
                            bits = np.bitwise_or.reduce(
                                1 << (pos[(pos >> 5) == wd] & 31))
                            if wd < cap_urow:
                                slot[wd] |= bits
                                n_or += 1
                    ors.append(n_or)
                    uw = (int(s.sum()) + 31) // 32
                    words += [int(slot[l]) if l < cap_urow else 0
                              for l in range(uw)]
                uoff = int(f["uex"][c * NB + b0])
                store_model(wire, sec, words, uoff,
                            min(uoff + len(words), cap_uwords), store)
    return store, ors


def store_model(wire, sec, words, uoff, end, store):
    """The warp's words into section words uoff .. end-1 at byte ``sec``;
    with 16-byte stores up to 3 words at each end as words and the groups
    between as 16-byte stores."""
    if end <= uoff:
        return
    if store != 16:  # words or bytes: the same bytes
        assert store == 1 or sec % 4 == 0
        for g in range(uoff, end):
            put_word(wire, sec + 4 * g, words[g - uoff])
        return
    a = min((uoff + 3) & ~3, end)
    b = max(end & ~3, a)
    assert a - uoff <= 3 and end - b <= 3
    for g in list(range(uoff, a)) + list(range(b, end)):
        put_word(wire, sec + 4 * g, words[g - uoff])
    for g in range(a, b, 4):
        assert (sec + 4 * g) % 16 == 0
        wire[sec + 4 * g : sec + 4 * g + 16] = np.array(
            words[g - uoff : g - uoff + 4], dtype="<u4").view(np.uint8)


def model_section(q, wbyte, ubits, caps):
    """The unary section the model writes into a zeroed wire (its widx
    table filled), on ``dpack_scan``'s scan; its store mode and ORs."""
    C, L = q.shape
    nbt = wbyte.shape[0]
    cap, ucap, urow = caps
    hdr = pp.wire_header_bytes(C)
    wire = np.zeros(pp.wire_bytes(C, nbt, cap, ucap, True), dtype=np.uint8)
    wire[hdr : hdr + nbt] = wbyte
    scan = pp.dpack_scan(torch.from_numpy(wbyte), torch.from_numpy(ubits),
                         urow, True, C).numpy()
    store, ors = unary_model(q, wire, scan, cap, ucap, urow)
    f = pp.scan_fields(scan, C, nbt // C, True)
    start = hdr + nbt + min(16 * int(f["groups"][0]), 16 * cap)
    return wire[start : start + 4 * ucap], scan, store, ors


# -- K7: tests ----------------------------------------------------------------


@pytest.mark.parametrize("cap", ["full", "soft", "trunc"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_k7_model_matches_twin(case, cap):
    """The model's section equals ``dpack_unary_plain`` byte for byte (and
    nothing is written past its words); the payload offset is of the
    case's class; a lane issues at most 4 ORs a row."""
    C, L, cls = case
    q, wbyte, ubits = select_of(C, L)
    assert (wbyte & 0x80).any() and not (wbyte & 0x80).all()
    caps = caps_of(wbyte.shape[0], cap)
    got, scan, store, ors = model_section(q, wbyte, ubits, caps)
    assert store == cls
    assert max(ors) <= 4 * LANES
    twin = pp.dpack_unary_plain(torch.from_numpy(q).to(torch.int16),
                                torch.from_numpy(wbyte), caps[1], caps[2])
    assert np.array_equal(got, twin.numpy())
    if cap == "trunc":  # the section cap cuts
        f = pp.scan_fields(scan, C, wbyte.shape[0] // C, True)
        assert int(f["uwords"][0]) > caps[1]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_k7_model_row_cap(case):
    """Rice rows on lower rungs than the select gave them: rows past the
    soft row cap (their words past it ship as 0) and more words than the
    soft section holds; the model equals the twin."""
    C, L, _ = case
    q, wbyte, _ = select_of(C, L)
    cut, ubits = lowered(q, wbyte)
    caps = caps_of(cut.shape[0], "soft")
    got, scan, _, _ = model_section(q, cut, ubits, caps)
    f = pp.scan_fields(scan, C, cut.shape[0] // C, True)
    assert int(f["over"][0]) == 1
    twin = pp.dpack_unary_plain(torch.from_numpy(q).to(torch.int16),
                                torch.from_numpy(cut), caps[1], caps[2])
    assert np.array_equal(got, twin.numpy())


def test_no_select_overflows_the_soft_row():
    """A block picks rice only while it undercuts its width coding, which
    keeps its unary part near the rice parameter's optimum: on every
    case's select, and on full-scale noise, no rice row reaches the soft
    row cap."""
    qs = [select_of(C, L)[0] for C, L, _ in CASES]
    qs.append(np.random.default_rng(7).integers(
        -32768, 32768, size=(2, 3000)).astype(np.int32))
    for q in qs:
        _, ubits = pp.dpack_select_plain(torch.from_numpy(q), True)
        assert int(((ubits.numpy() + 31) >> 5).max()) < \
            pp.UNARY_ROW_WORDS_SOFT


@pytest.mark.parametrize("case,cap", [(CASES[0], "full"),
                                      (CASES[3], "soft"),
                                      (CASES[4], "trunc")],
                         ids=["C1-full", "C2-soft", "C3-trunc"])
def test_k7_model_matches_pack_pcm(case, cap):
    """The model's kept unary section equals JAX ``pack_pcm``'s, where
    the reference places it, byte for byte (each JAX compile costs
    seconds, so three cases: one a channel count and a capacity)."""
    C, L, _ = case
    q, wbyte, ubits = select_of(C, L)
    nbt = wbyte.shape[0]
    cap_g, cap_u, urow = caps_of(nbt, cap)
    got, _, _, _ = model_section(q, wbyte, ubits, (cap_g, cap_u, urow))
    payload, nbytes, widx, cuts = map(np.asarray, jax.jit(
        lambda a: ref.pack_pcm(a, cap_g, cap_u, urow, rice=True))(
            jnp.asarray(q)))
    assert np.array_equal(widx, wbyte)
    assert int(nbytes) != pp.ROW_OVER_NBYTES
    plane = pp.plane_bytes_of(widx)
    ub = 4 * ((int(cuts[-1]) + 31) // 32)
    assert int(nbytes) == plane + ub
    start = min(plane, 16 * cap_g)
    kept = min(ub, 4 * cap_u)
    assert np.array_equal(got[:kept], payload[start : start + kept])


# -- K8 -----------------------------------------------------------------------


def make_floor0(order, n, bark_map_size=256):
    """The bark map of a floor0 config at blocksize n, without a bitstream
    (tests/test_floor0_device.py)."""
    f = types.SimpleNamespace(rate=44100, bark_map_size=bark_map_size)
    return Floor0._bark_map(f, n)


def lsp_rows(G, order, seed):
    """G rows of sorted LSP angles in (0.1, pi - 0.1), amplitudes, used
    (row 1 unused)."""
    rng = np.random.default_rng(seed)
    gaps = rng.uniform(0.3, 1.0, size=(G, order + 1))
    coeffs = (np.cumsum(gaps, axis=1)[:, :-1]
              / np.sum(gaps, axis=1, keepdims=True) * (np.pi - 0.2)
              + 0.1).astype(np.float32)
    amp = rng.integers(1, 64, size=G).astype(np.int32)
    used = np.ones(G, dtype=np.uint8)
    used[1] = 0
    return coeffs, amp, used


def floor0_model(coeffs, amp, used, tab, order, amp_bits, amp_off):
    """floor0_synth_kernel in numpy float32: a warp a row, lane l's bins
    4x .. 4x+3 for x = l, l + 32, ... (float4s of the tables), the row's
    cosines put into the warp's slab by lanes j < order 32 at a time and
    read 4 at a time, even j into q and odd j into p, j ascending, then the
    tails and the exponent.
    The cosines, square roots and exponentials come from the twin's own
    library calls on tensors of the twin's shapes: their roundings are the
    library's (torch's CPU sqrt is not numpy's everywhere), not the
    model's."""
    f32 = np.float32
    G, half = used.shape[0], tab.shape[1]
    nq = half // BINS
    cos_c = torch.cos(torch.from_numpy(coeffs).reshape(G, order)).numpy()
    pq = np.ones((G, half), dtype=f32)  # p + q after the tails
    for g in range(G):  # a warp
        if not used[g]:
            continue
        slab = np.concatenate([cos_c[g, j : j + LANES]  # 32 at a time
                               for j in range(0, order, LANES)])
        for x0 in range(0, nq, LANES):  # a step of 128 bins
            x = x0 + np.arange(LANES)
            x = x[x < nq]
            bins = (BINS * x[:, None] + np.arange(BINS)).reshape(-1)
            w = tab[0, bins]
            p = np.ones_like(w)
            q = np.ones_like(w)
            with np.errstate(over="ignore"):  # inf at high orders, as K8's
                for j0 in range(0, order, 4):  # a float4 of the slab
                    for j in range(j0, min(j0 + 4, order)):
                        d = slab[j] - w
                        acc = p if j % 2 else q  # even j into q, odd into p
                        acc *= f32(4.0) * (d * d)
                pq[g, bins] = p * tab[1, bins] + q * tab[2, bins]
    denom = torch.sqrt(torch.from_numpy(pq)).numpy()
    denom = np.where(denom == 0, f32(1e-9), denom).astype(f32)
    num = amp.astype(f32)[:, None] * f32(amp_off)
    e = f32(0.11512925) * (num / (f32((1 << amp_bits) - 1) * denom)
                           - f32(amp_off))
    lin = torch.exp(torch.minimum(torch.from_numpy(e),
                                  torch.tensor(80.0))).numpy()
    return np.where(used[:, None].astype(bool), lin, f32(0.0))


def floor0_case(order, half):
    """(model, twin, inputs) of one order and half: 5 rows, row 1 unused."""
    bark = make_floor0(order, 2 * half)
    coeffs, amp, used = lsp_rows(5, order, seed=order * 7 + half)
    tab = floor.floor0_tables(bark, 256, order)
    got = floor0_model(coeffs, amp, used, tab, order, 6, 160)
    twin = floor.floor0_curves(
        torch.from_numpy(coeffs), torch.from_numpy(amp),
        torch.from_numpy(used), torch.from_numpy(tab), order, 6, 160).numpy()
    return got, twin, (coeffs, amp, used, bark)


@pytest.mark.parametrize("half", [32, 128, 1024])
@pytest.mark.parametrize("order", [1, 4, 31, 32, 33, 255])
def test_k8_model_matches_twin(order, half):
    """The model equals ``floor0_curves`` (the twin on the CPU) bit for
    bit; the unused row is 0."""
    got, twin, _ = floor0_case(order, half)
    assert got.shape == twin.shape == (5, half)
    assert np.array_equal(got.view(np.int32), twin.view(np.int32))
    assert np.isfinite(got).all() and not got[1].any()


@pytest.mark.parametrize("half", [32, 128, 1024])
@pytest.mark.parametrize("order", [1, 4, 31, 32, 33])
def test_k8_model_matches_jax(order, half):
    """The model is within FLOOR0_REL of JAX ``floor0_curves`` where
    |curve| < 1e4, up to order 33 (real floor0 files stay near 30). At
    order 255 the float32 product's near-cancellations at bins close to an
    LSP root take the two backends' cos roundings to 0.095 relative at one
    bin of this input, so there the twin is the reference."""
    got, _, (coeffs, amp, used, bark) = floor0_case(order, half)
    want = np.asarray(jax_floor0_curves(
        coeffs, amp, used.astype(bool), order=order,
        bark_map=tuple(int(v) for v in bark), bark_map_size=256,
        amplitude_bits=6, amplitude_offset=160))
    assert want.shape == got.shape
    ok = np.abs(want) < FLOOR0_RANGE
    rel = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1e-6)
    assert rel.max() <= FLOOR0_REL


def test_k8_refuses_other_tables():
    """K8's operand checks: any ``tab`` but a contiguous float32 [3, half]
    one, a ``half`` off a multiple of 4, and a ``tab`` or ``out`` off a
    16-byte boundary are refused, with the reason."""
    tab = torch.from_numpy(floor.floor0_tables(make_floor0(4, 256), 256, 4))
    out = torch.empty((2, 128), dtype=torch.float32)
    floor.check_floor0_operands(tab, out)
    for bad in (tab.double(), tab[:2], tab.reshape(-1),
                tab.t().contiguous().t(),
                torch.cat([tab, tab], dim=1)[:, ::2]):
        with pytest.raises(ValueError, match=r"contiguous float32 \[3, half\]"):
            floor.check_floor0_operands(bad, out)
    buf = torch.empty(3 * 128 + 1, dtype=torch.float32)
    shifted = buf[1:].view(3, 128)
    assert shifted.data_ptr() % 16
    for t, o in ((tab[:, :126].contiguous(), out), (shifted, out),
                 (tab, buf[1:257].view(2, 128))):
        with pytest.raises(ValueError, match="float4s"):
            floor.check_floor0_operands(t, o)
