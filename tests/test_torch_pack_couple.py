"""PyTorch port, K6 dpack_pack and K3 couple_spectrum on the CPU (no card
needed): the schemes csrc/dpack_pack.cu and csrc/couple_spectrum.cu follow,
in plain numpy, held against the port's twins and the JAX package on the
same inputs.

- K6's scan: int32 (uint32, wrapping) sums of the groups and unary words
  of each tile of 32 block rows of a channel, a thread's 2 consecutive
  tiles and a scan of the thread sums in steps with a carry; each row's
  unary-word offset on a rice wire; the channel cuts from the threads that
  hold each channel's last tile; the 72 * NBt < 2^31 guard. It equals
  ``dpack_scan`` (the twin's int64 cumsums) and the header's fields equal
  JAX ``pack_pcm``'s.
- K6's pack: a CTA a tile, a warp 4 consecutive block rows a row at a
  time, each row's group offset the tile's plus the widths before it in
  the tile, 4 samples a lane, the 3 samples before a lane's run from the
  lane before (lane 0's from lane 31 of the row before; the warp's first
  row reads them), the zigzag masked to the block's width and staged (a
  lane's 4 values as one chunk up to 8 bits), lane j assembling words j,
  j+32 and j+64 from the entries that reach each (found by a multiply and
  a shift), and the stores by the payload offset's alignment (16-byte
  groups, words or bytes) with the groups at or past cap_groups dropped;
  on a rice wire each row's unary-word offset. For C in {1, 2,
  3, 6, 8}, rice off and on, payload offsets that are 16-aligned, 4-aligned
  and odd, a q in which every WIDTHS rung occurs and a cap that cuts a
  block in two, the wire equals ``dpack_pack_plain`` and JAX ``pack_pcm``
  byte for byte below nbytes.
- K3: ``couple_spectrum_chunk`` (the twin a bucket on the CPU) and a model
  of the kernel (each CTA finds its bucket by a walk over the descriptor's
  first tiles, a thread takes 4 bins of a frame and every channel) equal
  JAX ``inverse_couple_batch`` times the floors on every bucket of the
  stereo, surround (several coupling steps) and floor0 streams, and on a
  ten-channel chunk (the in-place path) with steps that share channels.

Tolerances: none. The pack is integer arithmetic, and the coupling makes
the same float32 sums, selects and products in the same order."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vorbispizza_tpu.ops import pcm_pack as ref
from vorbispizza_tpu.ops.coupling import inverse_couple_batch
from vorbispizza_tpu_torch.ops import coupling
from vorbispizza_tpu_torch.ops import pcm_pack as pp
from vorbispizza_tpu_torch.testing.chunks import first_chunk
from vorbispizza_tpu_torch.testing.streams import make_streams

WIDTHS = np.asarray(pp.WIDTHS, dtype=np.int64)
#: K6's scan: tiles a thread holds, threads of its CTA
SCAN_TILES = 2
SCAN_THREADS = 1024
#: K6's pack: consecutive block rows a warp takes
PACK_ROWS = 4
#: K3's threads a CTA (a tile)
K3_THREADS = 256
U32 = 0xFFFFFFFF


# -- K6: inputs ---------------------------------------------------------------

#: impulse height h for each width w >= 2: the impulse's second difference
#: -2h has zigzag 4h - 1, which needs exactly w bits
IMPULSE = {2: 1, 3: 2, 4: 4, 5: 8, 6: 16, 8: 64, 10: 256, 12: 1024,
           15: 8192, 18: 16384}


def crafted_q(C, L):
    """Block b of channel c gets rung (b + 3c) % 12: nothing for rung 0, a
    downward ramp that starts there for rung 1 (second differences 0 and
    -1), an impulse of IMPULSE[w] for the others; each channel's events sit
    at their own offset in the block, so a partner's never cancel them."""
    NB = -(-L // pp.BLOCK)
    q = np.zeros((C, L), dtype=np.int64)
    for c in range(C):
        for b in range(NB):
            pos = b * pp.BLOCK + 16 + 8 * c
            w = int(WIDTHS[(b + 3 * c) % len(WIDTHS)])
            if pos >= L or w == 0:
                continue
            if w == 1:
                q[c, pos:] -= np.arange(1, L - pos + 1)
            else:
                q[c, pos] += IMPULSE[w]
    assert q.min() >= -32768 and q.max() <= 32767
    return q.astype(np.int32)


def tone_q(C, L, seed=3):
    """Correlated tones with a little noise: third differences and inter
    candidates win here."""
    rng = np.random.default_rng(seed)
    t = np.arange(L, dtype=np.float64)
    base = 9000 * np.sin(2 * np.pi * 220 * t / 44100)
    chans = [(1 - 0.1 * c) * base + 30 * rng.standard_normal(L)
             for c in range(C)]
    return np.stack(chans).round().clip(-32768, 32767).astype(np.int32)


#: (C, L, content, payload-offset class of HDR + NBt: 16, 4 or 1)
CASES = [
    (1, 1000, "crafted", 4),
    (1, 1537, "crafted", 1),   # odd offset, L % 4 == 1
    (2, 3072, "crafted", 16),  # every rung in each channel
    (2, 1900, "tone", 1),      # offset 2 mod 4
    (3, 1300, "crafted", 1),   # odd NBt, odd offset
    (3, 1920, "tone", 1),
    (6, 1000, "tone", 16),
    (8, 1100, "crafted", 16),
    (1, 5120, "crafted", 4),   # two tiles, the second of 8 rows
    (2, 9000, "tone", 1),      # three tiles a channel, the last of 7 rows
]


def case_id(case):
    return f"C{case[0]}-L{case[1]}-{case[2]}"


_Q: dict = {}


def q_of(C, L, content):
    key = (C, L, content)
    if key not in _Q:
        _Q[key] = (crafted_q if content == "crafted" else tone_q)(C, L)
    return _Q[key]


# -- K6: the model of the kernels ---------------------------------------------


def tile_rows(t, T, NB):
    """Tile t's channel, first row and rows (the kernel's tile_rows)."""
    c = t // T
    b = (t - c * T) * pp.TILE_ROWS
    return c, c * NB + b, min(pp.TILE_ROWS, NB - b)


def scan_model(wbyte, ubits, C, cap_groups, cap_urow, rice,
               step=SCAN_THREADS * SCAN_TILES):
    """dpack_pack_scan in numpy: (the int32 scan in ``scan_fields``'s layout,
    the header's u32 words). One CTA; a thread takes SCAN_TILES consecutive
    tiles a step, a block scan of the thread sums gives each tile's offset
    and a carry the next step's. ``step``: tiles a step (the kernel's is
    2048; smaller ones make several steps at small sizes)."""
    nbt = wbyte.shape[0]
    pp.check_scan_range(nbt)
    NB = nbt // C
    T = -(-NB // pp.TILE_ROWS)
    nt = C * T
    threads = step // SCAN_TILES
    g_row = WIDTHS[wbyte & 31]
    u_row = ((ubits.astype(np.int64) + 31) >> 5) if rice else \
        np.zeros(nbt, np.int64)
    scan = np.zeros(pp.scan_size(C, NB, rice), dtype=np.int64)
    f = pp.scan_fields(scan, C, NB, rice)  # numpy views, the same layout
    head = np.zeros(2 + C, dtype=np.int64)
    carry, over = [0, 0], False
    for base in range(0, nt, step):
        sums = np.zeros((threads, SCAN_TILES, 2), dtype=np.int64)
        for i in range(threads):
            for j in range(SCAN_TILES):
                t = base + SCAN_TILES * i + j
                if t < nt:
                    _, row0, n = tile_rows(t, T, NB)
                    sums[i, j] = (g_row[row0 : row0 + n].sum(),
                                  u_row[row0 : row0 + n].sum())
                    over |= bool((u_row[row0 : row0 + n] > cap_urow).any())
        tsum = sums.sum(axis=1)
        ex = np.cumsum(tsum, axis=0) - tsum  # the block scan
        for i in range(threads):
            gp, up = carry[0] + ex[i, 0], carry[1] + ex[i, 1]
            for j in range(SCAN_TILES):
                t = base + SCAN_TILES * i + j
                if t < nt:
                    c, row0, n = tile_rows(t, T, NB)
                    f["tiles"][t] = gp & U32
                    if rice:
                        f["utiles"][t] = up & U32
                    if row0 + n == (c + 1) * NB:  # the channel's last tile
                        head[2 + c] = (32 * (up + sums[i, j, 1])) & U32
                gp += sums[i, j, 0]
                up += sums[i, j, 1]
        carry = [carry[k] + int(tsum[:, k].sum()) for k in (0, 1)]
    f["groups"][0], f["uwords"][0] = carry[0] & U32, carry[1] & U32
    f["over"][0] = over
    head[0] = 0x7FFFFFF0 if over else (16 * carry[0] + 4 * carry[1]) & U32
    head[1] = (16 * cap_groups) & U32
    return scan.astype(np.int32), head.astype(np.uint32)


def zigzag(v):
    return ((v << 1) ^ (v >> 31)) & U32


def load_runs(qc, b0, L):
    """A warp's PACK_ROWS rows from block b0: each lane's run of 4 samples a
    row (0 at or past L), and the 3 samples before the warp's first row,
    which lane 0 reads (0 before the channel's first sample)."""
    runs = np.zeros((PACK_ROWS, 32, 4), dtype=np.int64)
    for r in range(PACK_ROWS):
        i = (b0 + r) * pp.BLOCK + 4 * np.arange(32)[:, None] + np.arange(4)
        runs[r] = np.where(i < L, qc[np.minimum(i, L - 1)], 0)
    i = b0 * pp.BLOCK - 3 + np.arange(3)
    halo = np.where(i >= 0, qc[np.maximum(i, 0)], 0)
    return runs, halo


def row_window(runs, halo, r):
    """Each lane's x[0..6] = q[i-3 .. i+3] around its run of row r: its own
    4 samples, the 3 before shuffled up from the lane before; lane 0's from
    lane 31 of the row before, or the halo on the warp's first row."""
    x = np.zeros((32, 7), dtype=np.int64)
    x[:, 3:] = runs[r]
    x[1:, 0:3] = runs[r][:-1, 1:4]  # __shfl_up_sync(.., 1)
    x[0, 0:3] = runs[r - 1][31, 1:4] if r > 0 else halo  # __shfl_sync(.., 31)
    return x


def diffs(x):
    d2 = x[:, 3:7] - 2 * x[:, 2:6] + x[:, 1:5]
    d3 = x[:, 3:7] - 3 * x[:, 2:6] + 3 * x[:, 1:5] - x[:, 0:4]
    return d2, d3


def pack_model(q, wire, scan, ubits, C, L, cap_groups, rice):
    """dpack_pack_kernel in numpy, into ``wire`` (u8, header and widx
    already there) and, on a rice wire, into the scan's row offsets: a
    warp takes PACK_ROWS consecutive rows of a channel, a row at a time, 4
    samples a lane."""
    NB = -(-L // pp.BLOCK)
    nbt = C * NB
    hdr = pp.wire_header_bytes(C)
    pay = hdr + nbt
    store = 16 if pay % 16 == 0 else 4 if pay % 4 == 0 else 1
    partner = pp.pair_partner(C)
    f = pp.scan_fields(scan, C, NB, rice)
    T = -(-NB // pp.TILE_ROWS)
    lanes = np.arange(32)
    for c in range(C):
        for b0 in range(0, NB, PACK_ROWS):  # a warp
            own = load_runs(q[c].astype(np.int64), b0, L)
            par = load_runs(q[partner[c]].astype(np.int64), b0, L)
            # the row offsets: the tile's, then the warps' sums before this
            # warp (shared memory), then the rows' before in the warp
            bx, off = divmod(b0, pp.TILE_ROWS)  # off: the warp's first row
            rows = range(c * NB + bx * pp.TILE_ROWS,
                         c * NB + min(NB, (bx + 1) * pp.TILE_ROWS))
            wrows = [int(WIDTHS[int(wire[hdr + r]) & 31]) for r in rows]
            sums = [sum(wrows[v : v + PACK_ROWS])
                    for v in range(0, len(wrows), PACK_ROWS)]
            nw_before = off // PACK_ROWS
            before = int(f["tiles"][c * T + bx]) + sum(sums[:nw_before])
            if rice:  # each row's unary-word offset, for K7
                urows = [(int(ubits[r]) + 31) >> 5 for r in rows]
                usums = [sum(urows[v : v + PACK_ROWS])
                         for v in range(0, len(urows), PACK_ROWS)]
                u = int(f["utiles"][c * T + bx]) + sum(usums[:nw_before])
                for r in range(PACK_ROWS):
                    if b0 + r < NB:
                        f["uex"][c * NB + b0 + r] = u
                        u += urows[off + r]
            for r in range(PACK_ROWS):
                b = b0 + r
                if b >= NB:
                    continue
                row = c * NB + b
                wb = int(wire[hdr + row])
                w = int(WIDTHS[wb & 31]) if (wb & 31) < len(WIDTHS) else 0
                goff = before
                before += w
                if w == 0:
                    continue
                cand = ((wb >> 5) & 1) | (((wb >> 6) & 1) << 1)
                d2, d3 = diffs(row_window(*own, r))
                v = d3 if cand & 1 else d2
                if cand & 2:
                    p2, p3 = diffs(row_window(*par, r))
                    v = v - (p3 if cand & 1 else p2)
                i0 = b * pp.BLOCK + 4 * lanes
                inside = (i0[:, None] + np.arange(4)) < L
                z = np.where(inside, zigzag(v) & ((1 << w) - 1), 0)
                if w <= 8:  # a lane's 4 values as one 4w-bit chunk
                    val = (z << (w * np.arange(4))).sum(axis=1)
                    unit = 4 * w
                else:
                    val = z.reshape(-1)
                    unit = w
                words = {}
                for lane in range(32):
                    for j in range(3):
                        k = lane + 32 * j
                        if k >= 4 * w:
                            continue
                        bit0 = 32 * k
                        inv = ((1 << 20) + unit - 1) // unit
                        e0, e1 = (bit0 * inv) >> 20, ((bit0 + 31) * inv) >> 20
                        assert (e0, e1) == (bit0 // unit, (bit0 + 31) // unit)
                        assert e1 - e0 < 9
                        o = e0 * unit - bit0
                        acc = int(val[e0]) >> -o
                        for e in range(e0 + 1, e1 + 1):
                            o += unit
                            acc |= int(val[e]) << o
                        words[k] = acc & U32
                dst = pay + 16 * goff
                if store == 16:  # lane j < w: group j as one 16-byte store
                    for j in range(w):
                        if goff + j < cap_groups:
                            g = np.array([words[4 * j + i] for i in range(4)],
                                         dtype="<u4")
                            wire[dst + 16 * j : dst + 16 * j + 16] = g.view(
                                np.uint8)
                else:  # the words, as words or as bytes
                    for k, word in words.items():
                        if goff + k // 4 < cap_groups:
                            wire[dst + 4 * k : dst + 4 * k + 4] = np.array(
                                [word], dtype="<u4").view(np.uint8)
    return store


def model_wire(q, cap_groups, cap_uwords, cap_urow, rice, step=None):
    """The wire K4's select, K6's scan and K6's pack make of q (the unary
    section, K7's, left 0), and the scan."""
    C, L = q.shape
    wbyte, ubits = pp.dpack_select_plain(torch.from_numpy(q), rice)
    wbyte, ubits = wbyte.numpy(), ubits.numpy()
    nbt = wbyte.shape[0]
    hdr = pp.wire_header_bytes(C)
    wire = np.zeros(pp.wire_bytes(C, nbt, cap_groups, cap_uwords, rice),
                    dtype=np.uint8)
    wire[hdr : hdr + nbt] = wbyte
    kw = {} if step is None else {"step": step}
    scan, head = scan_model(wbyte, ubits, C, cap_groups, cap_urow, rice, **kw)
    wire[:hdr] = head.astype("<u4").view(np.uint8)
    store = pack_model(q, wire, scan, ubits, C, L, cap_groups, rice)
    return wire, scan, wbyte, ubits, store


def plane_end(wire, C, nbt, cap_groups):
    """End of the kept plane section: HDR + NBt + min(plane, 16*cap)."""
    widx = wire[pp.wire_header_bytes(C) : pp.wire_header_bytes(C) + nbt]
    return (pp.wire_header_bytes(C) + nbt
            + min(pp.plane_bytes_of(widx), 16 * cap_groups))


# -- K6: tests ----------------------------------------------------------------


@pytest.mark.parametrize("rice", [False, True])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_k6_model_matches_twin(case, rice):
    """The scan and the pack equal the twins (``dpack_scan``,
    ``dpack_pack_plain``) byte for byte below the plane section's end, at
    the kernel's step and at a step of 4 tiles (several steps); the
    payload offset is of the case's class."""
    C, L, content, cls = case
    q = q_of(C, L, content)
    nbt = pp.wire_rows(L, C)
    caps = pp.wire_caps(nbt, True)
    wire, scan, wbyte, ubits, store = model_wire(q, *caps, rice)
    assert store == cls
    twin_scan = pp.dpack_scan(torch.from_numpy(wbyte),
                              torch.from_numpy(ubits), caps[2], rice, C)
    assert np.array_equal(scan, twin_scan.numpy())
    small, _ = scan_model(wbyte, ubits, C, caps[0], caps[2], rice, step=4)
    pack_model(q, wire.copy(), small, ubits, C, L, caps[0], rice)
    assert np.array_equal(small, scan)
    twin = pp.dpack_pack_plain(torch.from_numpy(q).to(torch.int16),
                               torch.from_numpy(wbyte), twin_scan, caps[0],
                               rice).numpy()
    end = plane_end(wire, C, nbt, caps[0])
    assert np.array_equal(wire[:end], twin[:end])
    if rice:
        assert (wbyte >> 7).any(), "the case must pick rice blocks"


@pytest.mark.parametrize("C,L,rice", [
    (1, 1000, False), (2, 3072, False), (3, 1300, False), (6, 1000, False),
    (8, 1100, False), (3, 1300, True)])
def test_k6_model_matches_pack_pcm(C, L, rice):
    """The model's header, widx table and plane section equal JAX
    ``pack_pcm``'s of the same q, byte for byte below nbytes; the scan's
    unary totals are those of the reference's unary section. (Rice on is
    held to JAX on one case, each JAX compile of it costing seconds; the
    others are held to the twin, which test_torch_pcm_pack.py holds to
    JAX.)"""
    q = q_of(C, L, "crafted" if C != 6 else "tone")
    nbt = pp.wire_rows(L, C)
    cap, ucap, urow = pp.wire_caps(nbt, True)
    wire, scan, _, _, _ = model_wire(q, cap, ucap, urow, rice)
    payload, nbytes, widx, cuts = map(np.asarray, jax.jit(
        lambda a: ref.pack_pcm(a, cap, ucap, urow, rice=rice))(jnp.asarray(q)))
    hdr = pp.wire_header_bytes(C)
    nb, plane_cap, got_cuts, got_widx = pp.parse_header(wire, nbt, C)
    assert nb == int(nbytes) and plane_cap == 16 * cap
    assert np.array_equal(got_widx, widx) and np.array_equal(got_cuts, cuts)
    plane = pp.plane_bytes_of(widx)
    f = pp.scan_fields(scan, C, nbt // C, rice)
    assert 16 * int(f["groups"][0]) == plane
    assert np.array_equal(wire[hdr + nbt : hdr + nbt + plane], payload[:plane])
    if rice:
        ub = 4 * ((int(cuts[-1]) + 31) // 32)
        assert nb == plane + 4 * int(f["uwords"][0]) and ub == nb - plane


def test_every_rung_occurs():
    """The crafted q picks every WIDTHS rung in each channel (width-only),
    and the model's wire holds all of them."""
    q = q_of(2, 3072, "crafted")
    wbyte, _ = pp.dpack_select_plain(torch.from_numpy(q), False)
    rungs = (wbyte.numpy() & 31).reshape(2, -1)
    for c in range(2):
        assert set(rungs[c].tolist()) == set(range(len(pp.WIDTHS)))


@pytest.mark.parametrize("rice", [False, True])
def test_k6_cap_cuts_a_block(rice):
    """cap_groups inside a block of width >= 2: the model keeps its first
    groups and drops the rest and every later block's, as the twin and JAX
    ``pack_pcm`` do; nbytes still reports the true size."""
    C, L = 3, 1300
    q = q_of(C, L, "crafted")
    nbt = pp.wire_rows(L, C)
    wbyte, ubits = pp.dpack_select_plain(torch.from_numpy(q), rice)
    scan = pp.dpack_scan(wbyte, ubits, pp.UNARY_WORDS_FULL_PER_BLOCK, rice, C)
    w = WIDTHS[wbyte.numpy() & 31]
    gex = np.cumsum(w) - w
    row = int(np.flatnonzero(w >= 10)[len(np.flatnonzero(w >= 10)) // 2])
    cap = int(gex[row]) + int(w[row]) // 2
    _, ucap, urow = pp.wire_caps(nbt, True)
    wire, _, _, _, _ = model_wire(q, cap, ucap, urow, rice)
    twin = pp.dpack_pack_plain(torch.from_numpy(q).to(torch.int16), wbyte,
                               scan, cap, rice).numpy()
    hdr = pp.wire_header_bytes(C)
    end = hdr + nbt + 16 * cap
    assert pp.plane_bytes_of(wbyte.numpy()) > 16 * cap
    assert np.array_equal(wire[:end], twin[:end])
    if not rice:
        payload, nbytes, _, _ = map(np.asarray, jax.jit(
            lambda a: ref.pack_pcm(a, cap, ucap, urow, rice=False))(
                jnp.asarray(q)))
        assert pp.parse_header(wire, nbt, C)[0] == int(nbytes)
        assert np.array_equal(wire[hdr + nbt : end], payload[: 16 * cap])


def test_k6_unit_reciprocals():
    """K6's table of ceil(2^20 / unit) per rung (csrc/dpack_pack.cu) is the
    formula's, and (n * inv) >> 20 == n // unit for every bit offset a
    block can have."""
    src = (pathlib.Path(pp.__file__).parents[1] / "csrc"
           / "dpack_pack.cu").read_text()
    body = re.search(r"vp_unit_inv\[VP_NW\] = \{([^}]*)\}", src).group(1)
    table = [int(v) for v in body.replace("\n", " ").split(",")]
    units = [4 * w if w <= 8 else w for w in pp.WIDTHS[1:]]
    assert table == [0] + [((1 << 20) + u - 1) // u for u in units]
    n = np.arange(32 * 4 * pp.MAX_W + 32)
    for u, inv in zip(units, table[1:]):
        assert np.array_equal((n * inv) >> 20, n // u)


def test_k6_scan_guard_and_wrap():
    """int32 holds below the guard: 72 * NBt < 2^31 passes, one more row
    raises; the header's u32 words wrap as the reference's uint32 does."""
    n = (2**31 - 1) // pp.UNARY_WORDS_FULL_PER_BLOCK
    pp.check_scan_range(n)
    with pytest.raises(ValueError, match="2\\^31"):
        pp.check_scan_range(n + 1)
    wbyte = np.full(4, 11, dtype=np.uint8)  # width 18: 18 groups a block
    _, head = scan_model(wbyte, np.zeros(4, np.int32), 1, 2**29, 72, False)
    assert int(head[0]) == 16 * 72 and int(head[1]) == (16 * 2**29) & U32


# -- K3 -----------------------------------------------------------------------

_PARTS: dict = {}


def parts_of(group):
    """Each bucket's (residues, floors, steps) of a group's first chunk,
    through the port's stages before K3 (their twins on the CPU)."""
    if group not in _PARTS:
        synth, sig, host, _ = first_chunk(make_streams(group))
        bufs = [torch.from_numpy(a) for a in host]
        _PARTS[group] = [(synth.residues(bk), synth.floors(bk),
                          bk["tables"]["steps"])
                         for bk in synth.buckets(sig, bufs)]
    return _PARTS[group]


def reference(parts):
    """JAX inverse_couple_batch times the floors, a bucket at a time."""
    return [np.asarray(inverse_couple_batch(
        jnp.asarray(r.numpy()), tuple(map(tuple, s.tolist())))) * f.numpy()
        for r, f, s in parts]


def k3_model(parts):
    """couple_spectrum_kernel in numpy: first tiles from the C entry, each
    CTA's bucket by the walk over them, a thread's 4 bins of one frame (the
    frame and the bin by a shift and a mask) and every channel, the steps in
    reverse order on its registers, then the floor product."""
    firsts, tiles = [], 0
    for r, _, _ in parts:
        F, _, half = r.shape
        firsts.append(tiles)
        tiles += -(-(F * half // 4) // K3_THREADS)
    outs = [np.full(r.shape, np.nan, dtype=np.float32) for r, _, _ in parts]
    for blk in range(tiles):
        k = 0
        while k + 1 < len(parts) and blk >= firsts[k + 1]:
            k += 1
        res, flo, steps = (p.numpy() for p in parts[k])
        F, C, half = res.shape
        lg = (half // 4).bit_length() - 1
        t = (blk - firsts[k]) * K3_THREADS + np.arange(K3_THREADS)
        t = t[t < F * half // 4]
        f, x = t >> lg, t & ((1 << lg) - 1)
        cols = 4 * x[:, None] + np.arange(4)
        v = res[f[:, None, None], np.arange(C)[:, None], cols[:, None, :]]
        fl = flo[f[:, None, None], np.arange(C)[:, None], cols[:, None, :]]
        for m, a in steps[::-1]:
            mag, ang = v[:, m].copy(), v[:, a].copy()
            nm = np.where(ang > 0, mag, np.where(mag > 0, mag + ang, mag - ang))
            na = np.where(ang > 0, np.where(mag > 0, mag - ang, mag + ang), mag)
            v[:, m] = nm
            v[:, a] = na
        outs[k][f[:, None, None], np.arange(C)[:, None], cols[:, None, :]] = (
            v * fl)
    return outs


def many_channel_parts():
    """Two buckets of a ten-channel chunk (K3's in-place path past 8
    channels), with steps that reuse channels and one whose channels
    coincide."""
    rng = np.random.default_rng(11)
    steps = torch.tensor([[0, 1], [2, 3], [4, 5], [0, 2], [6, 7], [8, 9],
                          [3, 3], [1, 9]], dtype=torch.int32)
    parts = []
    for F, half in ((5, 32), (3, 256)):
        res = rng.standard_normal((F, 10, half)).astype(np.float32)
        res[rng.random(res.shape) < 0.2] = 0.0
        flo = rng.uniform(0.0, 2.0, (F, 10, half)).astype(np.float32)
        parts.append((torch.from_numpy(res), torch.from_numpy(flo), steps))
    return parts


@pytest.mark.parametrize("group", ["stereo", "surround", "floor0", "many"])
def test_couple_spectrum_chunk_matches_reference(group):
    """The chunk wrapper (the twin a bucket on the CPU) and the kernel's
    model equal JAX, bit for bit, on every bucket; the flat buffer holds
    the buckets back to back."""
    parts = many_channel_parts() if group == "many" else parts_of(group)
    if group == "surround":
        assert parts[0][2].shape[0] >= 2
    want = reference(parts)
    flat, views = coupling.couple_spectrum_chunk(parts)
    assert flat.dtype == torch.float32 and flat.numel() == sum(
        v.numel() for v in views)
    off = 0
    for v, w, (r, _, _) in zip(views, want, parts):
        assert v.shape == r.shape and v.is_contiguous()
        assert v.data_ptr() == flat.data_ptr() + 4 * off
        assert np.array_equal(v.numpy(), w)
        off += v.numel()
    for got, w in zip(k3_model(parts), want):
        assert np.array_equal(got, w)


def test_couple_spectrum_is_a_one_bucket_chunk():
    parts = parts_of("stereo")
    for r, f, s in parts:
        assert torch.equal(coupling.couple_spectrum(r, f, s),
                           coupling.couple_spectrum_plain(r, f, s))
