"""Delta block-pack (dpack) s16 wire: the select, kernels K6-K7, their twins,
the host half.

Port of vorbispizza_tpu/ops/pcm_pack.py (which imports jax, so its
constants and host helpers are carried over here). The wire is ONE device
buffer, laid out as models/pipeline.py ``_fused_body`` assembles it::

    [i32 nbytes][u32 16*cap_groups][u32 ch_ubit[C]][u8 widx|flags[NBt]]
    [payload: plane section (16-byte groups) | unary section]

Per 128-sample block the packer picks one of four candidates (second or
third difference, own or minus the pair partner's), zigzags it and codes
it either at the narrowest ``WIDTHS`` rung holding the block max (width
mode) or as a k-bit low plane plus unary high parts (rice mode, bit 7),
by exact bit cost. Three stages, each in a hand-written kernel with a
plain PyTorch twin:

    select   (K4's dpack mode, csrc/ola_assemble.cu)  widx|flags byte +
             unary bits per block, from the q K4 has just made
    K6 dpack_pack   (csrc/dpack_pack.cu)    the scans, header + plane
                                            section
    K7 dpack_unary  (csrc/dpack_unary.cu)   unary section (rice wires only)

The select (``dpack_select_plain`` is its twin) emits only the CHOICE per
block; K6 and K7 rebuild the winner's zigzag from q (four int16 reads per
sample) instead of reading a [NBt, 128] u32 plane and a [NBt, 128] i32
unary-length tensor that the select would have to write: 1 KiB a block of
device traffic saved twice. The exclusive scans between the stages (each
block's offset in 16-byte groups and in unary words, the channel cuts, the
row-overflow flag) run in K6's C entry into an int32 scratch that K7 reads
(``scan_fields``); ``dpack_scan`` is its plain twin.

``select_candidate_plain`` is the reference's ``select_candidate``;
``dpack_wire_plain`` its ``pack_pcm`` plus the header, byte-identical to
the JAX wire in every byte below nbytes for the same q.

The s16 quantize (reference stage 7) lives in kernel K4 (ops/ola.py); its
twin ``quantize_plain`` is here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..decoder import CLIP_MAX
from ..kernels import build as K

#: allowed block bit-widths (u32-word-multiple block sizes); must match
#: vp_unpack_pcm's table in native/frontend.cpp
WIDTHS = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 18)
BLOCK = 128
MAX_W = WIDTHS[-1]
#: u32 words per block for each width
WORDS = tuple(w * BLOCK // 32 for w in WIDTHS)
#: rice k rungs: the WIDTHS indices usable as a low-plane width
RICE_K_IDX = tuple(i for i, w in enumerate(WIDTHS) if w <= 15)
#: worst-case 16-byte groups per block (width 18)
G_PER = 4 * WORDS[-1] // 16
#: soft plane capacity, groups per block averaged over the chunk ("s16d")
SOFT_GROUPS_PER_BLOCK = 6
#: unary capacities in u32 words: the hard per-block bound (a block picks
#: rice only when it undercuts its width coding, <= 128*18 bits), the soft
#: per-block deposit row and the soft chunk average ("s16d")
UNARY_WORDS_FULL_PER_BLOCK = BLOCK * MAX_W // 32
UNARY_ROW_WORDS_SOFT = 32
SOFT_UNARY_WORDS_PER_BLOCK = 12
#: nbytes sentinel of a wire whose unary deposit overflowed its row cap
ROW_OVER_NBYTES = 0x7FFFFFF0
#: the fused body's outputs that are this wire: soft ("s16d") and full
#: ("s16df") capacity
DPACK = ("s16d", "s16df")
#: larger than any real block cost (<= 2^27 bits)
INF = 1 << 29

#: spec channel orders pair the correlated front L/R and surround pairs
_PARTNERS = {
    3: (0, 1, 0),                   # L C R
    5: (0, 1, 0, 3, 3),             # L C R Rl Rr
    6: (0, 1, 0, 3, 3, 5),          # L C R Rl Rr LFE
    7: (0, 1, 0, 3, 3, 5, 6),       # L C R Sl Sr Rc LFE
    8: (0, 1, 0, 3, 3, 5, 5, 7),    # L C R Sl Sr Rl Rr LFE
}


class PackOverflow(Exception):
    """A wire section holds more than its capacity (soft caps only)."""


def wire_header_bytes(channels: int) -> int:
    """u32 nbytes, u32 plane-section capacity, u32 ch_ubit per channel."""
    return 8 + 4 * channels


def wire_rows(out_len: int, channels: int = 1) -> int:
    """Width-byte rows of the wire: one per 128-sample block per channel."""
    return channels * (-(-out_len // BLOCK))


def pair_partner(C: int) -> np.ndarray:
    """Per-channel inter-candidate partner (partner[c] == c: none)."""
    if C in _PARTNERS:
        return np.array(_PARTNERS[C])
    ch = np.arange(C)
    return np.where(ch % 2 == 1, ch - 1, ch)


def plane_bytes_of(widx: np.ndarray) -> int:
    """Exact plane-section bytes from the width table; raises on a rung
    past the table."""
    wclass = (np.asarray(widx) & 0x1F).astype(np.int64)
    if wclass.size and int(wclass.max()) >= len(WIDTHS):
        raise ValueError(f"dpack width class {int(wclass.max())} out of range")
    return int(np.asarray(WIDTHS, dtype=np.int64)[wclass].sum()) * 16


def wire_caps(nbt: int, full: bool) -> tuple[int, int, int]:
    """(cap_groups, cap_uwords, cap_urow) of "s16df" (full) or "s16d"
    (soft), as models/pipeline.py _fused_body sizes them."""
    from ..models.pipeline import _pad_size

    cap = nbt * G_PER
    ucap = nbt * UNARY_WORDS_FULL_PER_BLOCK
    if full:
        return cap, ucap, UNARY_WORDS_FULL_PER_BLOCK
    return (
        min(_pad_size(nbt * SOFT_GROUPS_PER_BLOCK, 4096), cap),
        min(_pad_size(nbt * SOFT_UNARY_WORDS_PER_BLOCK, 1024), ucap),
        UNARY_ROW_WORDS_SOFT,
    )


def wire_bytes(channels: int, nbt: int, cap_groups: int, cap_uwords: int,
               rice: bool) -> int:
    """Length of the whole wire buffer."""
    return (wire_header_bytes(channels) + nbt + 16 * cap_groups
            + (4 * cap_uwords if rice else 0))


# -- s16 quantize (twin of K4's s16 modes) -------------------------------------


def quantize_plain(pcm: torch.Tensor) -> torch.Tensor:
    """ov_read-compatible quantize: clip to +-CLIP_MAX, x32768, round half
    to even, clip to the s16 range -> int32 (models/pipeline.py:819-826)."""
    scaled = pcm.clamp(-float(CLIP_MAX), float(CLIP_MAX)) * 32768.0
    return torch.round(scaled).clamp(-32768.0, 32767.0).to(torch.int32)


def planes_plain(q: torch.Tensor) -> torch.Tensor:
    """s16p byte planes [2, C, L] u8 (lo, hi of q + 32768)."""
    u = q.to(torch.int32) + 32768
    return torch.stack([u & 0xFF, u >> 8]).to(torch.uint8)


# -- plain twins of the select, K6 and K7 ---------------------------------------


def _table(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int64, device=device)


def _candidates(q: torch.Tensor):
    """Zigzagged candidate blocks [NBt, BLOCK] int64 in the reference's
    order d2, d3, i2, i3 (the inter pair only for C >= 2), padded in
    zigzag space past L."""
    C, L = q.shape
    NB = -(-L // BLOCK)
    qi = q.to(torch.int64)
    zero = qi.new_zeros((C, 1))
    d1 = torch.diff(qi, dim=1, prepend=zero)
    d2 = torch.diff(d1, dim=1, prepend=zero)
    d3 = torch.diff(d2, dim=1, prepend=zero)

    def zig_blocks(d):
        z = (d << 1) ^ (d >> 63)
        z = torch.nn.functional.pad(z, (0, NB * BLOCK - L))
        return z.reshape(C * NB, BLOCK)

    cands = [zig_blocks(d2), zig_blocks(d3)]
    if C >= 2:
        partner = torch.from_numpy(pair_partner(C)).to(q.device)
        cands += [zig_blocks(d2 - d2[partner]), zig_blocks(d3 - d3[partner])]
    return cands


def _inter_ok(C: int, NB: int, device) -> torch.Tensor:
    p = pair_partner(C)
    rows_ch = np.arange(C * NB) // max(NB, 1)
    return torch.from_numpy(p[rows_ch] != rows_ch).to(device)


def select_candidate_plain(q: torch.Tensor, rice: bool):
    """The reference's select_candidate: q [C, L] -> (blk [NBt, BLOCK]
    int64 low plane of the winner, widx int32 [NBt], flags int32 [NBt],
    ulen int32 [NBt, BLOCK] = high part + 1 on rice blocks, else 0)."""
    C, L = q.shape
    NB = -(-L // BLOCK)
    dev = q.device
    cands = _candidates(q)
    w_tbl = _table(WIDTHS, dev)
    rice_w = [WIDTHS[i] for i in RICE_K_IDX]
    flags_tbl = [0, 1 << 5, 1 << 6, (1 << 5) | (1 << 6)]
    costs, widx_c, rice_c = [], [], []
    for k, cb in enumerate(cands):
        m = cb.max(dim=1).values
        wi = sum((m > (1 << w) - 1).to(torch.int64) for w in WIDTHS[:-1])
        wcost = torch.where(m > (1 << MAX_W) - 1, INF, w_tbl[wi] * BLOCK)
        if rice:
            rstack = torch.stack([
                BLOCK * kw + (((cb >> kw).sum(dim=1) + BLOCK + 31) & ~31)
                for kw in rice_w
            ])
            rcost = rstack.min(dim=0).values
            rbest = rstack.argmin(dim=0)  # first minimum: smallest k
            use_rice = rcost < wcost  # ties -> width
            cost = torch.minimum(rcost, wcost)
            widx_c.append(torch.where(use_rice, _table(RICE_K_IDX, dev)[rbest],
                                      wi))
        else:
            use_rice = torch.zeros_like(m, dtype=torch.bool)
            cost = wcost
            widx_c.append(wi)
        if k >= 2:
            cost = torch.where(_inter_ok(C, NB, dev), cost, INF)
        costs.append(cost)
        rice_c.append(use_rice)
    best = torch.stack(costs).argmin(dim=0)  # first minimum: earlier wins
    rows = torch.arange(best.shape[0], device=dev)
    blk = torch.stack(cands)[best, rows]
    widx = torch.stack(widx_c)[best, rows]
    is_rice = torch.stack(rice_c)[best, rows]
    flags = _table(flags_tbl, dev)[best] | (is_rice.to(torch.int64) << 7)
    wv = w_tbl[widx]
    high = blk >> wv[:, None]
    ulen = torch.where(is_rice[:, None], high + 1, 0)
    blk = torch.where(is_rice[:, None], blk & ((1 << wv[:, None]) - 1), blk)
    return blk, widx.to(torch.int32), flags.to(torch.int32), ulen.to(torch.int32)


def dpack_select_plain(q: torch.Tensor, rice: bool):
    """Twin of the select in K4's dpack mode: (widx|flags u8 [NBt], unary
    bits int32 [NBt] = sum of ulen, 0 on width blocks)."""
    _, widx, flags, ulen = select_candidate_plain(q, rice)
    return (widx | flags).to(torch.uint8), ulen.sum(dim=1, dtype=torch.int32)


def _winner(q: torch.Tensor, wbyte: torch.Tensor) -> torch.Tensor:
    """The chosen candidate's zigzag [NBt, BLOCK] rebuilt from q and the
    widx|flags byte (what K6 and K7 do per sample)."""
    cands = _candidates(q)
    cand = ((wbyte >> 5) & 1).long() | (((wbyte >> 6) & 1).long() << 1)
    if len(cands) == 2 and bool((cand >= 2).any()):
        raise ValueError("inter candidate on a one-channel wire")
    rows = torch.arange(wbyte.shape[0], device=q.device)
    return torch.stack(cands)[cand, rows]


#: K6's scan scratch (csrc/dpack.cuh): int32 [groups, unary words, row
#: overflow, 0], then from SCAN_HEAD the exclusive group offset of each tile
#: (TILE_ROWS consecutive block rows of one channel, a K6 pack CTA's) and,
#: on a rice wire, each tile's exclusive unary-word offset, then each block
#: row's; the tile runs padded to a multiple of 4 entries
SCAN_HEAD = 4
TILE_ROWS = 32


def _tiles(C: int, NB: int) -> int:
    return C * -(-NB // TILE_ROWS)


def scan_size(C: int, NB: int, rice: bool) -> int:
    """int32 entries of K6's scan scratch for C channels of NB blocks."""
    pad = -(-_tiles(C, NB) // 4) * 4
    return SCAN_HEAD + pad + (pad + C * NB if rice else 0)


def scan_fields(scan, C: int, NB: int, rice: bool) -> dict:
    """Views of K6's scan: "groups", "uwords", "over" (one entry each),
    "tiles" (each tile's exclusive group offset) and, on a rice wire,
    "utiles" and "uex" (each tile's and each block row's exclusive
    unary-word offset)."""
    nt = _tiles(C, NB)
    pad = -(-nt // 4) * 4
    u0, r0 = SCAN_HEAD + pad, SCAN_HEAD + 2 * pad
    return {"groups": scan[0:1], "uwords": scan[1:2], "over": scan[2:3],
            "tiles": scan[SCAN_HEAD : SCAN_HEAD + nt],
            "utiles": scan[u0 : u0 + nt] if rice else None,
            "uex": scan[r0 : r0 + C * NB] if rice else None}


def tile_starts(C: int, NB: int) -> np.ndarray:
    """The first block row of each of K6's tiles, in row order."""
    first = np.arange(0, NB, TILE_ROWS)
    return (np.arange(C)[:, None] * NB + first[None, :]).reshape(-1)


def check_scan_range(nbt: int) -> None:
    """K6's scan sums in int32: a block has at most 18 groups and 72 unary
    words, so 72 * nbt must stay below 2^31."""
    if UNARY_WORDS_FULL_PER_BLOCK * nbt >= 2**31:
        raise ValueError(f"K6 scans in 32 bits: 72 * NBt ({nbt}) must stay "
                         "below 2^31")


def dpack_scan(wbyte: torch.Tensor, ubits: torch.Tensor, cap_urow: int,
               rice: bool, C: int) -> torch.Tensor:
    """Plain twin of K6's scan (int64 cumsums, stored as int32 in its
    layout, ``scan_fields``) of the C channels' widx table ``wbyte`` and
    unary bits ``ubits``: the tiles' exclusive offsets in 16-byte groups,
    (rice) the tiles' and the blocks' in unary words, their totals, and
    whether a block's unary words exceed the deposit row."""
    nbt = wbyte.shape[0]
    NB = nbt // max(C, 1)
    check_scan_range(nbt)
    out = torch.zeros(scan_size(C, NB, rice), dtype=torch.int32,
                      device=wbyte.device)
    f = scan_fields(out, C, NB, rice)
    w = _table(WIDTHS, wbyte.device)[(wbyte & 0x1F).long()]
    f["groups"][0] = w.sum()
    starts = torch.from_numpy(tile_starts(C, NB)).to(wbyte.device)
    f["tiles"][:] = (torch.cumsum(w, 0) - w)[starts]
    if rice:
        uw = (ubits.to(torch.int64) + 31) >> 5
        f["uwords"][0] = uw.sum()
        f["over"][0] = (uw > cap_urow).any()
        f["uex"][:] = torch.cumsum(uw, 0) - uw
        f["utiles"][:] = f["uex"][starts]
    return out


def _le_bytes(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> their low 32 bits as little-endian u8."""
    sh = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=x.device)
    return ((x.reshape(-1, 1) >> sh) & 0xFF).to(torch.uint8).reshape(-1)


def pack_planes_plain(blk: torch.Tensor, widx: torch.Tensor, cap_groups: int):
    """LSB-first w-bit pack of every block, blocks back to back at 16-byte
    granularity, groups past ``cap_groups`` dropped -> (u8 [16*cap_groups],
    true plane bytes). A direct bit pack: no selection matrix."""
    dev = blk.device
    w = _table(WIDTHS, dev)[widx.long()]
    goff = torch.cumsum(w, 0) - w
    out = torch.zeros(16 * cap_groups, dtype=torch.uint8, device=dev)
    for wi, wv in enumerate(WIDTHS):
        sel = torch.nonzero(widx == wi).reshape(-1)
        if wv == 0 or sel.numel() == 0:
            continue
        bits = (blk[sel][:, :, None] >> torch.arange(wv, device=dev)) & 1
        bits = bits.reshape(sel.numel(), 16 * wv, 8)
        by = (bits << torch.arange(8, device=dev)).sum(dim=2)
        pos = goff[sel][:, None] * 16 + torch.arange(16 * wv, device=dev)
        keep = pos < 16 * cap_groups
        out[pos[keep]] = by[keep].to(torch.uint8)
    return out, 16 * int(w.sum())


def pack_unary_plain(ulen: torch.Tensor, channels: int, cap_words: int,
                     cap_row_words: int):
    """The reference's pack_unary: per rice block the high parts as q zeros
    + a 1 terminator, padded to a u32 word, words compacted -> (u8
    [4*cap_words], true unary bytes, ch_ubit int64 [C], row_over). Row
    words past ``cap_row_words`` ship as 0 (the wire's nbytes says
    ROW_OVER_NBYTES then)."""
    dev = ulen.device
    NBt = ulen.shape[0]
    W = cap_row_words
    if NBt == 0:
        return (torch.zeros(4 * cap_words, dtype=torch.uint8, device=dev), 0,
                torch.zeros(channels, dtype=torch.int64, device=dev), False)
    ends = torch.cumsum(ulen.to(torch.int64), dim=1)
    uw = (ends[:, -1] + 31) >> 5
    row_over = bool((uw > W).any())
    pos = ends - 1
    word = pos >> 5
    keep = (ulen > 0) & (word < W)
    rows = torch.zeros(NBt * W, dtype=torch.int64, device=dev)
    b = torch.arange(NBt, device=dev)[:, None].expand_as(pos)
    rows.index_add_(0, (b * W + word)[keep], (1 << (pos & 31))[keep])
    goff = torch.cumsum(uw, 0) - uw
    NB = NBt // max(channels, 1)
    cut = torch.arange(1, channels + 1, device=dev) * NB - 1
    ch_ubit = 32 * (goff[cut] + uw[cut])
    lw = torch.arange(W, device=dev)
    g = goff[:, None] + lw
    m = (lw < uw[:, None]) & (g < cap_words)
    words = torch.zeros(cap_words, dtype=torch.int64, device=dev)
    words[g[m]] = rows.reshape(NBt, W)[m]
    return _le_bytes(words), 4 * int(uw.sum()), ch_ubit, row_over


def dpack_pack_plain(q, wbyte, scan, cap_groups: int, rice: bool):
    """Twin of K6: header + widx + plane section, u8 [HDR + NBt +
    16*cap_groups]. ``scan``: ``dpack_scan``'s."""
    C = q.shape[0]
    NBt = wbyte.shape[0]
    NB = NBt // max(C, 1)
    dev = q.device
    f = {k: None if v is None else v.to(torch.int64)
         for k, v in scan_fields(scan, C, NB, rice).items()}
    blk = _winner(q, wbyte)
    w = _table(WIDTHS, dev)[(wbyte & 0x1F).long()]
    blk = blk & ((1 << w[:, None]) - 1)
    planes, _ = pack_planes_plain(blk, (wbyte & 0x1F).long(), cap_groups)
    nbytes = 16 * f["groups"] + 4 * f["uwords"]
    nbytes = torch.where(f["over"] > 0, ROW_OVER_NBYTES, nbytes)
    cuts = torch.zeros(C, dtype=torch.int64, device=dev)
    if rice:  # the unary words up to each channel's end
        cuts = 32 * torch.cat([f["uex"][NB::NB][: C - 1], f["uwords"]])
    head = torch.cat([nbytes, _table([16 * cap_groups], dev), cuts])
    return torch.cat([_le_bytes(head), wbyte, planes])


def unary_lengths_plain(q, wbyte) -> torch.Tensor:
    """The unary lengths K7 rebuilds from q and the widx|flags bytes, int64
    [NBt, BLOCK]: (z >> k) + 1 of the winner's zigzag z on rice blocks
    (k the rung's width), 0 on width blocks. Their row sums are the select's
    unary bits for any widx|flags bytes, chosen by the select or not."""
    z = _winner(q, wbyte)
    w = _table(WIDTHS, q.device)[(wbyte & 0x1F).long()]
    is_rice = (wbyte >> 7).bool()
    return torch.where(is_rice[:, None], (z >> w[:, None]) + 1, 0)


def lowered_rungs(q, wbyte):
    """``wbyte`` with a third of its rice rows one rung lower and another
    third two lower (as far as rung 0), and the unary bits of the result,
    int32 [NBt]: rows past the soft row cap, which no select makes (a row
    picks rice only while it undercuts its width coding)."""
    wb = wbyte.long()
    rung = wb & 31
    idx = torch.arange(wb.shape[0], device=wb.device)
    drop = torch.where((wb >> 7).bool(), (idx % 3 + 1) % 3, 0)
    cut = ((wb & ~31) | (rung - torch.minimum(drop, rung))).to(torch.uint8)
    return cut, unary_lengths_plain(q, cut).sum(dim=1).to(torch.int32)


def dpack_unary_plain(q, wbyte, cap_uwords: int, cap_urow: int):
    """Twin of K7: the compacted unary section, u8 [4*cap_uwords]."""
    return pack_unary_plain(unary_lengths_plain(q, wbyte), q.shape[0],
                            cap_uwords, cap_urow)[0]


def dpack_wire_plain(q: torch.Tensor, cap_groups: int, cap_uwords: int,
                     cap_urow: int, rice: bool, select=None) -> torch.Tensor:
    """The whole wire of q [C, L] (the reference's pack_pcm + header):
    u8 [wire_bytes(...)]. ``select``: q's (widx|flags, unary bits), made
    here when not given."""
    C = q.shape[0]
    wbyte, ubits = select if select is not None else dpack_select_plain(
        q, rice)
    scan = dpack_scan(wbyte, ubits, cap_urow, rice, C)
    wire = dpack_pack_plain(q, wbyte, scan, cap_groups, rice)
    if not rice:
        return wire
    unary = dpack_unary_plain(q, wbyte, cap_uwords, cap_urow)
    pay = torch.cat([wire[wire_header_bytes(C) + wbyte.shape[0]:],
                     torch.zeros_like(unary)])
    start = min(16 * int(scan[0]), 16 * cap_groups)
    pay[start : start + unary.shape[0]] = unary
    return torch.cat([wire[: wire_header_bytes(C) + wbyte.shape[0]], pay])


# -- kernel wrappers: twin for CPU tensors, the kernels for CUDA ones -----------

_partners: dict = {}


def partner_table(C: int, device) -> torch.Tensor:
    """``pair_partner(C)`` as int32 on ``device`` (cached)."""
    key = (C, str(device))
    t = _partners.get(key)
    if t is None:
        t = torch.from_numpy(pair_partner(C).astype(np.int32)).to(device)
        _partners[key] = t
    return t


def _check_q(q: torch.Tensor) -> None:
    K.require_cuda(q)
    if q.dtype != torch.int16 or q.dim() != 2:
        raise TypeError("the dpack kernels take q as int16 [C, L]")


def dpack_select(q: torch.Tensor, rice: bool):
    """``dpack_select_plain`` for CPU tensors. On the card the select runs
    inside K4's dpack mode, on the q it makes, so a CUDA q raises."""
    if q.device.type == "cpu":
        return dpack_select_plain(q, rice)
    raise ValueError("the dpack select runs inside K4's dpack mode on the "
                     "card: ops.ola.ola_assemble(buckets, evs, L, 'dpack', "
                     "rice=rice) returns (q, widx|flags, unary bits)")


def wire_buffer(C: int, L: int, cap_groups: int, cap_uwords: int, rice: bool,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """An unfilled wire and the view of its widx table (u8 [NBt]), which
    K4's dpack mode writes."""
    NBt = wire_rows(L, C)
    HDR = wire_header_bytes(C)
    wire = torch.empty(wire_bytes(C, NBt, cap_groups, cap_uwords, rice),
                       dtype=torch.uint8, device=device)
    return wire, wire[HDR : HDR + NBt]


def dpack_pack(q: torch.Tensor, wire: torch.Tensor, ubits: torch.Tensor | None,
               cap_groups: int, cap_urow: int, rice: bool) -> torch.Tensor:
    """K6 into ``wire`` (CUDA only): its C entry scans the widx table that
    K4's dpack mode wrote into the wire (and, on a rice wire, K4's unary
    bits ``ubits``) into an int32 scratch, writes the header and packs the
    plane section; two device ops and no torch op. Returns the scratch
    (``scan_fields``), which K7 reads on a rice wire."""
    _check_q(q)
    K.require_cuda(wire)
    C, L = q.shape
    NB = -(-L // BLOCK)
    nbt = C * NB
    check_scan_range(nbt)
    if rice:
        K.require_cuda(ubits)
        if ubits.dtype != torch.int32 or ubits.shape != (nbt,):
            raise ValueError(f"ubits must be int32 [{nbt}]")
    if wire.data_ptr() % 16 or not 0 <= cap_groups < 2**31:
        raise ValueError("K6 takes a 16-byte aligned wire (wire_buffer) and "
                         "cap_groups below 2^31")
    scan = torch.empty(scan_size(C, NB, rice), dtype=torch.int32,
                       device=q.device)
    if nbt:
        K.launch("dpack_pack", q.data_ptr(),
                 partner_table(C, q.device).data_ptr(), wire.data_ptr(),
                 ubits.data_ptr() if rice else 0, scan.data_ptr(), C, L, NB,
                 wire_header_bytes(C), cap_groups, cap_urow, int(rice))
    return scan


def dpack_unary(q: torch.Tensor, wire: torch.Tensor, scan: torch.Tensor,
                cap_groups: int, cap_uwords: int, cap_urow: int) -> None:
    """K7 into ``wire`` (CUDA only): the unary section, placed at
    min(plane bytes, 16*cap_groups) of the payload. ``scan``: what K6
    returned for this wire with rice on."""
    _check_q(q)
    K.require_cuda(wire, scan)
    if not 0 < cap_urow <= UNARY_WORDS_FULL_PER_BLOCK:
        raise ValueError(f"cap_urow {cap_urow} outside 1..72")
    C, L = q.shape
    NB = -(-L // BLOCK)
    if scan.dtype != torch.int32 or scan.numel() != scan_size(C, NB, True):
        raise ValueError("scan is not K6's scan of a rice wire of this q")
    if wire.data_ptr() % 16:
        raise ValueError("K7 takes a 16-byte aligned wire (wire_buffer)")
    if C * NB:
        K.launch("dpack_unary", q.data_ptr(),
                 partner_table(C, q.device).data_ptr(), wire.data_ptr(),
                 scan.data_ptr(), C, L, NB, wire_header_bytes(C), cap_groups,
                 cap_uwords, cap_urow)


def dpack_wire(q: torch.Tensor, cap_groups: int, cap_uwords: int,
               cap_urow: int, rice: bool, select=None,
               wire: torch.Tensor | None = None) -> torch.Tensor:
    """The dpack wire of q. ``select``: (widx|flags, unary bits) of q, as
    K4's dpack mode made them; ``wire``: the buffer (``wire_buffer``) whose
    widx table is ``select``'s first tensor.

    CPU tensors: ``dpack_wire_plain`` (copied into ``wire`` when given).
    CUDA ones: K6 (its scans, the header and the planes; -> K7 on a rice
    wire) into ``wire``; both arguments are required. Bytes past nbytes
    are unspecified."""
    if q.device.type == "cpu":
        out = dpack_wire_plain(q, cap_groups, cap_uwords, cap_urow, rice,
                               select)
        return out if wire is None else wire.copy_(out)
    _check_q(q)
    C, L = q.shape
    NBt = wire_rows(L, C)
    HDR = wire_header_bytes(C)
    if select is None or wire is None:
        raise ValueError("dpack_wire on the card takes the select and the "
                         "wire of K4's dpack mode (ops.ola.ola_assemble(..., "
                         "'dpack', wbyte=wire_buffer(...)[1]))")
    wbyte, ubits = select
    K.require_cuda(wire, wbyte, ubits)
    if (wire.shape[0] != wire_bytes(C, NBt, cap_groups, cap_uwords, rice)
            or wbyte.data_ptr() != wire.data_ptr() + HDR
            or wbyte.shape != (NBt,)):
        raise ValueError("the select's widx table is not this wire's")
    scan = dpack_pack(q, wire, ubits, cap_groups, cap_urow, rice)
    if rice:
        dpack_unary(q, wire, scan, cap_groups, cap_uwords, cap_urow)
    return wire


# -- host half ------------------------------------------------------------------


def parse_header(h: np.ndarray, nbt: int, channels: int):
    """[u32 nbytes][u32 plane_cap][u32 ch_ubit[C]][widx u8[nbt]] ->
    (nbytes, plane_cap, ch_ubit, widx)."""
    HDR = wire_header_bytes(channels)
    if h.shape[0] < HDR + nbt:
        raise ValueError(f"dpack header needs {HDR + nbt} B, got {h.shape[0]}")
    nb = int(h[:4].view(np.int32)[0])
    plane_cap = int(h[4:8].view(np.uint32)[0])
    ch_ubit = h[8:HDR].view(np.uint32).copy()
    if ch_ubit.size and np.diff(ch_ubit.astype(np.int64)).min(initial=0) < 0:
        raise ValueError("dpack channel unary cuts are not monotonic")
    return nb, plane_cap, ch_ubit, h[HDR : HDR + nbt]


def check_sections(nb: int, plane_cap: int, ch_ubit: np.ndarray,
                   widx: np.ndarray, payload_cap: int):
    """Exact section checks (nbytes is always the TRUE total): a section
    past its capacity raises PackOverflow, any other size mismatch
    ValueError. Returns (plane bytes, unary bytes)."""
    plane_true = plane_bytes_of(widx)
    ubits = int(ch_ubit[-1]) if ch_ubit.size else 0
    ubytes = 4 * ((ubits + 31) // 32)
    if plane_true > plane_cap:
        raise PackOverflow(
            f"dpack plane section {plane_true} B exceeds cap {plane_cap} B")
    if ubytes > payload_cap - plane_cap:
        raise PackOverflow(f"dpack unary section {ubytes} B exceeds cap "
                           f"{payload_cap - plane_cap} B")
    if nb != plane_true + ubytes:
        raise ValueError(f"dpack size mismatch: header {nb} B != plane "
                         f"{plane_true} B + unary {ubytes} B")
    return plane_true, ubytes


def unpack_pcm(packed: np.ndarray, widx: np.ndarray, C: int, L: int,
               ch_ubit: np.ndarray | None = None) -> np.ndarray:
    """Host unpack -> int16 [C, L]: the threaded C++ unpacker
    (native.unpack_pcm) when its library is present, else the numpy copy
    below. A wire the C++ side rejects raises."""
    if native.available():
        out = native.unpack_pcm(packed, widx, C, L, ch_ubit)
        if out is not None:
            return out
    return _unpack_pcm_numpy(packed, widx, C, L, ch_ubit)


def _unpack_pcm_numpy(packed, widx, C: int, L: int, ch_ubit=None):
    """Vectorized numpy unpack (copy of the reference's
    _unpack_pcm_numpy, with its validations)."""
    NBt = widx.shape[0]
    if C <= 0 or NBt % C != 0:
        raise ValueError(f"dpack wire geometry invalid: nbt={NBt} C={C}")
    NB = NBt // C
    if NB * BLOCK < L:
        raise ValueError(f"dpack wire covers {NB * BLOCK} < L={L} samples")
    wclass = (widx & 0x1F).astype(np.int64)
    if wclass.size and int(wclass.max()) >= len(WIDTHS):
        raise ValueError(f"dpack width class {int(wclass.max())} out of range")
    ord3 = ((widx >> 5) & 1).astype(bool)
    ws = np.asarray(WIDTHS, dtype=np.int64)
    bpb = ws[wclass] * BLOCK // 8
    boff = np.cumsum(bpb) - bpb
    z = np.zeros((NBt, BLOCK), dtype=np.int64)
    for wi, w in enumerate(WIDTHS):
        sel = np.nonzero(wclass == wi)[0]
        if w == 0 or sel.size == 0:
            continue
        nb = w * BLOCK // 8
        idx = (boff[sel][:, None] + np.arange(nb)).reshape(-1)
        bits = np.unpackbits(packed[idx], bitorder="little").reshape(
            sel.size, BLOCK, w)
        z[sel] = (bits.astype(np.int64) << np.arange(w, dtype=np.int64)).sum(
            axis=2)
    rice = ((widx >> 7) & 1).astype(bool)
    if rice.any():
        if ch_ubit is None or np.asarray(ch_ubit).size != C:
            raise ValueError("dpack rice wire requires per-channel "
                             "unary cuts (ch_ubit)")
        ch_ubit = np.asarray(ch_ubit).astype(np.int64)
        plane_true = int(boff[-1] + bpb[-1])
        ubytes = 4 * ((int(ch_ubit[-1]) + 31) // 32)
        if plane_true + ubytes > packed.shape[0]:
            raise ValueError(f"dpack payload {packed.shape[0]} B short of "
                             f"plane {plane_true} B + unary {ubytes} B")
        ubits_all = np.unpackbits(packed[plane_true : plane_true + ubytes],
                                  bitorder="little")
        riceC = rice.reshape(C, NB)
        for c in range(C):
            s = int(ch_ubit[c - 1]) if c else 0
            e = int(ch_ubit[c])
            pos = np.flatnonzero(ubits_all[s:e])
            n_rice = int(riceC[c].sum()) * BLOCK
            if pos.size != n_rice or (
                n_rice and -(-(int(pos[-1]) + 1) // 32) * 32 != e - s
            ):
                raise ValueError(
                    f"dpack unary stream of channel {c} is corrupt: "
                    f"{pos.size} terminators for {n_rice} rice samples")
            if not n_rice:
                continue
            nrb = n_rice // BLOCK
            block_ends = pos[BLOCK - 1 :: BLOCK]
            starts = np.zeros(nrb, dtype=np.int64)
            starts[1:] = ((block_ends[:-1] + 32) >> 5) << 5
            qs = np.diff(np.concatenate(([-1], pos))) - 1
            firsts = np.arange(nrb) * BLOCK
            qs[firsts] = pos[firsts] - starts
            if qs.min(initial=0) < 0:
                raise ValueError(f"dpack unary stream of channel {c} is "
                                 "corrupt: terminator inside block padding")
            rows = c * NB + np.flatnonzero(riceC[c])
            z[rows] |= qs.reshape(-1, BLOCK) << ws[wclass[rows]][:, None]
    d = (z >> 1) ^ -(z & 1)
    d_flat = d.reshape(C, NB * BLOCK)
    f = ord3.reshape(C, NB)
    inter = ((widx >> 6) & 1).astype(bool).reshape(C, NB)

    def chain_d2(v, fl):
        """Order-3 runs carry d3: d2 is their running sum seeded by the d2
        just before the run (0 at channel start)."""
        if not fl.any():
            return v
        K_ = v.shape[0]
        f_s = np.repeat(fl, BLOCK, axis=1)
        S = np.cumsum(v * f_s, axis=1)
        first = fl & ~np.concatenate([np.zeros((K_, 1), bool), fl[:, :-1]],
                                     axis=1)
        startb = np.maximum.accumulate(
            np.where(first, np.arange(NB)[None, :], -1), axis=1)
        pre = np.repeat(startb * BLOCK - 1, BLOCK, axis=1)
        valid = pre >= 0
        idx = np.clip(pre, 0, NB * BLOCK - 1)
        base = np.where(valid, np.take_along_axis(v, idx, axis=1), 0)
        s_pre = np.where(valid, np.take_along_axis(S, idx, axis=1), 0)
        return np.where(f_s, base + S - s_pre, v)

    d2 = np.empty_like(d_flat)
    partner = pair_partner(C)
    ind = np.nonzero(partner == np.arange(C))[0]
    d2[ind] = chain_d2(d_flat[ind], f[ind])
    dep = np.nonzero(partner != np.arange(C))[0]
    if dep.size:
        d2_p = d2[partner[dep]]
        d3_p = np.diff(d2_p, axis=1, prepend=0)
        f_s = np.repeat(f[dep], BLOCK, axis=1)
        g_s = np.repeat(inter[dep], BLOCK, axis=1)
        v = d_flat[dep] + g_s * np.where(f_s, d3_p, d2_p)
        d2[dep] = chain_d2(v, f[dep])
    q = np.cumsum(np.cumsum(d2, axis=1), axis=1)[:, :L]
    return q.astype(np.int16)
