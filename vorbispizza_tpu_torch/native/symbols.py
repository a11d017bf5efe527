"""Symbol-level residue transport: static layout + reference expansion.

The C++ front end (frontend.cpp vp_decode_packets_sym) records, per audio
packet, the residue decode's raw products instead of expanding them:

  cls          u8 [C, pt_max]   per-partition classification per vector row
                                (channel row for formats 0/1; the submap's
                                first channel row for format 2). 0xFF = the
                                vector was not decoded (do-not-decode channel
                                or not reached before end-of-packet).
  syms         u16 [sym_cap]    VQ entry numbers, grouped by
                                (submap, pass, book) in the canonical order
                                of group_enumeration(); within a group, in
                                residue traversal order (partition-major,
                                vector-minor). A partition truncated by
                                end-of-packet is padded to its full symbol
                                count with the sentinel ``book.entries``
                                (which decodes to a zero row).
  slots        u16 [sym_cap]    parallel to syms, ONE entry per applied
                                partition (i.e. per nsym symbols): the
                                traversal slot id pv = partition * V +
                                vector_row — the region row the partition's
                                values land in. Grouped like syms (own
                                cursor; offsets = cumsum(sym_counts/nsym)).
                                This is what the device actually consumes
                                (ops/residue_sym.py scatter-add); cls and
                                pair_counts below are the redundant
                                first-principles encoding kept for the
                                executable spec and cross-checking.
  sym_counts   i32 [n_groups]   symbols recorded per group
  pair_counts  i32 [n_sp]       per (submap, pass) slot sm*8+p: the number
                                of (partition, vector) pairs that received
                                at least one symbol. Because residue decode
                                stops permanently at the first end-of-packet,
                                the applied pairs are exactly a PREFIX of the
                                coded pairs in traversal order — so a single
                                count reconstructs the truncation point.

expand_symbols() below is the executable specification of the reconstruction;
models/pipeline.py implements the same algorithm in batched XLA ops. The
reference behavior being reproduced is NVorbis/Residue0.cs:117-231 decode
(partition loop, cascade passes, end-of-packet partial data retention).

Eligibility: symbol transport reproduces the value path BIT-EXACTLY only
when every residue book's lookup values are integral (float32 addition of
small integers is exact, so device f32 accumulation equals the host's
float64-then-round); symbol_layout() returns None for setups where that
(or a structural assumption) fails, and callers fall back to value
transport.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SymGroup:
    """One (submap, pass, book) symbol group."""

    submap: int
    gpass: int
    book_idx: int
    dims: int
    entries: int
    nsym: int  # symbols per full partition
    fmt1: bool


@dataclass
class SymLayout:
    """Static symbol-transport layout for one setup."""

    pt_max: int
    sym_cap: int
    n_sp: int
    # per mapping index: list of SymGroup in canonical (wire) order
    groups_per_mapping: dict
    n_groups: int


def group_enumeration(setup, mapping) -> list[SymGroup]:
    """Canonical group order for one mapping: submap-major, then pass, then
    ascending book index. Must match frontend.cpp build_group_tables()."""
    cb_index = {id(cb): i for i, cb in enumerate(setup.codebooks)}
    groups: list[SymGroup] = []
    for sm in range(mapping.submaps):
        r = mapping.submap_residue[sm]
        fmt1 = r.residue_type != 0
        for p in range(8):
            ids = sorted(
                {cb_index[id(row[p])] for row in r.books if row[p] is not None}
            )
            for b in ids:
                book = setup.codebooks[b]
                d = book.dimensions
                psize = r.partition_size
                nsym = (psize + d - 1) // d if fmt1 else psize // d
                groups.append(
                    SymGroup(
                        submap=sm,
                        gpass=p,
                        book_idx=b,
                        dims=d,
                        entries=book.entries,
                        nsym=nsym,
                        fmt1=fmt1,
                    )
                )
    return groups


def _vec_shape(r, half: int, n_ch: int):
    """(V, vec_len, limit_begin, Pt) for one (residue, blocksize, n_ch)."""
    fmt2 = r.residue_type == 2
    vec_len = half * n_ch if fmt2 else half
    V = 1 if fmt2 else n_ch
    limit_begin = min(r.begin, vec_len)
    limit_end = min(r.end, vec_len)
    psize = r.partition_size
    Pt = max(0, (limit_end - limit_begin) // psize)
    return V, vec_len, limit_begin, Pt


def symbol_layout(setup, ident) -> SymLayout | None:
    """Compute buffer sizes for symbol transport, or None when this setup
    is ineligible (callers use value transport instead)."""
    channels = ident.channels
    pt_max = 1
    sym_cap = 1
    n_sp = 8
    groups_per_mapping = {}
    n_groups = 1
    # eligibility: every residue book integral-valued, entries within u16
    # (sentinel = entries), fmt1 partition size divisible by dims, fmt0
    # at least one symbol per partition
    for r in setup.residues:
        fmt1 = r.residue_type != 0
        psize = r.partition_size
        if r.classifications > 254:
            return None
        for row in r.books:
            for book in row:
                if book is None:
                    continue
                d = book.dimensions
                if book.entries > 65534 or d < 1:
                    return None
                if fmt1 and psize % d != 0:
                    return None
                if not fmt1 and psize // d < 1:
                    return None
                tbl = book.lookup_table
                if tbl is None:
                    return None
                if not np.all(tbl == np.rint(tbl)) or np.any(np.abs(tbl) > 1 << 20):
                    return None

    for mi, mapping in enumerate(setup.mappings):
        groups = group_enumeration(setup, mapping)
        groups_per_mapping[mi] = groups
        n_groups = max(n_groups, len(groups))
        n_sp = max(n_sp, mapping.submaps * 8)

    for mode in setup.modes:
        mapping = setup.mappings[mode.mapping_idx]
        half = mode.n // 2
        cap = 0
        for sm in range(mapping.submaps):
            r = mapping.submap_residue[sm]
            n_ch = sum(1 for c in range(channels) if mapping.mux[c] == sm)
            if n_ch == 0:
                continue
            V, _, _, Pt = _vec_shape(r, half, n_ch)
            if Pt * V > 65535:
                return None  # slot ids must fit the u16 wire
            pt_max = max(pt_max, Pt)
            per_pass = {}
            for g in groups_per_mapping[mode.mapping_idx]:
                if g.submap == sm:
                    per_pass[g.gpass] = max(per_pass.get(g.gpass, 0), g.nsym)
            cap += V * Pt * sum(per_pass.values())
        sym_cap = max(sym_cap, cap)
    return SymLayout(
        pt_max=pt_max,
        sym_cap=sym_cap,
        n_sp=n_sp,
        groups_per_mapping=groups_per_mapping,
        n_groups=n_groups,
    )


def book_slot_table(setup, mapping, groups: list[SymGroup]):
    """Per (submap, pass): u8/i32 table class -> global group id (-1 = no
    book). Shape [n_submaps, 8, 256] int32 — the device indexes it with the
    raw cls byte (0xFF rows hit the -1 padding)."""
    cb_index = {id(cb): i for i, cb in enumerate(setup.codebooks)}
    slot_of = {(g.submap, g.gpass, g.book_idx): i for i, g in enumerate(groups)}
    tbl = np.full((mapping.submaps, 8, 256), -1, dtype=np.int32)
    for sm in range(mapping.submaps):
        r = mapping.submap_residue[sm]
        for cls, row in enumerate(r.books):
            for p in range(8):
                book = row[p]
                if book is not None:
                    tbl[sm, p, cls] = slot_of[(sm, p, cb_index[id(book)])]
    return tbl


def partition_values(group: SymGroup, book_table: np.ndarray, syms: np.ndarray):
    """Expand one group's symbol stream into per-partition value rows
    [n_partitions, psize_cov] (float32). ``book_table`` is the book's
    lookup table with a zero row appended at index ``entries`` (the
    truncation sentinel). psize_cov = nsym*dims for format 1 (== psize by
    eligibility) and dims*(psize//dims) for format 0 (tail stays zero)."""
    d = group.dims
    rows = book_table[syms]  # [S, d]
    if group.fmt1:
        return rows.reshape(-1, group.nsym * d)
    # format 0: symbol k covers strided positions k, k+step, ... (step=nsym)
    return rows.reshape(-1, group.nsym, d).transpose(0, 2, 1).reshape(
        -1, d * group.nsym
    )


def applied_slots(
    setup,
    mode_idx: int,
    channels: int,
    cls_rows: np.ndarray,  # [C, pt_max] u8
    pair_counts: np.ndarray,  # [n_sp] i32
    groups: list[SymGroup] | None = None,
) -> dict:
    """Spec derivation of the per-group applied-partition slot streams the
    C++ front end records directly (SymOut.slots): for group g, the
    traversal slot ids pv = partition * V + vector_row of the pairs that
    received at least one symbol, in traversal order. Returns
    {global_group_id: np.ndarray u16}."""
    mode = setup.modes[mode_idx]
    mapping = setup.mappings[mode.mapping_idx]
    half = mode.n // 2
    if groups is None:
        groups = group_enumeration(setup, mapping)
    slot_tbl = book_slot_table(setup, mapping, groups)
    out: dict = {gi: np.zeros(0, dtype=np.uint16) for gi in range(len(groups))}
    for sm in range(mapping.submaps):
        r = mapping.submap_residue[sm]
        ch_list = [c for c in range(channels) if mapping.mux[c] == sm]
        if not ch_list:
            continue
        V, vec_len, limit_begin, Pt = _vec_shape(r, half, len(ch_list))
        if Pt == 0:
            continue
        rows_sel = ch_list[:1] if r.residue_type == 2 else ch_list
        cls_trav = cls_rows[rows_sel][:, :Pt].T.reshape(-1)  # [Pt*V]
        for p in range(8):
            n_pairs = int(pair_counts[sm * 8 + p])
            bsel = slot_tbl[sm, p][cls_trav]
            coded = bsel >= 0
            rank = np.cumsum(coded) - coded
            applied = coded & (rank < n_pairs)
            for gi, g in enumerate(groups):
                if g.submap != sm or g.gpass != p:
                    continue
                pv = np.nonzero(applied & (bsel == gi))[0]
                out[gi] = pv.astype(np.uint16)
    return out


def expand_symbols(
    setup,
    mode_idx: int,
    channels: int,
    cls_rows: np.ndarray,  # [C, pt_max] u8
    syms: np.ndarray,  # [sym_cap] u16
    sym_counts: np.ndarray,  # [n_groups] i32
    pair_counts: np.ndarray,  # [n_sp] i32
    groups: list[SymGroup] | None = None,
) -> np.ndarray:
    """Reference (numpy) reconstruction of one packet's residue vectors
    [channels, half] — the executable spec for the device expansion."""
    mode = setup.modes[mode_idx]
    mapping = setup.mappings[mode.mapping_idx]
    half = mode.n // 2
    if groups is None:
        groups = group_enumeration(setup, mapping)
    slot_tbl = book_slot_table(setup, mapping, groups)
    offs = np.concatenate([[0], np.cumsum(sym_counts[: len(groups)])])
    out = np.zeros((channels, half), dtype=np.float32)

    for sm in range(mapping.submaps):
        r = mapping.submap_residue[sm]
        ch_list = [c for c in range(channels) if mapping.mux[c] == sm]
        if not ch_list:
            continue
        psize = r.partition_size
        V, vec_len, limit_begin, Pt = _vec_shape(r, half, len(ch_list))
        if Pt == 0:
            continue
        rows_sel = ch_list[:1] if r.residue_type == 2 else ch_list
        cls = cls_rows[rows_sel][:, :Pt]  # [V, Pt]
        # traversal order: partition-major, vector-minor
        cls_trav = cls.T.reshape(-1)  # [Pt*V]
        region = np.zeros((Pt * V, psize), dtype=np.float32)
        for p in range(8):
            n_pairs = int(pair_counts[sm * 8 + p])
            bsel = slot_tbl[sm, p][cls_trav]  # [Pt*V] global group id / -1
            coded = bsel >= 0
            rank = np.cumsum(coded) - coded  # exclusive
            applied = coded & (rank < n_pairs)
            if not applied.any():
                continue
            for gi, g in enumerate(groups):
                if g.submap != sm or g.gpass != p:
                    continue
                m = applied & (bsel == gi)
                if not m.any():
                    continue
                sg = syms[offs[gi] : offs[gi + 1]]
                book = setup.codebooks[g.book_idx]
                vq = np.concatenate(
                    [
                        np.asarray(book.lookup_table, dtype=np.float32),
                        np.zeros((1, g.dims), dtype=np.float32),
                    ]
                )
                part = partition_values(g, vq, sg)
                idx = np.cumsum(m) - m  # exclusive rank within this group
                cov = part.shape[1]
                region[:, :cov] += np.where(
                    m[:, None], part[idx % max(len(part), 1)], 0.0
                )
        # region rows are traversal order [Pt, V]; back to [V, Pt*psize]
        region = region.reshape(Pt, V, psize).transpose(1, 0, 2).reshape(V, -1)
        if r.residue_type == 2:
            flat = np.zeros(vec_len, dtype=np.float32)
            flat[limit_begin : limit_begin + Pt * psize] = region[0]
            out[ch_list] += flat.reshape(half, len(ch_list)).T
        else:
            for j, c in enumerate(ch_list):
                out[c, limit_begin : limit_begin + Pt * psize] += region[j]
    return out
