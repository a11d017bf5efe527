"""Residue vectors from bit-packed VQ entry numbers (symbol transport).

Port of vorbispizza_tpu/ops/residue_sym.py. The wire per bucket submap
(host contract: vorbispizza_tpu/native/symbols.py) is, per (submap, pass,
book) group, a bit-packed stream of VQ entry numbers (``entries`` = the
zero-row sentinel) and a parallel bit-packed stream of region row indices,
one per applied partition (frame * Pt*V + slot; ``F*Pt*V`` = padding).

``expand_submap_plain`` is the PyTorch twin of the reference, one submap at
a time. Kernel K1 (csrc/residue_expand.cu) expands a whole bucket in one
launch from a descriptor table (``bucket_table``) into the bucket's
[Fp, C, half] residues; ``expand_bucket`` is its wrapper, and
``expand_bucket_plain``, which walks the same table, its twin for CPU
tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F_

from ..kernels import build as K


def pack_bits(vals: np.ndarray, w: int) -> np.ndarray:
    """Host-side LSB-first fixed-width pack: int[N] -> u8[ceil(N*w/8)]."""
    v = np.ascontiguousarray(vals, dtype=np.uint32)
    bits = ((v[:, None] >> np.arange(w, dtype=np.uint32)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little")


def unpack_bits(buf: torch.Tensor, w: int, count: int) -> torch.Tensor:
    """LSB-first fixed-width unpack: u8[B] -> int64[count] of w-bit values."""
    shifts = torch.arange(8, device=buf.device, dtype=torch.int32)
    bits = (buf.to(torch.int32)[:, None] >> shifts) & 1
    bits = bits.reshape(-1)[: count * w].reshape(count, w).to(torch.int64)
    weights = torch.ones(w, device=buf.device, dtype=torch.int64) << torch.arange(
        w, device=buf.device, dtype=torch.int64
    )
    return (bits * weights).sum(dim=1)


def _check(sub_sig, sym_bufs, idx_bufs, vq_tables):
    groups = sub_sig[7]
    if not (len(groups) == len(sym_bufs) == len(idx_bufs) == len(vq_tables)):
        raise ValueError("one sym, idx and VQ table per group expected")


def expand_submap_plain(sub_sig, sym_bufs, idx_bufs, vq_tables, F: int):
    """One submap's residue vectors [F, n_ch, half] float32: the
    reference's steps one submap at a time, held against the JAX package.

    ``sub_sig`` = (V, Pt, psize, limit_begin, vec_len, fmt2, w_i, groups,
    n_ch) with groups = ((w, d, nsym, fmt1, np_pad), ...) in wire order;
    ``vq_tables``: per group [entries+1, d] float32 with the zero row last.
    Rows are integer-valued, so the scatter-add is exact in any order."""
    _check(sub_sig, sym_bufs, idx_bufs, vq_tables)
    (V, Pt, psize, limit_begin, vec_len, fmt2, w_i, groups, n_ch) = sub_sig
    PV = Pt * V
    dev = vq_tables[0].device
    parts, idxs = [], []
    for (w, d, nsym, fmt1, np_pad), sbuf, xbuf, vq in zip(
        groups, sym_bufs, idx_bufs, vq_tables
    ):
        syms = unpack_bits(sbuf, w, np_pad * nsym)
        entries = vq.shape[0] - 1
        rows = vq[syms.clamp(max=entries)]  # [S, d]
        rows = torch.where((syms > entries)[:, None], float("nan"), rows)
        if fmt1:
            part = rows.reshape(np_pad, nsym * d)
        else:
            # format 0: symbol k covers strided positions k, k+nsym, ...
            part = rows.reshape(np_pad, nsym, d).transpose(1, 2)
            part = part.reshape(np_pad, d * nsym)
        if part.shape[1] < psize:
            part = F_.pad(part, (0, psize - part.shape[1]))
        parts.append(part)
        idxs.append(unpack_bits(xbuf, w_i, np_pad))
    region = torch.zeros((F * PV, psize), dtype=torch.float32, device=dev)
    part_all = torch.cat(parts)
    idx_all = torch.cat(idxs)
    keep = idx_all < F * PV  # the padding sentinel is dropped
    region.index_add_(0, idx_all[keep], part_all[keep])
    region = (
        region.reshape(F, Pt, V, psize).permute(0, 2, 1, 3)
        .reshape(F, V, Pt * psize)
    )
    vec = F_.pad(region, (limit_begin, vec_len - limit_begin - Pt * psize))
    if fmt2:
        # de-interleave [F, 1, half*n_ch] -> [F, n_ch, half]
        half = vec_len // n_ch
        return vec.reshape(F, half, n_ch).transpose(1, 2).contiguous()
    return vec.contiguous()


#: threads a K1 block; every group starts on a block of its own
K1_THREADS = 256
#: the int64 fields of a K1 group record, in order (csrc/residue_expand.cu)
K1_FIELDS = ("sym", "idx", "vq", "w", "d", "nsym", "fmt1", "entries", "w_i",
             "np_pad", "PV", "n_rows", "V", "psize", "limit_begin", "fmt2",
             "n_ch", "ch_off")


def bucket_table(subs, F: int):
    """K1's descriptor table of one bucket, from its signature alone:
    (int64 table, n_groups, n_blocks).

    ``subs``: per coded submap (sub_sig without n_ch, byte offsets of its
    groups' symbol streams and of their index streams in the chunk's u8
    buffer, per group (element offset in the bucket's concatenated VQ
    buffer, entries), its channel list). The table is the first block of every group
    (and the total) [n_groups + 1] | one record of K1_FIELDS a group |
    the channel lists. Groups with no thread are left out."""
    starts, recs, chans = [0], [], []
    for sub_sig, sym_offs, idx_offs, vq_offs, ch_list in subs:
        V, Pt, psize, limit_begin, vec_len, fmt2, w_i, groups = sub_sig
        ch_off = len(chans)
        chans.extend(ch_list)
        for (w, d, nsym, fmt1, np_pad), so, xo, (vo, entries) in zip(
                groups, sym_offs, idx_offs, vq_offs):
            threads = np_pad * nsym * d
            if threads == 0:
                continue
            if max(threads, F * Pt * V, vec_len) >= 2**31:
                raise ValueError("K1 indexes a group's threads and rows in "
                                 "32 bits")
            recs.append((so, xo, vo, w, d, nsym, int(fmt1), entries, w_i,
                         np_pad, Pt * V, F * Pt * V, V, psize, limit_begin,
                         int(fmt2), len(ch_list), ch_off))
            starts.append(starts[-1] + -(-threads // K1_THREADS))
    table = np.asarray(starts + [v for r in recs for v in r] + chans,
                       dtype=np.int64)
    return table, len(recs), starts[-1]


def _records(table: torch.Tensor, n_groups: int):
    t = table.tolist()
    n = len(K1_FIELDS)
    base = n_groups + 1
    recs = [dict(zip(K1_FIELDS, t[base + g * n : base + (g + 1) * n]))
            for g in range(n_groups)]
    return recs, t[base + n_groups * n :]


def expand_bucket_plain(table, n_groups: int, n_blocks: int, wire, vq,
                        shape):
    """[Fp, C, half] float32 residues of one bucket (plain twin of K1): walks
    the descriptor table of ``bucket_table`` (``n_blocks`` is unread),
    unpacks each group's streams from the u8 ``wire`` buffer, takes its VQ
    rows from ``vq`` and adds them at the addresses K1 computes. Every row
    is integer-valued, so the adds are exact in any order."""
    del n_blocks
    Fp, C, half = shape
    out = torch.zeros(Fp * C * half, dtype=torch.float32, device=vq.device)
    recs, chans = _records(table, n_groups)
    chans = torch.tensor(chans, dtype=torch.int64, device=vq.device)
    for r in recs:
        d, nsym, np_pad, w, w_i = r["d"], r["nsym"], r["np_pad"], r["w"], r["w_i"]
        S = np_pad * nsym
        syms = unpack_bits(wire[r["sym"] : r["sym"] + (S * w + 7) // 8], w, S)
        entries = r["entries"]
        vq_g = vq[r["vq"] : r["vq"] + (entries + 1) * d].view(entries + 1, d)
        rows = vq_g[syms.clamp(max=entries)]
        rows = torch.where((syms > entries)[:, None], float("nan"), rows)
        if r["fmt1"]:  # column k*d + e
            vals = rows.reshape(np_pad, nsym * d)
        else:  # format 0: column e*nsym + k
            vals = rows.reshape(np_pad, nsym, d).transpose(1, 2)
            vals = vals.reshape(np_pad, d * nsym)
        ridx = unpack_bits(wire[r["idx"] : r["idx"] + (np_pad * w_i + 7) // 8],
                           w_i, np_pad)
        keep = ridx < r["n_rows"]  # the padding sentinel is dropped
        ridx, vals = ridx[keep], vals[keep]
        f, pv = ridx // r["PV"], ridx % r["PV"]
        pt, vrow = pv // r["V"], pv % r["V"]
        q = (r["limit_begin"] + pt[:, None] * r["psize"]
             + torch.arange(nsym * d, device=vq.device)[None, :])
        ch_list = chans[r["ch_off"] : r["ch_off"] + r["n_ch"]]
        if r["fmt2"]:  # residue 2: q = k*n_ch + c -> channel c, bin k
            ch, pos = ch_list[q % r["n_ch"]], q // r["n_ch"]
        else:
            ch, pos = ch_list[vrow][:, None], q
        out.index_add_(0, ((f[:, None] * C + ch) * half + pos).reshape(-1),
                       vals.reshape(-1))
    return out.view(Fp, C, half)


def expand_bucket(table, n_groups: int, n_blocks: int, wire, vq, shape):
    """``expand_bucket_plain`` for CPU tensors; kernel K1 for CUDA ones: one
    launch over every group of the bucket into its [Fp, C, half] residues,
    which the C entry zeroes. A bucket that codes no group decodes as
    zeros. ``table`` from ``bucket_table`` on the device; ``wire`` the
    chunk's u8 buffer; ``vq`` the bucket's concatenated VQ tables."""
    if wire.device.type == "cpu":
        return expand_bucket_plain(table, n_groups, n_blocks, wire, vq, shape)
    if not n_blocks:
        return torch.zeros(shape, dtype=torch.float32, device=wire.device)
    K.require_cuda(table, wire, vq)
    if (table.dtype != torch.int64 or wire.dtype != torch.uint8
            or vq.dtype != torch.float32):
        raise TypeError("expected an int64 table, a u8 wire and float32 VQ "
                        "tables")
    out = torch.empty(shape, dtype=torch.float32, device=wire.device)
    Fp, C, half = shape
    K.launch(
        "residue_expand",
        wire.data_ptr(), table.data_ptr(), vq.data_ptr(), out.data_ptr(),
        n_groups, n_blocks, K1_THREADS, C, half, out.numel(),
    )
    return out
