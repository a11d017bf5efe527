"""Residue vectors from bit-packed VQ entry numbers (symbol transport).

Port of vorbispizza_tpu/ops/residue_sym.py. The wire per bucket submap
(host contract: vorbispizza_tpu/native/symbols.py) is, per (submap, pass,
book) group, a bit-packed stream of VQ entry numbers (``entries`` = the
zero-row sentinel) and a parallel bit-packed stream of region row indices,
one per applied partition (frame * Pt*V + slot; ``F*Pt*V`` = padding).

``expand_submap_plain`` is the PyTorch twin of the reference; the wrapper
``expand_submap`` runs it for CPU tensors and launches kernel K1
(csrc/residue_expand.cu) for CUDA tensors.
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


def _zeros(sub_sig, F, device):
    (V, Pt, psize, limit_begin, vec_len, fmt2, w_i, groups, n_ch) = sub_sig
    half = vec_len // n_ch if fmt2 else vec_len
    return torch.zeros((F, n_ch, half), dtype=torch.float32, device=device)


def expand_submap_plain(sub_sig, sym_bufs, idx_bufs, vq_tables, F: int):
    """One submap's residue vectors [F, n_ch, half] float32 (plain twin).

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


def expand_submap(sub_sig, sym_bufs, idx_bufs, vq_tables, F: int, device):
    """``expand_submap_plain`` for CPU tensors; kernel K1 for CUDA ones
    (one launch per group into one zeroed output). A submap that codes no
    group decodes as zeros on ``device``."""
    if not vq_tables:
        return _zeros(sub_sig, F, device)
    if vq_tables[0].device.type == "cpu":
        return expand_submap_plain(sub_sig, sym_bufs, idx_bufs, vq_tables, F)
    _check(sub_sig, sym_bufs, idx_bufs, vq_tables)
    (V, Pt, psize, limit_begin, vec_len, fmt2, w_i, groups, n_ch) = sub_sig
    out = _zeros(sub_sig, F, vq_tables[0].device)
    half = out.shape[2]
    for (w, d, nsym, fmt1, np_pad), sbuf, xbuf, vq in zip(
        groups, sym_bufs, idx_bufs, vq_tables
    ):
        K.require_cuda(sbuf, xbuf, vq, out)
        if vq.dtype != torch.float32 or sbuf.dtype != torch.uint8:
            raise TypeError("expected u8 streams and a float32 VQ table")
        if np_pad * nsym * d == 0:
            continue
        K.launch(
            "residue_expand",
            sbuf.data_ptr(), xbuf.data_ptr(), vq.data_ptr(), out.data_ptr(),
            np_pad, w, d, nsym, int(fmt1), vq.shape[0] - 1, w_i,
            Pt * V, F * Pt * V, V, psize, limit_begin, n_ch, half, int(fmt2),
        )
    return out
