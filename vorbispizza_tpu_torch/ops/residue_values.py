"""Residue vectors from the value-transport wire (kernel K9 and its twin).

Port of the value-transport branch of vorbispizza_tpu/models/pipeline.py
``_fused_body`` (789-804). The host ships the nonzero 32-value rows of
the chunk's residues once each (``packed`` [Kp, 32]: row 0 is the zero
row) and, per (frame, channel, 32-bin part), the row that holds it
(``gmap``). The rows travel as u8 biased by 128 ("u8b"), int16 ("i16") or
float32 ("f32"), the map as uint16 bit-cast into the int16 buffer ("u16")
or int32 ("i32"): the narrowest types that hold the chunk's values.

``residue_gather_plain`` is the twin (``torch.index_select`` plus the cast
and the un-bias); ``residue_gather`` runs it for CPU tensors and launches
K9 (csrc/residue_gather.cu) for CUDA ones. Both are exact: a cast of small
integers or a copy of float32 values.
"""

from __future__ import annotations

import torch

from ..kernels import build as K

#: values per packed row (models/pipeline.py BatchSynthesizer.PACK_GRAN)
PACK_GRAN = 32

PTAGS = {"u8b": (0, torch.uint8), "i16": (1, torch.int16),
         "f32": (2, torch.float32)}
GTAGS = {"u16": (0, torch.int16), "i32": (1, torch.int32)}


def _check(packed, gmap, ptag, gtag):
    if ptag not in PTAGS or gtag not in GTAGS:
        raise ValueError(f"wire tags {ptag!r}/{gtag!r} (expected one of "
                         f"{list(PTAGS)} / {list(GTAGS)})")
    if packed.dtype != PTAGS[ptag][1] or gmap.dtype != GTAGS[gtag][1]:
        raise TypeError(f"{ptag}/{gtag} wire with packed {packed.dtype} and "
                        f"map {gmap.dtype}")


def row_index(gmap: torch.Tensor, gtag: str) -> torch.Tensor:
    """The map as int64 row numbers; u16 entries ride the int16 buffer bit
    for bit, so they are read unsigned."""
    g = gmap.to(torch.int64)
    return g & 0xFFFF if gtag == "u16" else g


def residue_gather_plain(packed, gmap, ptag: str, gtag: str, shape):
    """[Fp, C, half] float32 residues: row ``gmap[r]`` of ``packed`` for
    each 32-bin part r, un-biased by 128 for "u8b" rows (plain twin). A
    map entry outside [0, Kp) raises IndexError on the CPU."""
    _check(packed, gmap, ptag, gtag)
    idx = row_index(gmap.reshape(-1), gtag)
    rows = torch.index_select(packed.reshape(-1, PACK_GRAN), 0,
                              idx).to(torch.float32)
    if ptag == "u8b":
        rows = rows - 128.0  # row 0 is the biased zero row
    return rows.view(shape)


def residue_gather(packed, gmap, ptag: str, gtag: str, shape):
    """``residue_gather_plain`` for CPU tensors; kernel K9 for CUDA ones.

    packed [Kp, 32] (u8, int16 or float32 by ``ptag``); gmap [rows] (int16
    holding uint16, or int32, by ``gtag``), each entry in [0, Kp) (K9
    writes zeros for one outside it); ``shape`` (Fp, C, half) with
    Fp*C*half == rows*32."""
    if packed.device.type == "cpu":
        return residue_gather_plain(packed, gmap, ptag, gtag, shape)
    _check(packed, gmap, ptag, gtag)
    rows = gmap.numel()
    if rows * PACK_GRAN != shape[0] * shape[1] * shape[2]:
        raise ValueError(f"{rows} map rows do not fill {tuple(shape)}")
    K.require_cuda(packed, gmap)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=packed.device)
    if rows:
        K.launch(
            "residue_gather",
            packed.data_ptr(), gmap.data_ptr(), out.data_ptr(),
            rows, packed.shape[0], PTAGS[ptag][0], GTAGS[gtag][0],
        )
    return out
