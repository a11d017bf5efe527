"""Overlap-add assembly from host events (kernel K4 and its twin).

Port of vorbispizza_tpu/ops/ola.py. Every output sample gathers its one or
two windowed-frame contributions:

    pcm[c, i] = flat[c, a(i)] * va(i) + flat[c, b(i)] * vb(i)

where ``flat`` is every bucket's windowed frames laid end to end per
channel and a/b/va/vb are piecewise affine between the host's j-sorted
events (models/pipeline.py ``_build_events``). ``expand_assemble`` is the
reference's per-sample definition; ``ola_assemble_plain`` builds ``flat``
with the IMDCT epilogue and applies it. Kernel K4 computes the same thing
without materializing ``flat``.

Output modes: "f32" (PCM), "s16" (quantized int16) and "s16p" (the s16
byte planes, u8 [2, C, L]); K4 quantizes in registers, the twin applies
ops.pcm_pack ``quantize_plain`` to its PCM.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build as K
from .imdct import imdct_window
from .pcm_pack import planes_plain, quantize_plain

#: buckets the K4 parameter table holds (csrc/ola_assemble.cu)
MAX_BUCKETS = 64

#: output mode -> (K4 mode, launch count name)
MODES = {"f32": (0, "ola_assemble"), "s16": (1, "ola_assemble_s16"),
         "s16p": (2, "ola_assemble_s16p")}


def gather_assemble(flat, a_idx, a_valid, b_idx, b_valid):
    """pcm[c, i] = flat[c, a_idx[i]]*a_valid + flat[c, b_idx[i]]*b_valid,
    with out-of-range indices reading 0."""
    Tf = flat.shape[1]

    def side(idx, valid):
        inb = (idx >= 0) & (idx < Tf)
        v = torch.where(inb, flat[:, idx.clamp(0, max(Tf - 1, 0))], 0.0)
        return v * valid.to(flat.dtype)

    return side(a_idx, a_valid) + side(b_idx, b_valid)


def expand_assemble(flat, evs, L: int):
    """Per-sample formulation: expand index/validity arrays from the events
    with unit scatters + cumsums, then gather (ops/ola.py expand_assemble).
    Events at j >= L (the padding) are dropped."""
    ev_j, ev_da, ev_db, ev_va, ev_vb = (e.to(torch.int64) for e in evs)
    j = ev_j.clamp(0, L)  # slot L collects the dropped events

    def levels(init, delta):
        arr = torch.full((L + 1,), init, dtype=torch.int64, device=flat.device)
        arr.index_add_(0, j, delta)
        return torch.cumsum(arr[:L], 0)

    a_idx = levels(1, ev_da) - 1
    b_idx = levels(1, ev_db) - 1
    a_valid = levels(0, ev_va) > 0
    b_valid = levels(0, ev_vb) > 0
    return gather_assemble(flat, a_idx, a_valid, b_idx, b_valid)


def flat_frames(buckets) -> torch.Tensor:
    """[C, sum Fp*n] windowed frames of every bucket, end to end per
    channel. ``buckets``: (d [Fp, C, n/2], window [n], prime u8 [Fp], final
    u8 [Fp]) per bucket, in flat order."""
    flats = []
    for d, window, prime, final in buckets:
        Fp, C, m = d.shape
        frames = imdct_window(d, window, prime, final)
        flats.append(frames.transpose(0, 1).reshape(C, Fp * 2 * m))
    return torch.cat(flats, dim=1)


def ola_assemble_plain(buckets, evs, L: int, mode: str = "f32"):
    """Plain twin of K4: PCM [C, L] float32, or its s16 [C, L] int16 or
    s16p [2, C, L] u8 quantization."""
    pcm = expand_assemble(flat_frames(buckets), evs, L)
    if mode == "f32":
        return pcm
    q = quantize_plain(pcm)
    return q.to(torch.int16) if mode == "s16" else planes_plain(q)


def ola_assemble(buckets, evs, L: int, mode: str = "f32") -> torch.Tensor:
    """``ola_assemble_plain`` for CPU tensors; kernel K4 for CUDA ones.

    ``evs``: (ev_j, ev_da, ev_db, ev_va, ev_vb) int32 [Ep], sorted by ev_j,
    padding events at ev_j = L. ``mode``: a key of MODES."""
    if mode not in MODES:
        raise ValueError(f"K4 output mode {mode!r} (not one of {list(MODES)})")
    d0 = buckets[0][0]
    if d0.device.type == "cpu":
        return ola_assemble_plain(buckets, evs, L, mode)
    if len(buckets) > MAX_BUCKETS:
        raise ValueError(f"{len(buckets)} buckets (K4 holds {MAX_BUCKETS})")
    C = d0.shape[1]
    ev_j = evs[0]
    if ev_j.dtype != torch.int32:
        raise TypeError("ev_j must be int32")
    # chain state after each event: inclusive cumsums (torch glue)
    da, db, va, vb = (torch.cumsum(e.to(torch.int64), 0) for e in evs[1:])
    K.require_cuda(ev_j, da, db, va, vb)
    rows = []
    base = 0
    for d, window, prime, final in buckets:
        K.require_cuda(d, window, prime, final)
        Fp, C_, m = d.shape
        if C_ != C or d.dtype != torch.float32 or window.shape[0] != 2 * m:
            raise ValueError("bucket tensors disagree in shape or type")
        if prime.dtype != torch.uint8 or final.dtype != torch.uint8:
            raise TypeError("prime/final must be u8")
        rows += [d.data_ptr(), window.data_ptr(), prime.data_ptr(),
                 final.data_ptr(), base, 2 * m]
        base += Fp * 2 * m
    desc = (ctypes.c_int64 * len(rows))(*rows)
    kmode, count = MODES[mode]
    if mode == "s16p":
        out = torch.empty((2, C, L), dtype=torch.uint8, device=d0.device)
    else:
        dtype = torch.float32 if mode == "f32" else torch.int16
        out = torch.empty((C, L), dtype=dtype, device=d0.device)
    if out.numel():
        K.launch(
            "ola_assemble",
            ctypes.addressof(desc), ev_j.data_ptr(), da.data_ptr(),
            db.data_ptr(), va.data_ptr(), vb.data_ptr(), out.data_ptr(),
            len(buckets), ev_j.shape[0], L, C, base, kmode, count=count,
        )
    return out
