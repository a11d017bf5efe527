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

Output modes: "f32" (PCM), "s16" (quantized int16), "s16p" (the s16
byte planes, u8 [2, C, L]) and "dpack" (int16 q and, per 128-sample block,
the dpack wire's candidate select: ops.pcm_pack ``dpack_select_plain``,
the reference's select_candidate). K4 quantizes in registers and selects
from the tile's q in shared memory (csrc/ola_assemble.cu); the twin
applies ops.pcm_pack ``quantize_plain`` and ``dpack_select_plain`` to its
PCM.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build as K
from .imdct import imdct_window
from .pcm_pack import (
    dpack_select_plain,
    partner_table,
    planes_plain,
    quantize_plain,
    wire_rows,
)

#: buckets the K4 parameter table holds and channels it takes (the Vorbis
#: limit; csrc/ola_assemble.cu)
MAX_BUCKETS = 64
MAX_CHANNELS = 255

#: output mode -> (K4 mode, launch count name)
MODES = {"f32": (0, "ola_assemble"), "s16": (1, "ola_assemble_s16"),
         "s16p": (2, "ola_assemble_s16p"), "dpack": (3, "ola_assemble_dpack")}


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


def ola_assemble_plain(buckets, evs, L: int, mode: str = "f32",
                       rice: bool = False):
    """Plain twin of K4: PCM [C, L] float32, or its s16 [C, L] int16 or
    s16p [2, C, L] u8 quantization; for "dpack" (q int16 [C, L], widx|flags
    u8 [NBt], unary bits int32 [NBt]), the select being
    ``dpack_select_plain`` of q."""
    pcm = expand_assemble(flat_frames(buckets), evs, L)
    if mode == "f32":
        return pcm
    q = quantize_plain(pcm)
    if mode == "s16p":
        return planes_plain(q)
    q = q.to(torch.int16)
    if mode == "s16":
        return q
    return (q, *dpack_select_plain(q, rice))


def ola_assemble(buckets, evs, L: int, mode: str = "f32", rice: bool = False,
                 wbyte: torch.Tensor | None = None):
    """``ola_assemble_plain`` for CPU tensors; kernel K4 for CUDA ones.

    ``evs``: (ev_j, ev_da, ev_db, ev_va, ev_vb) int32 [Ep], sorted by ev_j,
    padding events at ev_j = L. ``mode``: a key of MODES. In the "dpack"
    mode ``wbyte`` may name the u8 [NBt] view (the wire's widx table) that
    the select writes; it is returned as the second output."""
    if mode not in MODES:
        raise ValueError(f"K4 output mode {mode!r} (not one of {list(MODES)})")
    d0 = buckets[0][0]
    C = d0.shape[1]
    NBt = wire_rows(L, C)
    if wbyte is not None and (wbyte.dtype != torch.uint8
                              or wbyte.shape != (NBt,)):
        raise ValueError(f"wbyte must be u8 [{NBt}]")
    if d0.device.type == "cpu":
        out = ola_assemble_plain(buckets, evs, L, mode, rice)
        if mode == "dpack" and wbyte is not None:
            wbyte.copy_(out[1])
            out = (out[0], wbyte, out[2])
        return out
    if len(buckets) > MAX_BUCKETS:
        raise ValueError(f"{len(buckets)} buckets (K4 holds {MAX_BUCKETS})")
    K.require_cuda(*evs)
    if any(e.dtype != torch.int32 for e in evs):
        raise TypeError("the events must be int32")
    Ep = evs[0].shape[0]
    rows = []
    base = 0
    for d, window, prime, final in buckets:
        K.require_cuda(d, window, prime, final)
        Fp, C_, m = d.shape
        if C_ != C or d.dtype != torch.float32 or window.shape[0] != 2 * m:
            raise ValueError("bucket tensors disagree in shape or type")
        if m < 2 or m & (m - 1):
            raise ValueError(f"blocksize {2 * m} is not a power of two")
        if prime.dtype != torch.uint8 or final.dtype != torch.uint8:
            raise TypeError("prime/final must be u8")
        rows += [d.data_ptr(), window.data_ptr(), prime.data_ptr(),
                 final.data_ptr(), base, 2 * m]
        base += Fp * 2 * m
    if C > MAX_CHANNELS:
        raise ValueError(f"{C} channels (K4 takes {MAX_CHANNELS})")
    if base + L >= 2**31 or C * L >= 2**31 or not 0 < Ep < 2**31:
        raise ValueError(f"K4 indexes in 32 bits: Tf {base} + L {L}, C*L "
                         f"{C * L} and Ep {Ep} must stay below 2^31")
    desc = (ctypes.c_int64 * len(rows))(*rows)
    kmode, count = MODES[mode]
    dev = d0.device
    if mode == "s16p":
        out = torch.empty((2, C, L), dtype=torch.uint8, device=dev)
    else:
        dtype = torch.float32 if mode == "f32" else torch.int16
        out = torch.empty((C, L), dtype=dtype, device=dev)
    scratch = torch.empty(3 * Ep, dtype=torch.int32, device=dev)
    ubits = partner = None
    if mode == "dpack":
        if wbyte is None:
            wbyte = torch.empty(NBt, dtype=torch.uint8, device=dev)
        K.require_cuda(wbyte)
        ubits = torch.empty(NBt, dtype=torch.int32, device=dev)
        partner = partner_table(C, dev)
    if out.numel():
        K.launch(
            "ola_assemble",
            ctypes.addressof(desc), *(e.data_ptr() for e in evs),
            scratch.data_ptr(), out.data_ptr(),
            *(t.data_ptr() if t is not None else 0
              for t in (wbyte, ubits, partner)),
            len(buckets), Ep, L, C, base, kmode, int(rice), count=count,
        )
    return (out, wbyte, ubits) if mode == "dpack" else out
