"""Square-polar coupling inverse times the floor -> spectra (kernel K3).

Port of vorbispizza_tpu/ops/coupling.py ``inverse_couple_batch`` (spec
4.3.4 step 2, steps in reverse declaration order) followed by the
``residues * floors`` product of models/pipeline.py ``_synth_math``.

K3 takes every bucket of a chunk in one launch (``couple_spectrum_chunk``):
its output is one flat float32 buffer holding each bucket's spectra back
to back, and each bucket's [F, C, half] view of it is that bucket's DCT-IV
operand.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build as K

#: buckets K3's descriptor holds and channels it takes
#: (csrc/couple_spectrum.cu)
MAX_BUCKETS = 64
MAX_CHANNELS = 255


def couple_spectrum_plain(res: torch.Tensor, floors: torch.Tensor,
                          steps: torch.Tensor) -> torch.Tensor:
    """res, floors [F, C, half] float32; steps int32 [S, 2] (mag, ang) ->
    spectra [F, C, half] float32 (plain twin of K3, one bucket)."""
    res = res.clone()
    for m, a in reversed(steps.tolist()):
        mag = res[:, m, :]
        ang = res[:, a, :]
        pos_m = mag > 0
        pos_a = ang > 0
        new_m = torch.where(pos_a, mag, torch.where(pos_m, mag + ang, mag - ang))
        new_a = torch.where(pos_a, torch.where(pos_m, mag - ang, mag + ang), mag)
        res[:, m, :] = new_m
        res[:, a, :] = new_a
    return res * floors


def _views(flat: torch.Tensor, shapes) -> list:
    """Each bucket's [F, C, half] view of the flat buffer, back to back."""
    views, off = [], 0
    for shape in shapes:
        n = shape[0] * shape[1] * shape[2]
        views.append(flat[off : off + n].view(shape))
        off += n
    return views


def couple_spectrum_chunk(parts) -> tuple[torch.Tensor, list]:
    """Every bucket of a chunk: ``parts`` holds each bucket's (res, floors,
    steps) as ``couple_spectrum_plain`` takes them. Returns (the flat
    float32 buffer, each bucket's contiguous [F, C, half] view of it).

    CPU tensors: ``couple_spectrum_plain`` a bucket. CUDA ones: one K3
    launch over every bucket; it raises on more than MAX_BUCKETS buckets,
    channels past MAX_CHANNELS or differing between buckets, and on an
    operand that is not 16-byte aligned (K3 reads and writes float4s)."""
    if not parts:
        raise ValueError("couple_spectrum_chunk takes at least one bucket")
    shapes = [tuple(r.shape) for r, _, _ in parts]
    if parts[0][0].device.type == "cpu":
        outs = [couple_spectrum_plain(*p) for p in parts]
        flat = torch.cat([o.reshape(-1) for o in outs])
        return flat, _views(flat, shapes)
    if len(parts) > MAX_BUCKETS:
        raise ValueError(f"{len(parts)} buckets (K3 holds {MAX_BUCKETS})")
    C = shapes[0][1]
    if not 0 < C <= MAX_CHANNELS:
        raise ValueError(f"{C} channels (K3 takes 1..{MAX_CHANNELS})")
    dev = parts[0][0].device
    flat = torch.empty(sum(F * C_ * h for F, C_, h in shapes),
                       dtype=torch.float32, device=dev)
    views = _views(flat, shapes)
    rows = []
    for (res, floors, steps), out in zip(parts, views):
        K.require_cuda(res, floors, steps)
        F, C_, half = res.shape
        if (res.shape != floors.shape or C_ != C
                or res.dtype != torch.float32 or floors.dtype != torch.float32):
            raise ValueError("res and floors must be float32 [F, C, half], "
                             "with one C for every bucket")
        if steps.dtype != torch.int32 or steps.dim() != 2 or (
                steps.numel() and steps.shape[1] != 2):
            raise TypeError("coupling steps must be int32 [S, 2]")
        if half < 4 or half & (half - 1) or F * C * half >= 2**31:
            raise ValueError(f"K3 takes half a power of two from 4 and F*C*"
                             f"half below 2^31 (F {F}, half {half})")
        if any(t.data_ptr() % 16 for t in (res, floors, out)):
            raise ValueError("K3 reads and writes float4s: res, floors and "
                             "out must be 16-byte aligned")
        rows += [res.data_ptr(), floors.data_ptr(), steps.data_ptr(),
                 out.data_ptr(), F, half, steps.shape[0]]
    if flat.numel():
        desc = (ctypes.c_int64 * len(rows))(*rows)
        K.launch("couple_spectrum", ctypes.addressof(desc), len(parts), C)
    return flat, views


def couple_spectrum(res: torch.Tensor, floors: torch.Tensor,
                    steps: torch.Tensor) -> torch.Tensor:
    """One bucket through ``couple_spectrum_chunk``: the twin for CPU
    tensors, kernel K3 for CUDA ones."""
    return couple_spectrum_chunk([(res, floors, steps)])[1][0]
