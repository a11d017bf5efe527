"""Square-polar coupling inverse times the floor -> spectra (kernel K3).

Port of vorbispizza_tpu/ops/coupling.py ``inverse_couple_batch`` (spec
4.3.4 step 2, steps in reverse declaration order) followed by the
``residues * floors`` product of models/pipeline.py ``_synth_math``.
"""

from __future__ import annotations

import torch

from ..kernels import build as K


def couple_spectrum_plain(res: torch.Tensor, floors: torch.Tensor,
                          steps: torch.Tensor) -> torch.Tensor:
    """res, floors [F, C, half] float32; steps int32 [S, 2] (mag, ang) ->
    spectra [F, C, half] float32 (plain twin of K3)."""
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


def couple_spectrum(res: torch.Tensor, floors: torch.Tensor,
                    steps: torch.Tensor) -> torch.Tensor:
    """``couple_spectrum_plain`` for CPU tensors; kernel K3 for CUDA ones."""
    if res.device.type == "cpu":
        return couple_spectrum_plain(res, floors, steps)
    K.require_cuda(res, floors, steps)
    if res.shape != floors.shape or res.dtype != torch.float32:
        raise ValueError("res and floors must be float32 [F, C, half]")
    if steps.dtype != torch.int32:
        raise TypeError("coupling steps must be int32 [S, 2]")
    F, C, half = res.shape
    out = torch.empty_like(res)
    if res.numel():
        K.launch(
            "couple_spectrum",
            res.data_ptr(), floors.data_ptr(), steps.data_ptr(),
            out.data_ptr(),
            F, C, half, steps.shape[0],
        )
    return out
