"""Device resolution for the PyTorch port.

Every entry point takes a ``device`` and defaults it to "cuda"; this
function itself takes no default (None raises). A CUDA request on a
machine without CUDA raises instead of falling back to the CPU, and
resolving a CUDA device pins full-float32 matrix products (the DCT-IV
product of ops/imdct.py needs them: TF32 keeps ~3 decimal
digits, far outside the 1e-6 PCM budget against the float64 anchor).
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` ("cpu", "cuda", "cuda:1", a torch.device) -> torch.device.

    For CUDA this applies the fp32 matmul settings the IMDCT requires
    (TF32 off, "highest" precision) and raises when CUDA is absent."""
    if device is None:
        raise ValueError("device is required: pass 'cpu' or 'cuda'")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but CUDA is not available"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def check_fp32_matmul() -> None:
    """Raise unless CUDA matrix products run in full float32."""
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "fp32 matmul settings not in force (TF32 enabled or precision "
            "below 'highest'); resolve the device with resolve_device()"
        )
