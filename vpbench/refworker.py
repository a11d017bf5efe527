"""Worker side of the reference pool: decode one input with the plain
reference, or with the control (the same reference with its DCT-IV product
computed in TF32). Imports numpy and the frozen reference only, so a
spawned worker starts fast and never touches the device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import reference
from .reference import decoder


def tf32(a: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest
    even, as the tensor cores read a float32 operand."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x0FFF) + ((u >> np.uint32(13)) & np.uint32(1)))
    return (r & np.uint32(0xFFFFE000)).view(np.float32)


@lru_cache(maxsize=8)
def _basis_tf32(m: int) -> np.ndarray:
    k = np.arange(m, dtype=np.float64)[:, None]
    j = np.arange(m, dtype=np.float64)[None, :]
    return tf32(np.cos(np.pi / m * (j + 0.5) * (k + 0.5)))


def imdct_tf32(x: np.ndarray, n: int) -> np.ndarray:
    """The reference's IMDCT with the DCT-IV as a dense product of TF32
    operands accumulated in float32 (a matmul with TF32 on)."""
    x = np.asarray(x, dtype=np.float64)
    m = n // 2
    d = (tf32(x.astype(np.float32)) @ _basis_tf32(m)).astype(np.float64)
    y = np.empty(x.shape[:-1] + (n,), dtype=np.float64)
    h = m // 2
    y[..., :h] = d[..., h:m]
    y[..., h : h + m] = -d[..., ::-1]
    y[..., h + m :] = -d[..., :h]
    return y


def decode(data: bytes, control: bool = False, clip: bool = True
           ) -> np.ndarray:
    """Planar float32 PCM of ``data`` from the reference, or the control,
    clipped to full scale where ``clip``."""
    saved = decoder.imdct
    if control:
        decoder.imdct = imdct_tf32
    try:
        return reference.decode(data, clip)
    finally:
        decoder.imdct = saved
