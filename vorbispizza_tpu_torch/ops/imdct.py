"""IMDCT as a DCT-IV matrix product, and its window epilogue.

Port of vorbispizza_tpu/ops/imdct.py. The DCT-IV is a plain large float32
product against a compensated (hi, lo) basis, as XLA computed it outside
any kernel, so it stays ``torch.matmul`` (full float32: TF32 would keep
~3 decimal digits, far outside the 1e-6 PCM budget). The epilogue
(reflection, window, prime/final masks) is folded into kernel K4 on the
GPU; ``imdct_window`` below is its plain form.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import check_fp32_matmul


@lru_cache(maxsize=16)
def dct_iv_basis(m: int) -> tuple[np.ndarray, np.ndarray]:
    """[m, m] D with DCT-IV(x) = x @ D, D[k, j] = cos(pi/m (j+0.5)(k+0.5)),
    as a float32 (hi, lo) pair with hi + lo == D to float64 accuracy."""
    k = np.arange(m, dtype=np.float64)[:, None]
    j = np.arange(m, dtype=np.float64)[None, :]
    d = np.cos(np.pi / m * (j + 0.5) * (k + 0.5))
    hi = d.astype(np.float32)
    lo = (d - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


#: rows of every CPU product. The CPU BLAS sums a row's products in an
#: order that depends on how many rows share its call, so the CPU product
#: always takes exactly this many (the last block padded with zeros): a
#: row's result then does not depend on its chunk or shard, and one
#: stream decodes bit for bit alike however it is batched.
CPU_ROWS = 128


def dct_iv(spectra: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor):
    """[..., m] spectra -> [..., m] DCT-IV, two full-float32 products (on
    the CPU a block of CPU_ROWS rows at a time)."""
    if spectra.device.type == "cuda":
        check_fp32_matmul()
        return torch.matmul(spectra, hi) + torch.matmul(spectra, lo)
    m = spectra.shape[-1]
    rows = spectra.reshape(-1, m)
    n = rows.shape[0]
    if n % CPU_ROWS:
        rows = torch.cat([rows, rows.new_zeros(-n % CPU_ROWS, m)])
    return torch.cat([torch.matmul(b, hi) + torch.matmul(b, lo)
                      for b in rows.split(CPU_ROWS)])[:n].view(spectra.shape)


def imdct_window(d: torch.Tensor, window: torch.Tensor, prime: torch.Tensor,
                 final: torch.Tensor) -> torch.Tensor:
    """DCT-IV output [F, C, m] -> windowed, masked frames [F, C, 2m].

    The IMDCT symmetries y = [d[h:], -d[::-1], -d[:h]], times the window,
    times keep = (prime ? j >= m : 1) & (final ? j < m : 1): priming frames
    drop their left half, chain-final frames their right half."""
    m = d.shape[-1]
    h = m // 2
    y = torch.cat([d[..., h:], -d.flip(-1), -d[..., :h]], dim=-1) * window
    j = torch.arange(2 * m, device=d.device)[None, :]
    keep = torch.where(prime.bool()[:, None], j >= m, True) & torch.where(
        final.bool()[:, None], j < m, True
    )
    return y * keep[:, None, :].to(y.dtype)
