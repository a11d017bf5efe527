"""Inverse MDCT — scalar float64 reference (host, numpy).

The device version lives in ops/imdct.py; this module is the numerics
anchor it is verified against. Replaces the reference's stb-derived 8-step
pointer kernel (NVorbis/Mdct.cs:11) with the mathematical definition
evaluated exactly:

    y[j] = sum_{k=0}^{n/2-1} X[k] * cos(2*pi/n * (j + 0.5 + n/4) * (k + 0.5))

computed as a DCT-IV (via one 2M-point complex FFT, M = n/2) plus the
standard IMDCT reflection/extension symmetries. Exact to ~1e-15 relative in
float64 — far tighter than stb's reordered float32 arithmetic.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def imdct_direct(x: np.ndarray, n: int) -> np.ndarray:
    """O(n^2) direct evaluation (tests only)."""
    m = n // 2
    j = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(m, dtype=np.float64)[None, :]
    basis = np.cos(2.0 * np.pi / n * (j + 0.5 + n / 4.0) * (k + 0.5))
    return basis @ np.asarray(x, dtype=np.float64)


@lru_cache(maxsize=8)
def _twiddles(m: int) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(m, dtype=np.float64)
    pre = np.exp(-1j * np.pi * k / (2 * m))
    post = np.exp(-1j * np.pi * (k + 0.5) / (2 * m))
    return pre, post


def dct_iv(x: np.ndarray) -> np.ndarray:
    """DCT-IV_M(x)[j] = sum_k x[k] cos(pi/M (j+1/2)(k+1/2)) via 2M FFT."""
    m = x.shape[-1]
    pre, post = _twiddles(m)
    u = np.zeros(x.shape[:-1] + (2 * m,), dtype=np.complex128)
    u[..., :m] = x * pre
    f = np.fft.fft(u, axis=-1)[..., :m]
    return (post * f).real


def imdct(x: np.ndarray, n: int) -> np.ndarray:
    """IMDCT of spectra ``x`` (shape [..., n//2]) -> time frames [..., n].

    Uses d = DCT-IV(x) and the symmetries of
    f(t) = cos(pi/M (t+1/2)(k+1/2)):  f(-1-t) = f(t),  f(2M-1-t) = -f(t),
    f(t+2M) = -f(t), with the IMDCT being y[j] = d[j + M/2] extended.
    """
    x = np.asarray(x, dtype=np.float64)
    m = n // 2
    d = dct_iv(x)
    y = np.empty(x.shape[:-1] + (n,), dtype=np.float64)
    h = m // 2
    # j in [0, M/2): t = j + M/2 in [M/2, M)
    y[..., :h] = d[..., h:m]
    # j in [M/2, 3M/2): t in [M, 2M) -> -d[2M-1-t] with index M-1 .. 0
    y[..., h : h + m] = -d[..., ::-1]
    # j in [3M/2, 2M): t in [2M, 2M + M/2) -> -d[t - 2M] = -d[0 .. M/2)
    y[..., h + m :] = -d[..., :h]
    return y
