"""Vorbis synthesis windows (spec 4.3.1).

Behavior parity with reference NVorbis/BlocksizeDerivedCache.cs:22
(CalcWindowSlope) and StreamDecoder.OverlapBuffers:764 geometry.

window[i] = sin(pi/2 * sin^2(pi/2 * (i + 0.5) / slope_len)) rising;
the falling side is the same slope reversed (sin^2 -> cos^2 identity), so
overlapping windows satisfy Princen-Bradley (w_r^2 + w_f^2 == 1).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..setup.mode import WindowInfo, window_geometry


@lru_cache(maxsize=None)
def window_slope(length: int) -> np.ndarray:
    """Rising half-window slope of ``length`` samples (float64)."""
    x = (np.arange(length, dtype=np.float64) + 0.5) / length
    return np.sin(0.5 * np.pi * np.sin(0.5 * np.pi * x) ** 2)


@lru_cache(maxsize=None)
def full_window(
    n: int, left_start: int, left_end: int, right_start: int, right_end: int
) -> np.ndarray:
    """Complete per-frame window vector: zeros, rising slope, ones, falling
    slope, zeros (spec 4.3.1 window decode)."""
    w = np.zeros(n, dtype=np.float64)
    left_n = left_end - left_start
    right_n = right_end - right_start
    if left_n > 0:
        w[left_start:left_end] = window_slope(left_n)
    w[left_end:right_start] = 1.0
    if right_n > 0:
        w[right_start:right_end] = window_slope(right_n)[::-1]
    return w


def window_for(info: WindowInfo) -> np.ndarray:
    return full_window(
        info.n, info.left_start, info.left_end, info.right_start, info.right_end
    )
