"""Scalar (host, numpy float64) DSP reference implementations."""

from .imdct import dct_iv, imdct, imdct_direct
from .window import full_window, window_for, window_slope

__all__ = ["dct_iv", "imdct", "imdct_direct", "full_window", "window_for", "window_slope"]
