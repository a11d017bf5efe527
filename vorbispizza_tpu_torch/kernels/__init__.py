"""Hand-written CUDA kernels of the port: build, load, launch, count."""

from .build import COUNTS, load, reset_counts

__all__ = ["COUNTS", "load", "reset_counts"]
