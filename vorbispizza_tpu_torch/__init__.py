"""PyTorch/CUDA port of vorbispizza_tpu's batch decode.

Imports torch and numpy and the jax-free modules of vorbispizza_tpu (host
front end, setup parsing, the float64 scalar decoder), never jax. The
device stages are seven hand-written CUDA kernels for Hopper (csrc/), each
with a plain PyTorch twin that runs for CPU tensors.

Entry point: ``decode_corpus(sources, device="cuda", output="s16")`` (or
"f32", or "device").
"""

from .device import resolve_device
from .models.corpus import decode_corpus

__all__ = ["decode_corpus", "resolve_device"]
