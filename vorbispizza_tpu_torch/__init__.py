"""PyTorch/CUDA port of vorbispizza_tpu's batch decode.

Imports torch and numpy, never jax and nothing of vorbispizza_tpu: the
host layers (Ogg, setup parsing, the frame planner, the C++ entropy front
end, the float64 scalar decoder, the test-stream generators) are the
port's own copies of the JAX package's. The device stages are eight
hand-written CUDA kernels for Hopper (csrc/), each with a plain PyTorch
twin that runs for CPU tensors, and the DCT-IV product, a torch.matmul.

Entry point: ``decode_corpus(sources, device="cuda", output="s16")`` (or
"f32", or "device").
"""

from .device import resolve_device
from .models.corpus import decode_corpus

__all__ = ["decode_corpus", "resolve_device"]
