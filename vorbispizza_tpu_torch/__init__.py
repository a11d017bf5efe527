"""PyTorch/CUDA port of vorbispizza_tpu's batch decode.

Imports torch and numpy, never jax and nothing of vorbispizza_tpu: the
host layers (Ogg, setup parsing, the frame planner, the C++ entropy front
end, the float64 scalar decoder, the test-stream generators) are the
port's own copies of the JAX package's. The device stages are eight
hand-written CUDA kernels for Hopper (csrc/), each with a plain PyTorch
twin that runs for CPU tensors, and the DCT-IV product, a torch.matmul.

Entry points, each on ``device="cuda"`` unless told otherwise ("cpu"
runs the plain twins): ``decode_corpus(sources, output="s16")`` (or "f32",
or "device"), the overlapped corpus driver, with ``batched=``,
``devices=`` and ``timer=`` (a ``DecodeTimer``); ``decode_file_batch``
and ``decode_stream_batch``, one stream at a time; and
``VorbisReader(source, accelerated=True)``, reads and seeks served from
one batch decode of the stream.
"""

from .device import resolve_device
from .models.corpus import decode_corpus
from .models.pipeline import decode_file_batch, decode_stream_batch
from .reader import VorbisReader
from .utils.profiling import DecodeTimer

__all__ = ["DecodeTimer", "VorbisReader", "decode_corpus",
           "decode_file_batch", "decode_stream_batch", "resolve_device"]
