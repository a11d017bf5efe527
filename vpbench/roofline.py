"""The least time an H100 could take for the synthesis work of a decode,
counted from the inputs alone, so that the count is the same whatever
implements it (a fused kernel, a cuFFT IMDCT, another wire).

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 3.35 TB/s
of HBM3 and 67 TFLOP/s in float32 outside the tensor cores (the program
keeps TF32 off).

Bytes: the forward's inputs read once (the wire arrays sent to the device,
``stats["h2d_bytes"]``) and its output written once (the PCM or dpack wire
pulled back, ``stats["d2h_bytes"]``). Device tables are not counted: which
tables exist (a dense DCT-IV basis, say) is the implementation's choice.

Operations, per audio packet and channel, with m = blocksize / 2 spectral
lines:

- IMDCT: a DCT-IV of length m through an m/2-point complex FFT,
  5 (m/2) log2(m/2) = 2.5 m log2(m/2), plus the pre- and post-twiddle
  complex products, 2 (m/2) x 6 = 6 m;
- window and overlap-add: 2 m products and m sums, 3 m;
- floor times residue: m products;
- the floor curve: floor type 1 one step of its line per line, m; floor
  type 0 (LSP) 2 x order products per distinct bark-map value, of which
  there are min(m, bark_map_size);

and per packet 2 m for each square-polar coupling step (a compare and an
add or subtract per line pair). Residue decoding is table lookups: no
arithmetic is counted for it.
"""

from __future__ import annotations

import io
import math

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = 67e12


def dct_iv_flops(m: int) -> float:
    """FFT-based operation count of one DCT-IV of length m (m >= 4)."""
    return 2.5 * m * math.log2(m / 2) + 6 * m


def channel_flops(m: int, floor) -> float:
    """Operations of one channel of one packet: IMDCT, window and
    overlap-add, floor product and floor curve. ``floor`` is the channel's
    floor configuration (``floor_type``; ``order`` and ``bark_map_size``
    for type 0)."""
    if floor.floor_type == 0:
        curve = 2 * floor.order * min(m, floor.bark_map_size)
    else:
        curve = m
    return dct_iv_flops(m) + 3 * m + m + curve


def stream_flops(data: bytes) -> float:
    """Synthesis operations of a whole stream, from its headers and each
    audio packet's mode (the frozen reference parses them)."""
    from .reference.bitstream import BitReader
    from .reference.decoder import StreamDecoder
    from .reference.ogg.container import OggContainer

    container = OggContainer(io.BytesIO(bytes(data)))
    if not container.try_init():
        raise ValueError("no logical stream found")
    dec = StreamDecoder(container.providers[0])
    dec.initialize()
    setup = dec._setup
    per_mode = []
    for mode in setup.modes:
        mapping = setup.mappings[mode.mapping_idx]
        m = mode.n // 2
        ops = sum(channel_flops(m, mapping.submap_floor[sub])
                  for sub in mapping.mux)
        per_mode.append(ops + 2 * m * len(mapping.coupling_steps))
    total = 0.0
    provider = container.providers[0]
    while (pkt := provider.get_next_packet()) is not None:
        br = BitReader(pkt.data)
        if not pkt.data or br.read_bit():
            continue
        idx = br.read_bits(setup.mode_bits)
        if idx < len(per_mode) and not br.overrun:
            total += per_mode[idx]
    return total


def least_seconds(nbytes: float, flops: float) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the float32 rate."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_S)
