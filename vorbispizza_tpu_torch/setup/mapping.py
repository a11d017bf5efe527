"""Vorbis mapping type 0: submaps, channel coupling, floor/residue routing,
and per-packet spectral decode orchestration.

Behavior parity with reference NVorbis/Mapping.cs:9 (config :19-95, packet
orchestration DecodePacket:97-196, coupling inverse ApplyCoupling:198-269).
Implemented from Vorbis I spec sections 4.2.4 (mapping header) and
4.3.2-4.3.4 (floor decode, nonzero propagation, residue decode, inverse
coupling).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream import BitReader
from ..errors import InvalidDataError
from ..utils.bits import ilog


@dataclass
class DecodedFrame:
    """Dense per-packet spectra: the host/device boundary tensor bundle.

    ``residues`` is post-coupling; multiplying by the synthesized floor curve
    then IMDCT'ing yields the time-domain frame.
    """

    n: int  # blocksize
    floor_data: list  # FloorData per channel
    floors: list  # floor config per channel (for synthesis)
    residues: np.ndarray  # float64 [channels, n//2], post-coupling


class Mapping:
    def __init__(self, br: BitReader, channels: int, floors: list, residues: list):
        if br.read_bits(16) != 0:
            raise InvalidDataError("mapping type must be 0")
        self.channels = channels
        submaps = (br.read_bits(4) + 1) if br.read_bit() else 1
        self.coupling_steps: list[tuple[int, int]] = []
        if br.read_bit():
            n_steps = br.read_bits(8) + 1
            bits = ilog(channels - 1)
            for _ in range(n_steps):
                m = br.read_bits(bits)
                a = br.read_bits(bits)
                if m == a or m >= channels or a >= channels:
                    raise InvalidDataError("bad coupling channel pair")
                self.coupling_steps.append((m, a))
        if br.read_bits(2) != 0:
            raise InvalidDataError("mapping reserved bits nonzero")
        if submaps > 1:
            self.mux = [br.read_bits(4) for _ in range(channels)]
            if any(m >= submaps for m in self.mux):
                raise InvalidDataError("mux references missing submap")
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(submaps):
            br.read_bits(8)  # unused time-config placeholder
            fi = br.read_bits(8)
            ri = br.read_bits(8)
            if fi >= len(floors) or ri >= len(residues):
                raise InvalidDataError("submap references missing floor/residue")
            self.submap_floor.append(floors[fi])
            self.submap_residue.append(residues[ri])
        if br.overrun:
            raise InvalidDataError("mapping truncated")
        self.submaps = submaps

    # -- packet decode (spec 4.3.2-4.3.4) -------------------------------------------

    def decode_packet_raw(self, br: BitReader, n: int):
        """Entropy-decode one packet to dense tensors WITHOUT applying the
        coupling inverse: (floor_data list, floors list, residues [ch, n//2]).

        This is the host/device boundary of the batch pipeline — coupling,
        floor synthesis, and everything after run on device (ops/)."""
        half = n // 2
        ch = self.channels
        # 1. floor curves for all channels (spec 4.3.2)
        floors = [self.submap_floor[self.mux[c]] for c in range(ch)]
        floor_data = [floors[c].unpack(br) for c in range(ch)]
        # 2. nonzero-vector propagation through couplings (spec 4.3.3;
        #    reference Mapping.cs:121-130)
        no_residue = [fd.unused for fd in floor_data]
        for m, a in self.coupling_steps:
            if not (no_residue[m] and no_residue[a]):
                no_residue[m] = False
                no_residue[a] = False
        # 3. residue decode per submap (spec 4.3.4 step 1)
        residues = np.zeros((ch, half), dtype=np.float64)
        for s in range(self.submaps):
            ch_list = [c for c in range(ch) if self.mux[c] == s]
            if not ch_list:
                continue
            dnd = [no_residue[c] for c in ch_list]
            out = self.submap_residue[s].decode(br, dnd, half)
            for i, c in enumerate(ch_list):
                residues[c] = out[i]
        return floor_data, floors, residues

    def decode_packet(self, br: BitReader, n: int) -> DecodedFrame:
        floor_data, floors, residues = self.decode_packet_raw(br, n)
        # 4. inverse coupling, steps in reverse order (spec 4.3.4 step 2;
        #    reference ApplyCoupling:198)
        for m, a in reversed(self.coupling_steps):
            mag = residues[m]
            ang = residues[a]
            new_m, new_a = inverse_couple(mag, ang)
            residues[m] = new_m
            residues[a] = new_a
        return DecodedFrame(n=n, floor_data=floor_data, floors=floors, residues=residues)


def inverse_couple(mag: np.ndarray, ang: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Square-polar coupling inverse (spec 4.3.4; reference Mapping.cs:235-268).

    Truth table:
        M>0, A>0 -> (M, M-A)      M>0, A<=0 -> (M+A, M)
        M<=0, A>0 -> (M, M+A)     M<=0, A<=0 -> (M-A, M)
    """
    pos_m = mag > 0
    pos_a = ang > 0
    new_m = np.where(
        pos_a, mag, np.where(pos_m, mag + ang, mag - ang)
    )
    new_a = np.where(
        pos_a, np.where(pos_m, mag - ang, mag + ang), mag
    )
    return new_m, new_a
