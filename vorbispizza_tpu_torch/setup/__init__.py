"""Vorbis setup-header layer: codebooks, floors, residues, mappings, modes."""

from .codebook import Codebook, assign_codewords
from .floor import Floor0, Floor1, FloorData
from .header import parse_comments, parse_ident, parse_setup
from .mapping import Mapping, inverse_couple
from .mode import Mode, WindowInfo, window_geometry
from .residue import Residue, parse_residue

__all__ = [
    "Codebook", "assign_codewords", "Floor0", "Floor1", "FloorData",
    "parse_comments", "parse_ident", "parse_setup", "Mapping",
    "inverse_couple", "Mode", "WindowInfo", "window_geometry",
    "Residue", "parse_residue",
]
