"""Ogg physical/logical container layer (host side)."""

from .container import OggContainer
from .crc import ogg_crc
from .logical import GranuleTable, LogicalStream, Packet, PacketProvider
from .page import Page, PageScanner

__all__ = [
    "OggContainer",
    "ogg_crc",
    "GranuleTable",
    "LogicalStream",
    "Packet",
    "PacketProvider",
    "Page",
    "PageScanner",
]
