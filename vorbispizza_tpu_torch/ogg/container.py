"""Ogg container: sequential page demux to logical streams, new-stream
discovery callbacks, chained-stream support.

Behavior parity with reference NVorbis/Ogg/ContainerReader.cs:12 (TryInit:74,
FindNextStream:83, NewStreamCallback) and Ogg/PageReader.cs:11 (AddPage
demux:58, EOS retiring serials so chained files can reuse them:77-87).
"""

from __future__ import annotations

from typing import Callable, Optional

from .logical import LogicalStream, PacketProvider
from .page import PageScanner


class OggContainer:
    """Demuxes an Ogg byte stream into logical streams.

    ``new_stream_callback(provider) -> bool`` is invoked for each newly
    discovered logical stream; returning False ignores it (reference
    NewStreamEventArgs.IgnoreStream, NVorbis/NewStreamEventArgs.cs:29).
    """

    def __init__(self, stream, new_stream_callback: Optional[Callable] = None):
        self.scanner = PageScanner(stream)
        self.new_stream_callback = new_stream_callback
        self._active: dict[int, LogicalStream] = {}
        self._ignored: set[int] = set()
        self.providers: list[PacketProvider] = []
        self._eof = False

    # -- init / discovery -------------------------------------------------------

    @property
    def seekable(self) -> bool:
        return self.scanner.seekable

    def try_init(self) -> bool:
        """Read pages until the first logical stream appears (reference
        ContainerReader.TryInit:74)."""
        return self.find_next_stream() is not None

    def find_next_stream(self) -> PacketProvider | None:
        """Scan until a page for an unseen serial surfaces (reference
        ContainerReader.FindNextStream:83)."""
        known = len(self.providers)
        while len(self.providers) == known:
            if not self._scan_one():
                return None
        return self.providers[-1]

    # -- scanning ----------------------------------------------------------------

    def _scan_one(self) -> bool:
        """Scan exactly one page and route it. Returns False at EOF."""
        if self._eof:
            return False
        page = self.scanner.next_page()
        if page is None:
            self._eof = True
            for s in self._active.values():
                s.saw_eos = True
            return False
        serial = page.serial
        if serial in self._ignored:
            return True
        stream = self._active.get(serial)
        if stream is None:
            # A non-BOS page for an unknown serial after data loss is noise;
            # a BOS page (or the first page of a broken capture) starts a
            # stream. Reference accepts the first page of an unseen serial
            # (PageReader.AddPage:58-102).
            stream = LogicalStream(self, serial)
            provider = PacketProvider(stream)
            stream.add_page(page)
            # register BEFORE the callback: the callback typically pulls
            # header packets, which re-enters the scan loop (reference keeps
            # the same inversion, ContainerReader.cs:106-124)
            self._active[serial] = stream
            self.providers.append(provider)
            if self.new_stream_callback is not None:
                if not self.new_stream_callback(provider):
                    self._ignored.add(serial)
                    self._active.pop(serial, None)
                    self.providers.remove(provider)
                    return True
        else:
            stream.add_page(page)
        if page.is_eos:
            # retire the serial: chained files may reuse it
            # (reference PageReader.cs:77-87)
            self._active.pop(serial, None)
            stream.saw_eos = True
        return True

    def scan_into(self, stream: LogicalStream) -> bool:
        """Scan pages until ``stream`` gains one (or EOF/EOS). Used by the
        pull path (LogicalStream.ensure_page)."""
        before = len(stream.pages)
        while len(stream.pages) == before:
            if stream.saw_eos and self._active.get(stream.serial) is not stream:
                return False
            if not self._scan_one():
                return False
        return True

    def read_all(self) -> None:
        """Scan the entire container (builds every stream's page index)."""
        while self._scan_one():
            pass

    # -- stats --------------------------------------------------------------------

    @property
    def container_bits(self) -> int:
        return self.scanner.container_bits

    @property
    def waste_bits(self) -> int:
        return self.scanner.waste_bits
