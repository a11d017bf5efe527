"""One chunk's round trip between the host and a device, the one every
driver of the port takes: decode_corpus (models/corpus.py), the sharded
decode (parallel/corpus.py) and ``BatchSynthesizer.assemble`` (the
stream drivers and the accelerated reader). ``launch`` packs the wire
(``prepare``), stages it in pinned memory, sends it and launches the
forward on the device's dispatch stream (``send``); ``land`` waits for
the chunk, pulls it on the device's pull stream and unpacks it, and
``hand_over`` leaves it on the device for the caller's stream. Spans,
marks and counts go to the caller's ``utils.profiling.CallSpans``, under
the caller's key (c<k>, shard<k>; None marks nothing) and cause.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from ..decoder import CLIP_MAX
from ..ops.pcm_pack import (
    DPACK,
    check_sections,
    parse_header,
    unpack_pcm,
    wire_header_bytes,
    wire_rows,
)

_LANES: dict = {}
_LANES_LOCK = threading.Lock()
_UNLOCKED = contextlib.nullcontext()


def lanes(dev: torch.device):
    """(dispatch stream, pull stream) of a CUDA device, made once per
    process; (None, None) for the CPU. Every chunk's tensors, and the
    tables the shared synthesizers cache, are made on the one dispatch
    stream of their device, so the caching allocator never gives a freed
    block to one stream while another still reads it."""
    if dev.type != "cuda":
        return None, None
    pair = _LANES.get(dev)
    if pair is None:
        with _LANES_LOCK:
            pair = _LANES.setdefault(dev, (torch.cuda.Stream(dev),
                                           torch.cuda.Stream(dev)))
    return pair


@contextlib.contextmanager
def on(dev: torch.device, stream):
    """Make ``dev`` and ``stream`` current for this thread (both are
    thread-local in PyTorch, and every kernel launches on the current
    stream); nothing for the CPU."""
    if stream is None:
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def to_host(t: torch.Tensor) -> np.ndarray:
    """Copy ``t`` into pinned host memory (CUDA) or view it (CPU)."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def pull_dpack(wire: torch.Tensor, channels: int, out_len: int):
    """The dpack wire's header and width table, then its payload at the
    exact size -> (payload u8 [nbytes], widx, ch_ubit, bytes copied). The
    header is checked against the width table before the payload moves."""
    nbt = wire_rows(out_len, channels)
    head = wire_header_bytes(channels) + nbt
    h = to_host(wire[:head])
    nb, plane_cap, ch_ubit, widx = parse_header(h, nbt, channels)
    check_sections(nb, plane_cap, ch_ubit, widx, wire.shape[0] - head)
    payload = to_host(wire[head : head + nb])
    return payload, widx, ch_ubit, head + nb


def upload(arrays, device: torch.device):
    """Host numpy arrays -> (tensors on ``device``, their pinned staging
    copies). On the CPU the tensors are views and nothing is staged. For
    CUDA each array is copied into pinned memory and sent with a
    non-blocking copy on the current stream, so the host goes on while
    the copies run; the staging copies are returned so a caller can hold
    them until the stream has passed the copies (PyTorch's pinned
    allocator holds a freed block until then too). The staging copy is
    numpy's, on the calling thread: PyTorch's would wake its CPU thread
    pool, whose threads then spin for each chunk."""
    if device.type == "cpu":
        return [torch.from_numpy(a) for a in arrays], []
    staged = []
    for a in arrays:
        p = torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                        pin_memory=True)
        np.copyto(p.numpy(), a)
        staged.append(p)
    return [p.to(device, non_blocking=True) for p in staged], staged


@dataclasses.dataclass(slots=True)
class Trip:
    """One chunk on its way: prepare_host's host arrays until it is sent
    and the ``prepare`` span's wall (None where nothing records it); then
    its device output, completion event (None on the CPU), pinned staging
    copies (until the event has passed), bytes sent and pull stream (None:
    the current one)."""

    key: str | None
    cause: str | None
    dev: torch.device
    channels: int
    sig: tuple
    total: int
    host: list | None = None
    prepare_s: float | None = None
    out: object = None
    event: object = None
    staged: object = None
    h2d: int = 0
    pull: object = None


def prepare(synth, plan, buckets, fmt: str, dev: torch.device, rec,
            key=None, cause=None, pads=None) -> Trip:
    """prepare_host of one chunk for ``fmt`` (``pads``: the sharded
    re-prepare's merged pads), on ``dev``'s dispatch stream; span
    ``prepare``."""
    with on(dev, lanes(dev)[0]), rec("prepare", key, cause) as sp:
        sig, host, total = synth.prepare_host(plan, buckets, fmt, pads=pads,
                                              device=dev)
    return Trip(key, cause, dev, synth.channels, sig, total, host,
                None if sp is None else sp.wall_s)


def send(synth, trip: Trip, rec) -> Trip:
    """Stage and send a prepared chunk (span ``h2d``), launch its forward
    and record its completion event (span ``launch``), on the device's
    dispatch stream; marks ``.dispatch0`` and ``.dispatched``."""
    stream, trip.pull = lanes(trip.dev)
    key, cause = trip.key, trip.cause
    with on(trip.dev, stream):
        with rec("h2d", key, cause):
            bufs, trip.staged = upload(trip.host, trip.dev)
        trip.h2d = sum(a.nbytes for a in trip.host)
        trip.host = None
        rec.mark(key and f"{key}.dispatch0")
        with rec("launch", key, cause):
            trip.out = synth(trip.sig, bufs)
            if stream is not None:
                trip.event = torch.cuda.Event(blocking=True)
                trip.event.record(stream)
        rec.mark(key and f"{key}.dispatched")
    return trip


def launch(synth, plan, buckets, fmt: str, dev: torch.device, rec, key=None,
           cause=None, pads=None) -> Trip:
    """prepare, then send: one chunk from its plan to its running forward."""
    return send(synth, prepare(synth, plan, buckets, fmt, dev, rec, key,
                               cause, pads), rec)


def hand_over(trip: Trip):
    """A sent chunk's output, left on its device: the kept samples (a
    dpack wire whole), which the caller's current stream waits for."""
    if trip.event is not None:
        caller = torch.cuda.current_stream(trip.dev)
        caller.wait_event(trip.event)
        trip.out.record_stream(caller)
    return trip.out if trip.sig[5] in DPACK else trip.out[..., : trip.total]


def land(trip: Trip, clip: bool, rec, pull_lock=None):
    """A sent chunk -> host (PCM, bytes pulled): the event waited on (span
    ``wait``), the output pulled under ``pull_lock`` on the pull stream
    (span ``pull``; the dpack wire at its exact size) and unpacked by the
    sig's format (span ``unpack``), f32 clipped where ``clip``; marks
    ``.pull_wait``, ``.pull0``, ``.pull_done``. The caller's stats count
    the bytes pulled ("d2h_bytes") and the dpack payload ("wire_bytes"),
    where they have those keys."""
    key, cause, fmt = trip.key, trip.cause, trip.sig[5]
    if trip.event is not None:
        with rec("wait", key, cause):
            trip.event.synchronize()
    trip.staged = None  # the chunk's copies have run
    rec.mark(key and f"{key}.pull_wait")
    # the lock is taken outside the span, so the stage sums to the link's
    # occupancy and not to the threads' wait for it
    with pull_lock or _UNLOCKED, rec("pull", key, cause):
        rec.mark(key and f"{key}.pull0")
        with on(trip.dev, trip.pull):
            if fmt in DPACK:
                host, widx, ch_ubit, moved = pull_dpack(
                    trip.out, trip.channels, trip.sig[3])
            else:
                host = to_host(trip.out[..., : trip.total].contiguous())
                moved = host.nbytes
    trip.out = None
    rec.mark(key and f"{key}.pull_done")
    rec.tally("d2h_bytes", moved)
    with rec("unpack", key, cause):
        if fmt in DPACK:
            rec.tally("wire_bytes", host.nbytes)
            return unpack_pcm(host, widx, trip.channels, trip.sig[3],
                              ch_ubit)[:, : trip.total], moved
        if fmt == "s16p":  # byte planes [2, C, L] u8 -> int16, losslessly
            return (((host[1].astype(np.int32) << 8) | host[0])
                    - 32768).astype(np.int16), moved
        if fmt == "f32" and clip:
            np.clip(host, -CLIP_MAX, CLIP_MAX, out=host)
    return host, moved
