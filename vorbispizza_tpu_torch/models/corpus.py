"""Corpus decode: many Ogg Vorbis streams through one device.

Port of vorbispizza_tpu/models/corpus.py ``decode_corpus``. Per-stream
host front ends (Ogg demux + C++ entropy decode, which releases the GIL)
run on a thread pool. The main thread consumes them in input order, groups
streams by channel count into chunks of at least ``max_batch_bytes`` of
dense spectrum (exactly as the reference chunks, so the merged chunks and
their sigs match), merges each chunk into one plan (``merge_streams``),
packs it (``BatchSynthesizer.prepare_host``), copies the four typed
buffers and five event arrays to the device, runs the synthesis on the
current CUDA stream, and copies the output back once.

``output="s16"`` follows ``VorbisConfig.s16_wire`` as the reference does,
with one difference: "dpack" runs the FULL-capacity wire ("s16df", at most
288 B per 128-sample block plus the unary section) instead of the
reference's soft-capacity "s16d". A chunk then never overflows its wire,
so the reference's PackOverflow re-run of a chunk is not needed: a wire
that fails its checks raises. The pull copies the header and width table
into pinned memory, reads nbytes, checks the sections, and makes ONE
exact-size copy of ``payload[:nbytes]`` into pinned memory (the
reference's tunnel paging, ops/pcm_pack.py start_page0/pull_wire, is not
needed on PCIe); the host unpacks it (ops.pcm_pack.unpack_pcm).
``s16_rice="auto"`` resolves from the measured link rate (utils/link.py).

Streams the batch planner rejects (BatchUnsupported) decode through the
float64 scalar anchor, as in the reference; ``stats["scalar"]`` counts
them. Copy/compute overlap across chunks is not here yet.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import threading
import time

import numpy as np
import torch

from .. import native
from ..config import VorbisConfig
from ..decoder import CLIP_MAX, StreamDecoder
from ..device import resolve_device
from ..errors import InvalidDataError, VorbisError
from ..frames import (
    BatchUnsupported,
    BucketBatch,
    FloorGroup,
    FramePlan,
    FrameSoA,
    SymBucket,
    build_plan,
    build_plan_from_scan,
    extract_batch,
)
from ..ogg.container import OggContainer
from ..ops import pcm_pack
from ..reader import VorbisReader
from ..setup.header import parse_comments, parse_ident, parse_setup_cached
from .pipeline import BatchSynthesizer

_SYNTH_CACHE: dict = {}
_SYNTH_LOCK = threading.Lock()
_SYNTH_CACHE_MAX = 32

#: wall-clock stages of decode_corpus, in pipeline order
STAGES = ("front_end", "prepare", "h2d", "device", "d2h", "unpack")

#: config.s16_wire -> the fused body's output for output="s16"
S16_FORMATS = {"dpack": "s16df", "planes": "s16p", "raw": "s16"}


def _synthesizer_for(setup, channels: int) -> BatchSynthesizer:
    """Process-wide BatchSynthesizer per channel count; every setup that
    flows through registers with it (buckets name their setup via key.sid),
    so its device tables are built once per bucket key."""
    with _SYNTH_LOCK:
        synth = _SYNTH_CACHE.get(channels)
        if synth is None:
            synth = BatchSynthesizer(setup, channels)
            if len(_SYNTH_CACHE) >= _SYNTH_CACHE_MAX:
                _SYNTH_CACHE.pop(next(iter(_SYNTH_CACHE)))
            _SYNTH_CACHE[channels] = synth
        else:
            synth.add_setup(setup)
        return synth


def _front_end_native(data: bytes):
    """All-native front end: C++ Ogg scan -> raw arrays -> vectorized plan
    -> C++ entropy decode. Returns None when the native path cannot model
    the stream (Python path instead)."""
    if not VorbisConfig.default.use_native_frontend or not native.available():
        return None
    res = native.scan_ogg_arrays(data)
    if res is None or len(res[1]) < 4:
        return None
    blob, offs, granules, flags, _serial = res
    try:
        ident = parse_ident(blob[offs[0] : offs[1]].tobytes())
        parse_comments(blob[offs[1] : offs[2]].tobytes())
        setup = parse_setup_cached(blob[offs[2] : offs[3]].tobytes(), ident)
        plan = build_plan_from_scan(blob, offs, granules, flags, setup)
    except BatchUnsupported:
        raise
    except Exception:
        return None  # headers the scanner mis-modeled: use the full path
    buckets = extract_batch(plan, setup, ident.channels, ident=ident)
    return setup, ident.channels, plan, buckets


def _front_end(source):
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    fast = _front_end_native(data)
    if fast is not None:
        return fast
    container = OggContainer(io.BytesIO(data))
    if not container.try_init():
        raise InvalidDataError("no logical stream found")
    provider = container.providers[0]
    dec = StreamDecoder(provider)
    dec.initialize()
    plan = build_plan(provider, dec._setup)
    buckets = extract_batch(plan, dec._setup, dec.channels, ident=dec._ident)
    return dec._setup, dec.channels, plan, buckets


def merge_streams(items):
    """Merge per-stream (plan, buckets) into ONE plan + bucket set.

    Frames from different streams are independent, so they concatenate
    along the frame axis; each stream gets a disjoint global-coordinate
    range and its chains stay self-contained. All streams share the channel
    count but not the setup: bucket keys carry their setup id.
    Returns (plan, buckets, pcm_lengths)."""
    soa_parts: list = []
    n_frames = 0
    chains: list[list[int]] = []
    chain_segments: list[list[tuple[int, int]]] = []
    merged: dict = {}
    pcm_lengths: list[int] = []
    coord_base = 0
    for plan, buckets in items:
        frame_base = n_frames
        soa_parts.append((plan.soa(), coord_base))
        n_frames += plan.n_frames
        for chain in plan.chains:
            chains.append([i + frame_base for i in chain])
        for segs in plan.chain_segments:
            chain_segments.append(
                [(s + coord_base, e + coord_base) for s, e in segs]
            )
        for b in buckets:
            merged.setdefault(b.key, []).append((b, frame_base, coord_base))
        pcm_lengths.append(plan.pcm_length)
        coord_base += plan.total_len
    soa_m = FrameSoA(
        n=np.concatenate([s.n for s, _ in soa_parts]),
        left_start=np.concatenate([s.left_start for s, _ in soa_parts]),
        left_end=np.concatenate([s.left_end for s, _ in soa_parts]),
        right_end=np.concatenate([s.right_end for s, _ in soa_parts]),
        offset=np.concatenate([s.offset + cb for s, cb in soa_parts]),
        prime=np.concatenate([s.prime for s, _ in soa_parts]),
        final=np.concatenate([s.final for s, _ in soa_parts]),
    )

    out_buckets: list[BucketBatch] = []
    for key, parts in merged.items():
        first = parts[0][0]
        groups: list[FloorGroup] = []
        for gi, g0 in enumerate(first.floor_groups):
            g = FloorGroup(floor=g0.floor, channels=list(g0.channels))
            g.used = np.concatenate([p[0].floor_groups[gi].used for p in parts])
            if g0.floor.floor_type == 1:
                g.posts = np.concatenate(
                    [p[0].floor_groups[gi].posts for p in parts]
                )
                g.step2 = np.concatenate(
                    [p[0].floor_groups[gi].step2 for p in parts]
                )
                if all(
                    p[0].floor_groups[gi].ys is not None for p in parts
                ):
                    g.ys = np.concatenate(
                        [p[0].floor_groups[gi].ys for p in parts]
                    )
            else:
                g.coefficients = np.concatenate(
                    [p[0].floor_groups[gi].coefficients for p in parts]
                )
                g.amplitude = np.concatenate(
                    [p[0].floor_groups[gi].amplitude for p in parts]
                )
            groups.append(g)
        sym = None
        if first.sym is not None:
            # per-group streams stay in frame order, so the scatter indices
            # derived from part_counts + slots keep matching
            sym = SymBucket(
                layout=first.sym.layout,
                groups=first.sym.groups,
                syms=[
                    np.concatenate([p[0].sym.syms[gi] for p in parts])
                    for gi in range(len(first.sym.syms))
                ],
                slots=[
                    np.concatenate([p[0].sym.slots[gi] for p in parts])
                    for gi in range(len(first.sym.slots))
                ],
                part_counts=np.concatenate(
                    [p[0].sym.part_counts for p in parts]
                ),
            )
        out_buckets.append(
            BucketBatch(
                key=key,
                n=first.n,
                frame_indices=np.concatenate(
                    [b.frame_indices + fb for b, fb, _ in parts]
                ),
                offsets=np.concatenate(
                    [b.offsets + np.int32(cb) for b, _, cb in parts]
                ),
                prime=np.concatenate([b.prime for b, _, _ in parts]),
                final=np.concatenate([b.final for b, _, _ in parts]),
                residues=(
                    np.concatenate([b.residues for b, _, _ in parts])
                    if first.residues is not None
                    else None
                ),
                floor_groups=groups,
                sym=sym,
            )
        )
    plan_m = FramePlan(
        frames=[],  # merged plans are pure struct-of-arrays (soa_cache)
        total_len=max(coord_base, 1),
        chains=chains,
        chain_segments=chain_segments,
        buckets={b.key: list(b.frame_indices) for b in out_buckets},
        soa_cache=soa_m,
    )
    return plan_m, out_buckets, pcm_lengths


def _scalar_fallback(source, output: str, clip_samples: bool, device):
    """Exact streaming decode of one source (BatchUnsupported streams)."""
    r = VorbisReader(
        source if isinstance(source, (str, bytes)) else bytes(source),
        clip_samples=clip_samples,
    )
    r.initialize()
    pcm = r.read_all(planar=True)
    if output == "s16":
        return np.clip(
            np.rint(pcm.astype(np.float64) * 32768.0), -32768, 32767
        ).astype(np.int16)
    if output == "device":
        return torch.from_numpy(np.ascontiguousarray(pcm)).to(device)
    return pcm


class CorpusOutputs(list):
    """decode_corpus's per-source outputs, in input order, plus ``stats``:
    stream counts (streams, batched, scalar, failed), ``chunks``,
    ``d2h_bytes`` (bytes copied device -> host), and ``stage_s``: host wall
    seconds per stage of STAGES (device and copy stages end in a
    synchronize, so they include the device's time)."""

    stats: dict


def _to_host(t: torch.Tensor) -> np.ndarray:
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
    nbt = pcm_pack.wire_rows(out_len, channels)
    head = pcm_pack.wire_header_bytes(channels) + nbt
    h = _to_host(wire[:head])
    nb, plane_cap, ch_ubit, widx = pcm_pack.parse_header(h, nbt, channels)
    pcm_pack.check_sections(nb, plane_cap, ch_ubit, widx,
                            wire.shape[0] - head)
    payload = _to_host(wire[head : head + nb])
    return payload, widx, ch_ubit, head + nb


def decode_corpus(
    sources,
    *,
    device,
    output: str = "f32",
    clip_samples: bool = True,
    max_batch_bytes: int | None = None,
    n_workers: int | None = None,
    on_error: str = "raise",
) -> CorpusOutputs:
    """Decode many Ogg Vorbis sources (paths or bytes) -> planar PCM
    [C, samples] per source, in input order.

    ``device``: required ("cpu", "cuda", "cuda:N"); a CUDA request where
    CUDA is absent raises. ``output``: "f32" (numpy float32 on the host,
    clipped per ``clip_samples``), "s16" (numpy int16 on the host,
    quantized on the device and shipped over config.s16_wire: "dpack",
    "planes" or "raw") or "device" (float32 tensors left on the device,
    unclipped, as the reference leaves them). ``on_error``: "raise"
    propagates a malformed source's error; "none" leaves its slot None."""
    if output not in ("f32", "s16", "device"):
        raise ValueError(f"output {output!r}: not 'f32', 's16' or 'device'")
    if on_error not in ("raise", "none"):
        raise ValueError(f"on_error must be 'raise' or 'none', got {on_error!r}")
    dev = resolve_device(device)
    cfg = VorbisConfig.default
    if n_workers is None:
        n_workers = cfg.corpus_workers
    if max_batch_bytes is None:
        max_batch_bytes = cfg.corpus_batch_bytes
    fmt = "f32"
    if output == "s16":
        if cfg.s16_wire not in S16_FORMATS:
            raise ValueError(f"s16_wire {cfg.s16_wire!r} (not one of "
                             f"{list(S16_FORMATS)})")
        fmt = S16_FORMATS[cfg.s16_wire]

    outs = CorpusOutputs([None] * len(sources))
    stats = {"streams": len(sources), "batched": 0, "scalar": 0, "failed": 0,
             "chunks": 0, "d2h_bytes": 0,
             "stage_s": dict.fromkeys(STAGES, 0.0)}
    outs.stats = stats
    walls = stats["stage_s"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    _FAILED = object()  # per-file failure sentinel (on_error="none")

    def front_end_or_none(source):
        try:
            return _front_end(source)
        except BatchUnsupported:
            return None
        except VorbisError:
            if on_error == "raise":
                raise
            return _FAILED

    def scalar(i):
        stats["scalar"] += 1
        try:
            outs[i] = _scalar_fallback(sources[i], output, clip_samples, dev)
        except VorbisError:
            if on_error == "raise":
                raise
            stats["failed"] += 1

    def dispatch(chunk, fronts_by_idx):
        t0 = time.perf_counter()
        setup, channels = fronts_by_idx[chunk[0]][:2]
        synth = _synthesizer_for(setup, channels)
        for i in chunk[1:]:  # cross-setup chunk: register every setup
            synth.add_setup(fronts_by_idx[i][0])
        plan_m, buckets_m, pcm_lengths = merge_streams(
            [fronts_by_idx[i][2:4] for i in chunk]
        )
        for i in chunk:
            del fronts_by_idx[i]
        if plan_m.n_frames == 0:
            # no decodable audio frame in the chunk: the scalar anchor is
            # authoritative for degenerate streams
            for i in chunk:
                scalar(i)
            return
        try:
            sig, host, total = synth.prepare_host(plan_m, buckets_m, fmt,
                                                  device=dev)
            t1 = time.perf_counter()
            walls["prepare"] += t1 - t0
            bufs = [torch.from_numpy(a).to(dev) for a in host]
            sync()
            t2 = time.perf_counter()
            walls["h2d"] += t2 - t1
            out = synth(sig, bufs)
            sync()
            t3 = time.perf_counter()
            walls["device"] += t3 - t2
        except BatchUnsupported:
            for i in chunk:
                scalar(i)
            return
        stats["chunks"] += 1
        stats["batched"] += len(chunk)
        if output == "device":
            pcm = out[:, :total]
        elif fmt == "s16df":
            payload, widx, ch_ubit, moved = pull_dpack(
                out, synth.channels, sig[3])
            stats["d2h_bytes"] += moved
            t4 = time.perf_counter()
            walls["d2h"] += t4 - t3
            pcm = pcm_pack.unpack_pcm(payload, widx, synth.channels, sig[3],
                                      ch_ubit)[:, :total]
            walls["unpack"] += time.perf_counter() - t4
        else:
            host_out = _to_host(out[..., :total].contiguous())
            stats["d2h_bytes"] += host_out.nbytes
            t4 = time.perf_counter()
            walls["d2h"] += t4 - t3
            if fmt == "s16p":
                # byte planes [2, C, L] u8 -> int16, losslessly
                pcm = (((host_out[1].astype(np.int32) << 8) | host_out[0])
                       - 32768).astype(np.int16)
            else:
                pcm = host_out
                if fmt == "f32" and clip_samples:
                    np.clip(pcm, -CLIP_MAX, CLIP_MAX, out=pcm)
            walls["unpack"] += time.perf_counter() - t4
        c = 0
        for i, ln in zip(chunk, pcm_lengths):
            outs[i] = pcm[:, c : c + ln]
            c += ln

    fronts_by_idx: dict = {}
    acc: dict = {}  # channels -> [indices, dense spectrum bytes]
    with cf.ThreadPoolExecutor(max_workers=n_workers) as pool:
        futs = [pool.submit(front_end_or_none, src) for src in sources]
        # consume in SUBMISSION order so chunk composition is deterministic
        for i, fut in enumerate(futs):
            t0 = time.perf_counter()
            front = fut.result()
            walls["front_end"] += time.perf_counter() - t0
            if front is _FAILED:
                stats["failed"] += 1
                continue
            if front is None:
                scalar(i)
                continue
            fronts_by_idx[i] = front
            rec = acc.setdefault(front[1], [[], 0])
            rec[0].append(i)
            rec[1] += sum(b.batch_cost for b in front[3])
            if rec[1] >= max_batch_bytes:
                dispatch(sorted(rec[0]), fronts_by_idx)
                acc[front[1]] = [[], 0]
    for idxs, _nbytes in acc.values():
        if idxs:
            dispatch(sorted(idxs), fronts_by_idx)
    return outs
