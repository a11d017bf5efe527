"""Corpus decode: many Ogg Vorbis streams through one or more devices,
with the host's stages and the device's work overlapped.

Port of vorbispizza_tpu/models/corpus.py ``decode_corpus``, on its
structure:

- Per-stream host front ends (Ogg demux + C++ entropy decode, which
  releases the GIL) run on a thread pool (``FrontEnds``, shared with
  decode_corpus_sharded). The main thread consumes them
  in input order and groups streams by channel count into chunks of at
  least ``max_batch_bytes`` of dense spectrum, exactly as the reference
  chunks, so the chunks and their sigs match it. A stream with more is
  the exception (the reference keeps it whole): the main thread cuts its
  plan into pieces that fit the chunks, the workers extract them, and
  each piece is a unit of the chunks, its PCM placed into the stream's
  answer.
- ONE dispatch thread takes the chunks in submission order. For each it
  merges the streams (``merge_streams``), then (models/launch.py) packs
  the wire (``BatchSynthesizer.prepare_host``), stages the nine host
  arrays in pinned memory, sends them with non-blocking copies and
  launches the synthesis, all on the device's dispatch stream, and
  records the chunk's completion event. Chunks go round-robin over
  ``devices``.
- A pool of three collectors waits on each chunk's own event, pulls its
  output (one pull at a time, under a lock, on the device's pull stream)
  and unpacks it, while the dispatch thread packs the next chunk and the
  main thread takes more front ends. The main thread never synchronizes
  the device.

``output="s16"`` follows ``VorbisConfig.s16_wire`` as the reference does,
with one difference: "dpack" runs the FULL-capacity wire ("s16df", at most
288 B per 128-sample block plus the unary section) instead of the
reference's soft-capacity "s16d". A chunk then never overflows its wire,
so the reference's PackOverflow re-run of a chunk is not needed: a wire
that fails its checks raises. The pull copies the header and width table
into pinned memory, reads nbytes, checks the sections, and makes ONE
exact-size copy of ``payload[:nbytes]`` into pinned memory (the
reference's tunnel paging, ops/pcm_pack.py start_page0/pull_wire, is not
needed on PCIe); the host unpacks it (ops.pcm_pack.unpack_pcm, C++
through ctypes, which releases the GIL). ``s16_rice="auto"`` resolves
from the measured link rate (utils/link.py).

Streams the batch planner rejects (BatchUnsupported) decode through the
float64 scalar anchor, as in the reference; ``stats["scalar"]`` counts
them.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import io
import os
import threading

import numpy as np
import torch

from .. import native
from ..config import VorbisConfig
from ..decoder import StreamDecoder
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
    build_plan_native,
    dense_cost,
    extract_batch,
    plan_piece,
    split_bounds,
)
from ..ogg.container import OggContainer
from ..reader import VorbisReader
from ..setup.header import parse_comments, parse_ident, parse_setup_cached
from ..utils import profiling
from .launch import hand_over, land, launch
from .pipeline import BatchSynthesizer

_SYNTH_CACHE: dict = {}
_SYNTH_LOCK = threading.Lock()
_SYNTH_CACHE_MAX = 32

#: host wall-clock stages of decode_corpus (stats["stage_s"]), in
#: pipeline order: the main thread's wait on front ends; a front-end
#: worker's split of a long stream into pieces and their gathers; the
#: dispatch thread's merge, prepare_host, pinned staging + H2D enqueue
#: and forward launch; the collectors' wait on a chunk's event, pull and
#: unpack; placing a piece's PCM into its stream's answer. Each sums the
#: walls of its spans (utils/profiling.SPAN_STAGES)
STAGES = ("front_end", "split", "merge", "prepare", "h2d", "dispatch",
          "device", "d2h", "unpack", "stitch")

#: config.s16_wire -> the fused body's output for output="s16"
S16_FORMATS = {"dpack": "s16df", "planes": "s16p", "raw": "s16"}

#: the least dense spectrum (bytes) of a piece of a long stream: a
#: max_batch_bytes below it (one stream a chunk) splits no stream smaller,
#: and cuts the longer ones at it, so that no chunk is a few frames whose
#: fixed costs outweigh their work
MIN_PIECE_BYTES = 1 << 20


def _synthesizer_for(setup, channels: int) -> BatchSynthesizer:
    """Process-wide BatchSynthesizer per channel count; every setup that
    flows through registers with it (buckets name their setup via key.sid),
    so its device tables are built once per bucket key."""
    with _SYNTH_LOCK:
        synth = _SYNTH_CACHE.get(channels)
        if synth is None:
            synth = BatchSynthesizer(setup, channels)
            profiling.tally("synth")
            if len(_SYNTH_CACHE) >= _SYNTH_CACHE_MAX:
                _SYNTH_CACHE.pop(next(iter(_SYNTH_CACHE)))
            _SYNTH_CACHE[channels] = synth
        else:
            synth.add_setup(setup)
        return synth


def synthesizer_of(fronts) -> BatchSynthesizer:
    """The process-wide synthesizer of these front ends' channel count (a
    chunk's or a group's), every one of their setups registered with it."""
    synth = _synthesizer_for(fronts[0][0], fronts[0][1])
    for front in fronts[1:]:  # a cross-setup chunk
        synth.add_setup(front[0])
    return synth


def _cores() -> int:
    """The cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # a platform without affinity masks
        return os.cpu_count() or 1


def decode_threads(n_workers: int, n_units: int) -> int:
    """Threads of each C++ entropy decode on a front-end pool of
    ``n_workers`` given ``n_units`` decodes (a whole stream or a piece of a
    long one each): the cores, at most 16 as the C++ default takes, shared
    among the decodes the pool runs at once."""
    return max(1, min(_cores(), 16) // max(1, min(n_workers, n_units)))


#: the dense-spectrum limit of one stream (bytes; None: no stream is
#: split) and the C++ decode's threads of the corpus call whose front-end
#: worker runs on this thread; unset elsewhere
_worker = threading.local()


def join_pool(split_bytes: int | None, threads: int) -> None:
    """Make this thread a front-end worker of a corpus call (decode_corpus,
    decode_corpus_sharded) whose C++ decodes of whole streams take
    ``threads`` (a pool's initializer)."""
    _worker.split_bytes = split_bytes
    _worker.threads = threads


@dataclasses.dataclass(slots=True)
class Unextracted:
    """The buckets of a front end whose plan holds more dense spectrum than
    its thread's split limit: nothing is decoded yet; its worker splits the
    plan and extracts each piece with ``ident``."""

    ident: object


def _extract(plan, setup, ident):
    """extract_batch of the whole plan; Unextracted where this thread's
    decode_corpus call splits streams and the plan holds more dense
    spectrum than the call's limit. On a call's worker (join_pool) the C++
    decode takes the call's share of the cores; elsewhere the C++ default."""
    limit = getattr(_worker, "split_bytes", None)
    if limit is not None and int(dense_cost(plan, ident.channels).sum()) > limit:
        return Unextracted(ident)
    return extract_batch(plan, setup, ident.channels, ident=ident,
                         n_threads=getattr(_worker, "threads", None))


def _front_end_native(data: bytes):
    """All-native front end: C++ Ogg scan -> raw arrays -> C++ plan ->
    C++ entropy decode -> C++ gather; the numpy plan where a chain needs
    the exact layout (build_plan_native declines). Such a stream counts in
    ``front_native`` when the C++ planned it. Returns None when the native
    path cannot model the stream (Python path instead). Spans of the
    thread's task: the C++ scan ``front.scan``, the header parses
    ``front.headers``, the C++ plan ``front.native`` and its wrapping or
    the numpy plan ``front.plan``; extract_batch's after them."""
    if not VorbisConfig.default.use_native_frontend or not native.available():
        return None
    with profiling.sub("front.scan"):
        res = native.scan_ogg_arrays(data)
    if res is None or len(res[1]) < 4:
        return None
    blob, offs, granules, flags, _serial = res
    try:
        with profiling.sub("front.headers"):
            ident = parse_ident(blob[offs[0] : offs[1]].tobytes())
            parse_comments(blob[offs[1] : offs[2]].tobytes())
            setup = parse_setup_cached(blob[offs[2] : offs[3]].tobytes(),
                                       ident)
        plan = build_plan_native(blob, offs, granules, flags, setup)
        in_cpp = plan is not None
        if not in_cpp:
            with profiling.sub("front.plan"):
                plan = build_plan_from_scan(blob, offs, granules, flags,
                                            setup)
    except BatchUnsupported:
        raise
    except Exception:
        return None  # headers the scanner mis-modeled: use the full path
    buckets = _extract(plan, setup, ident)
    if in_cpp:
        profiling.tally("front_native")
    return setup, ident.channels, plan, buckets


def _front_end(source):
    """One source -> (setup, channels, plan, buckets): the native front
    end, or the Python path (counted as "front_python", its Ogg and header
    parse and plan the span ``front.python``) where that cannot model the
    stream. On a decode_corpus worker that splits long streams, buckets is
    Unextracted for a plan over the call's limit (_extract)."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    fast = _front_end_native(data)
    if fast is not None:
        return fast
    profiling.tally("front_python")
    with profiling.sub("front.python"):
        container = OggContainer(io.BytesIO(data))
        if not container.try_init():
            raise InvalidDataError("no logical stream found")
        provider = container.providers[0]
        dec = StreamDecoder(provider)
        dec.initialize()
        plan = build_plan(provider, dec._setup)
    buckets = _extract(plan, dec._setup, dec._ident)
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


def _scalar_fallback(source, output: str, clip_samples: bool):
    """Exact streaming decode of one source (BatchUnsupported streams):
    host PCM, int16 for ``output="s16"``, else float32."""
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
    return pcm


#: the front end of a source that raised VorbisError under on_error="none"
_FAILED = object()


class FrontEnds:
    """The front-end stage of a corpus call (decode_corpus,
    decode_corpus_sharded): a ``vp-front`` pool whose tasks record into
    the call's ``spans`` under their stream's key s<i>, inside its
    ``front`` span, each C++ decode of a whole stream on the pool's share
    of the cores and a plan over ``split_bytes`` left Unextracted
    (join_pool). Iterating yields (i, front) in input order (span
    ``front.wait``); a source the batch planner rejects goes to
    ``scalar(i)``, the float64 decoder (``stats["scalar"]``, its host PCM
    in ``outs[i]``: ``place`` moves it for output "device"); a malformed
    one raises, or under on_error="none" counts in ``stats["failed"]``."""

    def __init__(self, sources, outs, spans, *, output: str, clip: bool,
                 on_error: str, n_workers: int, split_bytes=None):
        if output not in ("f32", "s16", "device"):
            raise ValueError(f"output {output!r}: not 'f32', 's16' or "
                             "'device'")
        if on_error not in ("raise", "none"):
            raise ValueError(f"on_error must be 'raise' or 'none', got "
                             f"{on_error!r}")
        self.sources, self.outs, self.spans = sources, outs, spans
        self.output, self.clip, self.on_error = output, clip, on_error
        self.pool = cf.ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix="vp-front",
            initializer=join_pool,
            initargs=(split_bytes, decode_threads(n_workers, len(sources))))

    def submit(self, i, fn, *args):
        """``fn(*args)`` as stream i's task -> its future: the result, None
        (BatchUnsupported) or _FAILED (VorbisError, on_error="none")."""
        return self.pool.submit(self._task, i, fn, args)

    def _task(self, i, fn, args):
        key = f"s{i}"
        profiling.bind(self.spans, key)
        try:
            with self.spans("front", key):
                return fn(*args)
        except BatchUnsupported:
            return None
        except VorbisError:
            if self.on_error == "raise":
                raise
            return _FAILED

    def __iter__(self):
        futs = [self.submit(i, _front_end, s)
                for i, s in enumerate(self.sources)]
        for i, fut in enumerate(futs):
            with self.spans("front.wait", f"s{i}"):
                front = fut.result()
            if front is _FAILED:
                self.spans.tally("failed")
            elif front is None:
                self.scalar(i)
            else:
                yield i, front

    def scalar(self, i) -> None:
        self.spans.tally("scalar")
        try:
            self.outs[i] = _scalar_fallback(
                self.sources[i], "f32" if self.output == "device"
                else self.output, self.clip)
        except VorbisError:
            if self.on_error == "raise":
                raise
            self.spans.tally("failed")

    def place(self, dev) -> None:
        """For output "device": the scalar decodes' host PCM to ``dev``, on
        the caller's stream."""
        if self.output == "device":
            for i, o in enumerate(self.outs):
                if isinstance(o, np.ndarray):
                    self.outs[i] = torch.from_numpy(o).to(dev)


class CorpusOutputs(list):
    """decode_corpus's per-source outputs, in input order, plus ``stats``:
    stream counts (streams, batched, scalar, failed), ``chunks``,
    ``h2d_bytes`` and ``d2h_bytes`` (the wire bytes sent to the devices
    and copied back), ``builds`` (the call's table builds by kind,
    utils/profiling.BUILDS: setup parses, synthesizers, wire layouts, K1
    tables, bucket tables; 0 when earlier calls built them all),
    ``front_python`` (streams the native front end could not model),
    ``front_native`` (streams whose plan and gather ran in C++),
    ``split_streams`` (streams over the chunk size, decoded in pieces),
    ``pieces`` (the pieces they were cut into), ``chunk_bytes_max`` (the
    largest chunk's dense spectrum bytes), ``native_decodes`` (C++
    entropy decodes, of whole streams and pieces), ``native_threads``
    (the threads those decodes were given, summed; the C++ starts at most
    one a packet) and
    ``stage_s``: host wall seconds per stage of STAGES, each the summed
    walls of its spans (utils/profiling.SPAN_STAGES). The stages run on
    three kinds of thread at once, so their walls overlap and need not
    sum to the call's wall; "device" is the collectors' ``wait`` spans on
    chunk events, the device time no host work hid."""

    stats: dict


@dataclasses.dataclass(slots=True)
class _Member:
    """A stream decoded in pieces: its answer, allocated whole, each
    piece's first sample in it (set as the pieces arrive, in order), and
    whether the pieces make the answer ("ok"), or the stream failed or
    went to the scalar decoder."""

    out: object
    at: list
    state: str = "ok"


def decode_corpus(
    sources,
    *,
    device="cuda",
    output: str = "f32",
    clip_samples: bool = True,
    batched: bool = True,
    max_batch_bytes: int | None = None,
    n_workers: int | None = None,
    devices=None,
    timer=None,
    on_error: str = "raise",
) -> CorpusOutputs:
    """Decode many Ogg Vorbis sources (paths or bytes) -> planar PCM
    [C, samples] per source, in input order.

    ``device``: "cuda" (the default), "cuda:N" or "cpu" (every stage's
    plain twin); a CUDA request where CUDA is absent raises. ``devices``:
    a list of such specs to round-robin the chunks over (each chunk runs
    whole on one device); it replaces ``device``. ``output``: "f32"
    (numpy float32 on the host, clipped per ``clip_samples``), "s16"
    (numpy int16 on the host, quantized on the device and shipped over
    config.s16_wire: "dpack", "planes" or "raw") or "device" (float32
    tensors left on the device, unclipped, as the reference leaves them;
    the caller's current stream of each device waits for them before the
    call returns). ``batched``: merge streams into chunks of at least
    ``max_batch_bytes`` of dense spectrum; a stream with more (and more
    than MIN_PIECE_BYTES) is cut into pieces (frames.plan_piece), the
    first as large as its chunk has room for, the others of at most that
    much, each a unit of the chunks, and each piece's PCM is placed into
    the stream's answer. False runs one program per stream through the
    same prepare, forward and pull. ``n_workers``: the front-end threads
    (None: config.corpus_workers); each C++ entropy decode on them takes
    the cores shared among the decodes that run at once
    (decode_threads). ``timer``: a
    utils.profiling.DecodeTimer (stages front_end, merge, prepare,
    dispatch, collect, collect_pull, collect_unpack; counters h2d_bytes
    and d2h_bytes; per-chunk marks c<k>.merge0, .dispatch0, .dispatched,
    .pull_wait, .pull0, .pull_done; and spans, each with its thread's CPU
    time: the caller's ``call`` and ``front.wait`` (key s<i>, stream i);
    a front-end worker's ``front`` (s<i>) and within it ``front.scan``,
    ``front.headers``, ``front.native`` (the C++ plan and gather, without
    the interpreter lock), ``front.plan``, ``front.entropy`` (counter
    ``native_cpu_ns``: the C++ decode's threads) and ``front.gather``
    (the Python wrapping the plan and the buckets), or ``front.python``;
    for a piece of a long stream, a worker's ``front`` and within it
    ``front.split`` (the piece's plan and its extract_batch); the
    dispatch thread's ``merge``, ``prepare``, ``h2d``, ``launch`` and
    a collector's ``wait``, ``pull``, ``unpack``
    (key c<k>, chunk k; cause the s<i> whose front end closed the chunk);
    ``stitch`` (key s<i>) where a piece's PCM goes into its stream's
    answer, on a collector or, for ``output="device"``, the caller).
    Without a timer no span is made and no thread clock read. Every
    record goes through the call's one ``profiling.CallSpans``; a timer
    lacking ``span`` or ``mark`` is wrapped there (profiling.adapt): its
    stages still flow. ``on_error``: "raise" propagates a
    malformed source's error; "none" leaves its slot None. An error of a
    dispatch or a collector propagates, after both pools have stopped."""
    devs = [resolve_device(d) for d in (devices or [device])]
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
             "chunks": 0, "h2d_bytes": 0, "d2h_bytes": 0,
             "builds": dict.fromkeys(profiling.BUILDS, 0), "front_python": 0,
             "front_native": 0, "split_streams": 0, "pieces": 0,
             "chunk_bytes_max": 0, "native_decodes": 0, "native_threads": 0,
             "stage_s": dict.fromkeys(STAGES, 0.0)}
    outs.stats = stats
    lock = threading.Lock()  # stats: the three kinds of thread update it
    pull_lock = threading.Lock()  # one pull at a time: the link is one pipe
    spans = profiling.CallSpans(timer, stats, lock)

    members: dict = {}  # stream index -> _Member, for streams in pieces
    # a stream over this is cut into pieces of at most it
    piece_bytes = max(max_batch_bytes, MIN_PIECE_BYTES)

    def piece(i, front, a, b, threads):
        """Frames [a, b) of stream i's plan as a piece, extracted on
        ``threads`` (a front-end worker)."""
        setup, channels, plan, pending = front
        with spans("front.split", f"s{i}"):
            part = plan_piece(plan, a, b)
            return setup, channels, part, extract_batch(
                part, setup, channels, ident=pending.ident,
                n_threads=threads)

    def drop(i, state):
        """Take split stream i off its pieces; True the first time."""
        with lock:
            m = members[i]
            if m.state != "ok":
                return False
            m.state = state
            return True

    def unit_scalar(u):
        if isinstance(u, int):
            fronts.scalar(u)
        elif drop(u[0], "scalar"):
            fronts.scalar(u[0])

    def stitch(u, pcm):
        """Place piece u's PCM into its stream's answer."""
        i, k = u
        m = members[i]
        with spans("stitch", f"s{i}"):
            at = m.at[k]
            m.out[:, at : at + pcm.shape[1]] = pcm

    n_dispatched = 0  # the dispatch thread's alone

    def dispatch(idx, cause):
        """Merge one chunk's units and send it to its device (the dispatch
        thread) -> (units, PCM lengths, its Trip, its collector's future;
        None for output="device"), or None where it went scalar."""
        nonlocal n_dispatched
        cid = n_dispatched
        n_dispatched += 1  # a chunk that goes scalar keeps its cid too
        ck = f"c{cid}"
        spans.mark(f"{ck}.merge0")
        chunk = [fronts_by_idx[i] for i in idx]
        synth = synthesizer_of(chunk)
        if batched:
            with spans("merge", ck, cause):
                plan, buckets, lengths = merge_streams(
                    [f[2:4] for f in chunk])
        else:
            plan, buckets = chunk[0][2:4]
            lengths = [plan.pcm_length]
        del chunk
        for i in idx:
            # the merged copies exist now: corpus memory stays bounded by
            # the chunk size
            del fronts_by_idx[i]
        if plan.n_frames == 0:
            # no decodable audio frame in the chunk: the scalar anchor is
            # authoritative for degenerate streams
            for u in idx:
                unit_scalar(u)
            return None
        try:
            trip = launch(synth, plan, buckets, fmt, devs[cid % len(devs)],
                          spans, ck, cause)
        except BatchUnsupported:
            for u in idx:
                unit_scalar(u)
            return None
        spans.count("h2d_bytes", trip.h2d)
        with lock:
            stats["chunks"] += 1
            stats["batched"] += sum(isinstance(u, int) for u in idx)
            stats["h2d_bytes"] += trip.h2d
        fut = (None if output == "device"
               else collect_pool.submit(finish, idx, lengths, trip))
        return idx, lengths, trip, fut

    def finish(idx, lengths, trip):
        """Wait for a chunk, pull and unpack it, and place its pieces (a
        collector)."""
        pcm, moved = land(trip, clip_samples, spans, pull_lock)
        spans.count("d2h_bytes", moved)
        c = 0
        for u, ln in zip(idx, lengths):
            if isinstance(u, tuple):
                stitch(u, pcm[:, c : c + ln])
            c += ln
        return pcm

    fronts_by_idx: dict = {}
    acc: dict = {}  # channels -> [units, dense spectrum bytes]
    dispatch_futs: list = []

    def close(channels, cause):
        """Dispatch the open chunk of ``channels`` (the main thread)."""
        units, nbytes = acc[channels]
        acc[channels] = [[], 0]
        with lock:
            stats["chunk_bytes_max"] = max(stats["chunk_bytes_max"], nbytes)
        dispatch_futs.append(dispatch_pool.submit(dispatch, units, cause))

    def take(unit, front):
        """Add a unit to its channel count's open chunk; True where the
        chunk is full."""
        group = acc.setdefault(front[1], [[], 0])
        group[0].append(unit)
        group[1] += sum(b.batch_cost for b in front[3])
        return not batched or group[1] >= max_batch_bytes

    def split(i, front):
        """Stream i in pieces (the main thread): the first as large as its
        chunk has room for, each closing its chunk but the last; the
        front-end workers cut and extract them, taken here in order."""
        setup, channels, plan, _ = front
        cost = dense_cost(plan, channels)
        group = acc.get(channels)
        if group and group[0] and piece_bytes - group[1] < cost[:2].sum():
            close(channels, f"s{i}")  # no room for a piece of two frames
        room = piece_bytes - acc.get(channels, [[], 0])[1]
        bounds = split_bounds(plan, cost, room, piece_bytes)
        shape = (channels, plan.pcm_length)
        if output == "device":
            out = torch.empty(shape, dtype=torch.float32, device=devs[0])
        else:
            # pinned where the chunks come from a card: PyTorch's host
            # allocator keeps such blocks for the next call, as it keeps
            # the pulls', where fresh pages would fault in on first write
            out = torch.empty(shape, dtype=torch.int16 if output == "s16"
                              else torch.float32,
                              pin_memory=devs[0].type == "cuda").numpy()
        m = members[i] = _Member(out, [])
        spans.tally("split_streams")
        spans.tally("pieces", len(bounds))
        # the pieces decode in the stream's place, among the call's others
        threads = decode_threads(n_workers, len(sources) + len(bounds) - 1)
        pieces = [fronts.submit(i, piece, i, front, a, b, threads)
                  for a, b in bounds]
        at = 0
        for k, fut in enumerate(pieces):
            with spans("front.wait", f"s{i}"):
                part = fut.result()
            if m.state != "ok":
                continue  # off its pieces: the rest are read and dropped
            if part is _FAILED:
                if drop(i, "failed"):
                    spans.tally("failed")
                continue
            if part is None:
                if drop(i, "scalar"):
                    fronts.scalar(i)
                continue
            m.at.append(at)
            at += part[2].pcm_length
            fronts_by_idx[(i, k)] = part
            if take((i, k), part) or k < len(pieces) - 1:
                close(channels, f"s{i}")

    with spans("call"):
        fronts = FrontEnds(sources, outs, spans, output=output,
                           clip=clip_samples, on_error=on_error,
                           n_workers=n_workers,
                           split_bytes=piece_bytes if batched else None)
        # merge/prepare/dispatch run on ONE thread, in submission order
        # (chunk composition stays deterministic) while the main thread
        # goes on taking front ends; collectors pull and unpack behind
        # later chunks. The call's table builds on the dispatch thread
        # count to it (profiling.bind)
        dispatch_pool = cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="vp-dispatch",
            initializer=profiling.bind, initargs=(spans,))
        collect_pool = cf.ThreadPoolExecutor(max_workers=3,
                                             thread_name_prefix="vp-collect")
        try:
            with spans.stage("front_end"):
                # in SUBMISSION order, so chunk composition is
                # deterministic
                for i, front in fronts:
                    if isinstance(front[3], Unextracted):
                        split(i, front)
                        continue
                    fronts_by_idx[i] = front
                    if take(i, front):
                        close(front[1], f"s{i}")
            for channels, (units, _nbytes) in list(acc.items()):
                if units:  # closed by the end of the input: its last unit
                    last = units[-1]
                    close(channels, f"s{last if isinstance(last, int) else last[0]}")
            with spans.stage("collect"):
                # ordered drain; propagates dispatch and collector errors
                done = [r for r in (f.result() for f in dispatch_futs) if r]
                for idx, lengths, trip, fut in done:
                    pcm = hand_over(trip) if fut is None else fut.result()
                    c = 0
                    for u, ln in zip(idx, lengths):
                        if isinstance(u, int):
                            outs[u] = pcm[:, c : c + ln]
                        elif fut is None:  # a collector stitched the others
                            stitch(u, pcm[:, c : c + ln])
                        c += ln
                for i, m in members.items():
                    if m.state == "ok":
                        outs[i] = m.out
                        spans.tally("batched")
        finally:
            # an error must not leave in-flight front ends, dispatches or
            # pulls running after decode_corpus returns
            for pool in (fronts.pool, dispatch_pool, collect_pool):
                pool.shutdown(wait=True, cancel_futures=True)
        fronts.place(devs[0])
    return outs
