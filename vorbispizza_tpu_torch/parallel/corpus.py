"""Stream-data-parallel corpus decode: the production pipeline a shard a
device.

Port of vorbispizza_tpu/parallel/corpus.py. Streams are grouped by
channel count, balanced over the devices of a 1-D ``stream`` mesh by
frame count (``partition_indices``), and each device decodes its own
merged sub-chunk: the full pipeline of models/pipeline.py (symbol or
value residues, mixed blocksizes, granule trims, event OLA, the dpack PCM
wire). Streams are independent, so no halo is needed at stream seams.

The reference runs ONE SPMD program over the mesh, whose precondition is
a single signature across shards; the port keeps that contract and its
unification: every shard sees the same bucket list (empty clones fill the
holes, ``_empty_bucket``), shards are prepared with the quantized pads
and, if their sigs differ, prepared again under the elementwise MAXIMUM
pads (pipeline.sig_pads/merge_pads). Padded rows are zero frames, padded
symbols end-of-stream sentinels, padded events scatter out of range: all
no-ops by construction. If the sigs still disagree, ShardMismatch sends
the group to the reference's per-device dispatch, which the port counts
(``stats["mismatch_fallbacks"]``).

There is no SPMD program in the port. Each shard's nine host buffers go
to its own mesh device (``pipeline.upload``), and
``BatchSynthesizer.forward`` runs there on the device's dispatch stream
(models/corpus.py ``_streams``/``_on``), with a completion event a shard.
A mesh may repeat a device; its shards then run one after another on the
device's one stream. A shard with no streams is not launched. The
reference's ``psum`` of each shard's packed wire size is the sum of the
shards' header nbytes (``stats["wire_bytes"]``).

Departure from the reference: like the port's ``decode_corpus``, the
dpack wire is always the full-capacity "s16df" (at most 288 B per
128-sample block plus the unary section), so a shard never overflows its
wire and the reference's PackOverflow re-run of the group is not needed:
a wire that fails its checks raises.
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np
import torch

from ..config import VorbisConfig
from ..decoder import CLIP_MAX
from ..errors import VorbisError
from ..frames import BatchUnsupported, BucketBatch, FloorGroup, SymBucket
from ..models.corpus import (
    STAGES,
    CorpusOutputs,
    _front_end,
    _on,
    _scalar_fallback,
    _streams,
    _synthesizer_for,
    _to_host,
    decode_threads,
    join_pool,
    merge_streams,
    pull_dpack,
)
from ..models.pipeline import DPACK, merge_pads, upload
from ..ops.pcm_pack import unpack_pcm
from ..utils.profiling import CallSpans, DecodeTimer, adapt, bind

__all__ = [
    "ShardMismatch",
    "partition_indices",
    "sharded_chunk_run",
    "unpack_shard",
    "decode_corpus_sharded",
]


class ShardMismatch(Exception):
    """Shard program signatures could not be unified (callers fall back to
    per-device dispatch)."""


def _key_order(k):
    return (k.sid, k.mode_idx, bool(k.prev_flag), bool(k.next_flag))


def _empty_bucket(ref: BucketBatch) -> BucketBatch:
    """A zero-frame clone of ``ref`` (same key/floor/transport structure):
    shards missing a bucket key present elsewhere get one of these so every
    shard's bucket list — and therefore its program signature — lines up."""
    groups = []
    for g in ref.floor_groups:
        ng = FloorGroup(floor=g.floor, channels=list(g.channels))
        nc = len(g.channels)
        ng.used = np.zeros((0, nc), dtype=bool)
        if g.floor.floor_type == 1:
            ng.posts = np.zeros((0, nc, g.posts.shape[2]), g.posts.dtype)
            ng.step2 = np.zeros((0, nc, g.step2.shape[2]), g.step2.dtype)
            if g.ys is not None:
                # the clone must preserve ys availability or this shard
                # falls back to the posts wire while the others pick the
                # coded-ys wire -> ShardMismatch (fuzz seed 9003)
                ng.ys = np.zeros((0, nc, g.ys.shape[2]), g.ys.dtype)
        else:
            ng.coefficients = np.zeros(
                (0, nc, g.coefficients.shape[2]), g.coefficients.dtype
            )
            ng.amplitude = np.zeros((0, nc), g.amplitude.dtype)
        groups.append(ng)
    sym = None
    residues = None
    if ref.sym is not None:
        sym = SymBucket(
            layout=ref.sym.layout,
            groups=ref.sym.groups,
            syms=[np.zeros(0, s.dtype) for s in ref.sym.syms],
            slots=[np.zeros(0, s.dtype) for s in ref.sym.slots],
            part_counts=np.zeros(
                (0, ref.sym.part_counts.shape[1]), ref.sym.part_counts.dtype
            ),
        )
    elif ref.residues is not None:
        residues = np.zeros((0,) + ref.residues.shape[1:], ref.residues.dtype)
    return BucketBatch(
        key=ref.key,
        n=ref.n,
        frame_indices=np.zeros(0, ref.frame_indices.dtype),
        offsets=np.zeros(0, ref.offsets.dtype),
        prime=np.zeros(0, dtype=bool),
        final=np.zeros(0, dtype=bool),
        residues=residues,
        floor_groups=groups,
        sym=sym,
    )


def _empty_plan():
    from ..frames import FramePlan, FrameSoA

    z = np.zeros(0, dtype=np.int64)
    zb = np.zeros(0, dtype=bool)
    return FramePlan(
        frames=[],
        total_len=1,
        chains=[],
        chain_segments=[],
        buckets={},
        soa_cache=FrameSoA(z, z, z, z, z, zb, zb),
    )


def partition_indices(costs, n_shards: int):
    """Greedy longest-processing-time balance of stream indices into
    ``n_shards`` groups (indices stay sorted within a group so chunk
    composition is deterministic)."""
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for i in np.argsort(np.asarray(costs, dtype=np.int64))[::-1]:
        k = int(np.argmin(loads))
        shards[k].append(int(i))
        loads[k] += int(costs[i])
    return [sorted(s) for s in shards]


def _unify_buckets(merged):
    """Same sorted bucket list on every shard (empty clones for holes)."""
    ref_by_key = {}
    for _, bks, _ in merged:
        for b in bks:
            ref_by_key.setdefault(b.key, b)
    keys = sorted(ref_by_key, key=_key_order)
    blists = []
    for _, bks, _ in merged:
        by_key = {b.key: b for b in bks}
        blists.append(
            [by_key.get(k) or _empty_bucket(ref_by_key[k]) for k in keys]
        )
    return blists


def _mesh_devices(mesh) -> list:
    if len(mesh.axis_names) != 1:
        raise ShardMismatch("sharded_chunk_run needs a 1-D mesh")
    return list(mesh.devices.reshape(-1))


def sharded_chunk_run(synth, shard_items, mesh, output: str = "s16df",
                      stats: dict | None = None, timer=None):
    """Launch one decode of ``shard_items`` (one list of (plan, buckets)
    per mesh device; empty lists allowed) on a 1-D mesh, every shard under
    one unified sig.

    Returns (sig, outs, totals, lens_per_shard, events): ``outs[k]`` is
    shard k's device output (None for a shard with no streams, which is
    not launched) and ``events[k]`` its completion event on the device's
    dispatch stream (None on the CPU); unpack each with unpack_shard once
    its event has passed. Spans on ``timer`` (a DecodeTimer when None):
    ``merge``, and for shard k (key shard<k>) ``prepare``, ``h2d`` and
    ``launch``. ``stats`` (decode_corpus_sharded's) gets the spans' walls
    in its stages, and each shard's ``prepare`` walls summed in
    "shard_prepare_s"."""
    devs = _mesh_devices(mesh)
    if len(shard_items) != len(devs):
        raise ShardMismatch(
            f"{len(shard_items)} shards for a {len(devs)}-device mesh"
        )
    spans = CallSpans(DecodeTimer() if timer is None else timer, stats)
    with spans("merge"):
        merged = [
            merge_streams(items) if items else (_empty_plan(), [], [])
            for items in shard_items
        ]
        blists = _unify_buckets(merged)
    secs = [0.0] * len(devs)

    def prepare(pads):
        preps = []
        for k, ((plan, _, _), bl, dev) in enumerate(zip(merged, blists,
                                                        devs)):
            with spans("prepare", f"shard{k}") as sp:
                preps.append(synth.prepare_host(plan, bl, output, pads=pads,
                                                device=dev))
            secs[k] += sp.wall_s
        return preps

    preps = prepare({})
    sigs = [p[0] for p in preps]
    if len(set(sigs)) > 1:
        preps = prepare(merge_pads(sigs))
        sigs = [p[0] for p in preps]
    if stats is not None:
        stats["shard_prepare_s"] += secs
    if len(set(sigs)) > 1:
        raise ShardMismatch("shard sigs did not unify under max pads")
    sig = sigs[0]
    outs, events = [], []
    for k, (items, (_, host, _), dev) in enumerate(zip(shard_items, preps,
                                                       devs)):
        out = event = None
        if items:
            stream, _ = _streams(dev)
            with _on(dev, stream):
                with spans("h2d", f"shard{k}"):
                    bufs = upload(host, dev)[0]
                with spans("launch", f"shard{k}"):
                    out = synth(sig, bufs)
                if stream is not None:
                    event = torch.cuda.Event(blocking=True)
                    event.record(stream)
        outs.append(out)
        events.append(event)
    totals = [p[2] for p in preps]
    lens = [m[2] for m in merged]
    return sig, outs, totals, lens, events


def unpack_shard(row: torch.Tensor, sig, channels: int, total: int,
                 stats: dict | None = None, timer=None) -> np.ndarray:
    """One shard's device output -> host PCM [C, total] (int16 for dpack,
    else the row's dtype), pulled on the current stream. ``stats`` gets
    the bytes copied ("d2h_bytes"), for dpack the wire's payload bytes
    ("wire_bytes"), and the walls of the spans ``pull`` and ``unpack``
    (on ``timer``, where one is given)."""
    spans = CallSpans(timer, stats)
    if sig[5] in DPACK:
        with spans("pull"):
            payload, widx, ch_ubit, moved = pull_dpack(row, channels, sig[3])
        with spans("unpack"):
            pcm = unpack_pcm(payload, widx, channels, sig[3],
                             ch_ubit)[:, :total]
        wire = payload.nbytes
    else:
        with spans("pull"):
            pcm = _to_host(row[..., :total].contiguous())
        moved, wire = pcm.nbytes, 0
    if stats is not None:
        stats["d2h_bytes"] += moved
        stats["wire_bytes"] += wire
    return pcm


def _land(out, event, dev, sig, channels, total, output, stats, timer):
    """A launched output -> what ``output`` asks for: a [C, total] device
    view the caller's current stream waits for ("device"), or host PCM
    pulled on the device's pull stream after the event (f32 clipped, as
    the scalar fallback's)."""
    if output == "device":
        if event is not None:
            caller = torch.cuda.current_stream(dev)
            caller.wait_event(event)
            out.record_stream(caller)
        return out[..., :total]
    if event is not None:
        with CallSpans(timer, stats)("wait"):
            event.synchronize()
    with _on(dev, _streams(dev)[1]):
        pcm = unpack_shard(out, sig, channels, total, stats, timer)
    if pcm.dtype == np.float32:
        np.clip(pcm, -CLIP_MAX, CLIP_MAX, out=pcm)
    return pcm


def decode_corpus_sharded(sources, mesh, *, output: str = "s16",
                          on_error: str = "raise",
                          timer=None) -> CorpusOutputs:
    """Decode a corpus with stream-level data parallelism over ``mesh``
    (1-D, parallel.mesh.Mesh). Groups streams by channel count (setups may
    differ — bucket keys carry setup identity), partitions each group over
    the mesh devices (balanced by frame count), and runs one program a
    shard under one sig. Falls back per stream to the scalar decoder for
    shapes the batch planner rejects, and per group to per-device
    dispatch on the first mesh device on ShardMismatch. Returns PCM in
    input order, with ``stats``: streams, groups, shards (launched),
    batched, scalar (streams routed to the scalar decoder), failed,
    mismatch_fallbacks (groups dispatched per device), d2h_bytes,
    wire_bytes (the dpack payload bytes of every shard), native_decodes
    and native_threads (the front ends' C++ entropy decodes and the
    threads they were given, summed: each takes the cores shared among
    the workers, models/corpus.decode_threads), ``stage_s`` (host
    wall seconds of models/corpus.py's STAGES, one after another here, the
    walls of the spans of utils/profiling.SPAN_STAGES) and
    ``shard_prepare_s`` (each launched group's prepare_host seconds a
    shard, from its ``prepare`` spans keyed shard<k>). ``timer``: a
    DecodeTimer to keep the spans (sharded_chunk_run's, the front-end
    wait ``front.wait``, and ``wait``, ``pull``, ``unpack``); without one
    they go to a timer of the call's own.

    ``output``:
      "s16"    — host int16 [C, samples] (dpack wire, device quantize)
      "f32"    — host float32 [C, samples], clipped
      "device" — per-stream float32 views of each shard's output on the
                 device that decoded it, unclipped, as decode_corpus's
                 "device" tier; each device's current stream waits for
                 them before the call returns.

    ``on_error``: "raise" (default) propagates a malformed source's
    VorbisError; "none" leaves the failed file's slot as None and decodes
    the rest (same contract as decode_corpus).

    Degradation note: a stream the batch planner rejects falls back to the
    float64 scalar decoder, whose s16 quantization can differ from the
    device-f32 batch path by ±1 LSB."""
    if output not in ("f32", "s16", "device"):
        raise ValueError(f"output {output!r}: not 'f32', 's16' or 'device'")
    if on_error not in ("raise", "none"):
        raise ValueError(f"on_error must be 'raise' or 'none', got {on_error!r}")
    dev0 = mesh.devices.reshape(-1)[0]
    fmt = "s16df" if output == "s16" else "f32"
    timer = DecodeTimer() if timer is None else adapt(timer)
    outs = CorpusOutputs([None] * len(sources))
    stats = {"streams": len(sources), "groups": 0, "shards": 0, "batched": 0,
             "scalar": 0, "failed": 0, "mismatch_fallbacks": 0,
             "d2h_bytes": 0, "wire_bytes": 0, "native_decodes": 0,
             "native_threads": 0, "stage_s": dict.fromkeys(STAGES, 0.0),
             "shard_prepare_s": []}
    outs.stats = stats

    def scalar_or_failed(i):
        stats["scalar"] += 1
        try:
            return _scalar_fallback(sources[i], output, True, dev0)
        except VorbisError:
            if on_error == "raise":
                raise
            stats["failed"] += 1
            return None

    def front_end(src):
        try:
            return _front_end(src)
        except BatchUnsupported:
            return None
        except VorbisError as e:
            if on_error == "raise":
                raise
            return e

    n_workers = VorbisConfig.default.corpus_workers
    threads = decode_threads(n_workers, len(sources))
    spans = CallSpans(timer, stats)

    def worker():
        join_pool(None, threads)
        bind(spans)  # the front-end stages and the decodes' counts

    fronts: dict = {}
    groups: dict = {}
    with cf.ThreadPoolExecutor(n_workers, thread_name_prefix="vp-front",
                               initializer=worker) as pool, \
            spans("front.wait"):
        for i, front in enumerate(pool.map(front_end, sources)):
            if isinstance(front, VorbisError):
                stats["failed"] += 1  # slot stays None
                continue
            if front is None:
                outs[i] = scalar_or_failed(i)
                continue
            fronts[i] = front
            # group by channel count only — bucket keys carry setup
            # identity (BucketKey.sid)
            groups.setdefault(front[1], []).append(i)

    n_shards = mesh.size
    for channels, idxs in groups.items():
        synth = _synthesizer_for(fronts[idxs[0]][0], channels)
        for i in idxs[1:]:
            synth.add_setup(fronts[i][0])
        costs = [fronts[i][2].n_frames for i in idxs]
        if sum(costs) == 0:
            # no decodable audio frames anywhere in this group (e.g.
            # headers-only streams): the scalar anchor is authoritative
            for i in idxs:
                outs[i] = scalar_or_failed(i)
            continue
        stats["groups"] += 1
        parts = partition_indices(costs, n_shards)
        shard_items = [[fronts[idxs[j]][2:4] for j in part] for part in parts]
        try:
            sig, souts, totals, lens, events = sharded_chunk_run(
                synth, shard_items, mesh, fmt, stats, timer)
        except (ShardMismatch, BatchUnsupported):
            stats["mismatch_fallbacks"] += 1
            for i in sorted(idxs[j] for part in parts for j in part):
                outs[i] = _per_device(synth, fronts[i][2:4], dev0, fmt,
                                      output, stats, timer, lambda i=i:
                                      scalar_or_failed(i))
            continue
        stats["batched"] += len(idxs)
        for k, part in enumerate(parts):
            if not part:
                continue
            stats["shards"] += 1
            dev = mesh.devices.reshape(-1)[k]
            pcm = _land(souts[k], events[k], dev, sig, channels, totals[k],
                        output, stats, timer)
            souts[k] = None
            c = 0
            for j, ln in zip(part, lens[k]):
                outs[idxs[j]] = pcm[:, c : c + ln]
                c += ln
    return outs


def _per_device(synth, item, dev, fmt, output, stats, timer, scalar):
    """One stream through prepare_host and forward on ``dev`` (the
    reference's per-device dispatch after a ShardMismatch); the scalar
    decoder where the batch planner rejects it or it has no audio frame."""
    plan, buckets = item
    if plan.n_frames == 0:
        return scalar()
    stream, _ = _streams(dev)
    try:
        with _on(dev, stream):
            sig, host, total = synth.prepare_host(plan, buckets, fmt,
                                                  device=dev)
            out = synth(sig, upload(host, dev)[0])
            event = None
            if stream is not None:
                event = torch.cuda.Event(blocking=True)
                event.record(stream)
    except BatchUnsupported:
        return scalar()
    stats["batched"] += 1
    return _land(out, event, dev, sig, synth.channels, total, output, stats,
                 timer)
