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

There is no SPMD program in the port. Each shard takes the round trip of
models/launch.py, as decode_corpus's chunks do: its nine host buffers go
to its own mesh device, ``BatchSynthesizer.forward`` runs there on the
device's dispatch stream with a completion event a shard, and its output
comes back on the device's pull stream. A mesh may repeat a device; its
shards then run one after another on the device's one stream. A shard
with no streams is not launched. The reference's ``psum`` of each
shard's packed wire size is the sum of the shards' header nbytes
(``stats["wire_bytes"]``).

Departure from the reference: like the port's ``decode_corpus``, the
dpack wire is always the full-capacity "s16df" (at most 288 B per
128-sample block plus the unary section), so a shard never overflows its
wire and the reference's PackOverflow re-run of the group is not needed:
a wire that fails its checks raises.
"""

from __future__ import annotations

import numpy as np

from ..config import VorbisConfig
from ..frames import BatchUnsupported, BucketBatch, FloorGroup, SymBucket
from ..models.corpus import (
    STAGES,
    CorpusOutputs,
    FrontEnds,
    merge_streams,
    synthesizer_of,
)
from ..models.launch import Trip, hand_over, land, lanes, launch, prepare, send
from ..models.pipeline import merge_pads
from ..utils.profiling import CallSpans

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
    its event has passed. Spans on ``timer``, where one is given:
    ``merge``, and for shard k (key shard<k>) ``prepare``, ``h2d`` and
    ``launch``. ``stats`` (decode_corpus_sharded's) gets the spans' walls
    in its stages, and each shard's ``prepare`` walls summed in
    "shard_prepare_s"."""
    devs = _mesh_devices(mesh)
    if len(shard_items) != len(devs):
        raise ShardMismatch(
            f"{len(shard_items)} shards for a {len(devs)}-device mesh"
        )
    spans = CallSpans(timer, stats)
    with spans("merge"):
        merged = [
            merge_streams(items) if items else (_empty_plan(), [], [])
            for items in shard_items
        ]
        blists = _unify_buckets(merged)
    secs = [0.0] * len(devs)

    def prepare_all(pads):
        trips = []
        for k, ((plan, _, _), bl, dev) in enumerate(zip(merged, blists,
                                                        devs)):
            trips.append(prepare(synth, plan, bl, output, dev, spans,
                                 f"shard{k}", pads=pads))
            secs[k] += trips[-1].prepare_s or 0.0
        return trips

    trips = prepare_all({})
    sigs = [t.sig for t in trips]
    if len(set(sigs)) > 1:
        trips = prepare_all(merge_pads(sigs))
        sigs = [t.sig for t in trips]
    if stats is not None:
        stats["shard_prepare_s"] += secs
    if len(set(sigs)) > 1:
        raise ShardMismatch("shard sigs did not unify under max pads")
    for items, trip in zip(shard_items, trips):
        if items:
            send(synth, trip, spans)
    return (sigs[0], [t.out for t in trips], [t.total for t in trips],
            [m[2] for m in merged], [t.event for t in trips])


def unpack_shard(row, sig, channels: int, total: int,
                 stats: dict | None = None, timer=None) -> np.ndarray:
    """One shard's device output -> host PCM [C, total] (int16 for dpack,
    else the row's dtype), pulled on the current stream. ``stats`` gets
    the bytes copied ("d2h_bytes"), for dpack the wire's payload bytes
    ("wire_bytes"), each where it has the key, and the walls of the spans
    ``pull`` and ``unpack`` (on ``timer``, where one is given)."""
    trip = Trip(None, None, row.device, channels, sig, total, out=row)
    return land(trip, False, CallSpans(timer, stats))[0]


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
    walls of the spans of utils/profiling.SPAN_STAGES: ``front_end`` sums
    the streams' ``front.wait`` spans, as in decode_corpus, and leaves out
    the scalar decodes; the per-device fallback adds its unkeyed
    ``prepare``, ``h2d`` and ``launch`` walls) and
    ``shard_prepare_s`` (each launched group's prepare_host seconds a
    shard, the walls of its ``prepare`` spans keyed shard<k>). A long
    stream is decoded whole. ``timer``: a DecodeTimer to keep the spans
    (decode_corpus's front-end spans, sharded_chunk_run's, and ``wait``,
    ``pull``, ``unpack``).

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
    devs = list(mesh.devices.reshape(-1))
    fmt = "s16df" if output == "s16" else "f32"
    outs = CorpusOutputs([None] * len(sources))
    stats = {"streams": len(sources), "groups": 0, "shards": 0, "batched": 0,
             "scalar": 0, "failed": 0, "mismatch_fallbacks": 0,
             "d2h_bytes": 0, "wire_bytes": 0, "native_decodes": 0,
             "native_threads": 0, "stage_s": dict.fromkeys(STAGES, 0.0),
             "shard_prepare_s": []}
    outs.stats = stats
    spans = CallSpans(timer, stats)

    def landed(trip):
        if output == "device":
            return hand_over(trip)
        return land(trip, True, spans)[0]

    fronts = FrontEnds(sources, outs, spans, output=output, clip=True,
                       on_error=on_error,
                       n_workers=VorbisConfig.default.corpus_workers)
    by_idx: dict = {}
    groups: dict = {}
    try:
        for i, front in fronts:
            by_idx[i] = front
            # group by channel count only — bucket keys carry setup
            # identity (BucketKey.sid)
            groups.setdefault(front[1], []).append(i)
    finally:
        fronts.pool.shutdown(wait=True, cancel_futures=True)

    n_shards = mesh.size
    for channels, idxs in groups.items():
        synth = synthesizer_of([by_idx[i] for i in idxs])
        costs = [by_idx[i][2].n_frames for i in idxs]
        if sum(costs) == 0:
            # no decodable audio frames anywhere in this group (e.g.
            # headers-only streams): the scalar anchor is authoritative
            for i in idxs:
                fronts.scalar(i)
            continue
        stats["groups"] += 1
        parts = partition_indices(costs, n_shards)
        shard_items = [[by_idx[idxs[j]][2:4] for j in part] for part in parts]
        try:
            sig, souts, totals, lens, events = sharded_chunk_run(
                synth, shard_items, mesh, fmt, stats, timer)
        except (ShardMismatch, BatchUnsupported):
            # the reference's per-device dispatch: a stream at a time on
            # the first mesh device
            stats["mismatch_fallbacks"] += 1
            for i in sorted(idxs[j] for part in parts for j in part):
                plan, buckets = by_idx[i][2:4]
                try:
                    trip = (launch(synth, plan, buckets, fmt, devs[0], spans)
                            if plan.n_frames else None)
                except BatchUnsupported:
                    trip = None
                if trip is None:  # the scalar anchor, as for a group
                    fronts.scalar(i)
                    continue
                stats["batched"] += 1
                outs[i] = landed(trip)
            continue
        stats["batched"] += len(idxs)
        for k, part in enumerate(parts):
            if not part:
                continue
            stats["shards"] += 1
            pcm = landed(Trip(f"shard{k}", None, devs[k], channels, sig,
                              totals[k], out=souts[k], event=events[k],
                              pull=lanes(devs[k])[1]))
            souts[k] = None
            c = 0
            for j, ln in zip(part, lens[k]):
                outs[idxs[j]] = pcm[:, c : c + ln]
                c += ln
    fronts.place(devs[0])
    return outs
