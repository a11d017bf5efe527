"""Frame-batch compiler: turn a logical Vorbis stream into dense, bucketed
tensors for the batch synthesis pipeline (models/pipeline.py).

This is the "irregular -> dense" pass of the TPU-first design (SURVEY.md §7):

  pass 1 (plan)    — walk every packet, read only the mode header bits
                     (the same trick the reference uses to measure packets,
                     NVorbis/StreamDecoder.cs:882 GetPacketGranuleCount),
                     compute window geometry, global output offsets, chain
                     segmentation at resyncs, and granule-anchored trims.
  pass 2 (extract) — entropy-decode every audio packet (floor posts +
                     pre-coupling residue spectra) into per-bucket arrays.

Buckets are keyed by (mode index, prev flag, next flag): within a bucket the
blocksize, window vector, floor/residue configs and coupling steps are all
static, so each bucket runs as one set of kernel launches.

Overlap-add becomes position arithmetic: frame f's windowed samples land at
offset[f] = offset[f-1] + right_end[f-1] - left_end[f] and neighbors sum
where they overlap (ops/ola.py). Priming frames (chain starts) contribute
nothing left of their center; chain-final frames nothing right of it —
exactly the reference's lapping semantics (StreamDecoder.cs:764).
"""

from __future__ import annotations

import bisect
import ctypes
import itertools
import threading
from dataclasses import dataclass, field, replace

import numpy as np

from .bitstream import BitReader
from .errors import InvalidDataError
from .ogg.logical import Packet, PacketProvider
from .setup.mode import WindowInfo
from .utils import profiling


class BatchUnsupported(Exception):
    """Stream shape the batch planner does not model (e.g. a granule cut
    reaching back past an earlier cut). Callers fall back to the scalar
    streaming decoder."""


@dataclass(frozen=True)
class BucketKey:
    mode_idx: int
    prev_flag: bool
    next_flag: bool
    #: originating-setup id (setup_sid): lets buckets from DIFFERENT
    #: setups coexist in one merged plan / fused program (cross-setup
    #: chunk merging, models/corpus.py). 0 only before extract stamps it.
    sid: int = 0


_sid_counter = [0]
_sid_lock = threading.Lock()


def setup_sid(setup) -> int:
    """Small process-stable id for a parsed setup object. Byte-identical
    setup headers share one object (header.parse_setup_cached), so the id
    is stable for as long as any bucket/synthesizer holds the setup.

    Locked: corpus front ends run on a thread pool and may race the first
    stamp of a shared setup object — an unlocked double-increment would
    either register the setup under a sid no bucket carries (KeyError at
    dispatch) or let two setups collide on one sid (wrong-codebook PCM)."""
    sid = getattr(setup, "_vp_sid", None)
    if sid is None:
        with _sid_lock:
            sid = getattr(setup, "_vp_sid", None)
            if sid is None:
                _sid_counter[0] += 1
                sid = _sid_counter[0]
                setup._vp_sid = sid
    return sid


@dataclass(slots=True)
class FrameEntry:
    packet: Packet | None
    mode_idx: int
    info: WindowInfo
    offset: int = 0  # global index of frame sample 0 in the accumulator
    prime: bool = False  # chain start: left half contributes nothing
    final: bool = False  # chain end: right half contributes nothing
    granule: int = -1  # end-page granule anchor (packet.granule when present)


@dataclass
class FrameSoA:
    """Struct-of-arrays view of a plan's frames: everything the device
    pipeline needs per frame, as numpy arrays (no per-frame Python on the
    prepare path — merged corpus plans carry ONLY this, no FrameEntry
    objects)."""

    n: np.ndarray  # [F] blocksize
    left_start: np.ndarray
    left_end: np.ndarray
    right_end: np.ndarray
    offset: np.ndarray  # [F] global index of frame sample 0
    prime: np.ndarray  # [F] bool
    final: np.ndarray  # [F] bool

    @staticmethod
    def from_frames(frames: list["FrameEntry"]) -> "FrameSoA":
        F = len(frames)
        n = np.empty(F, dtype=np.int64)
        ls = np.empty(F, dtype=np.int64)
        le = np.empty(F, dtype=np.int64)
        re = np.empty(F, dtype=np.int64)
        off = np.empty(F, dtype=np.int64)
        pr = np.empty(F, dtype=bool)
        fi = np.empty(F, dtype=bool)
        for i, fr in enumerate(frames):
            n[i] = fr.info.n
            ls[i] = fr.info.left_start
            le[i] = fr.info.left_end
            re[i] = fr.info.right_end
            off[i] = fr.offset
            pr[i] = fr.prime
            fi[i] = fr.final
        return FrameSoA(n, ls, le, re, off, pr, fi)


@dataclass
class FramePlan:
    frames: list[FrameEntry]
    total_len: int  # global coordinate span (last chain's end)
    chains: list[list[int]]  # frame indices per resync-free run
    chain_segments: list[list[tuple[int, int]]]  # kept ranges per chain
    buckets: dict[BucketKey, list[int]]  # bucket -> frame indices
    # native-scan transport: (blob u8[.], starts i64[F], ends i64[F]) — each
    # frame's packet bytes addressed straight into the Ogg scan's blob, so
    # extraction hands the C++ decoder zero-copy spans (no Packet objects)
    scan: tuple | None = None
    # preset struct-of-arrays (merged plans and C++ plans, which hold no
    # FrameEntry objects); lazily built from ``frames`` otherwise
    soa_cache: FrameSoA | None = None
    # exact per-frame audio bits consumed (set by the native extract path;
    # None when only the Python path ran). Feeds StreamStats with the
    # reference's exact definition (StreamStats.cs:94-122) instead of the
    # whole-packet-bytes approximation.
    audio_bits: np.ndarray | None = None

    def soa(self) -> FrameSoA:
        if self.soa_cache is None:
            self.soa_cache = FrameSoA.from_frames(self.frames)
        return self.soa_cache

    @property
    def n_frames(self) -> int:
        s = self.soa_cache
        return len(s.n) if s is not None else len(self.frames)

    @property
    def segments(self) -> list[tuple[int, int]]:
        return [seg for segs in self.chain_segments for seg in segs]

    @property
    def pcm_length(self) -> int:
        return sum(e - s for s, e in self.segments)


def build_plan(provider: PacketProvider, setup) -> FramePlan:
    """Pass 1: walk all packets and lay out the output."""
    frames: list[FrameEntry] = []
    chains: list[list[int]] = []  # frame indices per chain
    current: list[int] = []
    eos_seen = False
    # fast inline mode-header parse: 1 + mode_bits (+2 window-flag) bits
    # always fit in the first two bytes (mode_bits <= 6)
    mode_bits = setup.mode_bits
    n_modes = len(setup.modes)
    mode_mask = (1 << mode_bits) - 1
    block_flags = [m.block_flag for m in setup.modes]
    need_bits = [1 + mode_bits + (2 if bf else 0) for bf in block_flags]
    info_memo: dict[tuple[int, bool, bool], WindowInfo] = {}
    while not eos_seen:
        packet = provider.get_next_packet()
        if packet is None:
            break
        if packet.is_end_of_stream:
            eos_seen = True
        if packet.is_resync and current:
            chains.append(current)
            current = []
        data = packet.data
        if not data or data[0] & 1:
            continue
        v = data[0] | ((data[1] << 8) if len(data) > 1 else 0)
        mode_idx = (v >> 1) & mode_mask
        if mode_idx >= n_modes:
            # scalar-anchor parity: StreamDecoder._decode_packet raises on
            # an out-of-range mode index (decoder.py) — so must the plan
            raise InvalidDataError("mode index out of bounds")
        if need_bits[mode_idx] > 8 * len(data):
            continue  # window flags truncated: undecodable, skip (anchor parity)
        if block_flags[mode_idx]:
            prev_flag = bool((v >> (1 + mode_bits)) & 1)
            next_flag = bool((v >> (2 + mode_bits)) & 1)
        else:
            prev_flag = next_flag = False
        key = (mode_idx, prev_flag, next_flag)
        info = info_memo.get(key)
        if info is None:
            info = setup.modes[mode_idx].window_info(prev_flag, next_flag)
            info_memo[key] = info
        current.append(len(frames))
        frames.append(
            FrameEntry(
                packet=packet, mode_idx=mode_idx, info=info,
                granule=packet.granule,
            )
        )
    if current:
        chains.append(current)

    chain_segments: list[list[tuple[int, int]]] = []
    base = 0
    for chain in chains:
        segments: list[tuple[int, int]] = []
        base = _lay_out_chain(frames, chain, base, segments)
        chain_segments.append(segments)

    buckets: dict[BucketKey, list[int]] = {}
    for i, fr in enumerate(frames):
        key = BucketKey(fr.mode_idx, fr.info.prev_flag, fr.info.next_flag)
        buckets.setdefault(key, []).append(i)
    return FramePlan(
        frames=frames,
        total_len=max(base, 1),
        chains=chains,
        chain_segments=chain_segments,
        buckets=buckets,
    )


def build_plan_from_scan(
    blob: np.ndarray,
    offs: np.ndarray,
    granules: np.ndarray,
    flags: np.ndarray,
    setup,
    first_audio: int = 3,
) -> FramePlan:
    """Pass 1 straight from the native Ogg scan's raw arrays: the
    mode-header parse, decodability filter and chain split vectorized in
    numpy, each chain laid out by the exact per-frame loop. Semantics
    identical to build_plan over a provider (differentially tested). The
    front end runs it for the streams whose anchoring (start trims,
    granule gaps or regressions) the C++ plan, build_plan_native,
    declines.

    Reference hot-path analog: Ogg/PacketProvider.CreatePacket:427-560 +
    StreamDecoder.DecodeNextPacket:696 header reads.
    """
    lens_all = np.diff(offs)
    P_all = len(lens_all)
    if first_audio >= P_all:
        return FramePlan([], 1, [], [], {})
    lens = lens_all[first_audio:]
    starts = offs[first_audio:-1]
    g_arr = granules[first_audio:].astype(np.int64)
    fl = flags[first_audio:]
    P = len(lens)

    # build_plan stops AFTER the first EOS packet
    eos = np.nonzero(fl & 2)[0]
    if len(eos):
        P = int(eos[0]) + 1
        lens, starts, g_arr, fl = lens[:P], starts[:P], g_arr[:P], fl[:P]

    safe = np.minimum(starts, len(blob) - 1)
    b0 = np.where(lens > 0, blob[safe], 1).astype(np.int32)  # empty -> skip
    b1 = np.where(
        lens > 1, blob[np.minimum(safe + 1, len(blob) - 1)], 0
    ).astype(np.int32)
    v = b0 | (b1 << 8)

    mode_bits = setup.mode_bits
    n_modes = len(setup.modes)
    audio = (lens > 0) & ((b0 & 1) == 0)
    mode_idx = (v >> 1) & ((1 << mode_bits) - 1)
    if np.any(audio & (mode_idx >= n_modes)):
        raise InvalidDataError("mode index out of bounds")
    mi = np.where(audio, mode_idx, 0)
    bf_arr = np.array([m.block_flag for m in setup.modes], dtype=bool)
    need_arr = np.array(
        [1 + mode_bits + (2 if b else 0) for b in bf_arr], dtype=np.int64
    )
    decodable = audio & (need_arr[mi] <= 8 * lens)
    bf = bf_arr[mi] & decodable
    pf = (np.where(bf, v >> (1 + mode_bits), 0) & 1).astype(bool)
    nf = (np.where(bf, v >> (2 + mode_bits), 0) & 1).astype(bool)

    sel = np.nonzero(decodable)[0]
    combo = mi[sel] * 4 + pf[sel] * 2 + nf[sel]
    infos: dict[int, WindowInfo] = {}
    for c in np.unique(combo):
        c = int(c)
        infos[c] = setup.modes[c >> 2].window_info(bool(c & 2), bool(c & 1))
    g_sel = g_arr[sel]
    mi_sel = mi[sel]
    frames = [
        FrameEntry(
            packet=None, mode_idx=int(m), info=infos[int(c)], granule=int(gr)
        )
        for m, c, gr in zip(mi_sel, combo, g_sel)
    ]

    # chains split where any resync packet lies in (prev_sel, sel] —
    # build_plan breaks on ENCOUNTERING a resync packet, decodable or not
    cum_res = np.concatenate([[0], np.cumsum((fl & 1).astype(np.int64))])
    chains: list[list[int]] = []
    if len(sel):
        res_before = cum_res[sel + 1]
        breaks = np.zeros(len(sel), dtype=bool)
        breaks[1:] = (res_before[1:] - res_before[:-1]) > 0
        bounds = [0, *np.nonzero(breaks)[0].tolist(), len(sel)]
        chains = [
            list(range(a, b))
            for a, b in zip(bounds[:-1], bounds[1:])
            if b > a
        ]

    chain_segments: list[list[tuple[int, int]]] = []
    base = 0
    for chain in chains:
        segments: list[tuple[int, int]] = []
        base = _lay_out_chain(frames, chain, base, segments)
        chain_segments.append(segments)

    buckets: dict[BucketKey, list[int]] = {}
    for c in combo[np.sort(np.unique(combo, return_index=True)[1])]:
        c = int(c)
        idxs = np.nonzero(combo == c)[0]
        info = infos[c]
        buckets[BucketKey(c >> 2, info.prev_flag, info.next_flag)] = (
            idxs.tolist()
        )
    return FramePlan(
        frames=frames,
        total_len=max(base, 1),
        chains=chains,
        chain_segments=chain_segments,
        buckets=buckets,
        scan=(blob, starts[sel], starts[sel] + lens[sel]),
    )


def _mode_tables(setup):
    """The plan's constants of a setup, memoized on it: (mode_bits, block
    flag u8 [modes], window table i64 [modes * 4, 4] (n, left_start,
    left_end, right_end of combo mode*4 + prev*2 + next), the BucketKey of
    each combo)."""
    try:
        return setup._vp_mode_tables
    except AttributeError:
        pass
    infos = [m.window_info(bool(c & 2), bool(c & 1))
             for m in setup.modes for c in range(4)]
    tables = (
        setup.mode_bits,
        np.array([m.block_flag for m in setup.modes], dtype=np.uint8),
        np.array([(i.n, i.left_start, i.left_end, i.right_end)
                  for i in infos], dtype=np.int64),
        [BucketKey(c >> 2, i.prev_flag, i.next_flag)
         for c, i in enumerate(infos)],
    )
    setup._vp_mode_tables = tables
    return tables


def build_plan_native(
    blob: np.ndarray,
    offs: np.ndarray,
    granules: np.ndarray,
    flags: np.ndarray,
    setup,
    first_audio: int = 3,
) -> FramePlan | None:
    """build_plan_from_scan in the C++ front end (native.plan_scan, span
    ``front.native``, without the interpreter lock), wrapped into a
    FramePlan (span ``front.plan``) that carries only the struct of
    arrays: no FrameEntry objects. The C++ lays a chain out from the
    window math alone where every granule anchor agrees with it, bar an
    end trim on the final frame; None where a chain needs the exact
    per-frame layout (start trims or offsets, granule gaps, forward jumps,
    a trim before the final frame): build_plan_from_scan plans such a
    stream."""
    from . import native

    mode_bits, block_flag, win, keys = _mode_tables(setup)
    with profiling.sub("front.native"):
        p = native.plan_scan(blob, offs, granules, flags, first_audio,
                             mode_bits, block_flag, win)
    if p is None:
        return None
    with profiling.sub("front.plan"):
        bounds = p["chain"].tolist()
        perm, bstart = p["perm"], p["bstart"].tolist()
        return FramePlan(
            frames=[],
            total_len=p["total_len"],
            chains=[list(range(a, b)) for a, b in zip(bounds, bounds[1:])],
            chain_segments=[[(lo, hi)] if hi > lo else []
                            for lo, hi in p["seg"].tolist()],
            buckets={keys[c]: perm[a:b].tolist() for c, a, b in
                     zip(p["bcombo"].tolist(), bstart, bstart[1:])},
            scan=(blob, p["start"], p["end"]),
            soa_cache=FrameSoA(p["n"], p["left_start"], p["left_end"],
                               p["right_end"], p["offset"], p["prime"],
                               p["final"]),
        )


def _lay_out_chain(
    frames: list[FrameEntry],
    chain: list[int],
    base: int,
    segments: list[tuple[int, int]],
) -> int:
    """Assign offsets for one resync-free run of frames; returns next base.

    Mirrors StreamDecoder._next_block position/trim semantics: the first
    frame primes lapping only; per-frame emission is the center-to-center
    distance; page granules anchor the position and cut excess samples
    (end trim / short first page)."""
    if not chain:
        return base
    first = frames[chain[0]]
    first.prime = True
    first.offset = base - first.info.n // 2  # center of frame 0 at `base`
    frames[chain[-1]].final = True

    centers = [base]  # global center position of each frame
    prev = first
    for idx in chain[1:]:
        fr = frames[idx]
        fr.offset = prev.offset + prev.info.right_end - fr.info.left_end
        centers.append(fr.offset + fr.info.n // 2)
        prev = fr

    # granule anchoring + cuts (reference StreamDecoder.cs:458-463,657-666)
    pos: int | None = None  # granule-space position after frame f
    unanchored = 0
    seg_open = base  # global start of the currently-kept range
    for k, idx in enumerate(chain):
        fr = frames[idx]
        n_emit = centers[k] - centers[k - 1] if k > 0 else 0
        if pos is None:
            unanchored += n_emit
        else:
            pos += n_emit
        granule = fr.granule
        if granule < 0:
            continue
        if pos is None:
            implied_start = granule - unanchored
            if implied_start < 0:
                seg_open = _cut(segments, seg_open, centers[k], -implied_start)
            pos = granule
            unanchored = 0
        elif granule < pos:
            seg_open = _cut(segments, seg_open, centers[k], pos - granule)
            pos = granule
        else:
            pos = granule  # forward jump: position skips, no samples inserted
    end = centers[-1]
    if end > seg_open:
        segments.append((seg_open, end))
    return end


def _cut(
    segments: list[tuple[int, int]], seg_open: int, emitted_end: int, cut: int
) -> int:
    """Drop the last ``cut`` samples emitted so far; returns the new open
    segment start (samples resume at ``emitted_end``)."""
    keep_until = emitted_end - cut
    if keep_until < seg_open:
        raise BatchUnsupported("granule cut reaches past an earlier cut")
    if keep_until > seg_open:
        segments.append((seg_open, keep_until))
    return emitted_end


def dense_cost(plan: FramePlan, channels: int) -> np.ndarray:
    """Each frame's dense spectrum bytes (channels x n/2 x float32), i64
    [F]: what BucketBatch.batch_cost sums over a bucket's frames."""
    return 2 * channels * plan.soa().n.astype(np.int64)


def split_bounds(plan: FramePlan, cost: np.ndarray, first: int,
                 rest: int) -> list[tuple[int, int]]:
    """Frame ranges [a, b) of the pieces that plan_piece cuts from
    ``plan``: the first piece's frames cost at most ``first`` (``cost``
    per frame), each later piece's at most ``rest``, and a piece holds at
    least two frames whatever they cost. A piece that ends inside a chain
    shares its last frame with the next piece, which primes on it."""
    F = plan.n_frames
    cum = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(cost, out=cum[1:])
    chain_start = np.zeros(F + 1, dtype=bool)
    chain_start[[c[0] for c in plan.chains if c]] = True
    chain_start[F] = True
    out, a, budget = [], 0, first
    while True:
        b = int(np.searchsorted(cum, cum[a] + budget, side="right")) - 1
        b = min(max(b, a + 2), F)
        out.append((a, b))
        if b >= F:
            return out
        a = b if chain_start[b] else b - 1
        budget = rest


def plan_piece(plan: FramePlan, a: int, b: int) -> FramePlan:
    """Frames [a, b) of ``plan`` as a plan of their own, for bounded-memory
    decode of long streams.

    A chain cut at a frame boundary keeps that frame in both pieces: the
    earlier piece flags it ``final`` (its right half masked), the later
    ``prime`` (its left half masked), which is exactly the lapping split.
    Each piece keeps the part of its chains' ``chain_segments`` (granule
    trims included) that lies between its first and last frame's centres,
    so the pieces' PCM, one after another, is the plan's, sample for
    sample. Coordinates restart at the first frame's centre; packet spans
    (``scan``) and FrameEntry objects are carried where the plan has
    them."""
    s = plan.soa()
    centre = s.offset + s.n // 2
    shift = int(centre[a])
    prime = s.prime[a:b].copy()
    final = s.final[a:b].copy()
    # a piece starts at a chain's start or on a frame it shares with the
    # previous piece, and ends at a chain's end or on one it shares
    prime[0] = final[-1] = True
    chains, chain_segments = [], []
    for chain, segs in zip(plan.chains, plan.chain_segments):
        if not chain or chain[-1] < a or chain[0] >= b:
            continue
        lo, hi = max(chain[0], a), min(chain[-1] + 1, b)
        chains.append(list(range(lo - a, hi - a)))
        keep_lo, keep_hi = int(centre[lo]), int(centre[hi - 1])
        chain_segments.append([
            (max(s0, keep_lo) - shift, min(e0, keep_hi) - shift)
            for s0, e0 in segs if min(e0, keep_hi) > max(s0, keep_lo)])
    buckets = {}
    for key, idx in plan.buckets.items():  # each in frame order
        inside = idx[bisect.bisect_left(idx, a) : bisect.bisect_left(idx, b)]
        if inside:
            buckets[key] = [f - a for f in inside]
    soa = FrameSoA(s.n[a:b], s.left_start[a:b], s.left_end[a:b],
                   s.right_end[a:b], s.offset[a:b] - shift, prime, final)
    frames = [
        replace(fr, offset=fr.offset - shift, prime=bool(p), final=bool(f))
        for fr, p, f in zip(plan.frames[a:b], prime, final)
    ]
    scan = None
    if plan.scan is not None:
        blob, starts, ends = plan.scan
        scan = (blob, starts[a:b], ends[a:b])
    return FramePlan(
        frames=frames,
        total_len=max(int(centre[b - 1]) - shift, 1),
        chains=chains,
        chain_segments=chain_segments,
        buckets=buckets,
        scan=scan,
        soa_cache=soa,
    )


def split_plan(plan: FramePlan, max_frames: int) -> list[FramePlan]:
    """Split a plan into pieces of at most ``max_frames`` frames (at least
    two), each decoded on its own, for bounded-memory decode of long
    streams (plan_piece). The pieces' PCM, one after another, is the
    plan's, bit for bit on the CPU, granule trims included."""
    if plan.n_frames <= max_frames:
        return [plan]
    ones = np.ones(plan.n_frames, dtype=np.int64)
    return [plan_piece(plan, a, b)
            for a, b in split_bounds(plan, ones, max_frames, max_frames)]


@dataclass
class FloorGroup:
    """Channels of one bucket sharing a floor config."""

    floor: object  # Floor0 | Floor1 config
    channels: list[int]
    # floor1 tensors [F, n_ch, P] / floor0 tensors [F, n_ch, order]
    posts: np.ndarray | None = None
    step2: np.ndarray | None = None
    # floor1 coded values (pre-unwrap, int16): the ys wire ships these
    # and the device runs the unwrap cascade (ops/floor.floor1_unwrap)
    ys: np.ndarray | None = None
    coefficients: np.ndarray | None = None
    amplitude: np.ndarray | None = None
    used: np.ndarray | None = None  # [F, n_ch] bool


@dataclass
class SymBucket:
    """Symbol-transport residue payload for one bucket (native/symbols.py
    wire contract). ``syms[g]`` is group g's entry stream for this bucket's
    frames, concatenated in frame order; ``slots[g]`` is the parallel
    per-APPLIED-partition stream of traversal slot ids
    (pv = partition_index * V + vector_row, frame-local — the region row
    each partition's values land in), one entry per nsym symbols. The
    device scatters partition rows straight to region rows, so no
    classifications or pair counts ride the wire at all.
    Merges by concatenation along the frame axis (models/corpus.py)."""

    layout: object  # SymLayout (shared per setup)
    groups: list  # list[SymGroup] for this bucket's mapping
    syms: list  # per group (global id): np.ndarray u16 (possibly empty)
    slots: list  # per group: np.ndarray u16 [syms[g].size // nsym_g]
    part_counts: np.ndarray  # [F, n_groups] i32 applied partitions


@dataclass
class BucketBatch:
    key: BucketKey
    n: int
    frame_indices: np.ndarray  # [F] indices into plan.frames
    offsets: np.ndarray  # [F] int32 global frame start
    prime: np.ndarray  # [F] bool
    final: np.ndarray  # [F] bool
    residues: np.ndarray | None  # [F, C, n//2] float32, pre-coupling
    floor_groups: list[FloorGroup] = field(default_factory=list)
    sym: SymBucket | None = None  # symbol transport (residues is None)

    @property
    def batch_cost(self) -> int:
        """Chunk-sizing cost: DENSE spectrum bytes (frames x channels x
        half x f32) regardless of wire format, so corpus_batch_bytes keeps
        meaning 'audio per merged execution' — the knob bounds compile
        size and pipeline granularity, not literal transfer bytes."""
        if self.residues is not None:
            return self.residues.nbytes
        channels = sum(len(g.channels) for g in self.floor_groups)
        return len(self.frame_indices) * channels * (self.n // 2) * 4

    @property
    def transport_nbytes(self) -> int:
        """Approximate host->device residue wire bytes."""
        if self.residues is not None:
            return self.residues.nbytes
        s = self.sym
        total = 0
        for g, arr, sl in zip(s.groups, s.syms, s.slots):
            w = max(int(g.entries).bit_length(), 1)
            total += (arr.size * w + 7) // 8
            total += sl.size * 2  # scatter slot ids (~w_i<=16 bits packed)
        return total


def extract_batch(
    plan: FramePlan, setup, channels: int, ident=None,
    use_native: bool | None = None, n_threads: int | None = None,
) -> list[BucketBatch]:
    """Pass 2: entropy-decode every frame into per-bucket dense tensors.

    Uses the C++ front end (native/frontend.cpp, threaded over packets) when
    available and ``ident`` is provided; falls back to the pure-Python
    decode otherwise. Both paths produce identical tensors (double
    accumulation, float32 output). ``use_native=None`` follows
    VorbisConfig.default.use_native_frontend. ``n_threads``: the C++
    decode's threads (None: one a core, at most 16). Spans of the calling
    thread's task (utils/profiling.bind): the native call
    ``front.entropy`` (its threads' CPU as ``native_cpu_ns``), the C++
    gather after it ``front.native`` and the Python around that
    ``front.gather``, or the Python decode ``front.python``."""
    from .config import VorbisConfig

    if use_native is None:
        use_native = VorbisConfig.default.use_native_frontend
    if use_native and ident is not None:
        from . import native

        if native.available():
            transport = VorbisConfig.default.residue_transport
            layout = None
            if transport in ("auto", "symbols"):
                layout = _sym_layout_cached(setup, ident)
            return _extract_batch_native(
                plan, setup, channels, ident, sym_layout=layout,
                n_threads=n_threads,
            )
    with profiling.sub("front.python"):
        return _extract_batch_python(plan, setup, channels)


def _sym_layout_cached(setup, ident):
    """symbol_layout(setup) memoized on the setup object (None = setup
    ineligible for symbol transport; callers use value transport)."""
    try:
        return setup._sym_layout
    except AttributeError:
        from .native.symbols import symbol_layout

        setup._sym_layout = symbol_layout(setup, ident)
        return setup._sym_layout


def _bucket_groups(mapping, channels: int):
    """Group channels by floor config (static per mapping)."""
    groups: list[FloorGroup] = []
    by_id: dict[int, FloorGroup] = {}
    for c in range(channels):
        fl = mapping.submap_floor[mapping.mux[c]]
        g = by_id.get(id(fl))
        if g is None:
            g = FloorGroup(floor=fl, channels=[])
            by_id[id(fl)] = g
            groups.append(g)
        g.channels.append(c)
    return groups


def _extract_batch_native(
    plan: FramePlan, setup, channels: int, ident, sym_layout=None,
    n_threads: int | None = None,
) -> list[BucketBatch]:
    from . import native
    from .native.serialize import serialize_setup

    blob = getattr(setup, "_native_blob", None)
    if blob is None:
        blob = serialize_setup(setup, ident)
        setup._native_blob = blob
    max_half = ident.blocksizes[1] // 2
    max_order = max(
        (f.order for f in setup.floors if f.floor_type == 0), default=0
    )
    if plan.scan is not None:
        # zero-copy: packet spans point straight into the Ogg scan's blob
        sblob, sstarts, sends = plan.scan
    else:
        packets = [fr.packet.data for fr in plan.frames]
        offs = np.zeros(len(packets) + 1, dtype=np.int64)
        for i, p in enumerate(packets):
            offs[i + 1] = offs[i] + len(p)
        sblob = np.frombuffer(b"".join(packets), dtype=np.uint8)
        sstarts, sends = offs[:-1], offs[1:]
    with profiling.sub("front.entropy") as sp:
        # the native threads' CPU, summed by the C++ only when recorded
        cpu = None if sp is None else ctypes.c_int64(0)
        if sym_layout is not None:
            dec = native.decode_packet_spans_sym(
                blob, sblob, sstarts, sends, channels, max_order, sym_layout,
                n_threads=n_threads, cpu_ns=cpu,
            )
        else:
            dec = native.decode_packet_spans(
                blob, sblob, sstarts, sends, channels, max_half, max_order,
                n_threads=n_threads, cpu_ns=cpu,
            )
        if sp is not None:
            sp.counters["native_cpu_ns"] = cpu.value
    if n_threads is not None:  # a corpus call's share of the cores
        profiling.tally("native_decodes")
        profiling.tally("native_threads", n_threads)
    return _gather_buckets(plan, setup, channels, dec, sym_layout)


def _gather_tables(setup, channels: int, sym_layout):
    """Per mode of a setup, memoized on it: each floor group's template
    (floor, channels, type, width: posts or order) and first channel in
    ``chs`` (i64, every group's channels after each other); with a symbol
    layout, each mode's group count and nsym row (0 past its groups)."""
    cache = getattr(setup, "_vp_gather_tables", None)
    if cache is None:
        cache = setup._vp_gather_tables = {}
    key = (channels, id(sym_layout))
    hit = cache.get(key)
    if hit is not None and hit[0] is sym_layout:
        return hit[1]
    floors, chs = [], []
    for mode in setup.modes:
        groups = []
        for g in _bucket_groups(setup.mappings[mode.mapping_idx], channels):
            fl = g.floor
            width = fl.n_posts if fl.floor_type == 1 else fl.order
            groups.append((fl, g.channels, fl.floor_type, width, len(chs)))
            chs += g.channels
        floors.append(groups)
    sym = None
    if sym_layout is not None:
        n_modes, n_groups = len(setup.modes), sym_layout.n_groups
        counts = np.zeros(n_modes, dtype=np.int64)
        nsym = np.zeros((n_modes, n_groups), dtype=np.int64)
        for m, mode in enumerate(setup.modes):
            gs = sym_layout.groups_per_mapping[mode.mapping_idx]
            counts[m] = len(gs)
            nsym[m, : len(gs)] = [g.nsym for g in gs]
        sym = (counts, nsym)
    tables = (floors, np.asarray(chs, dtype=np.int64), sym)
    cache[key] = (sym_layout, tables)
    return tables


def _gather_buckets(plan: FramePlan, setup, channels: int, dec,
                    sym_layout) -> list[BucketBatch]:
    """The native decode's per-frame outputs -> per-bucket arrays. The
    gather runs in C++ (native.gather_buckets, span ``front.native``):
    every bucket array lies in one output buffer of its kind, bucket after
    bucket. The Python around it (spans ``front.gather``) sizes those
    buffers and wraps views of them into the buckets; value-transport
    residues stay a numpy slice."""
    from . import native

    with profiling.sub("front.gather"):
        keys = list(plan.buckets)
        sizes = [len(v) for v in plan.buckets.values()]
        F = plan.n_frames
        perm = np.fromiter(
            itertools.chain.from_iterable(plan.buckets.values()),
            dtype=np.int64, count=sum(sizes))
        bstart = np.zeros(len(keys) + 1, dtype=np.int64)
        np.cumsum(sizes, out=bstart[1:])
        bmode = np.array([k.mode_idx for k in keys], dtype=np.int64)
        floors, chs, sym_t = _gather_tables(setup, channels, sym_layout)
        # the floor groups' blocks: [F_k, nc, width] and [F_k, nc]
        jobs, groups_of = [], []
        at = [0, 0]  # elements of the floor0 and the floor1 outputs
        uat = 0
        for k, (key, fk) in enumerate(zip(keys, sizes)):
            groups = []
            for fl, g_chs, ftype, width, ch_at in floors[key.mode_idx]:
                nc = len(g_chs)
                jobs.append((k, ftype, width, ch_at, nc, at[ftype], uat))
                groups.append((FloorGroup(floor=fl, channels=list(g_chs)),
                               ftype, at[ftype], uat, (fk, nc, width)))
                at[ftype] += fk * nc * width
                uat += fk * nc
            groups_of.append(groups)
        jobs = np.array(jobs, dtype=np.int64).reshape(-1, 7)
        out = {
            "offsets": np.empty(F, dtype=np.int32),
            "prime": np.empty(F, dtype=bool),
            "final": np.empty(F, dtype=bool),
            "audio_bits": np.empty(F, dtype=np.int64),
            "posts": np.empty(at[1], dtype=np.int32),
            "step2": np.empty(at[1], dtype=bool),
            "ys": np.empty(at[1], dtype=np.int16),
            "f0c": np.empty(at[0], dtype=np.float32),
            "used": np.empty(uat, dtype=bool),
            "f0a": np.empty(uat if at[0] else 0, dtype=np.int32),
        }
        sym = None
        if sym_layout is not None:
            counts, nsym = sym_t
            sym = (counts[bmode], nsym[bmode])
            cap = int(dec["sym_counts"].sum())
            out["pc"] = np.empty(int(sym[0] @ np.asarray(sizes, np.int64)),
                                 dtype=np.int32)
            out["syms"] = np.empty(cap, dtype=np.uint16)
            out["slots"] = np.empty(cap, dtype=np.uint16)
            out["lens"] = np.zeros((len(keys), nsym.shape[1], 2),
                                   dtype=np.int64)
        s = plan.soa()
    with profiling.sub("front.native"):
        native.gather_buckets(dec, perm, bstart, bmode, s.offset, s.prime,
                              s.final, jobs, chs, out, sym)
    with profiling.sub("front.gather"):
        plan.audio_bits = out["audio_bits"]
        if sym is not None:
            # each group stream's [start, end) in the syms and slots outputs
            lens = out["lens"].reshape(-1, 2)
            ends = np.cumsum(lens, axis=0)
            spans = np.concatenate([ends - lens, ends], axis=1).tolist()
            n_groups = out["lens"].shape[1]
        sid = setup_sid(setup)
        bounds = bstart.tolist()
        pc_at = 0
        batches: list[BucketBatch] = []
        for k, key in enumerate(keys):
            mode = setup.modes[key.mode_idx]
            a, b = bounds[k], bounds[k + 1]
            fk = b - a
            idx = perm[a:b]
            groups = []
            for g, ftype, gat, guat, shape in groups_of[k]:
                size = shape[0] * shape[1]
                g.used = out["used"][guat : guat + size].reshape(shape[:2])
                end = gat + size * shape[2]
                if ftype == 1:
                    g.posts = out["posts"][gat:end].reshape(shape)
                    g.step2 = out["step2"][gat:end].reshape(shape)
                    g.ys = out["ys"][gat:end].reshape(shape)
                else:
                    g.coefficients = out["f0c"][gat:end].reshape(shape)
                    g.amplitude = out["f0a"][guat : guat + size].reshape(
                        shape[:2])
                groups.append(g)
            residues = sym_b = None
            if sym is None:
                residues = np.ascontiguousarray(
                    dec["residues"][idx][:, :, : mode.n // 2])
            else:
                G = int(sym[0][k])
                streams, slot_streams = [], []
                for s0, p0, s1, p1 in spans[k * n_groups : k * n_groups + G]:
                    streams.append(out["syms"][s0:s1])
                    slot_streams.append(out["slots"][p0:p1])
                sym_b = SymBucket(
                    layout=sym_layout,
                    groups=sym_layout.groups_per_mapping[mode.mapping_idx],
                    syms=streams,
                    slots=slot_streams,
                    part_counts=out["pc"][pc_at : pc_at + fk * G].reshape(
                        fk, G),
                )
                pc_at += fk * G
            batches.append(
                BucketBatch(
                    key=replace(key, sid=sid),
                    n=mode.n,
                    frame_indices=idx,
                    offsets=out["offsets"][a:b],
                    prime=out["prime"][a:b],
                    final=out["final"][a:b],
                    residues=residues,
                    floor_groups=groups,
                    sym=sym_b,
                )
            )
    return batches


def _extract_batch_python(plan: FramePlan, setup, channels: int) -> list[BucketBatch]:
    sid = setup_sid(setup)
    out: list[BucketBatch] = []
    for key, indices in plan.buckets.items():
        mode = setup.modes[key.mode_idx]
        mapping = setup.mappings[mode.mapping_idx]
        key = replace(key, sid=sid)
        n = mode.n
        half = n // 2
        F = len(indices)
        residues = np.zeros((F, channels, half), dtype=np.float32)

        groups = _bucket_groups(mapping, channels)
        for g in groups:
            nc = len(g.channels)
            g.used = np.zeros((F, nc), dtype=bool)
            if g.floor.floor_type == 1:
                P = g.floor.n_posts
                g.posts = np.zeros((F, nc, P), dtype=np.int32)
                g.step2 = np.zeros((F, nc, P), dtype=bool)
                g.ys = np.zeros((F, nc, P), dtype=np.int16)
            else:
                g.coefficients = np.zeros((F, nc, g.floor.order), dtype=np.float32)
                g.amplitude = np.zeros((F, nc), dtype=np.int32)

        for fi, frame_idx in enumerate(indices):
            fr = plan.frames[frame_idx]
            br = BitReader(fr.packet.data)
            br.read_bit()
            br.read_bits(setup.mode_bits)
            mode.read_window_flags(br)
            floor_data, _, res = mapping.decode_packet_raw(br, n)
            residues[fi] = res.astype(np.float32)
            for g in groups:
                for ci, c in enumerate(g.channels):
                    fd = floor_data[c]
                    if fd.unused:
                        continue
                    g.used[fi, ci] = True
                    if g.floor.floor_type == 1:
                        g.posts[fi, ci] = fd.posts
                        g.step2[fi, ci] = fd.step2
                        if fd.ys is not None:
                            g.ys[fi, ci] = np.minimum(fd.ys, 32767)
                    else:
                        g.coefficients[fi, ci] = fd.coefficients
                        g.amplitude[fi, ci] = fd.amplitude

        out.append(
            BucketBatch(
                key=key,
                n=n,
                frame_indices=np.asarray(indices, dtype=np.int64),
                offsets=np.asarray(
                    [plan.frames[i].offset for i in indices], dtype=np.int32
                ),
                prime=np.asarray([plan.frames[i].prime for i in indices], dtype=bool),
                final=np.asarray([plan.frames[i].final for i in indices], dtype=bool),
                residues=residues,
                floor_groups=groups,
            )
        )
    return out
