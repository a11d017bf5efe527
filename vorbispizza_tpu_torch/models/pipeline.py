"""Batch decode pipeline: packed host wire -> PCM on one device.

Port of vorbispizza_tpu/models/pipeline.py in two halves.

The HOST half (``BatchSynthesizer.prepare_host`` and the helpers it calls)
is a numpy copy of the reference's host methods: it produces the same
``sig`` and byte-identical host buffers for the same merged chunk, so both
packages read the same wire. Like every host module of the port, it is a
copy: the port imports nothing of the JAX package.

The DEVICE half (``BatchSynthesizer.forward``) does what the reference's
fused XLA program (``_fused_body``) does, for every residue and floor wire
and every output of the reference:

    residues: residue_sym.expand_bucket (K1, symbol transport: one launch
              a bucket) or residue_values.residue_gather (K9, value
              transport)
    floors:   floor.floor1_from_ys (K2, coded-ys wire),
              floor.floor1_from_posts (K2 posts mode, posts/step2 wire) or
              floor.floor0_curves (K8, floor0)
    -> coupling.couple_spectrum_chunk (K3, one launch over every bucket)
    -> imdct.dct_iv (torch.matmul, a bucket at a time)
    -> ola.ola_assemble (K4, with the IMDCT epilogue folded in; "f32"
       PCM, or the s16 quantize in registers for "s16"/"s16p"; for the
       dpack wires its dpack mode: q and the wire's per-block select)
    -> for "s16d"/"s16df": pcm_pack.dpack_wire (K6: its scans, the header
       and the planes; K7 unary on a rice wire), into the one u8 wire
       buffer K4 began

``BatchSynthesizer.assemble`` runs both halves for one plan, through the
round trip every driver shares (models/launch.py), and the stream-level
drivers ``decode_stream_batch`` and
``decode_file_batch`` (the reference's, plus ``device``) decode one
stream through it; the corpus driver is models/corpus.py.
"""

from __future__ import annotations

import io
import threading
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ..config import VorbisConfig
from ..decoder import CLIP_MAX, StreamDecoder
from ..device import resolve_device
from ..dsp.window import full_window
from ..frames import (
    BatchUnsupported,
    BucketBatch,
    FramePlan,
    _bucket_groups,
    build_plan,
    extract_batch,
    setup_sid,
    split_plan,
)
from ..ogg.container import OggContainer
from ..native.symbols import _vec_shape
from ..ops.coupling import couple_spectrum_chunk
from ..ops.floor import (
    floor0_curves,
    floor0_tables,
    floor1_from_posts,
    floor1_from_ys,
    floor1_levels,
    floor1_tables,
    inverse_db_tables,
)
from ..ops.imdct import dct_iv, dct_iv_basis
from ..ops.ola import ola_assemble
from ..ops.pcm_pack import (
    DPACK,
    dpack_wire,
    wire_buffer,
    wire_caps,
    wire_rows,
)
from ..ops.residue_sym import bucket_table, expand_bucket, pack_bits
from ..ops.residue_values import residue_gather
from ..setup.mode import window_geometry
from ..utils import profiling
from ..utils.link import d2h_rate_estimate
from .launch import hand_over, launch

#: outputs of the fused body (models/pipeline.py _fused_body)
OUTPUTS = ("f32", "s16", "s16p", "s16d", "s16df")
#: floor wire of a floor group -> its wrapper in ops.floor
FLOORS = {"ys": floor1_from_ys, "posts": floor1_from_posts,
          "floor0": floor0_curves}


class OlaUnsupported(BatchUnsupported):
    """Overlap geometry the batch OLA cannot model (non-ascending frame
    supports, >2-deep coverage)."""


def _pad_size(x: int, base: int = 64) -> int:
    """Quantized padding: round up to a 1.5x-geometric size series
    (64, 96, 128, 192, 256, ...)."""
    if x <= base:
        return base
    s = base
    while s < x:
        s2 = s + s // 2
        if s2 >= x:
            return s2
        s *= 2
    return s


class _LRU(OrderedDict):
    """Bounded, locked cache (least recently used evicted first)."""

    MAX = 64

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._lock = threading.Lock()

    def get(self, key, default=None):
        with self._lock:
            v = super().get(key, default)
            if key in self:
                self.move_to_end(key)
            return v

    def __setitem__(self, key, value):
        with self._lock:
            super().__setitem__(key, value)
            self.move_to_end(key)
            while len(self) > self.MAX:
                self.popitem(last=False)


class _FrozenMeta(tuple):
    """Hashable static metadata (a tuple of sorted key/value pairs exposing
    dict-style item access)."""

    def __getitem__(self, key):
        if isinstance(key, str):
            for k, v in tuple.__iter__(self):
                if k == key:
                    return v
            raise KeyError(key)
        return tuple.__getitem__(self, key)


def dict_frozen(**kwargs) -> _FrozenMeta:
    return _FrozenMeta(sorted(kwargs.items()))


class BatchSynthesizer(nn.Module):
    """Host wire packing and device synthesis for every stream of one
    channel count. Holds the registered setups (buckets name theirs via
    key.sid) and the per-bucket device tables."""

    #: retention bound for registered setups (LRU evicted beyond this)
    SETUPS_MAX = 128

    #: largest packed-row count still addressable by the 16-bit gather map
    GMAP_U16_MAX = 65534

    #: sparse-residue packing granularity (columns per block)
    PACK_GRAN = 32

    def __init__(self, setup, channels: int):
        super().__init__()
        self.setup = setup
        self.channels = channels
        self.setups: OrderedDict = OrderedDict()
        self._setups_lock = threading.Lock()
        self.add_setup(setup)
        #: sym statics, layouts and device tables
        self._cache: dict = _LRU()

    def add_setup(self, setup) -> None:
        """Register a setup so its buckets (key.sid) resolve."""
        with self._setups_lock:
            self.setups[setup_sid(setup)] = setup
            self.setups.move_to_end(setup_sid(setup))
            while len(self.setups) > self.SETUPS_MAX:
                self.setups.popitem(last=False)

    def _setup_for(self, key):
        with self._setups_lock:
            s = self.setups.get(key.sid)
            if s is not None:
                self.setups.move_to_end(key.sid)
        if s is None:
            if key.sid == 0:  # hand-built test buckets (no extract stamp)
                return self.setup
            raise BatchUnsupported(f"setup sid {key.sid} evicted before use")
        return s

    def _bucket_static(self, key):
        """(n, window, coupling_steps) — static per bucket key."""
        setup = self._setup_for(key)
        mode = setup.modes[key.mode_idx]
        mapping = setup.mappings[mode.mapping_idx]
        info = window_geometry(
            mode.blocksizes, mode.block_flag, key.prev_flag, key.next_flag
        )
        window = full_window(
            info.n, info.left_start, info.left_end, info.right_start, info.right_end
        ).astype(np.float32)
        return mode.n, window, tuple(mapping.coupling_steps)

    @staticmethod
    def _resolve_rice(device="cpu") -> bool:
        """Rice mode of the dpack wire (sig[6]): config.s16_rice "on"/"off",
        or under "auto" whether the measured device->host rate
        (utils/link.py; +inf for the CPU) is below
        s16_rice_threshold_mbps."""
        cfg = VorbisConfig.default
        if cfg.s16_rice == "on":
            return True
        if cfg.s16_rice == "off":
            return False
        if cfg.s16_rice != "auto":
            raise ValueError(f"s16_rice {cfg.s16_rice!r}: not on/off/auto")
        return d2h_rate_estimate(device) < cfg.s16_rice_threshold_mbps * 1e6

    @staticmethod
    def _floor1_ys_ok(floor) -> bool:
        """Static gate for the coded-ys floor1 wire: every value the
        bitstream can put into ys fits u8."""
        return all(
            b is None or b.entries <= 256
            for books in floor.subclass_books
            for b in books
        )

    @staticmethod
    def _group_meta(bucket: BucketBatch, pads: dict | None = None):
        """Static floor metadata per floor group (part of the sig)."""
        metas = []
        for gi, g in enumerate(bucket.floor_groups):
            if g.floor.floor_type == 1:
                use_ys = (
                    VorbisConfig.default.floor1_wire == "ys"
                    and g.ys is not None
                    and BatchSynthesizer._floor1_ys_ok(g.floor)
                )
                if use_ys:
                    # quantized capacity of the compacted nonzero u8 stream
                    n_nz = int(np.count_nonzero(g.ys[:, :, 2:]))
                    nz_cap = _pad_size(max(n_nz, 1), 2048)
                    if pads:
                        nz_cap = max(
                            nz_cap, pads.get(("ysnz", bucket.key, gi), 0)
                        )
                    metas.append(
                        dict_frozen(
                            type=1,
                            channels=tuple(g.channels),
                            xs=tuple(int(x) for x in g.floor.xs),
                            multiplier=g.floor.multiplier,
                            wire="ys",
                            nz_cap=nz_cap,
                        )
                    )
                else:
                    metas.append(
                        dict_frozen(
                            type=1,
                            channels=tuple(g.channels),
                            xs=tuple(int(x) for x in g.floor.xs),
                            multiplier=g.floor.multiplier,
                        )
                    )
            else:
                metas.append(
                    dict_frozen(
                        type=0,
                        channels=tuple(g.channels),
                        order=g.floor.order,
                        bark_map=tuple(int(v) for v in g.floor._maps[bucket.n]),
                        bark_map_size=g.floor.bark_map_size,
                        amplitude_bits=g.floor.amplitude_bits,
                        amplitude_offset=g.floor.amplitude_offset,
                    )
                )
        return tuple(metas)

    @staticmethod
    def _flat_base(plan: FramePlan, buckets, padded_n):
        """Flat-layout start index of each frame's sample 0: [n_frames]."""
        flat_base = np.zeros(plan.n_frames, dtype=np.int64)
        base = 0
        for bucket, pn in zip(buckets, padded_n):
            Fp, n = pn[0], pn[1]
            flat_base[bucket.frame_indices] = base + np.arange(
                len(bucket.frame_indices), dtype=np.int64
            ) * n
            base += Fp * n
        return flat_base

    def _frame_tables(self, plan: FramePlan, buckets, padded_n):
        """Per-frame OLA tables: effective support offsets/ends in global
        coordinates and the frame's base index in the flat layout."""
        s = plan.soa()
        n_frames = plan.n_frames
        # nonzero support of each windowed frame, narrowed to [center, ...)
        # for priming frames and [..., center) for chain-final frames
        centers = s.n // 2
        sup_start = np.where(s.prime, centers, s.left_start)
        sup_end = np.where(s.final, centers, s.right_end)
        offsets = s.offset
        offsets_eff = offsets + sup_start
        ends_eff = offsets + sup_end
        flat_base = self._flat_base(plan, buckets, padded_n)
        if np.any(np.diff(offsets_eff) < 0):
            raise OlaUnsupported("frame supports not ascending")
        if n_frames >= 3 and not np.all(ends_eff[:-2] <= offsets_eff[2:]):
            raise OlaUnsupported("three frames overlap one sample")
        # every kept sample must be covered (the device gather cannot raise)
        for chain in plan.chains:
            ch = np.asarray(chain, dtype=np.int64)
            if len(ch) >= 2 and not np.all(
                offsets_eff[ch][1:] <= ends_eff[ch][:-1]
            ):
                raise OlaUnsupported("output sample not covered by any frame")
        return (
            offsets_eff.astype(np.int32),
            ends_eff.astype(np.int32),
            (flat_base + sup_start - offsets_eff).astype(np.int32),  # fbase-off
        )

    @staticmethod
    def _build_events(offs, ends, fbase, segs, total):
        """j-domain OLA mapping events (ev_j, ev_da, ev_db, ev_va, ev_vb):
        at each ev_j, ev_da/ev_db adjust the +1/sample drift of the gather
        indices and ev_va/ev_vb add validity-level deltas."""
        F = len(offs)
        j_l, f_l, p_l, e_l = [], [], [], []
        c = 0
        for s_, e_ in segs:
            if e_ <= s_:
                continue
            lk = int(e_ - s_)
            f0 = int(np.searchsorted(offs, s_, side="right")) - 1
            f_hi = int(np.searchsorted(offs, e_ - 1, side="right"))
            cross = np.arange(f0 + 1, f_hi, dtype=np.int64)
            rj = np.concatenate([[c], c + offs[cross] - s_])
            rf = np.concatenate([[f0], cross])
            j_l.append(rj)
            f_l.append(rf)
            p_l.append(s_ + rj - c)
            e_l.append(np.concatenate([rj[1:], [c + lk]]))
            c += lk
        zero = np.zeros(1, dtype=np.int32)
        if not j_l:
            return zero, zero, zero, zero.copy(), zero.copy()
        rj = np.concatenate(j_l).astype(np.int64)
        rf = np.concatenate(f_l).astype(np.int64)
        rp = np.concatenate(p_l).astype(np.int64)
        re_ = np.concatenate(e_l).astype(np.int64)
        offs = offs.astype(np.int64)
        ends = ends.astype(np.int64)
        fbase = fbase.astype(np.int64)
        acl = np.clip(rf, 0, F - 1)
        bcl = np.clip(rf - 1, 0, F - 1)
        a_tgt = fbase[acl] + rp
        b_tgt = fbase[bcl] + rp
        # index deltas vs the natural +1/sample drift between events
        step = rj[1:] - rj[:-1]
        da = a_tgt - np.concatenate([[0], a_tgt[:-1] + step])
        db = b_tgt - np.concatenate([[0], b_tgt[:-1] + step])
        # validity: level at run start, mid-run turn-off when pos hits the
        # frame's effective end, carry into the next (j-contiguous) run
        va_on = (rf >= 0) & (rp < ends[acl])
        vb_on = (rf > 0) & (rp < ends[bcl])
        va_off = rj + np.maximum(ends[acl] - rp, 0)
        vb_off = rj + np.maximum(ends[bcl] - rp, 0)
        va_in = va_on & (va_off < re_)
        vb_in = vb_on & (vb_off < re_)
        va_lvl = (va_on & ~va_in).astype(np.int64)  # level carried out
        vb_lvl = (vb_on & ~vb_in).astype(np.int64)
        dva = va_on.astype(np.int64) - np.concatenate([[0], va_lvl[:-1]])
        dvb = vb_on.astype(np.int64) - np.concatenate([[0], vb_lvl[:-1]])
        nz = np.zeros
        ev_j = np.concatenate(
            [rj, va_off[va_in], vb_off[vb_in], [total]]
        )
        ev_da = np.concatenate(
            [da, nz(va_in.sum()), nz(vb_in.sum()), [0]]
        )
        ev_db = np.concatenate(
            [db, nz(va_in.sum()), nz(vb_in.sum()), [0]]
        )
        ev_va = np.concatenate(
            [dva, -np.ones(va_in.sum()), nz(vb_in.sum()), [-va_lvl[-1]]]
        )
        ev_vb = np.concatenate(
            [dvb, nz(va_in.sum()), -np.ones(vb_in.sum()), [-vb_lvl[-1]]]
        )
        return (
            ev_j.astype(np.int32),
            ev_da.astype(np.int32),
            ev_db.astype(np.int32),
            ev_va.astype(np.int32),
            ev_vb.astype(np.int32),
        )

    def _sym_static(self, key):
        """Symbol-transport structure of one bucket key (cached): per
        submap the region geometry, its groups in wire order and their VQ
        tables (zero row appended for the end-of-packet sentinel), and
        each table's (element offset, entries) in ``vq_all``, the key's
        tables end to end (K1 reads them there). ``None`` sigs mark
        submaps with no channels or no coded region."""
        cached = self._cache.get(("symstatic", key))
        if cached is not None:
            return cached
        setup = self._setup_for(key)
        mode = setup.modes[key.mode_idx]
        mapping = setup.mappings[mode.mapping_idx]
        layout = setup._sym_layout
        groups_m = layout.groups_per_mapping[mode.mapping_idx]
        half = mode.n // 2
        subs = []
        vq_at = 0
        for sm in range(mapping.submaps):
            r = mapping.submap_residue[sm]
            ch_list = [
                c for c in range(self.channels) if mapping.mux[c] == sm
            ]
            V, vec_len, limit_begin, Pt = _vec_shape(r, half, len(ch_list))
            if not ch_list or Pt == 0:
                subs.append(
                    {"sm": sm, "ch_list": ch_list, "sig": None,
                     "gis": [], "groups": [], "vqs": [], "vq_offs": []}
                )
                continue
            gis = [gi for gi, g in enumerate(groups_m) if g.submap == sm]
            vqs = [
                np.concatenate(
                    [
                        np.asarray(
                            setup.codebooks[groups_m[gi].book_idx].lookup_table,
                            dtype=np.float32,
                        ),
                        np.zeros((1, groups_m[gi].dims), dtype=np.float32),
                    ]
                )
                for gi in gis
            ]
            vq_offs = []
            for v in vqs:
                vq_offs.append((vq_at, v.shape[0] - 1))
                vq_at += v.size
            subs.append(
                {
                    "sm": sm,
                    "ch_list": ch_list,
                    "sig": (
                        V, Pt, r.partition_size, limit_begin, vec_len,
                        r.residue_type == 2,
                    ),
                    "gis": gis,
                    "groups": [groups_m[gi] for gi in gis],
                    "vqs": vqs,
                    "vq_offs": vq_offs,
                }
            )
        vq_all = [v.reshape(-1) for sub in subs for v in sub["vqs"]]
        res = {"subs": subs, "vq_all": np.concatenate(
            vq_all or [np.zeros(1, dtype=np.float32)])}
        self._cache[("symstatic", key)] = res
        return res

    @staticmethod
    def _layout(statics, padded_n, channels):
        """Static packed-transfer layout: every host tensor gets a
        (buffer-tag, offset, shape) slot in one of four flat transfer
        buffers (f32 / i32 / i16 / u8).

        ``padded_n`` per bucket: (Fp, n, "sym", sub_sigs) for symbol
        transport, else (Fp, n, Kp, ptag, gtag)."""
        counts = {"f32": 0, "i32": 0, "i16": 0, "u8": 0}
        PG = BatchSynthesizer.PACK_GRAN

        def slot(tag, shape):
            size = int(np.prod(shape))
            off = counts[tag]
            counts[tag] += size
            return (tag, off, shape)

        entries = []
        for (key, metas), pn in zip(statics, padded_n):
            Fp, n = pn[0], pn[1]
            half = n // 2
            if pn[2] == "sym":
                # bit-packed entry streams per (submap, pass, book) +
                # parallel bit-packed scatter indices
                sub_sigs = pn[3]
                e = {
                    "syms": [],
                    "idx": [],
                    "groups": [],
                }
                for ss in sub_sigs:
                    if ss is None:
                        e["syms"].append([])
                        e["idx"].append([])
                        continue
                    V, Pt, psize, lb, vl, fmt2, w_i, sgroups = ss
                    gs = []
                    xs = []
                    for (w, d, nsym, fmt1, np_pad) in sgroups:
                        gs.append(
                            slot("u8", ((np_pad * nsym * w + 7) // 8,))
                        )
                        xs.append(
                            slot("u8", ((np_pad * w_i + 7) // 8,))
                        )
                    e["syms"].append(gs)
                    e["idx"].append(xs)
            else:
                Kp, ptag, gtag = pn[2], pn[3], pn[4]
                npart = half // PG
                e = {
                    "gmap": slot(
                        "i16" if gtag == "u16" else "i32",
                        (Fp * channels * npart,),
                    ),
                    # "u8b" = int8 values shipped +128-biased in the u8 buffer
                    "packed": slot("u8" if ptag == "u8b" else ptag, (Kp, PG)),
                    "groups": [],
                }
            for meta in metas:
                nc = len(meta["channels"])
                if meta["type"] == 1:
                    P = len(meta["xs"])
                    if dict(meta).get("wire") == "ys":
                        # posts 0/1 raw u8, the other P-2 coded values as a
                        # zero bitmask + the compacted nonzero values u8
                        P2 = P - 2
                        g = {"ys01": slot("u8", (Fp, nc, 2))}
                        if P2 > 0:
                            g["ysmask"] = slot(
                                "u8", (Fp, nc, (P2 + 7) // 8)
                            )
                            g["ysnz"] = slot("u8", (meta["nz_cap"],))
                    else:
                        g = {
                            "posts": slot("u8", (Fp, nc, P)),
                            "step2": slot("u8", (Fp, nc, (P + 7) // 8)),
                        }
                else:
                    g = {
                        "coefficients": slot("f32", (Fp, nc, meta["order"])),
                        "amplitude": slot("i32", (Fp, nc)),
                    }
                g["used"] = slot("u8", (Fp, nc))
                e["groups"].append(g)
            e["prime"] = slot("u8", (Fp,))
            e["final"] = slot("u8", (Fp,))
            entries.append(e)
        return entries, counts

    def prepare_host(
        self,
        plan: FramePlan,
        buckets: list[BucketBatch],
        output: str = "f32",
        pads: dict | None = None,
        device="cpu",
    ):
        """Pack a merged chunk into the wire: returns (sig, host numpy
        arrays [f32, i32, i16, u8, ev_j, ev_da, ev_db, ev_va, ev_vb],
        total). ``pads`` forces padded dimensions and wire dtypes up to
        given maxima (the reference's cross-shard signature unification).
        ``device``: where the output will be pulled from, which sets the
        dpack rice flag under s16_rice="auto"."""
        if output not in OUTPUTS:
            raise ValueError(f"output {output!r} (not one of {OUTPUTS})")
        metas_per = [self._group_meta(b, pads=pads) for b in buckets]
        packs = []
        padded_n = []
        for b in buckets:
            F = len(b.frame_indices)
            Fp = _pad_size(max(F, 1))
            if pads:
                Fp = max(Fp, pads.get(("Fp", b.key), 0))
            if b.sym is not None:
                st = self._sym_static(b.key)
                sub_sigs = []
                syms_packed = []
                idx_packed = []
                g_seq = 0  # ordinal over (submap, pass, group) enumeration
                for si, sub in enumerate(st["subs"]):
                    if sub["sig"] is None:
                        sub_sigs.append(None)
                        continue
                    V, Pt, psize, lb, vl, fmt2 = sub["sig"]
                    PV = Pt * V
                    # scatter-index wire width: values 0..Fp*PV (sentinel
                    # Fp*PV marks padding; the device drops it)
                    w_i = max(int(Fp * PV).bit_length(), 1)
                    frame_row = np.arange(F, dtype=np.int64) * PV
                    groups = []
                    for gi, g in zip(sub["gis"], sub["groups"]):
                        stream = b.sym.syms[gi]
                        if stream.size % g.nsym:
                            raise BatchUnsupported(
                                "symbol stream not partition-aligned"
                            )
                        np_ = stream.size // g.nsym
                        np_pad = _pad_size(max(np_, 1), 16)
                        if pads:
                            np_pad = max(
                                np_pad,
                                pads.get(("np", b.key, g_seq), 0),
                            )
                        g_seq += 1
                        w = max(int(g.entries).bit_length(), 1)
                        padded = np.full(
                            np_pad * g.nsym, g.entries, dtype=np.uint32
                        )
                        padded[: stream.size] = stream
                        syms_packed.append(pack_bits(padded, w))
                        # region row per applied partition: frame*PV + pv
                        gidx = np.full(np_pad, Fp * PV, dtype=np.int64)
                        gidx[:np_] = (
                            np.repeat(frame_row, b.sym.part_counts[:, gi])
                            + b.sym.slots[gi]
                        )
                        idx_packed.append(pack_bits(gidx, w_i))
                        groups.append((w, g.dims, g.nsym, g.fmt1, np_pad))
                    sub_sigs.append(
                        (V, Pt, psize, lb, vl, fmt2, w_i, tuple(groups))
                    )
                packs.append(("sym", syms_packed, idx_packed))
                padded_n.append((Fp, b.n, "sym", tuple(sub_sigs)))
                continue
            _, C, half = b.residues.shape
            npart = half // self.PACK_GRAN
            r = b.residues.reshape(F * C * npart, self.PACK_GRAN)
            nz = np.any(r != 0, axis=1)
            rows = r[nz]
            K = rows.shape[0]
            if K == 0:
                ptag = "u8b"
            elif np.any(rows != np.rint(rows)):
                ptag = "f32"
            else:
                amax = np.abs(rows).max()
                ptag = "u8b" if amax <= 127.0 else (
                    "i16" if amax <= 32000.0 else "f32"
                )
            gmap = np.zeros(F * C * npart, dtype=np.int32)
            gmap[nz] = 1 + np.arange(K, dtype=np.int32)
            gtag = "u16" if K <= self.GMAP_U16_MAX else "i32"
            Kp = _pad_size(K + 1)
            if pads:
                Kp = max(Kp, pads.get(("Kp", b.key), 0))
                order = {"u8b": 0, "i16": 1, "f32": 2}
                pt = pads.get(("ptag", b.key), "u8b")
                if order[pt] > order[ptag]:
                    ptag = pt
                if pads.get(("gtag", b.key)) == "i32":
                    gtag = "i32"
            packs.append(("val", gmap, rows, K, ptag))
            padded_n.append((Fp, b.n, Kp, ptag, gtag))
        statics = tuple(
            (b.key, metas) for b, metas in zip(buckets, metas_per)
        )
        entries, counts = self._layout(statics, padded_n, self.channels)
        f32 = np.zeros(counts["f32"], dtype=np.float32)
        i32 = np.zeros(counts["i32"], dtype=np.int32)
        i16 = np.zeros(counts["i16"], dtype=np.int16)
        u8 = np.zeros(counts["u8"], dtype=np.uint8)
        bufs = {"f32": f32, "i32": i32, "i16": i16, "u8": u8}

        def put(slot, value):
            tag, off, shape = slot
            size = int(np.prod(shape))
            view = bufs[tag][off : off + size].reshape(shape)
            view[: value.shape[0]] = value

        for bucket, e, metas, pk in zip(buckets, entries, metas_per, packs):
            if pk[0] == "sym":
                _, syms_packed, idx_packed = pk
                flat_slots = [s for gs in e["syms"] for s in gs]
                for sslot, sdata in zip(flat_slots, syms_packed):
                    put(sslot, sdata)
                flat_idx = [s for xs in e["idx"] for s in xs]
                for xslot, xdata in zip(flat_idx, idx_packed):
                    put(xslot, xdata)
            else:
                _, gmap, rows, K, ptag = pk
                tag, off, shape = e["gmap"]
                if tag == "i16":
                    gmap = gmap.astype(np.uint16).view(np.int16)
                bufs[tag][off : off + len(gmap)] = gmap
                tag, off, shape = e["packed"]
                view = bufs[tag][off : off + int(np.prod(shape))].reshape(
                    shape
                )
                if ptag == "u8b":
                    view[0] = 128  # biased zero row
                    view[1 : K + 1] = (rows + 128.0).astype(np.uint8)
                else:
                    view[1 : K + 1] = rows  # row 0 stays all-zero
            put(e["prime"], bucket.prime.astype(np.uint8))
            put(e["final"], bucket.final.astype(np.uint8))
            for g, ge, meta in zip(bucket.floor_groups, e["groups"], metas):
                put(ge["used"], g.used.astype(np.uint8))
                if meta["type"] == 1:
                    if "ys01" in ge:
                        ys = g.ys.astype(np.int32)  # [F, nc, P]
                        put(ge["ys01"], ys[:, :, :2].astype(np.uint8))
                        if "ysnz" in ge:
                            tail = ys[:, :, 2:]
                            mask = tail != 0
                            put(
                                ge["ysmask"],
                                np.packbits(
                                    mask, axis=-1, bitorder="little"
                                ),
                            )
                            # compacted nonzero values, row-major scan order
                            # (padded frames carry zero mask bits)
                            cap = ge["ysnz"][2][0]
                            nz = tail[mask]
                            if nz.size > cap:
                                raise BatchUnsupported(
                                    "floor1 ys nonzero stream overflow"
                                )
                            nz_w = np.zeros(cap, dtype=np.uint8)
                            nz_w[: nz.size] = nz
                            put(ge["ysnz"], nz_w)
                    else:
                        put(ge["posts"], g.posts.astype(np.uint8))
                        put(
                            ge["step2"],
                            np.packbits(
                                g.step2.astype(bool),
                                axis=-1,
                                bitorder="little",
                            ),
                        )
                else:
                    put(ge["coefficients"], g.coefficients)
                    put(ge["amplitude"], g.amplitude)

        total = plan.pcm_length
        host_args = [f32, i32, i16, u8]
        offs, ends, fbase_off = self._frame_tables(plan, buckets, padded_n)
        out_len = _pad_size(max(total, 1), 65536)
        if pads:
            out_len = max(out_len, pads.get("out_len", 0))
        evs = self._build_events(
            offs, ends, fbase_off, plan.segments, total
        )
        # events sorted by j, then padded to a quantized size with events
        # at j = out_len, which the assembly drops
        order = np.argsort(evs[0], kind="stable")
        evs = [a[order] for a in evs]
        E = len(evs[0])
        Ep = _pad_size(E, 64)
        if pads:
            Ep = max(Ep, pads.get("Ep", 0))
        for i_, a_ in enumerate(evs):
            pad_arr = np.full(
                Ep, out_len if i_ == 0 else 0, dtype=np.int32
            )
            pad_arr[:E] = a_
            host_args.append(pad_arr)
        seg_sig = ("ev", Ep)
        F_tab = 0
        # sig[6] is the dpack wire's rice flag: True for every other output
        rice = self._resolve_rice(device) if output in DPACK else True
        sig = (statics, tuple(padded_n), seg_sig, out_len, F_tab, output, rice)
        return sig, host_args, total

    # -- device half ------------------------------------------------------------

    def entries(self, sig):
        """The wire layout of ``sig`` (cached)."""
        cached = self._cache.get(("layout", sig))
        if cached is None:
            cached = self._layout(list(sig[0]), list(sig[1]), self.channels)[0]
            self._cache[("layout", sig)] = cached
            profiling.tally("layout")
        return cached

    def buckets(self, sig, bufs) -> list[dict]:
        """Per bucket of ``sig``: its key, metas, padded rows ``Fp``, ``n``,
        wire entry ``e``, padded_n record ``pn``, device ``tables`` and a
        ``take(slot)`` view into the device buffers ``bufs``."""
        if sig[5] not in OUTPUTS:
            raise ValueError(f"output {sig[5]!r} (not one of {OUTPUTS})")
        dev = bufs[0].device
        typed = dict(zip(("f32", "i32", "i16", "u8"), bufs[:4]))

        def take(slot_):
            tag, off, shape = slot_
            return typed[tag][off : off + int(np.prod(shape))].view(shape)

        return [
            {"key": key, "metas": metas, "Fp": pn[0], "n": pn[1], "e": e,
             "pn": pn, "tables": device_tables(self, key, dev), "take": take,
             "device": dev, "wire": typed["u8"], "k1": k1}
            for (key, metas), e, pn, k1 in zip(
                sig[0], self.entries(sig), sig[1], self.k1_tables(sig, dev))
        ]

    def k1_tables(self, sig, device) -> list:
        """Per bucket of ``sig``: K1's (descriptor table on ``device``,
        n_groups, n_blocks) (ops.residue_sym.bucket_table), None for a
        value-transport bucket. Made from the sig alone, so cached per sig
        and sent to the card once."""
        ck = ("k1", sig, str(device))
        cached = self._cache.get(ck)
        if cached is not None:
            return cached
        cached = []
        for (key, _), e, pn in zip(sig[0], self.entries(sig), sig[1]):
            if pn[2] != "sym":
                cached.append(None)
                continue
            subs = [
                (ss, [s[1] for s in e["syms"][si]],
                 [x[1] for x in e["idx"][si]], sub["vq_offs"], sub["ch_list"])
                for si, (ss, sub) in enumerate(
                    zip(pn[3], self._sym_static(key)["subs"]))
                if ss is not None
            ]
            table, n_groups, n_blocks = bucket_table(subs, pn[0])
            cached.append((torch.from_numpy(table).to(device), n_groups,
                           n_blocks))
        self._cache[ck] = cached
        profiling.tally("k1")
        return cached

    def residue_calls(self, bk) -> list:
        """(ch_list, args of ops.residue_sym.expand_submap_plain) per coded
        submap of bucket ``bk``, or (ch_list, None) for a submap with no
        coded region (zeros); none for a value-transport bucket. The
        per-submap reference form of ``residue_call``."""
        pn, e, take = bk["pn"], bk["e"], bk["take"]
        if pn[2] != "sym":
            return []
        calls = []
        for si, ss in enumerate(pn[3]):
            sub = bk["tables"]["subs"][si]
            if not sub["ch_list"]:
                continue
            args = None
            if ss is not None:
                args = (
                    (*ss, len(sub["ch_list"])),
                    [take(s) for s in e["syms"][si]],
                    [take(x) for x in e["idx"][si]],
                    sub["vqs"],
                    bk["Fp"],
                )
            calls.append((sub["ch_list"], args))
        return calls

    def residue_call(self, bk):
        """Args of ops.residue_sym.expand_bucket (K1) for a symbol-transport
        bucket ``bk``; None for a value-transport one."""
        if bk["k1"] is None:
            return None
        return (*bk["k1"], bk["wire"], bk["tables"]["vq"],
                (bk["Fp"], self.channels, bk["n"] // 2))

    def value_call(self, bk):
        """Args of ops.residue_values.residue_gather for a value-transport
        bucket ``bk``; None for a symbol-transport one."""
        pn, e, take = bk["pn"], bk["e"], bk["take"]
        if pn[2] == "sym":
            return None
        _, _, _, ptag, gtag = pn
        return (take(e["packed"]), take(e["gmap"]), ptag, gtag,
                (bk["Fp"], self.channels, bk["n"] // 2))

    def residues(self, bk) -> torch.Tensor:
        """[Fp, C, half] residues of bucket ``bk`` (K1, one launch over its
        groups, or K9 for the value-transport wire)."""
        args = self.residue_call(bk)
        if args is not None:
            return expand_bucket(*args)
        return residue_gather(*self.value_call(bk))

    def floor_calls(self, bk) -> list:
        """(channels, wire, args of FLOORS[wire]) per floor group of bucket
        ``bk``: wire "ys" or "posts" for floor1, "floor0" for floor0."""
        calls = []
        take = bk["take"]
        half = bk["n"] // 2
        for meta, g, tab, lev in zip(bk["metas"], bk["e"]["groups"],
                                     bk["tables"]["floors"],
                                     bk["tables"]["levels"]):
            ch = list(meta["channels"])
            if meta["type"] == 0:
                calls.append((ch, "floor0", (
                    take(g["coefficients"]), take(g["amplitude"]),
                    take(g["used"]), tab, meta["order"],
                    meta["amplitude_bits"], meta["amplitude_offset"],
                )))
                continue
            P = len(meta["xs"])
            if "ys01" in g:
                calls.append((ch, "ys", (
                    take(g["ys01"]),
                    take(g["ysmask"]) if P > 2 else None,
                    take(g["ysnz"]) if P > 2 else None,
                    take(g["used"]), tab, bk["tables"]["ab"], P,
                    meta["multiplier"], half, lev,
                )))
            else:
                calls.append((ch, "posts", (
                    take(g["posts"]), take(g["step2"]), take(g["used"]), tab,
                    bk["tables"]["ab"], P, meta["multiplier"], half,
                )))
        return calls

    def floors(self, bk) -> torch.Tensor:
        """[Fp, C, half] floor curves of bucket ``bk``."""
        return self.place(bk, [
            (ch, FLOORS[wire](*args))
            for ch, wire, args in self.floor_calls(bk)
        ])

    def place(self, bk, parts) -> torch.Tensor:
        """[Fp, C, half] from per-channel-group parts [(channels, [Fp, nc,
        half] or None for zeros)]; a single part holding every channel in
        order is returned as it is."""
        C = self.channels
        shape = (bk["Fp"], C, bk["n"] // 2)
        if len(parts) == 1 and parts[0][0] == list(range(C)) and (
            parts[0][1] is not None
        ):
            return parts[0][1].view(shape)
        out = torch.zeros(shape, device=bk["device"])
        for chans, v in parts:
            if v is not None:
                out[:, chans] = v.view(bk["Fp"], len(chans), -1)
        return out

    def dct(self, bk, spectra: torch.Tensor) -> torch.Tensor:
        """[Fp, C, half] spectra -> [Fp, C, half] DCT-IV output."""
        Fp, C, half = spectra.shape
        return dct_iv(spectra.view(Fp * C, half), *bk["tables"]["dct"]).view(
            Fp, C, half
        )

    def ola_bucket(self, bk, d: torch.Tensor):
        """The K4 operands of one bucket: (d, window, prime, final)."""
        take = bk["take"]
        return (d, bk["tables"]["window"], take(bk["e"]["prime"]),
                take(bk["e"]["final"]))

    def forward(self, sig, bufs) -> torch.Tensor:
        """Device synthesis of one prepared chunk: ``bufs`` are the nine
        host arrays of prepare_host as tensors on one device. Returns, on
        that device, by output sig[5]: "f32" PCM [C, out_len] float32;
        "s16" int16 [C, out_len]; "s16p" u8 [2, C, out_len]; "s16d" and
        "s16df" the dpack wire, u8 (the kept samples are the first
        ``total`` columns)."""
        bks = self.buckets(sig, bufs)
        # K3 once over every bucket's residues and floors
        _, spectra = couple_spectrum_chunk([
            (self.residues(bk), self.floors(bk), bk["tables"]["steps"])
            for bk in bks])
        ola_buckets = [self.ola_bucket(bk, self.dct(bk, sp))
                       for bk, sp in zip(bks, spectra)]
        output, L, C, rice = sig[5], sig[3], self.channels, sig[6]
        if output not in DPACK:
            return ola_assemble(ola_buckets, bufs[4:9], L, output)
        caps = wire_caps(wire_rows(L, C), output == "s16df")
        # K4 writes the select straight into the wire's widx table
        wire, widx = wire_buffer(C, L, *caps[:2], rice, bufs[0].device)
        q, wbyte, ubits = ola_assemble(ola_buckets, bufs[4:9], L, "dpack",
                                       rice=rice, wbyte=widx)
        return dpack_wire(q, *caps, rice=rice, select=(wbyte, ubits),
                          wire=wire)

    def assemble(self, plan: FramePlan, buckets: list[BucketBatch],
                 output: str = "f32", device="cuda"):
        """prepare_host, upload and forward of one plan on ``device``'s
        dispatch stream (models/launch.py), which the current stream then
        waits for. Returns, on the device, the kept samples
        ``out[..., :total]``, or for the dpack wires ("s16d", "s16df")
        ("dpack", wire, nbt, out_len, total), as the reference's
        ``BatchSynthesizer.run`` does; [C, 0] zeros for no buckets."""
        dev = resolve_device(device)
        if not buckets:
            dt = torch.int16 if output == "s16" else torch.float32
            return torch.zeros((self.channels, 0), dtype=dt, device=dev)
        rec = profiling.CallSpans()
        trip = launch(self, plan, buckets, output, dev, rec)
        out = hand_over(trip)
        if output in DPACK:
            L = trip.sig[3]
            return ("dpack", out, wire_rows(L, self.channels), L, trip.total)
        return out


_PTAG_ORDER = {"u8b": 0, "i16": 1, "f32": 2}


def sig_pads(sig) -> dict:
    """Extract the padded dimensions / wire dtypes of one prepare_host sig
    as a pads dict (the hint format prepare_host consumes)."""
    pads: dict = {}
    statics, padded_n, seg_sig, out_len = sig[0], sig[1], sig[2], sig[3]
    for (key, _metas), pn in zip(statics, padded_n):
        pads[("Fp", key)] = pn[0]
        for gi, meta in enumerate(_metas):
            m = dict(meta)
            if m.get("wire") == "ys":
                pads[("ysnz", key, gi)] = m["nz_cap"]
        if pn[2] == "sym":
            g_seq = 0
            for ss in pn[3]:
                if ss is None:
                    continue
                for (_w, _d, _nsym, _fmt1, np_pad) in ss[7]:
                    pads[("np", key, g_seq)] = np_pad
                    g_seq += 1
        else:
            pads[("Kp", key)] = pn[2]
            pads[("ptag", key)] = pn[3]
            if pn[4] == "i32":
                pads[("gtag", key)] = "i32"
    if seg_sig and seg_sig[0] == "ev":
        pads["Ep"] = seg_sig[1]
    pads["out_len"] = out_len
    return pads


def merge_pads(sigs) -> dict:
    """Elementwise maximum of each sig's pads: preparing every shard with
    the merged pads yields identical sigs whenever the shards share a setup
    and bucket-key list (parallel/corpus.py's one-sig precondition)."""
    out: dict = {}
    for sig in sigs:
        for k, v in sig_pads(sig).items():
            if isinstance(v, str):
                cur = out.get(k)
                if cur is None or _PTAG_ORDER.get(v, 9) > _PTAG_ORDER.get(cur, -1):
                    out[k] = v
            else:
                out[k] = max(out.get(k, 0), v)
    return out


def device_tables(synth: BatchSynthesizer, key, device) -> dict:
    """The static per-bucket tensors ("weights") of ``key`` on ``device``,
    cached per (key, device) — the key carries the setup id:

    window [n] f32; dct (hi, lo) [n/2, n/2] f32; steps int32 [S, 2]
    (coupling); vq: the key's VQ tables end to end, f32 (K1 reads them
    there; None without symbol transport); subs: per submap ch_list and
    its VQ tables [entries+1, d] f32 (zero row last), views into vq;
    floors: per floor group its static table, int32 for
    floor1 (ops/floor.floor1_tables) and f32 [3, half] for floor0
    (ops/floor.floor0_tables: cos_w and the two tail factors); levels: per
    floor group K2's unwrap order, int32 for floor1
    (ops/floor.floor1_levels), None for floor0; ab [32] f32 (A then B)."""
    device = torch.device(device)
    ck = ("tables", key, str(device))
    cached = synth._cache.get(ck)
    if cached is not None:
        return cached
    setup = synth._setup_for(key)
    mode = setup.modes[key.mode_idx]
    mapping = setup.mappings[mode.mapping_idx]
    n, window, steps = synth._bucket_static(key)
    half = n // 2

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    subs, vq = [], None
    if getattr(setup, "_sym_layout", None) is not None:
        st = synth._sym_static(key)
        vq = put(st["vq_all"])
        for sub in st["subs"]:
            subs.append({"ch_list": sub["ch_list"], "vqs": [
                vq[o : o + (e + 1) * v.shape[1]].view(e + 1, v.shape[1])
                for (o, e), v in zip(sub["vq_offs"], sub["vqs"])]})
    groups = _bucket_groups(mapping, synth.channels)
    floors = [
        put(floor1_tables(g.floor.xs, half)) if g.floor.floor_type == 1
        else put(floor0_tables(g.floor._maps[n], g.floor.bark_map_size,
                               g.floor.order))
        for g in groups
    ]
    levels = [put(floor1_levels(g.floor.xs)) if g.floor.floor_type == 1
              else None for g in groups]
    hi, lo = dct_iv_basis(half)
    tables = {
        "window": put(window),
        "dct": (put(hi), put(lo)),
        "steps": put(np.asarray(steps, dtype=np.int32).reshape(-1, 2)),
        "subs": subs,
        "vq": vq,
        "floors": floors,
        "levels": levels,
        "ab": put(inverse_db_tables()),
    }
    synth._cache[ck] = tables
    profiling.tally("tables")
    return tables


# -- stream-level drivers -----------------------------------------------------


def decode_stream_batch(provider, *, device="cuda", clip_samples: bool = True,
                        stats=None, max_frames: int | None = None
                        ) -> np.ndarray:
    """Decode one logical stream entirely through the batch pipeline on
    ``device``. Returns planar float32 PCM [channels, samples] on the
    host. Raises BatchUnsupported for stream shapes the planner does not
    model (callers fall back to the scalar StreamDecoder). Pass a
    StreamStats as ``stats`` to receive the bit accounting, as the
    reference's decode_stream_batch fills it.

    ``max_frames`` bounds memory for very long streams: the plan splits
    into pieces that decode one after another into their slices of the
    answer (frames.split_plan; each piece's own program, so on the card
    only the anchor budget holds across splits, not bit equality)."""
    dev = resolve_device(device)
    dec = StreamDecoder(provider)
    dec.initialize()
    setup = dec._setup
    plan = build_plan(provider, setup)
    plans = split_plan(plan, max_frames) if max_frames else [plan]
    synth = BatchSynthesizer(setup, dec.channels)
    pcm = np.empty((dec.channels, plan.pcm_length), dtype=np.float32)
    at = 0
    for p in plans:
        buckets = extract_batch(p, setup, dec.channels, ident=dec._ident)
        part = synth.assemble(p, buckets, device=dev).cpu().numpy()
        pcm[:, at : at + part.shape[1]] = part
        at += part.shape[1]
    if clip_samples:
        np.clip(pcm, -CLIP_MAX, CLIP_MAX, out=pcm)
    if stats is not None:
        stats.sample_rate = dec.sample_rate
        stats.header_bits += dec.stats.header_bits
        stats.container_bits += dec.stats.container_bits
        for fr in plan.frames:
            stats.add_packet(
                samples=fr.info.sample_count,
                audio_bits=8 * len(fr.packet.data),
                waste_bits=0,
                container_bits=fr.packet.container_bits,
            )
    return pcm


def decode_file_batch(source, *, device="cuda", clip_samples: bool = True,
                      max_frames: int | None = None) -> np.ndarray:
    """Open an Ogg file (path, bytes or binary file object) and
    batch-decode its first Vorbis stream (decode_stream_batch)."""
    if isinstance(source, str):
        f = open(source, "rb")
    elif isinstance(source, (bytes, bytearray)):
        f = io.BytesIO(source)
    else:
        f = source
    try:
        container = OggContainer(f)
        if not container.try_init():
            raise BatchUnsupported("no logical stream found")
        return decode_stream_batch(container.providers[0], device=device,
                                   clip_samples=clip_samples,
                                   max_frames=max_frames)
    finally:
        if f is not source:
            f.close()
