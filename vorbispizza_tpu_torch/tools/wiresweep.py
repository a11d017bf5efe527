"""Offline (host-only) dpack wire-size sweep: what would finer width
granularity, smaller blocks, or Rice coding save on the bench corpus?

Port of vorbispizza_tpu/tools/wiresweep.py. Every candidate wire change
gets sized here on decoded PCM before any device implementation is
attempted: a pure numpy mirror of the dpack wire's candidate selection
(d2/d3 x intra/inter) over ops/pcm_pack.py's constants. The PCM is
decoded by native libvorbisfile (testing/oracle.py) where it loads, else
by the port's float64 ``reader.VorbisReader``; the first line printed
names the decoder. The streams are the bench corpus's recipe (stereo
music at q0.5): the committed members of testdata/corpus32 for 15 s
streams, libvorbisenc encodes of the same recipe for other lengths.

The reference records these findings (8x15 s stereo q0.5, raw s16
21.2 MB; sizes are of the host-side wire, so they carry over):
  current (width rungs, d2/d3 x intra/inter)   0.211 of raw
  exact widths / B=64 / B=32                   <=2.4% better — rejected
  escape coding (base plane + outlier list)    ~3% better — rejected
  rice, k in rungs, same candidates ("mixed")  0.179 of raw = 0.847x — LANDED
  rice + d1/d4 extended predictors             0.175 (+1.6%) — rejected
  order-0 entropy bound of chosen candidates   0.187 (rice's per-block
  adaptation beats the global memoryless bound)

Usage: python -m vorbispizza_tpu_torch.tools.wiresweep [n_streams] [seconds]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from ..ops.pcm_pack import BLOCK, WIDTHS, pair_partner
from ..testing import oracle


def decoder_name() -> str:
    if oracle.available():
        return "libvorbisfile (testing/oracle.py)"
    return ("the port's float64 reader.VorbisReader (libvorbisfile.so.3 "
            "does not load)")


def _sources(n_streams: int, seconds: float, rate: int):
    if seconds == 15.0 and rate == 44100 and n_streams <= 32:
        from ..testing.corpus32 import load_corpus

        return load_corpus()[:n_streams]
    from ..testing.encode import encode_vorbis, make_signal

    return [
        encode_vorbis(
            make_signal(2, seconds, rate=rate, kind="music", seed=seed),
            rate=rate,
            quality=0.5,
        )
        for seed in range(n_streams)
    ]


def _decode(data: bytes) -> np.ndarray:
    """Planar float32 PCM of ``data``'s first logical stream."""
    if not oracle.available():
        from ..reader import VorbisReader

        r = VorbisReader(data)
        r.initialize()
        return r.read_all(planar=True)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "v.ogg")
        with open(path, "wb") as f:
            f.write(data)
        segs = oracle.OracleDecoder(path).read_all_float()
    return np.concatenate([b for _, b in segs], axis=1)


def decoded_s16(n_streams: int, seconds: float, rate: int = 44100):
    outs = []
    for data in _sources(n_streams, seconds, rate):
        pcm = _decode(data)
        q = np.clip(np.rint(pcm.astype(np.float64) * 32768.0), -32768, 32767)
        outs.append(q.astype(np.int32))
    return outs


def zigzag(d):
    return ((d << 1) ^ (d >> 31)).astype(np.uint32).astype(np.int64)


def candidates(q: np.ndarray, extended: bool = False):
    """Per-channel candidates in zigzag space, [K, C, L]. ``extended``
    adds d1/d4 (FLAC's remaining fixed predictors) to size whether more
    orders compound with better per-block coding."""
    C, L = q.shape
    d1 = np.diff(q, axis=1, prepend=0)
    d2 = np.diff(d1, axis=1, prepend=0)
    d3 = np.diff(d2, axis=1, prepend=0)
    d4 = np.diff(d3, axis=1, prepend=0)
    partner = pair_partner(C)
    cands = [zigzag(d2), zigzag(d3)]
    ok = [np.ones(C, bool), np.ones(C, bool)]
    if extended:
        cands += [zigzag(d1), zigzag(d4)]
        ok += [np.ones(C, bool), np.ones(C, bool)]
    if C >= 2:
        cands += [zigzag(d2 - d2[partner]), zigzag(d3 - d3[partner])]
        paired = partner != np.arange(C)
        ok += [paired, paired]
        if extended:
            cands += [zigzag(d1 - d1[partner]), zigzag(d4 - d4[partner])]
            ok += [paired, paired]
    return np.stack(cands), np.stack(ok)


def as_blocks(z: np.ndarray, B: int):
    K, C, L = z.shape
    NB = -(-L // B)
    pad = NB * B - L
    if pad:
        z = np.pad(z, ((0, 0), (0, 0), (0, pad)))
    return z.reshape(K, C * NB, B), NB


def bits_width(blocks, widths=None):
    """Per-block payload bits under block-width coding. widths=None ->
    exact bit widths 0..18; else round up to the given rung table."""
    m = blocks.max(axis=-1)
    w = np.zeros(m.shape, dtype=np.int64)
    nz = m > 0
    w[nz] = np.floor(np.log2(m[nz])).astype(np.int64) + 1
    if widths is not None:
        rungs = np.asarray(widths, dtype=np.int64)
        w = rungs[np.searchsorted(rungs, w)]
    return w * blocks.shape[-1]


def bits_rice(blocks, kmax=16, ks=None, aligned=False):
    """Optimal per-block Rice parameter k: bits = sum(v >> k) + B*(k+1).
    ``ks`` restricts k to a rung table (the device k-plane packs through
    the existing width-selection matmul, so k must come from WIDTHS).
    ``aligned`` pads each block's unary segment to a u32 word — the
    LANDED wire (block-local device construction; ~0.9% extra)."""
    B = blocks.shape[-1]
    best = None
    for k in ks if ks is not None else range(kmax):
        u = (blocks >> k).sum(axis=-1) + B
        if aligned:
            u = ((u + 31) // 32) * 32
        b = u + B * k
        best = b if best is None else np.minimum(best, b)
    return best


def bits_escape(blocks, widths, exc_bytes=3):
    """Per-block escape coding: base plane at w bits + fixed-size
    exceptions (pos byte + high bits) for samples exceeding w, +1 count
    byte when any. Cost = B*w + 8*exc_bytes*n_over(w) (+8 if n_over>0),
    minimized over w in `widths` (w>=2 so 18-w fits 16 bits)."""
    B = blocks.shape[-1]
    best = None
    for w in widths:
        if w and w < 2:
            continue
        lim = (1 << w) - 1
        n_over = (blocks > lim).sum(axis=-1)
        b = B * w + 8 * exc_bytes * n_over + 8 * (n_over > 0)
        best = b if best is None else np.minimum(best, b)
    return best


def choose(bits_kc, ok):
    """bits [K, CNB] + per-channel validity [K, C] -> min over candidates."""
    K, CNB = bits_kc.shape
    C = ok.shape[1]
    NB = CNB // C
    mask = np.repeat(ok, NB, axis=1)
    masked = np.where(mask, bits_kc, np.int64(1) << 40)
    return masked.min(axis=0)


def order0_entropy_bits(blocks, chosen_bits, z):
    """Empirical order-0 entropy of the chosen candidate's zigzag values —
    a bound on any memoryless per-sample coder."""
    vals = z.reshape(-1)
    vals = np.minimum(vals, 1 << 20)
    cnt = np.bincount(vals)
    p = cnt[cnt > 0] / vals.size
    return float(-(p * np.log2(p)).sum() * vals.size)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 8
    secs = float(argv[1]) if len(argv) > 1 else 15.0
    print(f"decoder: {decoder_name()}", flush=True)
    streams = decoded_s16(n, secs)
    totals: dict[str, float] = {}
    raw_total = 0
    ent_total = 0.0
    rice_ks = tuple(w for w in WIDTHS if w <= 15)
    for q in streams:
        C, L = q.shape
        raw_total += C * L * 2
        zx, okx = candidates(q, extended=True)
        bx, _ = as_blocks(zx, BLOCK)
        hdrx = bx.shape[1]  # C*NB width bytes
        for tag, ks in (("rice_ext", None), ("rice_extW", rice_ks)):
            r = choose(bits_rice(bx, ks=ks), okx)
            totals[tag] = totals.get(tag, 0) + (r.sum() / 8 + hdrx)
        # mixed: per block free choice between rice and plain width coding
        # (the real wire: bit 7 selects; k/width share the rung table)
        mixed = choose(
            np.minimum(
                bits_rice(bx, ks=rice_ks), bits_width(bx, WIDTHS)
            ),
            okx,
        )
        totals["mixed_extW"] = totals.get("mixed_extW", 0) + (
            mixed.sum() / 8 + hdrx
        )
        z0, ok0 = candidates(q)
        b0, _ = as_blocks(z0, BLOCK)
        landed = choose(
            np.minimum(
                bits_rice(b0, ks=rice_ks, aligned=True),
                bits_width(b0, WIDTHS),
            ),
            ok0,
        )
        totals["LANDED"] = totals.get("LANDED", 0) + (
            landed.sum() / 8 + hdrx
        )
        z, ok = candidates(q)
        for B in (128, 64, 32):
            blocks, NB = as_blocks(z, B)
            hdr = blocks.shape[1]  # one width byte per block
            exact = choose(bits_width(blocks), ok)
            totals[f"exact_B{B}"] = totals.get(f"exact_B{B}", 0) + (
                exact.sum() / 8 + hdr
            )
            rice = choose(bits_rice(blocks), ok)
            totals[f"rice_B{B}"] = totals.get(f"rice_B{B}", 0) + (
                rice.sum() / 8 + hdr
            )
            if B == BLOCK:
                mixedb = choose(
                    np.minimum(
                        bits_rice(blocks, ks=rice_ks),
                        bits_width(blocks, WIDTHS),
                    ),
                    ok,
                )
                totals["mixed_base"] = totals.get("mixed_base", 0) + (
                    mixedb.sum() / 8 + hdr
                )
                for tag, ws, eb in (
                    ("esc_W", WIDTHS, 3),
                    ("esc_all", range(2, 19), 3),
                    ("esc_all2B", range(2, 19), 2),
                ):
                    esc = choose(bits_escape(blocks, ws, eb), ok)
                    totals[f"{tag}_B{B}"] = totals.get(
                        f"{tag}_B{B}", 0
                    ) + (esc.sum() / 8 + hdr)
            if B == BLOCK:
                cur = choose(bits_width(blocks, WIDTHS), ok)
                totals["current"] = totals.get("current", 0) + (
                    cur.sum() / 8 + hdr
                )
                # entropy bound over the current scheme's chosen candidate
                bb = bits_width(blocks, WIDTHS)
                K = bb.shape[0]
                mask = np.repeat(ok, NB, axis=1)
                masked = np.where(mask, bb, np.int64(1) << 40)
                best_k = masked.argmin(axis=0)
                zc = np.take_along_axis(
                    blocks, best_k[None, :, None], axis=0
                )[0]
                ent_total += order0_entropy_bits(blocks, None, zc) / 8

    audio_mb_raw = raw_total / 1e6
    print(f"corpus: {n} x {secs}s stereo q0.5  raw s16 {audio_mb_raw:.1f} MB")
    cur = totals["current"]
    for k in sorted(totals, key=totals.get):
        v = totals[k]
        print(
            f"{k:12s} {v / 1e6:8.2f} MB  ratio_raw {v / raw_total:6.3f}"
            f"  vs_current {v / cur:6.3f}"
        )
    print(
        f"{'entropy0':12s} {ent_total / 1e6:8.2f} MB  ratio_raw"
        f" {ent_total / raw_total:6.3f}  vs_current {ent_total / cur:6.3f}"
        "   (order-0 bound, chosen candidate)"
    )


if __name__ == "__main__":
    main()
