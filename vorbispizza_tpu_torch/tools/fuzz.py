"""Offline robustness fuzzer: randomized streams, stream corruption, and
chained/multiplexed compositions against the scalar decoder and the batch
pipeline, on a device.

Port of vorbispizza_tpu/tools/fuzz.py. It runs until a wall-clock budget
expires and prints a repro line for every failure. The robustness
contract checked on every trial:

- a corrupt stream either raises ``VorbisError`` (loud rejection) or
  decodes; any OTHER exception is a bug;
- whenever both paths decode, batch == scalar within TOL (2e-6 on the
  CPU, 1e-6 on a card), s16 within 1 LSB of the quantized scalar PCM;
- no trial may wedge: a trial slower than _SLOW_S is reported.

Base streams: libvorbisenc encodes of random (channels, rate, quality or
bitrate, signal) where libvorbisenc loads, as in the reference; where it
does not (a machine without libogg), the port's spec-corner generators
(testing/rawstream.py) at random sizes, rates and seeds, and the
committed corpus's members (testdata/corpus32) cut to a random number of
pages; every base stream gets the trial's serial. floor0 streams are left
out of that pool: their float32 LSP synthesis is held to its own share
budget (chip_smoke.py), not to TOL. The seek trial holds the accelerated
reader to native libvorbisfile where it loads, else to the scalar reader.

Usage: python -m vorbispizza_tpu_torch.tools.fuzz [budget_seconds=300]
           [seed0=0] [shapes] [--device cuda|cpu]
``shapes`` (optional) is a comma-list restricting the trial pool (e.g.
``corpus`` or ``seek,corrupt``) for targeted regression hunting.
Exit status 1 if any trial failed.
"""

from __future__ import annotations

import argparse
import functools
import struct
import sys
import time
import traceback

import numpy as np

#: wedge heuristic: only multi-minute trials are suspicious
_SLOW_S = 120.0

_RATES = (8000, 11025, 16000, 22050, 32000, 44100, 48000, 96000)
_CHANNELS = (1, 2, 3, 4, 5, 6, 8)

#: batch against scalar, f32 max-abs, by device type
TOL = {"cpu": 2e-6, "cuda": 1e-6}
#: s16 against the quantized scalar PCM
S16_LSB = 1

#: spec-corner generators of the pool without libvorbisenc
_RAW = ("make_extreme_blocksize_stream", "make_multisubmap_stream",
        "make_oddbooks_stream", "make_lookup2_stream")


@functools.lru_cache(maxsize=None)
def _vorbisenc() -> bool:
    from ..testing.streams import vorbisenc_available

    return vorbisenc_available()


@functools.lru_cache(maxsize=1)
def _corpus() -> tuple:
    from ..testing.corpus32 import load_corpus

    return tuple(load_corpus())


def _pages(data: bytes) -> list:
    """(offset, size) of each page of a well-formed physical stream."""
    out, pos = [], 0
    while pos + 27 <= len(data) and data[pos : pos + 4] == b"OggS":
        nseg = data[pos + 26]
        size = 27 + nseg + sum(data[pos + 27 : pos + 27 + nseg])
        out.append((pos, size))
        pos += size
    return out


def reserial(data: bytes, serial: int, n_pages: int | None = None) -> bytes:
    """``data`` with every page's serial set to ``serial``; cut to its
    first ``n_pages`` pages (the last one flagged end-of-stream) when
    given. CRCs are recomputed."""
    from ..ogg.crc import ogg_crc

    pages = _pages(data)
    if n_pages is not None:
        pages = pages[:n_pages]
    out = []
    for k, (off, size) in enumerate(pages):
        page = bytearray(data[off : off + size])
        page[14:18] = struct.pack("<I", serial & 0xFFFFFFFF)
        if n_pages is not None and k == len(pages) - 1:
            page[5] |= 4
        page[22:26] = b"\0\0\0\0"
        page[22:26] = struct.pack("<I", ogg_crc(bytes(page)))
        out.append(bytes(page))
    return b"".join(out)


def _random_stream(rng: np.random.Generator, serial: int = 1) -> bytes:
    """A random base stream (see the module docstring). Raises
    RuntimeError when libvorbisenc rejects the combination."""
    if not _vorbisenc():
        return _stock_stream(rng, serial)
    from ..testing.encode import encode_vorbis, make_signal

    ch = int(rng.choice(_CHANNELS))
    rate = int(rng.choice(_RATES))
    kind = str(rng.choice(["music", "sine", "noise"]))
    sig = make_signal(ch, float(rng.uniform(0.25, 0.8)), rate=rate, kind=kind,
                      seed=int(rng.integers(0, 2**31)))
    if rng.random() < 0.25:  # bitrate-managed vintage
        bitrate = int(rng.choice([32000, 64000, 128000, 256000])) * max(1, ch // 2)
        return encode_vorbis(sig, rate=rate, serial=serial, bitrate=bitrate)
    return encode_vorbis(sig, rate=rate, serial=serial,
                         quality=float(rng.uniform(-0.1, 1.0)))


def _stock_stream(rng: np.random.Generator, serial: int) -> bytes:
    """A base stream without libvorbisenc: a committed corpus member cut
    to 8-40 pages (a third of the draws), else a spec-corner generator."""
    from ..testing import rawstream

    if rng.random() < 1 / 3:
        data = _corpus()[int(rng.integers(0, len(_corpus())))]
        return reserial(data, serial, int(rng.integers(8, 41)))
    make = getattr(rawstream, str(rng.choice(_RAW)))
    data = make(n_packets=int(rng.integers(8, 41)),
                rate=int(rng.choice([8000, 16000, 22050, 44100])),
                seed=int(rng.integers(0, 2**31)))
    return reserial(data, serial)


def _corrupt(rng: np.random.Generator, data: bytes) -> bytes:
    """One random mutation. Header bytes are fair game: corrupt headers
    must be rejected loudly, not crash."""
    bad = bytearray(data)
    mode = str(rng.choice(["bitflip", "truncate", "shear", "dup", "swap", "zero"]))
    if mode == "bitflip":
        for pos in rng.integers(0, len(bad), size=int(rng.integers(1, 8))):
            bad[int(pos)] ^= int(rng.integers(1, 256))
    elif mode == "truncate":
        bad = bad[: int(rng.integers(1, len(bad)))]
    elif mode == "shear":
        cut = int(rng.integers(0, len(bad) - 1))
        del bad[cut: cut + int(rng.integers(1, 5000))]
    elif mode == "dup":  # duplicate a span in place (fake page replay)
        cut = int(rng.integers(0, len(bad) - 1))
        span = bytes(bad[cut: cut + int(rng.integers(100, 6000))])
        bad[cut:cut] = span
    elif mode == "swap":  # transpose two spans (page reorder analog)
        n = len(bad)
        a, b = sorted(int(x) for x in rng.integers(0, max(1, n - 4000), size=2))
        w = int(rng.integers(100, 4000))
        bad[a: a + w], bad[b: b + w] = bad[b: b + w], bad[a: a + w]
    else:
        cut = int(rng.integers(0, len(bad) - 1))
        w = int(rng.integers(100, 6000))
        bad[cut: cut + w] = bytes(min(w, len(bad) - cut))
    return bytes(bad)


def _decode_scalar(data: bytes):
    from ..reader import VorbisReader

    r = VorbisReader(data)
    r.initialize()
    out = [r.read_all(planar=True)]
    while r.find_next_stream():  # walk every logical stream (chains/mux)
        if r.switch_streams(r.streams_count - 1):
            pass
        out.append(r.read_all(planar=True))
    return out


def _s16(pcm) -> np.ndarray:
    return np.clip(np.rint(np.asarray(pcm, dtype=np.float64) * 32768.0),
                   -32768, 32767)


def _seek_trial(rng: np.random.Generator, device: str) -> str:
    """Randomized seek differential: after seeking both to the same
    sample, the next 512 samples must agree within the s16 band (the
    tests/test_seek_oracle.py contract, randomized over streams,
    positions, and seek direction). The other decoder is native
    libvorbisfile where it loads, else the port's scalar reader."""
    import os
    import tempfile

    from ..reader import VorbisReader
    from ..testing import oracle

    try:
        data = _random_stream(rng)
    except RuntimeError:
        return "skip"
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "v.ogg")
        with open(path, "wb") as f:
            f.write(data)
        accelerated = bool(rng.random() < 0.5)
        r = VorbisReader(path, accelerated=accelerated, device=device)
        r.initialize()
        if oracle.available():
            nat = oracle.OracleDecoder(path)
            total = min(r.total_samples, nat.total)
        else:
            nat = VorbisReader(path)
            nat.initialize()
            total = min(r.total_samples, nat.total_samples)
        if total < 4096:
            return "skip"
        for pos in rng.integers(0, total - 1024, size=4):  # unsorted:
            # backward seeks exercise the bisection restart + preroll
            pos = int(pos)
            if isinstance(nat, oracle.OracleDecoder):
                nat.seek(pos)
                want = nat.read_float_n(512)
            else:
                nat.seek_to(pos)
                want = nat.read_samples(512).T
            r.seek_to(pos)
            got = r.read_samples(512).T
            m = min(want.shape[1], got.shape[1])
            assert m >= 256, (pos, m)
            assert np.abs(_s16(got[:, :m]) - _s16(want[:, :m])).max() <= 2, pos
    return "ok"


def _verify_against_scalar(sources, outs, output, label, device):
    """Shared contract check for the corpus-family trials: a None slot is
    acceptable only when the scalar decoder also rejects; when both
    produce PCM they must agree (f32 within TOL, s16 within S16_LSB)."""
    from ..decoder import CLIP_MAX
    from ..errors import VorbisError
    from ..reader import VorbisReader

    for src, got in zip(sources, outs):
        try:
            r = VorbisReader(src)
            r.initialize()
            ref = r.read_all(planar=True)  # first logical stream
        except VorbisError:
            continue  # scalar rejects: any corpus outcome is in contract
        assert got is not None, f"{label} dropped a file the scalar decodes"
        assert got.shape == ref.shape, (got.shape, ref.shape)
        if not got.size:
            continue
        if output == "f32":
            ref = np.clip(ref, -CLIP_MAX, CLIP_MAX)
            err = float(np.abs(got - ref).max())
            assert err <= TOL[_kind(device)], f"{label}: {err}"
        else:
            lsb = np.abs(got.astype(np.int64) - _s16(ref)).max()
            assert lsb <= S16_LSB, f"{label}: {lsb} LSB"


def _kind(device) -> str:
    import torch

    return torch.device(device).type


def _sources(rng, serial0: int, p_corrupt: float):
    sources = []
    for k in range(int(rng.integers(2, 6))):
        try:
            s = _random_stream(rng, serial=serial0 + k)
        except RuntimeError:
            continue
        if rng.random() < p_corrupt:
            s = _corrupt(rng, s)
        sources.append(s)
    return sources


def _corpus_trial(rng: np.random.Generator, device: str) -> str:
    """Randomized corpus composition through decode_corpus: mixed
    channels/rates/qualities (shared and distinct setups), a possibly
    corrupt member under on_error='none', a small max_batch_bytes to force
    chunk splits/merges and, in some trials, the chunks round-robin over
    the device repeated 2-4 times. Exercises the merge, the dispatch
    thread, the collectors and failure isolation. Contract per file: a
    None slot is acceptable only when the scalar decoder also rejects;
    when both produce PCM they must agree."""
    from ..models.corpus import decode_corpus

    sources = _sources(rng, 200, 0.25)
    if len(sources) < 2:
        return "skip"
    output = str(rng.choice(["s16", "f32"]))
    devices = None
    if rng.random() < 0.3:  # multi-device round-robin dispatch
        devices = [device] * int(rng.integers(2, 5))
    outs = decode_corpus(
        sources, device=device, output=output, on_error="none",
        max_batch_bytes=int(rng.integers(1, 5)) << 20,
        devices=devices,
    )
    _verify_against_scalar(sources, outs, output, "corpus", device)
    return "ok"


def _sharded_trial(rng: np.random.Generator, device: str) -> str:
    """decode_corpus_sharded over a stream mesh of the device repeated 2
    or 4 times vs per-file scalar: exercises LPT balancing, signature
    unification across shards, the wire-size sum, and the degradation
    ladder under the same randomized compositions as the corpus trial."""
    from ..parallel.corpus import decode_corpus_sharded
    from ..parallel.mesh import Mesh

    mesh = Mesh([device] * int(rng.choice([2, 4])), ("stream",))
    sources = _sources(rng, 300, 0.2)
    if len(sources) < 2:
        return "skip"
    output = str(rng.choice(["s16", "f32"]))
    outs = decode_corpus_sharded(sources, mesh, output=output,
                                 on_error="none")
    _verify_against_scalar(sources, outs, output, "sharded corpus", device)
    return "ok"


#: default trial pool (weights = repetition)
SHAPES = ("single", "single", "corrupt", "corrupt", "corrupt",
          "chain", "mux", "chain_corrupt", "seek", "seek",
          "corpus", "corpus", "sharded")


def _one_trial(rng: np.random.Generator, shapes=SHAPES, device="cuda",
               info: dict | None = None) -> str:
    """Returns 'ok' | 'skip' | 'reject'. Raises on contract violation.
    ``info`` receives the trial's shape."""
    from ..errors import VorbisError
    from ..frames import BatchUnsupported
    from ..models.pipeline import decode_file_batch
    from ..testing.encode import chain_streams, multiplex_streams

    shape = str(rng.choice(list(shapes)))
    if info is not None:
        info["shape"] = shape
    if shape == "seek":
        return _seek_trial(rng, device)
    if shape == "corpus":
        return _corpus_trial(rng, device)
    if shape == "sharded":
        return _sharded_trial(rng, device)
    try:
        if shape in ("chain", "mux", "chain_corrupt"):
            parts = [_random_stream(rng, serial=100 + k)
                     for k in range(int(rng.integers(2, 4)))]
            data = (multiplex_streams(*parts) if shape == "mux"
                    else chain_streams(*parts))
            if shape == "chain_corrupt":
                data = _corrupt(rng, data)
        else:
            data = _random_stream(rng, serial=int(rng.integers(1, 2**31)))
            if shape == "corrupt":
                data = _corrupt(rng, data)
    except RuntimeError:
        return "skip"  # encoder rejected the config — not our surface

    try:
        ref = _decode_scalar(data)
    except VorbisError:
        ref = None  # loud rejection is within contract
    if shape == "mux":
        return "ok" if ref is not None else "reject"  # batch path is per-logical-stream

    try:
        got = decode_file_batch(data, device=device)
    except (VorbisError, BatchUnsupported):
        # batch may reject earlier than scalar; BatchUnsupported means the
        # batch planner declined the stream — production decode_corpus
        # falls back to the scalar path for exactly this case
        return "reject" if ref is None else "ok"
    if ref is None:
        return "ok"  # scalar rejected, batch found a decodable prefix
    want = ref[0]  # batch pipeline decodes the FIRST logical stream only
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.size:
        err = float(np.abs(got - want).max())
        assert err <= TOL[_kind(device)], f"batch/scalar diverge: {err}"
    return "ok"


def run(budget: float, seed0: int = 0, shapes=SHAPES, device="cuda",
        shape_arg: str = "", log=print) -> dict:
    """Trials with seeds seed0, seed0 + 1, ... until ``budget`` seconds
    have passed. Returns {"trials", "seconds", "stats": counts by status
    (ok, skip, reject, fail, slow), "by_shape": {shape: {status: n}},
    "failed": [seeds]}."""
    from ..device import resolve_device

    resolve_device(device)  # a CUDA request without CUDA raises here
    t0 = time.time()
    stats = {"ok": 0, "skip": 0, "reject": 0, "fail": 0, "slow": 0}
    by_shape: dict = {}
    failed = []
    trial = 0
    while time.time() - t0 < budget:
        seed = seed0 + trial
        rng = np.random.default_rng(seed)
        info: dict = {}
        t1 = time.time()
        try:
            status = _one_trial(rng, shapes, device, info)
        except Exception:
            status = "fail"
            failed.append(seed)
            # repro must carry the SAME shape filter: the pool size
            # changes how the seed's rng draws map to a trial
            log(f"FAIL seed={seed} (repro: tools.fuzz 1 {seed}{shape_arg} "
                f"--device {device})")
            log(traceback.format_exc())
        stats[status] += 1
        row = by_shape.setdefault(info.get("shape", "?"), {})
        row[status] = row.get(status, 0) + 1
        dt = time.time() - t1
        if dt > _SLOW_S:
            stats["slow"] += 1
            log(f"SLOW seed={seed} took {dt:.1f}s")
        trial += 1
        if trial % 50 == 0:
            log(f"fuzz progress: {trial} trials: {stats}")
    return {"trials": trial, "seconds": time.time() - t0, "stats": stats,
            "by_shape": by_shape, "failed": failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vorbispizza_tpu_torch.tools.fuzz")
    ap.add_argument("budget", nargs="?", type=float, default=300.0)
    ap.add_argument("seed0", nargs="?", type=int, default=0)
    ap.add_argument("shapes", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shapes = SHAPES
    if args.shapes:
        want = set(args.shapes.split(","))
        unknown = want - set(SHAPES)
        if unknown:
            raise SystemExit(f"unknown shapes: {sorted(unknown)}")
        shapes = tuple(s for s in SHAPES if s in want)
    res = run(args.budget, args.seed0, shapes, args.device,
              f" {args.shapes}" if args.shapes else "",
              log=lambda m: print(m, flush=True))
    print(f"fuzz: {res['trials']} trials in {res['seconds']:.0f}s on "
          f"{args.device}: {res['stats']}; by shape {res['by_shape']}")
    return 1 if res["stats"]["fail"] else 0


if __name__ == "__main__":
    sys.exit(main())
