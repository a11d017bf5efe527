"""Entry points of the port: one device's production step, and a
multi-device dry run.

Port of the repository's ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``), which stays as it is for the JAX package.

``entry(device)`` returns the production decode step that
``decode_corpus`` dispatches: ``BatchSynthesizer.forward`` bound to one merged
chunk's sig (floor1 render -> coupling inverse x floor -> DCT-IV ->
OLA assembly -> the s16 dpack wire), with that chunk's nine wire buffers
already on the device.

``dryrun_multichip(n_devices, device)`` runs, on an ``n_devices`` mesh
(the device's cards in turn, repeated where there are fewer: one card or
the CPU carries any mesh), the sharded corpus decode (parallel/corpus.py),
held to the single-device ``decode_corpus``, and the ('stream', 'frame')
step (parallel/mesh.py), held to its one-shard run.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .dsp.window import full_window

# a typical 44.1 kHz stereo floor1 layout (post X list, multiplier) and one
# square-polar coupling step, as produced by the reference encoder family
_N = 2048
_C = 2
_XS = (
    0, 1024, 93, 23, 372, 6, 46, 186, 750, 14, 33, 65, 130,
    260, 556, 3, 10, 18, 28, 39, 55, 79, 111, 158, 220,
    312, 464, 650, 850,
)
_MULT = 2
_STEPS = ((0, 1),)

#: max-abs of the mesh step against its one-shard run, by device type
#: (the CPU's float32 products may sum in another order: the CPU budget)
STEP_TOL = {"cpu": 2e-6, "cuda": 1e-6}


def step_config() -> dict:
    """The mesh step's static arguments (sharded_decode_step's keywords):
    blocksize 2048, stereo, a 29-post floor1, one coupling step, the
    long-long window."""
    return dict(n=_N, channels=_C, xs=_XS, multiplier=_MULT,
                coupling_steps=_STEPS,
                window=full_window(_N, 0, _N // 2, _N // 2,
                                   _N).astype(np.float32))


def example_inputs(F: int, seed: int = 0):
    """(residues [F, C, n/2] f32, posts [F, C, P] int32, step2 bool, used
    bool) of the mesh step, made from ``seed``: spectra at audio level
    (PCM well inside full scale, so the 1e-6 budget applies), with one
    frame 6 times louder, a few of whose samples clip."""
    rng = np.random.default_rng(seed)
    P = len(_XS)
    residues = rng.standard_normal((F, _C, _N // 2)).astype(np.float32)
    residues *= np.float32(0.02)
    residues[F // 2] *= np.float32(6.0)
    posts = rng.integers(0, 128, size=(F, _C, P)).astype(np.int32)
    step2 = rng.random((F, _C, P)) < 0.7
    step2[..., :2] = True
    used = np.ones((F, _C), dtype=bool)
    return residues, posts, np.ascontiguousarray(step2), used


def example_streams(n: int, seconds: float) -> list[bytes]:
    """``n`` stereo streams: libvorbisenc music signals of ``seconds`` at
    q0.3 where libvorbisenc loads, else the committed corpus's first
    ``n`` members (15 s each)."""
    from .testing.streams import vorbisenc_available

    if vorbisenc_available():
        from .testing.encode import encode_vorbis, make_signal

        return [encode_vorbis(make_signal(2, seconds, kind="music", seed=s),
                              quality=0.3) for s in range(n)]
    from .testing.corpus32 import load_corpus

    return load_corpus()[:n]


def entry(device="cuda"):
    """(fn, example_args): ``fn(*example_args)`` decodes the first chunk
    decode_corpus merges of two short streams (both, under the default
    chunk size) on ``device`` into the full-capacity dpack wire ("s16df",
    a u8 tensor whose first four bytes are the payload's byte count)."""
    from .models.launch import upload
    from .testing.chunks import first_merge

    dev = resolve_device(device)
    synth, plan, buckets, _ = first_merge(example_streams(2, 1.0))
    sig, host, _ = synth.prepare_host(plan, buckets, "s16df", device=dev)
    bufs, _ = upload(host, dev)

    def fn(*args):
        return synth(sig, list(args))

    return fn, tuple(bufs)


def _devices(n_devices: int, device) -> list:
    """``n_devices`` devices of ``device``'s type: the cards in turn,
    repeated where there are fewer; the CPU repeated."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_devices
    have = torch.cuda.device_count()
    return [torch.device("cuda", k % have) for k in range(n_devices)]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Multi-device dry run: the production pipeline sharded over a 1-D
    ``stream`` mesh (``max(n_devices, 2)`` streams, each shard on its own
    device), whose s16 must equal the single-device decode_corpus's on
    the first device (on a card, where cuBLAS sums a shard's DCT-IV rows
    in another order, within 1 LSB, the differing samples counted); then
    the ('stream', 'frame') step on the same devices, whose PCM must have
    the shape [S, F * n/2, C] and lie within STEP_TOL of its one-shard
    run, with the same clip flag. Returns what it measured."""
    from .models.corpus import decode_corpus
    from .parallel.corpus import decode_corpus_sharded
    from .parallel.mesh import Mesh, shard_inputs, sharded_decode_step

    devs = _devices(n_devices, device)
    srcs = example_streams(max(n_devices, 2), 0.35)
    sharded = decode_corpus_sharded(srcs, Mesh(devs, ("stream",)),
                                    output="s16")
    single = decode_corpus(srcs, output="s16", devices=[devs[0]])
    differ, lsb = 0, 0
    for a, b in zip(sharded, single, strict=True):
        _check(a.shape == b.shape and a.dtype == b.dtype,
               f"sharded {a.dtype} {a.shape}, one device {b.dtype} {b.shape}")
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        differ += int(np.count_nonzero(d))
        lsb = max(lsb, int(d.max()) if d.size else 0)
    _check(lsb <= (0 if devs[0].type == "cpu" else 1),
           f"sharded s16 {lsb} LSB off the one-device decode")

    streams = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    frames = n_devices // streams
    mesh = Mesh(np.array(devs, dtype=object).reshape(streams, frames),
                ("stream", "frame"))
    S, F = streams * 2, frames * 4
    inputs = [np.stack([x] * S) for x in example_inputs(F)]
    kw = step_config()
    pcm, clipped = sharded_decode_step(mesh, **kw)(*shard_inputs(mesh,
                                                                 *inputs))
    one = Mesh([[devs[0]]], ("stream", "frame"))
    ref, ref_clipped = sharded_decode_step(one, **kw)(*inputs)
    _check(tuple(pcm.shape) == (S, F * (_N // 2), _C),
           f"mesh step PCM {tuple(pcm.shape)}")
    err = float((pcm - ref).abs().max())
    _check(err <= STEP_TOL[devs[0].type],
           f"mesh step {err} off its one-shard run")
    _check(bool(clipped) == bool(ref_clipped), "mesh step clip flag differs")
    return {"streams": len(srcs), "s16_differing_samples": differ,
            "s16_max_lsb": lsb, "step_shape": tuple(pcm.shape),
            "step_max_abs": err, "has_clipped": bool(clipped)}
