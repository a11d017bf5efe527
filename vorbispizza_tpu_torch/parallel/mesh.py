"""Sharded decode step over a ('stream', 'frame') device mesh.

Port of vorbispizza_tpu/parallel/mesh.py. ``stream`` is data parallelism
over independent streams/files; ``frame`` is sequence parallelism over
the frame axis of each stream. All synthesis stages (floor render,
coupling inverse, IMDCT, window) are frame-local, so they shard
trivially; the only cross-shard dependency is overlap-add, where the
first output hop of a shard laps with the LAST frame of the left
neighbour: one frame of halo.

There is no SPMD program here. A ``Mesh`` is a grid of torch devices, and
a device may repeat (that is how one card, or the CPU, carries a mesh).
Each shard runs on its device's dispatch stream (models/launch.py
``lanes``): K2's posts mode (ops/floor.py ``floor1_from_posts``), K3
(ops/coupling.py ``couple_spectrum``, which multiplies by the floor),
then the DCT-IV ``torch.matmul`` and the window. The halo (the
reference's ``ppermute``) is the left neighbour's last frame, taken on
the shard's stream after the neighbour's completion event; the reference's
``psum`` of the clip flag is the sum of the shards' flags on the first
device. The uniform lap and window stay PyTorch elementwise ops, as the
reference keeps them outside any kernel: the production overlap-add
(kernel K4) runs on the sharded corpus path (parallel/corpus.py).

This module is the uniform-blocksize (steady-state long-block) path; a
mixed-blocksize stream routes through models/pipeline.py per shard.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decoder import CLIP_MAX
from ..device import resolve_device
from ..models.launch import lanes, on
from ..ops.coupling import couple_spectrum
from ..ops.floor import floor1_from_posts, floor1_tables, inverse_db_tables
from ..ops.imdct import dct_iv, dct_iv_basis


class Mesh:
    """A grid of torch devices with named axes (the part of
    jax.sharding.Mesh this package uses). ``devices`` is any nested list
    of device specs ("cpu", "cuda", "cuda:1", torch.device); each is
    resolved (a CUDA one raises without CUDA) and they may repeat."""

    def __init__(self, devices, axis_names):
        shape = np.shape(np.asarray(devices, dtype=object))
        flat = [resolve_device(d) for d in
                np.asarray(devices, dtype=object).reshape(-1)]
        self.devices = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            self.devices[i] = d
        self.devices = self.devices.reshape(shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-D device grid")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(n_devices: int | None = None, *, streams: int | None = None,
              device="cuda") -> Mesh:
    """A ('stream', 'frame') mesh. On "cuda": ``n_devices`` distinct cards
    (default all; more than exist raises). On "cpu": the CPU device
    repeated ``n_devices`` times (default 1)."""
    kind = torch.device(device).type
    if kind == "cuda":
        resolve_device("cuda")  # raises without CUDA
        have = torch.cuda.device_count()
        if n_devices is None:
            n_devices = have
        if n_devices > have:
            raise ValueError(
                f"requested {n_devices} devices, only {have} available"
            )
        devs = [torch.device("cuda", i) for i in range(n_devices)]
    elif kind == "cpu":
        n_devices = 1 if n_devices is None else n_devices
        devs = [torch.device("cpu")] * n_devices
    else:
        raise ValueError(f"unsupported device type {kind!r}")
    if streams is None:
        # favor the frame axis (long single streams are the hard case)
        streams = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    if n_devices % streams != 0:
        raise ValueError(
            f"streams={streams} must divide n_devices={n_devices}"
        )
    frames = n_devices // streams
    return Mesh(np.array(devs, dtype=object).reshape(streams, frames),
                axis_names=("stream", "frame"))


def _fetch(t: torch.Tensor, event, dev: torch.device, stream):
    """``t`` (made on its device's dispatch stream, done at ``event``) for
    use on ``dev``'s ``stream``: that stream waits on the event, and a
    copy between two cards is ordered after it too (PyTorch copies on the
    source device's current stream)."""
    if event is None:
        return t.to(dev)
    stream.wait_event(event)
    if t.device != dev:
        src = torch.cuda.current_stream(t.device)
        src.wait_event(event)
        t.record_stream(src)
        return t.to(dev)
    t.record_stream(stream)
    return t


def sharded_decode_step(
    mesh: Mesh,
    *,
    n: int,
    channels: int,
    xs: tuple[int, ...],
    multiplier: int,
    coupling_steps: tuple[tuple[int, int], ...],
    window: np.ndarray,
):
    """Build the sharded synthesis step.

    Returns ``step(residues, posts, step2, used) -> (pcm, has_clipped)``
    (the four inputs as ``shard_inputs`` places them, or host arrays,
    which it places itself):

      residues [S, F, C, n//2] f32  (pre-coupling spectra)
      posts    [S, F, C, P] int, step2 [S, F, C, P] bool, used [S, F, C] bool
      -> pcm [S, F * n//2, C] f32 interleaved, has_clipped a bool scalar,
         both on the mesh's first device, on its caller's current stream

    S shards over 'stream', F over 'frame'. Frame f's output hop is
    lap(tail of frame f-1, head of frame f); each shard receives its left
    neighbour's final frame (the first hop of the stream laps with zeros:
    the priming frame)."""
    half = n // 2
    P = len(xs)
    window_np = np.asarray(window, dtype=np.float32)
    steps_np = np.asarray(coupling_steps, dtype=np.int32).reshape(-1, 2)
    tables: dict = {}

    def tables_on(dev):
        t = tables.get(dev)
        if t is None:
            hi, lo = dct_iv_basis(half)
            t = tables[dev] = [
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (floor1_tables(xs, half), inverse_db_tables(), hi,
                          lo, window_np, steps_np)
            ]
        return t

    def frames_of(res, posts, step2, used, dev):
        """One shard's windowed frames [S, F, C, n]."""
        tab, ab, hi, lo, win, steps = tables_on(dev)
        S, F, C, _ = res.shape
        curves = floor1_from_posts(posts, step2, used, tab, ab, P,
                                   multiplier, half)
        spectra = couple_spectrum(res.reshape(S * F, C, half),
                                  curves.view(S * F, C, half), steps)
        d = dct_iv(spectra.view(-1, half), hi, lo)
        h = half // 2
        y = torch.cat([d[..., h:], -d.flip(-1), -d[..., :h]], dim=-1) * win
        return y.view(S, F, C, n)

    def step(residues, posts, step2, used):
        if not (isinstance(residues, np.ndarray) and residues.dtype == object):
            residues, posts, step2, used = shard_inputs(
                mesh, residues, posts, step2, used)
        devs = mesh.devices
        ns, nf = devs.shape
        frames = np.empty((ns, nf), dtype=object)
        done = np.empty((ns, nf), dtype=object)
        for (i, j), dev in np.ndenumerate(devs):
            stream, _ = lanes(dev)
            with on(dev, stream):
                frames[i, j] = frames_of(residues[i, j], posts[i, j],
                                         step2[i, j], used[i, j], dev)
                if stream is not None:
                    done[i, j] = torch.cuda.Event()
                    done[i, j].record(stream)
        pcm = np.empty((ns, nf), dtype=object)
        clip = np.empty((ns, nf), dtype=object)
        lapped = np.empty((ns, nf), dtype=object)
        for (i, j), dev in np.ndenumerate(devs):
            stream, _ = lanes(dev)
            with on(dev, stream):
                fr = frames[i, j]
                S, F, C, _ = fr.shape
                if j == 0:
                    prev_last = torch.zeros((S, C, n), dtype=fr.dtype,
                                            device=dev)
                else:
                    prev_last = _fetch(frames[i, j - 1][:, -1],
                                       done[i, j - 1], dev, stream)
                prev = torch.cat([prev_last[:, None], fr[:, :-1]], dim=1)
                out = prev[..., half:] + fr[..., :half]  # [S, F, C, half]
                out = out.permute(0, 1, 3, 2).reshape(S, F * half, C)
                clip[i, j] = (out.abs() > CLIP_MAX).any().to(torch.int32)
                pcm[i, j] = out.clamp(-CLIP_MAX, CLIP_MAX)
                if stream is not None:
                    lapped[i, j] = torch.cuda.Event()
                    lapped[i, j].record(stream)
        dev0 = devs.flat[0]
        stream0, _ = lanes(dev0)
        with on(dev0, stream0):
            rows = [torch.cat([_fetch(pcm[i, j], lapped[i, j], dev0, stream0)
                               for j in range(nf)], dim=1)
                    for i in range(ns)]
            flags = [_fetch(clip[i, j], lapped[i, j], dev0, stream0)
                     for i in range(ns) for j in range(nf)]
            out = torch.cat(rows, dim=0)
            has_clipped = torch.stack(flags).sum() > 0
            if stream0 is not None:
                end = torch.cuda.Event()
                end.record(stream0)
        if stream0 is not None:
            caller = torch.cuda.current_stream(dev0)
            caller.wait_event(end)
            out.record_stream(caller)
            has_clipped.record_stream(caller)
        return out, has_clipped

    return step


def shard_inputs(mesh: Mesh, residues, posts, step2, used):
    """Place host arrays with the step's sharding: four object arrays of
    the mesh's shape, each entry a shard's block on its device (uploaded on
    the device's dispatch stream): residues f32, posts u8, step2 as u8 bit
    planes (LSB first over P, the posts wire of models/pipeline.py) and
    used u8."""
    residues = np.asarray(residues, dtype=np.float32)
    posts = np.asarray(posts)
    if posts.size and (posts.min() < 0 or posts.max() > 255):
        raise ValueError("floor1 posts must lie in 0..255")
    step2_bits = np.packbits(np.asarray(step2, dtype=bool), axis=-1,
                             bitorder="little")
    host = (residues, posts.astype(np.uint8), step2_bits,
            np.asarray(used, dtype=np.uint8))
    ns, nf = mesh.devices.shape
    S, F = residues.shape[:2]
    if S % ns or F % nf:
        raise ValueError(f"[{S}, {F}] streams x frames do not split over a "
                         f"{ns} x {nf} mesh")
    s, f = S // ns, F // nf
    out = [np.empty((ns, nf), dtype=object) for _ in host]
    for (i, j), dev in np.ndenumerate(mesh.devices):
        stream, _ = lanes(dev)
        with on(dev, stream):
            for o, a in zip(out, host):
                block = a[i * s : (i + 1) * s, j * f : (j + 1) * f]
                o[i, j] = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
    return tuple(out)
