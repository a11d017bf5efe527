#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vorbispizza_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
the CUDA toolkit and PyTorch built for CUDA. It imports nothing of JAX and
nothing of the JAX package: the float64 anchor is the port's own
``reader.VorbisReader``. Phases, each printed as it runs:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
   whether the C++ host front end is native;
2. the kernel build (nvcc, sm_90a) and its time;
3. each kernel against its plain PyTorch twin on the card, at the shapes
   of the first merged chunk of its path, with the bound of its work
   (bytes over 3.35 TB/s or operations over 67 TFLOP/s, counted from
   this run's inputs: for K7 and K8 what their data makes them read, the
   rice rows' q and the used rows' coefficients). K1 and K2 on the
   committed corpus's chunk; K3 (one launch over every bucket of a
   chunk) and K4 in its four modes (f32, s16, s16p and dpack, the last
   with rice off and on) on that chunk, on it prepared under the
   fallback config (floor1_wire="posts", residue_transport="values") and
   on the floor0 corpus's chunk; on all three, the dpack select (K4's
   dpack mode) against ``dpack_select_plain`` of the card's q, K6 (its
   scans, the header and the planes, with its int32 scan held to
   ``dpack_scan``) and K7 (unary, reading K6's scan) in both rice modes
   (K7 under the full and the soft caps), and the composed wire; the
   same dpack kernels on a synthetic three-channel q with an odd NBt (an
   odd payload offset, and L not a multiple of 4), there K7 also with a
   third of the rice rows one rung lower and a third two lower, so that
   the soft row cap and section cap both cut; K3 on a synthetic
   ten-channel chunk (its in-place path), and a misaligned operand,
   which K3's wrapper must refuse; K2's posts mode and K9 (value
   residues) on the fallback chunk; K1 (format 0) and K8 (floor0) on the
   floor0 chunk, K8 also at orders 32 and 31 over half 1024 (G = 16,384,
   synthetic). K1 runs once a bucket, K2 as its rank kernel then its
   main kernel, K4 as its chain-state scan then its tiled kernel, K6 as
   its scan then its pack kernel. All are held with ``torch.equal``
   (K8's twin takes K8's steps in K8's order, with the card's own
   cos/sqrt/exp; on a miss its max ulp distance and the share of values
   that differ are printed);
4. the paths, each driven through ``decode_corpus(..., device="cuda")``
   with the launch counts set to 0 just before it and read just after,
   none routing a stream to the scalar decoder. On the committed 32 x 15 s
   stereo corpus (testdata/corpus32): "f32", every stream within 1e-6
   max-abs of the float64 anchor; the main path "s16" (dpack wire, rice
   resolved from the measured link rate), bit-equal to the host
   quantization of this card's f32 and within 1 LSB of the quantized
   anchor; ``s16_rice="on"`` (K7), ``s16_wire="raw"`` and "planes" (K4's
   s16p mode), identical int16; under the fallback config "f32" bit-equal
   to the default f32 and "s16" identical int16. On the floor0 corpus (32
   x 15 s mono floor0 streams, testing/floor0_32): "f32" against the
   anchor (max-abs printed), "s16" equal to the host quantization of the
   card's f32 with at most 1e-3 of each stream's samples over 2 LSB from
   the quantized anchor, and "f32" under residue_transport="values" (K9)
   bit-equal to the symbol wire's. decode_corpus is the overlapped
   driver (a dispatch thread, a collector pool, pinned non-blocking H2D
   on a dispatch stream, a completion event a chunk), and on corpus32
   phase 4 also holds: (a) ``devices=["cuda:0", "cuda:0"]`` bit-equal to
   the one-device s16; (b) ``batched=False`` s16 (a program a stream, 32
   chunks) within 1 LSB of the quantized anchor; (c)
   ``decode_file_batch`` on 3 streams, unsplit and with
   ``max_frames=64``, within 1e-6 of the anchor (the split-unsplit
   distance printed); (d) ``VorbisReader(accelerated=True,
   device="cuda")`` read in pieces and after 3 seeks within 1e-6 of the
   scalar reader, with its stats bits equal; (e) the decode CLI
   (``python -m vorbispizza_tpu_torch.tools.decode --s16``) on one
   stream, its WAV within 1 LSB of the quantized anchor; (f)
   ``output="device"`` tensors, read after the call returns with no
   synchronize, equal to the f32 output. Then the scale-out modules,
   each on a mesh whose every entry is this one card (shards run one
   after another on its dispatch stream; the partition, the sig
   unification, the empty clones, the halo and the reductions are what is
   checked): (g) ``parallel.corpus.decode_corpus_sharded`` of corpus32
   over 4 shards, "s16", "f32", "device" and the fallback wires' "s16",
   each bit-equal to decode_corpus's or, where cuBLAS sums a shard's
   DCT-IV rows in another order, within 1e-6 of the anchor (s16 within
   1 LSB of the quantized anchor), the differing samples counted, with 0
   scalar, 0 failed and 0 mismatch fallbacks and the shards' wire bytes
   summed; (h) a mixed-setup mono group (odd codebooks, lookup type 2,
   blocksizes 64/8192, floor0) and a stereo group (corpus32 streams with a
   value-transport multi-submap stream), sharded against the one-device
   decode; (i) the ('stream', 'frame') mesh step at full width (n = 2048,
   C = 2, 1024 frames a shard) on 2x2 and 1x4 meshes, within 1e-6 of its
   one-shard run with the same clip flag; (j) ``entry.dryrun_multichip(4)``;
   (k) ``tools.fuzz`` for FUZZ_S seconds from seed FUZZ_SEED, its counts by
   shape and status, no failed trial; (l) ``tools.ablate`` at one rep on
   the first chunk, every variant returning (its times not printed);
5. once the CPU workers of phases 3-4 have stopped: each kernel's time,
   its twin's and, where one PyTorch call computes the same function,
   that call's (CUDA events around 20 calls after a warm one, at phase
   3's inputs: ``ms``, the host's wall per call), and the DCT-IV product's
   (``torch.matmul``, against its bound by operations); then the kernel's
   20 calls again under torch.profiler: ``device_ms``, the device time
   per call of the kernel's own CUDA kernels, ``device_all_ms`` of every
   device op of the call, and ``device_launches``, the device ops per
   call (fills and scans around the kernel included). Then one s16 run
   of corpus32 under torch.profiler, after a warm one with a caller's
   ``DecodeTimer`` (each chunk's six marks present and in order, its
   h2d/d2h byte counters equal to ``stats``): the device's busy
   and idle share of its window, its top device ops by time, and the
   device ops that ran between each chunk's K4 (dpack mode) and K6. The
   corpus driver's end-to-end walls are the benchmark's (``vpbench/``);
   no wall of ``decode_file_batch`` or of the sharded driver is taken.

Any failure raises (exit code 1). Without CUDA, or without the package
beside it, it exits 2 and prints no result. The last two lines are the
kernel table and ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ANCHOR_TOL = 1e-6
S16_TOL = 1  # LSB against the quantized float64 anchor
FLOOR0_LSB = 2  # floor0 s16: at most FLOOR0_SHARE of a stream's samples
FLOOR0_SHARE = 1e-3  # more than FLOOR0_LSB off the quantized anchor
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_S = 67e12  # H100 SXM float32 rate outside the tensor cores
REPS = 20  # timed calls of each kernel's wrapper
FALLBACK = {"floor1_wire": "posts", "residue_transport": "values"}
SHARDS = 4  # mesh entries of phase 4 (g), (h) and (j), each the one card
MESH_FRAMES = 1024  # frames a shard of the mesh step, phase 4 (i)
FUZZ_S = 60.0  # phase 4 (k)'s budget, seconds
FUZZ_SEED = 90000
MARKS = ("merge0", "dispatch0", "dispatched", "pull_wait", "pull0",
         "pull_done")  # a chunk's DecodeTimer marks, in their order
KERNELS = {
    # name: (source, reference stage it replaces, run its launches are
    # read from, launch-count key[, phase-3 check if not that key])
    "residue_expand": ("vorbispizza_tpu_torch/csrc/residue_expand.cu",
                       "vorbispizza_tpu/ops/residue_sym.py:44", "s16",
                       "residue_expand"),
    "floor1_synth": ("vorbispizza_tpu_torch/csrc/floor1_synth.cu",
                     "vorbispizza_tpu/ops/floor.py:119", "s16", "floor1_synth"),
    "floor1_posts": ("vorbispizza_tpu_torch/csrc/floor1_synth.cu",
                     "vorbispizza_tpu/models/pipeline.py:737", "fallback_s16",
                     "floor1_posts"),
    "couple_spectrum": ("vorbispizza_tpu_torch/csrc/couple_spectrum.cu",
                        "vorbispizza_tpu/ops/coupling.py:14", "s16",
                        "couple_spectrum"),
    "ola_assemble": ("vorbispizza_tpu_torch/csrc/ola_assemble.cu",
                     "vorbispizza_tpu/ops/ola.py:220", "s16",
                     "ola_assemble_dpack"),
    # the select runs inside K4's dpack mode
    "dpack_select": ("vorbispizza_tpu_torch/csrc/ola_assemble.cu",
                     "vorbispizza_tpu/ops/pcm_pack.py:129", "s16",
                     "ola_assemble_dpack", "dpack_select"),
    "dpack_pack": ("vorbispizza_tpu_torch/csrc/dpack_pack.cu",
                   "vorbispizza_tpu/ops/pcm_pack.py:321", "s16", "dpack_pack"),
    "dpack_unary": ("vorbispizza_tpu_torch/csrc/dpack_unary.cu",
                    "vorbispizza_tpu/ops/pcm_pack.py:442", "rice",
                    "dpack_unary"),
    "floor0_synth": ("vorbispizza_tpu_torch/csrc/floor0_synth.cu",
                     "vorbispizza_tpu/ops/floor.py:201", "floor0_s16",
                     "floor0_synth"),
    "residue_gather": ("vorbispizza_tpu_torch/csrc/residue_gather.cu",
                       "vorbispizza_tpu/models/pipeline.py:789",
                       "fallback_s16", "residue_gather"),
}
#: K4's output modes: (mode, rice, reference stage, run, launch-count key)
K4_MODES = {
    "f32": ("f32", False, "vorbispizza_tpu/ops/ola.py:220", "f32",
            "ola_assemble"),
    "s16": ("s16", False, "vorbispizza_tpu/models/pipeline.py:819", "raw",
            "ola_assemble_s16"),
    "s16p": ("s16p", False, "vorbispizza_tpu/models/pipeline.py:878",
             "planes", "ola_assemble_s16p"),
    "dpack": ("dpack", False, "vorbispizza_tpu/ops/pcm_pack.py:129", "s16",
              "ola_assemble_dpack"),
    "dpack_rice": ("dpack", True, "vorbispizza_tpu/ops/pcm_pack.py:129",
                   "rice", "ola_assemble_dpack"),
}
#: the chunks K4's modes are held and timed on (phase-3 name suffix)
K4_CHUNKS = {"corpus32": "", "fallback": "_fallback", "floor0": "_floor0"}
_S16_PATH = ("couple_spectrum", "ola_assemble_dpack", "dpack_pack")
#: launch counts each run must show (the kernels on its path)
RUN_KERNELS = {
    "f32": ("residue_expand", "floor1_synth", "couple_spectrum",
            "ola_assemble"),
    "s16": ("residue_expand", "floor1_synth") + _S16_PATH,
    "rice": ("ola_assemble_dpack", "dpack_pack", "dpack_unary"),
    "raw": ("ola_assemble_s16",),
    "planes": ("ola_assemble_s16p",),
    "fallback_f32": ("residue_gather", "floor1_posts", "couple_spectrum",
                     "ola_assemble"),
    "fallback_s16": ("residue_gather", "floor1_posts") + _S16_PATH,
    "floor0_f32": ("residue_expand", "floor0_synth", "couple_spectrum",
                   "ola_assemble"),
    "floor0_s16": ("residue_expand", "floor0_synth") + _S16_PATH,
    "floor0_values": ("residue_gather", "floor0_synth", "couple_spectrum",
                      "ola_assemble"),
    "devices": ("residue_expand", "floor1_synth") + _S16_PATH,
    "unbatched": ("residue_expand", "floor1_synth") + _S16_PATH,
    "sharded_s16": ("residue_expand", "floor1_synth") + _S16_PATH,
    "sharded_f32": ("residue_expand", "floor1_synth", "couple_spectrum",
                    "ola_assemble"),
    "sharded_device": ("residue_expand", "floor1_synth", "couple_spectrum",
                       "ola_assemble"),
    "sharded_fallback_s16": ("residue_gather", "floor1_posts") + _S16_PATH,
    "sharded_mono_s16": ("floor0_synth",) + _S16_PATH,
    "sharded_mono_f32": ("floor0_synth", "couple_spectrum", "ola_assemble"),
    "sharded_stereo_s16": ("residue_expand", "residue_gather",
                           "floor1_synth") + _S16_PATH,
    "sharded_stereo_f32": ("residue_expand", "residue_gather",
                           "floor1_synth", "couple_spectrum", "ola_assemble"),
    "mesh_2x2": ("floor1_posts", "couple_spectrum"),
    "mesh_1x4": ("floor1_posts", "couple_spectrum"),
    "dryrun": ("residue_expand", "floor1_synth", "floor1_posts")
    + _S16_PATH,
}


def _anchor(data: bytes):
    """float64 scalar decode of one stream (runs in a worker process)."""
    from vorbispizza_tpu_torch.reader import VorbisReader

    r = VorbisReader(data)
    r.initialize()
    return r.read_all(planar=True)


#: the StreamStats bits an accelerated reader must share with the scalar one
STATS_BITS = ("audio_bits", "waste_bits", "container_bits", "header_bits",
              "packet_count")


def _scalar_stats(data: bytes) -> dict:
    """The scalar reader's StreamStats bits after reading the whole stream
    (runs in a worker process)."""
    from vorbispizza_tpu_torch.reader import VorbisReader

    r = VorbisReader(data)
    r.initialize()
    r.read_all()
    return {k: getattr(r.stats, k) for k in STATS_BITS}


@contextlib.contextmanager
def configured(**settings):
    """The port's VorbisConfig.default with ``settings``, restored after."""
    from vorbispizza_tpu_torch.config import VorbisConfig

    cfg = VorbisConfig.default
    saved = {k: getattr(cfg, k) for k in settings}
    try:
        for k, v in settings.items():
            setattr(cfg, k, v)
        yield cfg
    finally:
        for k, v in saved.items():
            setattr(cfg, k, v)


def _cuda_ms(fn, reps: int = REPS) -> float:
    """Mean time of ``fn`` in ms over ``reps`` runs between two CUDA
    events: the host's enqueue as much as the card, for a small call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _is_device(evt) -> bool:
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CUDA


def _device_us(row) -> float:
    """Device time in us of a ``key_averages()`` row (the attribute was
    renamed between torch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(row, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _profile(fn, reps: int = REPS, tries: int = 2) -> dict:
    """``fn`` ``reps`` times under torch.profiler (CPU and CUDA activity)
    after a warm call: {device op name: (device us summed over the reps,
    launches)}, from ``key_averages()``. A trace with no device op (the
    H100's tracer can drop one) is taken again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = {r.key: (_device_us(r), r.count) for r in prof.key_averages()
               if _is_device(r)}
        if ops:
            break
    return ops


def _profile_run(run_fn, top: int = 10, tries: int = 3) -> dict:
    """One decode (``run_fn`` returns its outputs) under torch.profiler:
    the device's busy and idle share of the call's host window (the union
    of every device kernel, copy and fill interval inside it) and its top
    device ops by time. The window is the profiled call's, so it holds the
    profiler's own host overhead. A trace that lost a chunk's kernels
    (it holds fewer K4 launches than the decode's chunks: the H100's
    tracer can drop some) is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tag = "vp_profiled_run"
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(tag):
                chunks = run_fn().stats["chunks"]
        evs = prof.events()
        k4 = sum(1 for e in evs
                 if _is_device(e) and "ola_assemble_kernel" in e.name)
        if k4 >= chunks:
            break
        print(f"  profiled run {attempt}: the trace holds {k4} of {chunks} "
              f"chunks' K4 launches; taken again", flush=True)
    win = [e.time_range for e in evs if e.name == tag and not _is_device(e)]
    dev = [e for e in evs if _is_device(e) and e.name != tag
           and not getattr(e, "is_user_annotation", False)]
    if not win or not dev:
        return {}
    t0, t1 = win[0].start, win[0].end
    busy, cur = 0.0, None
    for s, e in sorted((max(d.time_range.start, t0), min(d.time_range.end, t1))
                       for d in dev):
        if e <= s:
            continue
        if cur is None or s > cur[1]:
            busy += cur[1] - cur[0] if cur else 0.0
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += cur[1] - cur[0] if cur else 0.0
    by_name: dict = {}
    for d in dev:
        us, n = by_name.get(d.name, (0.0, 0))
        by_name[d.name] = (us + d.time_range.elapsed_us(), n + 1)
    tops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    # the device ops between each K4 (its tiled kernel) and the next K6
    seq = sorted(dev, key=lambda d: d.time_range.start)
    between, k4_then_k6 = [], 0
    for i, d in enumerate(seq):
        if "ola_assemble_kernel" not in d.name:
            continue
        j = i + 1
        while j < len(seq) and not any(k in seq[j].name for k in (
                "dpack_pack", "ola_assemble")):
            between.append(seq[j].name[:60])
            j += 1
        k4_then_k6 += j < len(seq) and "dpack_pack" in seq[j].name
    return {"chunks": chunks, "chunks_traced": k4,
            "k4_then_k6": k4_then_k6, "ops_between_k4_and_k6": between,
            "window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (t1 - t0), "idle_share": 1 - busy / (t1 - t0),
            "device_ops": len(dev),
            "top": [{"name": k[:90], "ms": us / 1e3, "count": n}
                    for k, (us, n) in tops]}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _bound(in_bytes: int, out_bytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the memory rate
    and the operations over the float32 rate."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_S * 1e3
    t_ops = ops / FP32_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": in_bytes + out_bytes, "ops": ops}


def _compare(name, kernel_fn, plain_fn, inputs, ops, view_k=None,
             view_p=None, library_fn=None, check=None, kernel=None,
             in_bytes=None):
    """Run both on the same inputs; assert bit-equality of their outputs
    (or ``check(got, want)``, which returns a note); bound the work from
    ``inputs`` (or ``in_bytes``, the input bytes this run's data makes
    the kernel read, where it skips some), the compared outputs and
    ``ops`` (a function of the outputs). The result keeps the functions
    to time (``_time`` times them once the CPU workers have stopped: host
    contention stretches the launch gaps of these small kernels) and
    ``kernel``, the part of the
    CUDA kernel names (default ``name``) whose device time is the
    kernel's."""
    import torch

    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    got = view_k(got) if view_k else got
    want = view_p(want) if view_p else want
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {g.shape} != {w.shape}")
        err = max(err, (g.double() - w.double()).abs().max().item())
    if check is None:
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel differs from its twin "
                                     f"(max abs {err})")
        note = "bit-equal to its twin"
    else:
        note = check(got, want)
    res = {"max_abs_err": err, "name": name, "kernel": kernel or name,
           "fns": (kernel_fn, plain_fn, library_fn),
           **_bound(_nbytes(inputs) if in_bytes is None else in_bytes,
                    _nbytes(got), ops(got))}
    print(f"  {name}: {note} over {len(got)} outputs; bound "
          f"{res['bound_ms']:.4f} ms by {res['bound_by']} ({res['bytes']} B, "
          f"{res['ops']} ops)", flush=True)
    return res


def _time(res) -> None:
    """Time a ``_compare`` result's kernel, twin and library call with CUDA
    events (``ms``: the host's wall per call); then the wrapper's calls
    again under torch.profiler: ``device_ms``, the device time per call of
    the CUDA kernels named ``res["kernel"]``; ``device_all_ms``, of every
    device op the call makes; ``device_launches``, how many device ops
    (kernels, fills, copies) the call makes."""
    kernel_fn, plain_fn, library_fn = res.pop("fns")
    res["ms"] = _cuda_ms(kernel_fn)
    res["plain_ms"] = _cuda_ms(plain_fn) if plain_fn else None
    res["library_ms"] = _cuda_ms(library_fn) if library_fn else None
    ops = _profile(kernel_fn)
    mine = {k: v for k, v in ops.items() if res["kernel"] in k}
    if mine:
        res["device_ms"] = sum(us for us, _ in mine.values()) / REPS / 1e3
        res["device_all_ms"] = sum(us for us, _ in ops.values()) / REPS / 1e3
        res["device_launches"] = sum(n for _, n in ops.values()) / REPS
        dev = (f"; device {res['device_ms']:.4f} ms ({res['device_all_ms']:.4f}"
               f" ms in all {res['device_launches']:g} device ops a call)")
        if len(mine) > 1:
            dev += " [" + "; ".join(
                f"{k.split('(')[0][:40]} {us / REPS / 1e3:.4f} ms"
                for k, (us, _) in sorted(mine.items())) + "]"
    else:
        res["device_ms"] = res["device_all_ms"] = "not measured"
        res["device_launches"] = "not measured"
        dev = (f"; device_ms: not measured (the profiler showed "
               f"{sorted(ops)[:6]})")
    plain = (f", plain {res['plain_ms']:.4f} ms" if plain_fn else "")
    lib = (f", library {res['library_ms']:.4f} ms" if library_fn else "")
    print(f"  {res['name']}: kernel {res['ms']:.4f} ms{plain}{lib}{dev}; "
          f"bound {res['bound_ms']:.4f} ms", flush=True)


def _print_profile(name, prof, card) -> None:
    if not prof:
        print(f"  [{name}] profiled run: the profiler showed no device "
              f"ops; device_ms: not measured", flush=True)
        return
    print(f"  [{name}] profiled run: window {prof['window_ms']:.3f} ms, "
          f"device busy {prof['busy_ms']:.3f} ms ({prof['busy_share']:.4f}), "
          f"idle share {prof['idle_share']:.4f}, {prof['device_ops']} device "
          f"ops [{card}]", flush=True)
    for t in prof["top"]:
        print(f"    {t['ms']:9.3f} ms {t['count']:5d}x  {t['name']}")
    print("  profile " + json.dumps({"run": name, **prof}), flush=True)


def _numel(outs) -> int:
    return sum(o.numel() for o in outs)


def _chunk(corpus, dev, output="f32", **settings):
    """(synth, sig, device buffers, buckets) of the first chunk."""
    import torch

    from vorbispizza_tpu_torch.testing.chunks import first_chunk

    with configured(**settings):
        synth, sig, host, n_streams = first_chunk(corpus, output)
    bufs = [torch.from_numpy(a).to(dev) for a in host]
    bks = synth.buckets(sig, bufs)
    print(f"  first chunk ({output}{', ' + str(settings) if settings else ''}"
          f"): {n_streams} streams, {len(bks)} buckets, out_len {sig[3]}, "
          f"rows " + ", ".join(f"{bk['Fp']}x{bk['n']}" for bk in bks),
          flush=True)
    return synth, sig, bufs, bks


def check_kernels(corpus, dev):
    """Phase 3: K1-K4 and the dpack kernels at the first chunk's shapes."""
    from vorbispizza_tpu_torch.ops import floor

    synth, sig, bufs, bks = _chunk(corpus, dev)
    flo_calls = [a for bk in bks for _, w, a in synth.floor_calls(bk)]
    out = {"residue_expand": _check_k1("residue_expand", synth, bks)}
    out["floor1_synth"] = _compare(
        "floor1_synth",
        lambda: [floor.floor1_from_ys(*a) for a in flo_calls],
        lambda: [floor.floor1_from_ys_plain(*a) for a in flo_calls],
        inputs=[t for a in flo_calls for t in a[:6]],
        ops=lambda o: 8 * _numel(o), kernel="floor1_",
    )
    out["couple_spectrum"], spectra = _check_k3("couple_spectrum", synth,
                                                bks)
    out["couple_spectrum_c10"] = _check_k3_wide(dev)
    _check_k3_refuses_misaligned(synth, bks)
    out["dct_iv"] = _dct_row(synth, spectra)
    obks = [synth.ola_bucket(bk, synth.dct(bk, sp)) for bk, sp in spectra]
    evs, L, C = bufs[4:9], sig[3], synth.channels
    out.update(_check_k4(obks, evs, L, C, K4_CHUNKS["corpus32"]))
    print(f"  dpack wire: C {C}, L {L}, NBt {C * -(-L // 128)}", flush=True)
    for rice in (False, True):
        out.update(_check_dpack(obks, evs, L, rice, dev))
        out.update(_check_dpack_synthetic(rice, dev))
    return out


def _k3_parts(synth, bks):
    """Each bucket's (residues, floors, steps): K3's operands."""
    return [(synth.residues(bk), synth.floors(bk), bk["tables"]["steps"])
            for bk in bks]


def _check_k3(name, synth, bks):
    """K3, one launch over every bucket of a chunk, against the twin a
    bucket. The work: residues, floors and steps in, spectra out; a
    product and a sum per value and coupling step. Returns the result and
    [(bucket, its spectra)]."""
    from vorbispizza_tpu_torch.ops import coupling

    parts = _k3_parts(synth, bks)
    res = _k3_compare(name, parts)
    return res, list(zip(bks, coupling.couple_spectrum_chunk(parts)[1]))


def _k3_compare(name, parts):
    from vorbispizza_tpu_torch.ops import coupling

    return _compare(
        name,
        lambda: coupling.couple_spectrum_chunk(parts)[1],
        lambda: [coupling.couple_spectrum_plain(*p) for p in parts],
        inputs=[t for p in parts for t in p],
        ops=lambda o: sum(r.numel() * (1 + s.shape[0]) for r, _, s in parts),
        kernel="couple_spectrum",
    )


def _check_k3_wide(dev):
    """K3 past 8 channels (its in-place path) on a synthetic two-bucket,
    ten-channel chunk made from a seed, with steps that reuse channels and
    one whose channels coincide."""
    import torch

    g = torch.Generator().manual_seed(11)
    steps = torch.tensor([[0, 1], [2, 3], [4, 5], [0, 2], [6, 7], [8, 9],
                          [3, 3], [1, 9]], dtype=torch.int32).to(dev)
    parts = []
    for F, half in ((64, 128), (16, 1024)):
        res = torch.randn((F, 10, half), generator=g)
        res[torch.rand(res.shape, generator=g) < 0.2] = 0.0
        flo = torch.rand((F, 10, half), generator=g) * 2.0
        parts.append((res.to(dev), flo.to(dev), steps))
    return _k3_compare("couple_spectrum (10 channels, synthetic)", parts)


def _check_k3_refuses_misaligned(synth, bks):
    """A residue view 4 bytes off a 16-byte boundary: K3's wrapper must
    raise rather than launch."""
    import torch

    from vorbispizza_tpu_torch.ops import coupling

    res, flo, steps = _k3_parts(synth, bks[:1])[0]
    buf = torch.empty(res.numel() + 1, dtype=res.dtype, device=res.device)
    mis = buf[1:].view(res.shape)
    try:
        coupling.couple_spectrum_chunk([(mis, flo, steps)])
    except ValueError as e:
        print(f"  couple_spectrum_chunk refuses a misaligned view: {e}",
              flush=True)
        return
    raise AssertionError("couple_spectrum_chunk took a misaligned operand")


def _check_k1(name, synth, bks):
    """K1 over every bucket of a chunk (one launch a bucket) against the
    twin that walks the same descriptor tables. The work: the applied
    partitions' symbol and index streams, the VQ tables and the tables
    in; the [Fp, C, half] residues out; a product per covered column."""
    from vorbispizza_tpu_torch.ops import residue_sym

    calls = [synth.residue_call(bk) for bk in bks]
    subs = [a for bk in bks for _, a in synth.residue_calls(bk)
            if a is not None]
    print(f"  {name}: {len(calls)} launches, "
          f"{sum(c[1] for c in calls)} groups, "
          f"{sum(c[2] for c in calls)} blocks", flush=True)
    return _compare(
        name,
        lambda: [residue_sym.expand_bucket(*c) for c in calls],
        lambda: [residue_sym.expand_bucket_plain(*c) for c in calls],
        inputs=[t for a in subs for t in (*a[1], *a[2], *a[3])]
        + [c[0] for c in calls],
        ops=lambda _: sum(g[4] * g[2] * g[1] for a in subs for g in a[0][7]),
        kernel="residue_expand",
    )


def _dct_row(synth, spectra):
    """The DCT-IV product of the chunk (``torch.matmul``, not a kernel of
    the port): no twin to hold it against, so only its bound and, in
    phase 5, its times. Bound by operations: two products (hi and lo) of
    2 * rows * half^2 flops a bucket."""
    outs = [synth.dct(bk, sp) for bk, sp in spectra]
    res = {"max_abs_err": None, "name": "dct_iv (torch.matmul)", "kernel": "",
           "fns": (lambda: [synth.dct(bk, sp) for bk, sp in spectra], None,
                   None),
           **_bound(_nbytes([t for bk, sp in spectra
                             for t in (sp, *bk["tables"]["dct"])]),
                    _nbytes(outs),
                    sum(4 * sp.shape[0] * sp.shape[1] * sp.shape[2] ** 2
                        for _, sp in spectra))}
    print(f"  {res['name']}: bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']} ({res['bytes']} B, {res['ops']} flops)",
          flush=True)
    return res


def _ola_operands(synth, spectra):
    """K4's bucket operands of a chunk from K3's [(bucket, spectra)]."""
    return [synth.ola_bucket(bk, synth.dct(bk, sp)) for bk, sp in spectra]


def _outs(x) -> list:
    return list(x) if isinstance(x, tuple) else [x]


def _check_k4(obks, evs, L, C, suffix):
    """K4's modes (K4_MODES: the dpack mode with rice off and on) on one
    chunk's operands against their twins. The dpack mode's work: the s16
    mode's, plus 32 operations a sample for the select."""
    from vorbispizza_tpu_torch.ops import ola

    ola_in = [t for b in obks for t in b] + list(evs)
    out = {}
    for key, (mode, rice, *_) in K4_MODES.items():
        name = f"ola_assemble_{key}{suffix}"
        ops = {"f32": 3, "s16": 4, "s16p": 4, "dpack": 36}[mode] * C * L
        out[name] = _compare(
            name,
            lambda m=mode, r=rice: _outs(ola.ola_assemble(obks, evs, L, m,
                                                          rice=r)),
            lambda m=mode, r=rice: _outs(ola.ola_assemble_plain(obks, evs, L,
                                                                m, r)),
            inputs=ola_in, ops=lambda o, n=ops: n, kernel="ola_assemble",
        )
    return out


def _check_dpack(obks, evs, L, rice, dev, suffix=""):
    """The select (K4's dpack mode, into a wire's widx table) against
    ``dpack_select_plain`` of the card's q, then K6, K7 and the composed
    wire on the card's q and select (``_check_k6_k7``). A function of its
    own per rice mode, so the kept closures bind this mode's buffers."""
    from vorbispizza_tpu_torch.ops import ola
    from vorbispizza_tpu_torch.ops import pcm_pack as pp

    C = obks[0][0].shape[1]
    cap, ucap, _ = pp.wire_caps(pp.wire_rows(L, C), True)
    tag, key = (" (rice)", "_rice") if rice else (" (width-only)", "")
    wire, wview = pp.wire_buffer(C, L, cap, ucap, rice, dev)
    q, wbyte, ubits = ola.ola_assemble(obks, evs, L, "dpack", rice=rice,
                                       wbyte=wview)
    out = {"dpack_select" + key + suffix: _compare(
        "dpack_select" + tag + suffix,
        lambda: list(ola.ola_assemble(obks, evs, L, "dpack", rice=rice,
                                      wbyte=wview)),
        lambda: [q, *pp.dpack_select_plain(q, rice)],
        inputs=[t for b in obks for t in b] + list(evs),
        ops=lambda _: 36 * q.numel(), kernel="ola_assemble",
    )}
    out.update(_check_k6_k7(q, wire, wbyte, ubits, rice, suffix))
    return out


def _scan_parts(scan, C, NB, rice):
    """The fields of K6's int32 scan (its padding apart)."""
    from vorbispizza_tpu_torch.ops import pcm_pack as pp

    return [v for v in pp.scan_fields(scan, C, NB, rice).values()
            if v is not None]


def _check_k6_k7(q, wire, wbyte, ubits, rice, suffix):
    """K6 (its scan into int32 scratch, the header and the planes; two
    device ops) against ``dpack_scan`` and ``dpack_pack_plain``: the scan's
    fields and the wire below the kept plane section's end. K7 (rice) on
    K6's scan against ``dpack_unary_plain``, then ``dpack_wire`` against
    the composed twin below nbytes (full-capacity wire)."""
    import torch

    from vorbispizza_tpu_torch.ops import pcm_pack as pp

    C, L = q.shape
    nbt = pp.wire_rows(L, C)
    hdr = pp.wire_header_bytes(C)
    cap, ucap, urow = pp.wire_caps(nbt, True)
    tag, key = (" (rice)", "_rice") if rice else (" (width-only)", "")
    tag, key = tag + suffix, key + suffix
    scan_p = pp.dpack_scan(wbyte, ubits, urow, rice, C)
    n_k6 = hdr + nbt + min(16 * int(scan_p[0]), 16 * cap)
    out = {}
    out["dpack_pack" + key] = _compare(
        "dpack_pack" + tag,
        lambda: pp.dpack_pack(q, wire, ubits, cap, urow, rice),
        lambda: (pp.dpack_pack_plain(q, wbyte, scan_p, cap, rice),
                 pp.dpack_scan(wbyte, ubits, urow, rice, C)),
        inputs=[q, wbyte, ubits if rice else None],
        ops=lambda _: 8 * q.numel(), kernel="dpack_pack",
        view_k=lambda sc: [wire[:n_k6], *_scan_parts(sc, C, nbt // C, rice)],
        view_p=lambda o: [o[0][:n_k6], *_scan_parts(o[1], C, nbt // C, rice)],
    )
    if rice:
        out["dpack_unary" + suffix] = _check_k7(
            "dpack_unary" + tag, q, wire, wbyte, ubits, (cap, ucap, urow))
        out["dpack_unary_soft" + suffix] = _check_k7(
            "dpack_unary (soft caps)" + tag, q, wire, wbyte, ubits,
            pp.wire_caps(nbt, False))
    wk = pp.dpack_wire(q, cap, ucap, urow, rice, select=(wbyte, ubits),
                       wire=wire)
    wp = pp.dpack_wire_plain(q, cap, ucap, urow, rice)
    nb = int(wk[:4].cpu().numpy().view("<i4")[0])
    if not torch.equal(wk[: hdr + nbt + nb], wp[: hdr + nbt + nb]):
        raise AssertionError(f"dpack_wire{tag}: kernels differ from twin")
    print(f"  dpack_wire{tag}: {nb} payload bytes "
          f"({nb / (2 * C * L):.4f} of raw s16), payload at byte {hdr + nbt} "
          f"of the wire, equal to the twin", flush=True)
    return out


def _check_k7(name, q, wire, wbyte, ubits, caps, bite=False):
    """K7 under ``caps`` (cap_groups, cap_uwords, cap_urow) on the scan K6
    makes of this rice wire under them, against ``dpack_unary_plain``: the
    kept unary section, which starts at min(plane bytes, 16*cap_groups) of
    the payload. ``bite``: the row cap and the section cap must both cut
    this wire (K6's row-overflow flag set, more unary words than
    cap_uwords)."""
    from vorbispizza_tpu_torch.ops import pcm_pack as pp

    C, L = q.shape
    nbt = pp.wire_rows(L, C)
    cap, ucap, urow = caps
    scan = pp.dpack_pack(q, wire, ubits, cap, urow, True)
    f = {k: int(v[0]) for k, v in pp.scan_fields(scan, C, nbt // C,
                                                 True).items()
         if k in ("groups", "uwords", "over")}
    start = pp.wire_header_bytes(C) + nbt + min(16 * f["groups"], 16 * cap)
    ub = min(4 * f["uwords"], 4 * ucap)
    print(f"  {name}: caps {caps}, {f['uwords']} unary words, row overflow "
          f"{bool(f['over'])}", flush=True)
    if bite and not (f["over"] and f["uwords"] > ucap):
        raise AssertionError(f"{name}: the caps {caps} do not both cut")
    return _compare(
        name,
        lambda: pp.dpack_unary(q, wire, scan, cap, ucap, urow),
        lambda: pp.dpack_unary_plain(q, wbyte, ucap, urow),
        inputs=[q, wbyte, scan],
        in_bytes=_k7_in_bytes(q, wbyte),
        ops=lambda _: 8 * 128 * _k7_rows(wbyte), kernel="dpack_unary",
        view_k=lambda _: [wire[start : start + ub]],
        view_p=lambda u: [u[:ub]],
    )


def _k7_rows(wbyte) -> int:
    """The block rows whose windows K7 differences: each rice row, and an
    inter row's partner row again."""
    rice = (wbyte >> 7) & 1
    return int(rice.sum()) + int((rice & (wbyte >> 6)).sum())


def _k7_in_bytes(q, wbyte) -> int:
    """The bytes this wire makes K7 read: its widx table; once, the q of
    each row that a rice row or an inter row's partner needs; one offset of
    the scan for each warp (4 rows) that holds a rice row."""
    import torch
    import torch.nn.functional as F

    from vorbispizza_tpu_torch.ops import pcm_pack as pp

    C, L = q.shape
    nbt = wbyte.shape[0]
    nb = nbt // C
    rice = ((wbyte >> 7) & 1).view(C, nb)
    need = rice.clone()
    for c, p in enumerate(pp.pair_partner(C)):
        need[int(p)] |= rice[c] & (wbyte.view(C, nb)[c] >> 6)
    samples = (L - pp.BLOCK * torch.arange(nb, device=q.device)).clamp(
        max=pp.BLOCK)
    warps = F.pad(rice, (0, -nb % 4)).view(C, -1, 4).amax(-1)
    return nbt + 2 * int((need * samples).sum()) + 4 * int(warps.sum())


def _check_dpack_synthetic(rice, dev):
    """K6 and K7 on a synthetic three-channel q made from a seed (tones,
    noise and a few full-scale steps), whose NBt is odd, so the payload
    starts at an odd byte and K6 stores bytes; L is not a multiple of 4, so
    K6 reads q a sample at a time. The select is the twin's."""
    import torch

    from vorbispizza_tpu_torch.ops import pcm_pack as pp

    C, L = 3, 128 * 1001 - 51
    g = torch.Generator().manual_seed(5)
    t = torch.arange(L, dtype=torch.float64)
    q = torch.stack([(9000 - 1500 * c) * torch.sin(t * (0.031 + 0.007 * c))
                     + 40 * torch.randn(L, generator=g, dtype=torch.float64)
                     for c in range(C)])
    q[:, 50_000:50_300] = 32000.0
    q = q.round().clamp(-32768, 32767).to(torch.int16).to(dev)
    nbt = pp.wire_rows(L, C)
    assert (pp.wire_header_bytes(C) + nbt) % 2 == 1
    cap, ucap, _ = pp.wire_caps(nbt, True)
    wire, wview = pp.wire_buffer(C, L, cap, ucap, rice, dev)
    wbyte, ubits = pp.dpack_select_plain(q, rice)
    wview.copy_(wbyte)
    out = _check_k6_k7(q, wire, wview, ubits, rice, "_odd")
    if rice:
        # K7 where the soft caps cut, on a wire of its own (phase 5 times
        # the checks above again on theirs): no select's rice row reaches
        # the soft row cap, so lowered rungs make rows past it and more
        # words than the section cap
        wire, wview = pp.wire_buffer(C, L, cap, ucap, rice, dev)
        cut, ubits = pp.lowered_rungs(q, wbyte)
        wview.copy_(cut)
        out["dpack_unary_cut_odd"] = _check_k7(
            "dpack_unary (soft caps, lowered rungs)_odd", q, wire, wview,
            ubits, pp.wire_caps(nbt, False), bite=True)
    return out


def check_fallback_kernels(corpus, dev):
    """Phase 3, fallback wires: K2's posts mode, K9 and K4 on the first
    chunk prepared under the fallback config."""
    import torch

    from vorbispizza_tpu_torch.ops import floor
    from vorbispizza_tpu_torch.ops import residue_values as rv

    synth, sig, bufs, bks = _chunk(corpus, dev, **FALLBACK)
    posts = [a for bk in bks for _, w, a in synth.floor_calls(bk)
             if w == "posts"]
    vals = [synth.value_call(bk) for bk in bks]
    if not posts or None in vals:
        raise AssertionError("the fallback chunk is not on the posts and "
                             "value wires")
    print("  value wire tags: " + ", ".join(
        f"{a[2]}/{a[3]} Kp {a[0].shape[0]}" for a in vals), flush=True)
    out = {}
    out["floor1_posts"] = _compare(
        "floor1_posts",
        lambda: [floor.floor1_from_posts(*a) for a in posts],
        lambda: [floor.floor1_from_posts_plain(*a) for a in posts],
        inputs=[t for a in posts for t in a[:5]],
        ops=lambda o: 8 * _numel(o), kernel="floor1_",
    )
    idx = [rv.row_index(a[1], a[3]) for a in vals]
    out["residue_gather"] = _compare(
        "residue_gather",
        lambda: [rv.residue_gather(*a) for a in vals],
        lambda: [rv.residue_gather_plain(*a) for a in vals],
        inputs=[t for a in vals for t in a[:2]],
        ops=_numel,
        library_fn=lambda: [torch.index_select(a[0], 0, i)
                            for a, i in zip(vals, idx)],
    )
    sfx = K4_CHUNKS["fallback"]
    out["couple_spectrum" + sfx], spectra = _check_k3(
        "couple_spectrum" + sfx, synth, bks)
    out.update(_check_k4(_ola_operands(synth, spectra), bufs[4:9], sig[3],
                         synth.channels, sfx))
    for rice in (False, True):
        out.update(_check_dpack(_ola_operands(synth, spectra), bufs[4:9],
                                sig[3], rice, dev, sfx))
    return out


def _floor0_check(got, want):
    """K8 against its twin: finite and bit-equal, on every bin; a miss
    names the max ulp distance and the share of values that differ."""
    import torch

    ulp, differ, n = 0, 0, 0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError("floor0_synth: non-finite curve values")
        d = (g.view(torch.int32).long() - w.view(torch.int32).long()).abs()
        ulp = max(ulp, int(d.max().item()) if d.numel() else 0)
        differ += int((g != w).sum().item())
        n += g.numel()
    if differ:
        raise AssertionError(f"floor0_synth: {differ / n:.3e} of its values "
                             f"differ from its twin's, by up to {ulp} ulp")
    return "finite and bit-equal to its twin (0 ulp)"


def check_floor0_kernel(corpus, dev):
    """Phase 3, floor0: K1, K8, K4 and the dpack kernels on the floor0
    corpus's first chunk."""
    from vorbispizza_tpu_torch.ops import floor

    synth, sig, bufs, bks = _chunk(corpus, dev)
    calls = [a for bk in bks for _, w, a in synth.floor_calls(bk)
             if w == "floor0"]
    if not calls:
        raise AssertionError("the floor0 chunk has no floor0 group")
    out = {"residue_expand_f0": _check_k1("residue_expand (floor0 chunk, "
                                         "format 0)", synth, bks),
           "floor0_synth": _compare(
        "floor0_synth",
        lambda: [floor.floor0_curves(*a) for a in calls],
        lambda: [floor.floor0_curves_plain(*a) for a in calls],
        inputs=[t for a in calls for t in a[:4]],
        in_bytes=sum(_k8_in_bytes(a) for a in calls),
        ops=lambda o: sum(_k8_ops(a) for a in calls),
        check=_floor0_check,
    )}
    out.update(_check_k8_synthetic(dev))
    suffix = K4_CHUNKS["floor0"]
    out["couple_spectrum" + suffix], spectra = _check_k3(
        "couple_spectrum" + suffix, synth, bks)
    obks = _ola_operands(synth, spectra)
    out.update(_check_k4(obks, bufs[4:9], sig[3], synth.channels, suffix))
    for rice in (False, True):
        out.update(_check_dpack(obks, bufs[4:9], sig[3], rice, dev, suffix))
    return out


def _k8_in_bytes(args) -> int:
    """What a K8 call's data makes it read: used, the tables, and the
    coefficients and amplitude of its used rows."""
    coeffs, amp, used, tab = args[:4]
    n = int(used.bool().sum())
    return (used.numel() + _nbytes([tab])
            + n * (coeffs.element_size() * args[4] + amp.element_size()))


def _k8_ops(args) -> int:
    """K8's float operations: about 4*order+8 a bin of its used rows."""
    used, tab, order = args[2], args[3], args[4]
    return int(used.bool().sum()) * tab.shape[1] * (4 * order + 8)


def _check_k8_synthetic(dev):
    """K8 beside the floor0 chunk's order 4 and half 128: orders 32 (a
    whole chunk of 32 cosines in the warp's slab) and 31 (odd: the other
    tails, and a last partial float4 of cosines) at
    half 1024, the blocksize 2048 of real pre-1.0 floor0 files, on G =
    16,384 rows made from a seed (LSP angles sorted in (0.1, pi - 0.1), a
    tenth of the rows unused)."""
    import math
    import types

    import torch

    from vorbispizza_tpu_torch.ops import floor
    from vorbispizza_tpu_torch.setup.floor import Floor0

    G, n, bark_size, amp_bits, amp_off = 16384, 2048, 256, 6, 160
    bark = Floor0._bark_map(types.SimpleNamespace(rate=44100,
                                                  bark_map_size=bark_size), n)
    out = {}
    for order in (32, 31):
        g = torch.Generator().manual_seed(order)
        gaps = torch.rand((G, order + 1), generator=g, dtype=torch.float64)
        gaps = 0.3 + 0.7 * gaps
        lsp = (torch.cumsum(gaps, 1)[:, :-1] / gaps.sum(1, keepdim=True)
               * (math.pi - 0.2) + 0.1).float()
        amp = torch.randint(1, 1 << amp_bits, (G,), generator=g,
                            dtype=torch.int32)
        used = (torch.rand(G, generator=g) >= 0.1).to(torch.uint8)
        tab = torch.from_numpy(floor.floor0_tables(bark, bark_size, order))
        args = (lsp.to(dev), amp.to(dev), used.to(dev), tab.to(dev), order,
                amp_bits, amp_off)
        out[f"floor0_synth_o{order}"] = _compare(
            f"floor0_synth (order {order}, half {n // 2}, synthetic)",
            lambda a=args: [floor.floor0_curves(*a)],
            lambda a=args: [floor.floor0_curves_plain(*a)],
            inputs=list(args[:4]), in_bytes=_k8_in_bytes(args),
            ops=lambda o, a=args: _k8_ops(a),
            check=_floor0_check, kernel="floor0_synth",
        )
    return out


def _read_pieces(reader, np, n: int = 3001):
    """A reader's remaining samples, read ``n`` at a time -> [C, N]."""
    parts = []
    while True:
        c = reader.read_samples(n)
        if not c.shape[0]:
            return np.concatenate(parts, axis=0).T
        parts.append(c)


def check_entry_points(run, same, corpus, anchors, f32, s16, scalar_stats,
                       np, card):
    """Phase 4, checks (a)-(f) on corpus32: the driver's ``devices=`` and
    ``batched=``, the stream drivers, the accelerated reader, the CLI and
    the ``output="device"`` tier."""
    import struct
    import tempfile

    from vorbispizza_tpu_torch import (
        VorbisReader,
        decode_corpus,
        decode_file_batch,
    )
    from vorbispizza_tpu_torch.decoder import CLIP_MAX

    def lsb_off(got, ref):
        ref_q = np.clip(np.rint(ref * 32768.0), -32768, 32767)
        return int(np.abs(got.astype(np.int64) - ref_q).max())

    print("phase 4 (a): output='s16', devices=['cuda:0', 'cuda:0']",
          flush=True)
    same("devices", run("devices", "s16",
                        opts={"devices": ["cuda:0", "cuda:0"]}),
         s16, "the one-device int16")

    print("phase 4 (b): output='s16', batched=False", flush=True)
    unb = run("unbatched", "s16", opts={"device": "cuda", "batched": False})
    if unb.stats["chunks"] != len(corpus):
        raise AssertionError(f"batched=False ran {unb.stats['chunks']} "
                             f"chunks for {len(corpus)} streams")
    lsb = max(lsb_off(got, ref) for got, ref in zip(unb, anchors))
    print(f"  {unb.stats['chunks']} chunks; max |s16 - quantized anchor| = "
          f"{lsb} LSB (limit {S16_TOL}); d2h {unb.stats['d2h_bytes']} B",
          flush=True)
    if lsb > S16_TOL:
        raise AssertionError(f"batched=False s16 off the anchor by {lsb} LSB")

    print("phase 4 (c): decode_file_batch(stream, device='cuda'), unsplit "
          "and max_frames=64, on 3 streams", flush=True)
    err, gap = 0.0, 0.0
    for i, (data, ref) in enumerate(zip(corpus[:3], anchors)):
        whole = decode_file_batch(data, device="cuda")
        split = decode_file_batch(data, device="cuda", max_frames=64)
        for pcm in (whole, split):
            if pcm.shape != ref.shape or not np.isfinite(pcm).all():
                raise AssertionError(f"stream {i}: shape {pcm.shape} vs "
                                     f"{ref.shape} or non-finite PCM")
            err = max(err, float(np.abs(pcm.astype(np.float64) - ref).max()))
        gap = max(gap, float(np.abs(split - whole).max()))
    print(f"  max abs vs float64 anchor {err:.3e} (limit {ANCHOR_TOL:g}); "
          f"split vs unsplit max abs {gap:.3e}", flush=True)
    if err > ANCHOR_TOL:
        raise AssertionError(f"decode_file_batch off the anchor by {err}")

    print("phase 4 (d): VorbisReader(accelerated=True, device='cuda'), read "
          "in pieces of 3001 and after 3 seeks", flush=True)
    acc = VorbisReader(corpus[0], accelerated=True, device="cuda")
    acc.initialize()
    got = _read_pieces(acc, np)
    if got.shape != anchors[0].shape:
        raise AssertionError(f"accelerated reader: {got.shape} samples vs "
                             f"{anchors[0].shape}")
    err = float(np.abs(got.astype(np.float64) - anchors[0]).max())
    bits = {k: getattr(acc.stats, k) for k in STATS_BITS}
    if bits != scalar_stats:
        raise AssertionError(f"accelerated stats {bits} != scalar "
                             f"{scalar_stats}")
    scalar = VorbisReader(corpus[0])
    scalar.initialize()
    for pos in (5000, 0, scalar.total_samples // 2):
        acc.seek_to(pos)
        scalar.seek_to(pos)
        a = acc.read_samples(1024, planar=True)
        b = scalar.read_samples(1024, planar=True)
        if a.shape != b.shape or acc.sample_position != scalar.sample_position:
            raise AssertionError(f"seek to {pos}: {a.shape} at "
                                 f"{acc.sample_position} vs {b.shape} at "
                                 f"{scalar.sample_position}")
        err = max(err, float(np.abs(a.astype(np.float64) - b).max()))
    print(f"  max abs vs the scalar reader {err:.3e} (limit {ANCHOR_TOL:g}); "
          f"stats bits equal: {bits}", flush=True)
    if err > ANCHOR_TOL:
        raise AssertionError(f"accelerated reader off by {err}")

    print("phase 4 (e): python -m vorbispizza_tpu_torch.tools.decode --s16 "
          "on one stream", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "s00.ogg")
        with open(src, "wb") as f:
            f.write(corpus[0])
        proc = subprocess.run(
            [sys.executable, "-m", "vorbispizza_tpu_torch.tools.decode",
             "--s16", "--out", tmp, src],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise AssertionError(f"the CLI exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        with open(os.path.join(tmp, "s00.wav"), "rb") as f:
            wav = f.read()
    C, N = anchors[0].shape
    tag, channels, _rate, _brate, _align, width = struct.unpack(
        "<HHIIHH", wav[20:36])
    if (wav[:4], wav[8:16], tag, channels, width, len(wav)) != (
            b"RIFF", b"WAVEfmt ", 1, C, 16, 44 + 2 * C * N):
        raise AssertionError(f"the CLI's WAV header: {wav[:44]!r}")
    lsb = lsb_off(np.frombuffer(wav[44:], "<i2").reshape(N, C).T, anchors[0])
    print(f"  {proc.stdout.strip()} [{card}]; max |WAV - quantized anchor| "
          f"= {lsb} LSB (limit {S16_TOL})", flush=True)
    if lsb > S16_TOL:
        raise AssertionError(f"the CLI's WAV off the anchor by {lsb} LSB")

    print("phase 4 (f): output='device', read after the call returns with "
          "no synchronize", flush=True)
    outs = decode_corpus(corpus, device="cuda", output="device")
    clip = float(CLIP_MAX)
    host = [o.clamp(-clip, clip).cpu().numpy() for o in outs]
    if not all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(host, f32)):
        raise AssertionError("output='device' differs from the f32 output")
    print(f"  {len(outs)} tensors on {outs[0].device}, identical to the f32 "
          f"output (clipped)", flush=True)


def _hold(name, got, want, anchors, np, what):
    """Each stream of ``got`` against ``want``: bit-equal, or (where a
    card's GEMM sums rows in another order) within ANCHOR_TOL of the
    float64 anchor, int16 within S16_TOL of the quantized anchor; without
    ``anchors``, within those limits of ``want`` itself. Prints and
    returns the count of samples that differ."""
    differ, gap = 0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: stream {i} is {g.dtype} {g.shape}"
                                 f", {what} {w.dtype} {w.shape}")
        d = int(np.count_nonzero(g != w))
        differ += d
        if not d:
            continue
        ref = w if anchors is None else anchors[i]
        if g.dtype == np.int16:
            if anchors is not None:
                ref = np.clip(np.rint(ref * 32768.0), -32768, 32767)
            limit = S16_TOL
        else:
            limit = ANCHOR_TOL
        off = float(np.abs(g.astype(np.float64) - ref).max())
        gap = max(gap, off)
        if off > limit:
            raise AssertionError(f"{name}: stream {i} differs from {what} by "
                                 f"{d} samples, {off} from "
                                 f"{'the anchor' if anchors else what} "
                                 f"(limit {limit})")
    ref = "the anchor" if anchors is not None else what
    print(f"  {name}: " + (f"bit-equal to {what}" if not differ else
                           f"{differ} samples differ from {what}; the worst "
                           f"is {gap:g} from {ref}"), flush=True)
    return differ


def check_scale_out(path, corpus, anchors, f32, s16, np, card):
    """Phase 4, checks (g)-(l): the sharded corpus decode, its mixed-setup
    groups, the mesh step, the dry run and the fuzzer, each on a mesh
    whose every entry is this card, and the stage ablation."""
    from vorbispizza_tpu_torch import decode_corpus
    from vorbispizza_tpu_torch import entry as E
    from vorbispizza_tpu_torch.decoder import CLIP_MAX
    from vorbispizza_tpu_torch.parallel.corpus import decode_corpus_sharded
    from vorbispizza_tpu_torch.parallel.mesh import (
        Mesh,
        shard_inputs,
        sharded_decode_step,
    )
    from vorbispizza_tpu_torch.testing import rawstream
    from vorbispizza_tpu_torch.tools import ablate, fuzz

    mesh = Mesh(["cuda:0"] * SHARDS, ("stream",))

    def sharded(name, output, sources=corpus, **settings):
        with configured(**settings):
            outs = path(name, lambda: decode_corpus_sharded(
                sources, mesh, output=output))
        st = outs.stats
        print(f"  [{name}] stats {json.dumps(st)}", flush=True)
        if st["scalar"] or st["failed"] or st["mismatch_fallbacks"] or (
                st["batched"] != len(sources)):
            raise AssertionError(f"{name}: streams left the sharded batch "
                                 f"path: {st}")
        return outs

    print(f"phase 4 (g): decode_corpus_sharded(corpus32, {SHARDS} x cuda:0), "
          f"output='s16', 'f32', 'device', and 's16' under the fallback "
          f"wires", flush=True)
    _hold("sharded_s16", sharded("sharded_s16", "s16"), s16, anchors, np,
          "decode_corpus's int16")
    _hold("sharded_f32", sharded("sharded_f32", "f32"), f32, anchors, np,
          "decode_corpus's f32")
    outs = sharded("sharded_device", "device")
    if not all(o.device.type == "cuda" for o in outs):
        raise AssertionError("output='device' left the card")
    _hold("sharded_device", [o.clamp(-CLIP_MAX, CLIP_MAX).cpu().numpy()
                             for o in outs], f32, anchors, np,
          "decode_corpus's f32 (clipped)")
    _hold("sharded_fallback_s16",
          sharded("sharded_fallback_s16", "s16", **FALLBACK), s16, anchors,
          np, "decode_corpus's int16")

    print("phase 4 (h): mixed setups, sharded against the one-device "
          "decode_corpus", flush=True)
    groups = {
        "mono": [rawstream.make_oddbooks_stream(),
                 rawstream.make_lookup2_stream(),
                 rawstream.make_extreme_blocksize_stream(),
                 rawstream.make_floor0_stream()],
        "stereo": corpus[:6] + [rawstream.make_multisubmap_stream()],
    }
    for group, sources in groups.items():
        for output in ("s16", "f32"):
            name = f"sharded_{group}_{output}"
            got = sharded(name, output, sources)
            want = decode_corpus(sources, device="cuda", output=output)
            _hold(name, got, want, None, np, "the one-device decode")

    print(f"phase 4 (i): the ('stream', 'frame') mesh step, n 2048, C 2, "
          f"{MESH_FRAMES} frames a shard, against its one-shard run",
          flush=True)
    kw = E.step_config()
    one = Mesh([["cuda:0"]], ("stream", "frame"))
    for streams, frames in ((2, 2), (1, 4)):
        name = f"mesh_{streams}x{frames}"
        inputs = [np.stack([x] * 2) for x in E.example_inputs(
            frames * MESH_FRAMES, seed=streams)]
        grid = Mesh(np.array(["cuda:0"] * 4, dtype=object).reshape(
            streams, frames), ("stream", "frame"))
        args = shard_inputs(grid, *inputs)
        pcm, clip = path(name, lambda: sharded_decode_step(grid, **kw)(*args))
        ref, ref_clip = sharded_decode_step(one, **kw)(*inputs)
        shape = (2, frames * MESH_FRAMES * 1024, 2)
        if tuple(pcm.shape) != shape or not bool(pcm.isfinite().all()):
            raise AssertionError(f"{name}: {tuple(pcm.shape)} (want {shape})"
                                 f" or non-finite PCM")
        err = float((pcm - ref).abs().max())
        n_diff = int((pcm != ref).sum())
        print(f"  {name}: {tuple(pcm.shape)}, {n_diff} samples differ from "
              f"the one-shard run, max abs {err:.3e} (limit {ANCHOR_TOL:g}); "
              f"has_clipped {bool(clip)} / {bool(ref_clip)}", flush=True)
        if err > ANCHOR_TOL or bool(clip) != bool(ref_clip):
            raise AssertionError(f"{name}: off its one-shard run")

    print(f"phase 4 (j): entry.dryrun_multichip({SHARDS}, device='cuda')",
          flush=True)
    res = path("dryrun", lambda: E.dryrun_multichip(SHARDS, device="cuda"))
    print(f"  {json.dumps(res)}", flush=True)

    print(f"phase 4 (k): tools.fuzz on the card, {FUZZ_S:g} s from seed "
          f"{FUZZ_SEED}", flush=True)
    res = path("fuzz", lambda: fuzz.run(
        FUZZ_S, FUZZ_SEED, device="cuda",
        log=lambda m: print("  " + m, flush=True)))
    print(f"  {res['trials']} trials in {res['seconds']:.1f} s: "
          f"{json.dumps(res['stats'])}; by shape "
          f"{json.dumps(res['by_shape'])} [{card}]", flush=True)
    if res["failed"]:
        raise AssertionError(f"fuzz: failed seeds {res['failed']}")

    print("phase 4 (l): tools.ablate on corpus32's first chunk, one rep",
          flush=True)
    res = ablate.run_ablation(reps=1, device="cuda", log=lambda m: None)
    names = [v[0] for v in ablate.variants()]
    bad = [n for n in names
           if not np.isfinite(res.get(n, {}).get("ms", np.nan))]
    if list(res) != names or bad:
        raise AssertionError(f"ablate: variants {list(res)} (want {names}), "
                             f"no time for {bad}")
    print(f"  every variant returned: {', '.join(names)}", flush=True)


def _check_timer(decode_corpus, corpus):
    """One s16 run with a caller's DecodeTimer: each chunk's marks present
    and in order, and the timer's h2d and d2h byte counters equal to the
    call's ``stats``."""
    from vorbispizza_tpu_torch import DecodeTimer

    timer = DecodeTimer()
    stats = decode_corpus(corpus, device="cuda", output="s16",
                          timer=timer).stats
    names = [n for n, _ in timer.events]
    at = dict(timer.events)
    for k in range(stats["chunks"]):
        keys = [f"c{k}.{m}" for m in MARKS]
        if any(n not in at for n in keys):
            raise AssertionError(f"timer: chunk {k} has marks "
                                 f"{[n for n in keys if n in at]}")
        order = [names.index(n) for n in keys]
        times = [at[n] for n in keys]
        if order != sorted(order) or times != sorted(times):
            raise AssertionError(f"timer: chunk {k}'s marks out of order: "
                                 f"{list(zip(keys, times))}")
    counts = {n: timer.counters.get(n) for n in ("h2d_bytes", "d2h_bytes")}
    if any(v != stats[n] for n, v in counts.items()):
        raise AssertionError(f"timer: counters {counts} differ from stats")
    print(f"  DecodeTimer: {stats['chunks']} chunks, each with its "
          f"{len(MARKS)} marks in order; counters {json.dumps(counts)} equal "
          f"to stats", flush=True)


def _quantize(pcm, np):
    return np.clip(np.rint(pcm * np.float32(32768.0)), -32768,
                   32767).astype(np.int16)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "vorbispizza_tpu_torch")):
        print("chip_smoke.py: the vorbispizza_tpu_torch package is not beside "
              "this script; run it from the repository root", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import concurrent.futures as cf
    import multiprocessing as mp

    import numpy as np

    from vorbispizza_tpu_torch import decode_corpus, kernels, native
    from vorbispizza_tpu_torch.kernels import build
    from vorbispizza_tpu_torch.testing import floor0_32
    from vorbispizza_tpu_torch.testing.corpus32 import load_corpus

    corpus = load_corpus()
    # the floor0 corpus and the float64 anchors are made on CPU workers
    # while the card works
    pool = cf.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=mp.get_context("spawn"),
    )
    try:
        f0_futs = floor0_32.submit(pool)
        anchor_futs = [pool.submit(_anchor, d) for d in corpus]
        stats_fut = pool.submit(_scalar_stats, corpus[0])

        # -- phase 1: card, versions, host front end
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()
        card = smi[0].strip()
        print("phase 1: card, versions, front end")
        print(card)
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        print(f"  host front end: "
              f"{'native C++' if native.available() else 'pure Python'}",
              flush=True)
        dev = torch.device("cuda", 0)

        # -- phase 2: kernel build
        t0 = time.perf_counter()
        kernels.load()
        print(f"phase 2: kernels built and loaded in "
              f"{time.perf_counter() - t0:.1f} s ({build.library_path().name})")
        log = build.BUILD / "nvcc.log"
        for line in log.read_text().splitlines() if log.exists() else []:
            if "entry function" in line or "Used" in line:
                print("  ptxas:", line.split(":", 1)[1].strip())
        sys.stdout.flush()

        # -- phase 3: each kernel against its twin
        print("phase 3: kernels against their plain twins (first chunk)",
              flush=True)
        from vorbispizza_tpu_torch.device import resolve_device

        resolve_device(dev)
        checks = check_kernels(corpus, dev)
        checks.update(check_fallback_kernels(corpus, dev))
        t0 = time.perf_counter()
        f0_corpus = floor0_32.collect(f0_futs)
        print(f"  floor0 corpus: {len(f0_corpus)} streams, "
              f"{sum(map(len, f0_corpus))} B, sha256s match (waited "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        f0_anchor_futs = [pool.submit(_anchor, d) for d in f0_corpus]
        checks.update(check_floor0_kernel(f0_corpus, dev))

        # -- phase 4: the paths, each with fresh launch counts
        from vorbispizza_tpu_torch.config import VorbisConfig
        from vorbispizza_tpu_torch.models.pipeline import BatchSynthesizer
        from vorbispizza_tpu_torch.utils import link

        runs = {}

        def path(name, fn):
            """``fn()`` with the launch counts set to 0 just before it and
            read just after; each kernel of RUN_KERNELS[name] must have
            launched."""
            kernels.reset_counts()
            out = fn()
            runs[name] = dict(kernels.COUNTS)
            print(f"  [{name}] launches {runs[name]}", flush=True)
            missing = [k for k in RUN_KERNELS.get(name, ())
                       if runs[name][k] == 0]
            if missing:
                raise AssertionError(f"{name}: kernels never launched: "
                                     f"{missing}")
            return out

        def run(name, output, sources=corpus, opts=None, **settings):
            opts = opts or {"device": "cuda"}
            with configured(**settings):
                outs = path(name, lambda: decode_corpus(
                    sources, output=output, **opts))
            stats = outs.stats
            print(f"  [{name}] stats {json.dumps(stats)}", flush=True)
            if stats["scalar"] or stats["batched"] != len(sources):
                raise AssertionError(f"streams left the batch path: {stats}")
            return outs

        def same(name, outs, ref, what):
            if not all(a.dtype == b.dtype and np.array_equal(a, b)
                       for a, b in zip(outs, ref)):
                raise AssertionError(f"{name}: output differs from {what}")
            print(f"  identical to {what}; d2h {outs.stats['d2h_bytes']} B",
                  flush=True)

        print("phase 4: decode_corpus(corpus, device='cuda', output='f32')",
              flush=True)
        f32 = run("f32", "f32")
        anchors = [fut.result() for fut in anchor_futs]
        errs = []
        for i, (pcm, ref) in enumerate(zip(f32, anchors)):
            if pcm.shape != ref.shape or not np.isfinite(pcm).all():
                raise AssertionError(f"stream {i}: shape {pcm.shape} vs "
                                     f"{ref.shape} or non-finite PCM")
            errs.append(float(np.abs(pcm.astype(np.float64) - ref).max()))
        print(f"  max abs vs float64 anchor over {len(errs)} streams: "
              f"{max(errs):.3e} (limit {ANCHOR_TOL:g})", flush=True)
        if max(errs) > ANCHOR_TOL:
            raise AssertionError(f"anchor error {max(errs)} > {ANCHOR_TOL}")

        cfg = VorbisConfig.default
        rate = link.d2h_rate_estimate(dev)
        rice = BatchSynthesizer._resolve_rice(dev)
        print(f"phase 4: decode_corpus(corpus, device='cuda', output='s16'), "
              f"s16_wire={cfg.s16_wire!r}, s16_rice={cfg.s16_rice!r}: "
              f"measured d2h {rate / 1e6:.1f} MB/s -> rice {rice} "
              f"(threshold {cfg.s16_rice_threshold_mbps} MB/s) [{card}]",
              flush=True)
        s16 = run("s16", "s16")
        lsb = 0
        for i, (got, pcm, ref) in enumerate(zip(s16, f32, anchors)):
            if got.dtype != np.int16 or not np.array_equal(got,
                                                           _quantize(pcm, np)):
                raise AssertionError(f"stream {i}: s16 differs from the host "
                                     "quantization of this card's f32")
            ref_q = np.clip(np.rint(ref * 32768.0), -32768, 32767)
            lsb = max(lsb, int(np.abs(got.astype(np.int64) - ref_q).max()))
        print(f"  every stream equals the host quantization of the f32 "
              f"output; max |s16 - quantized anchor| = {lsb} LSB "
              f"(limit {S16_TOL})", flush=True)
        if lsb > S16_TOL:
            raise AssertionError(f"s16 off the anchor by {lsb} LSB")
        for name, wire, rice_mode in (("rice", "dpack", "on"),
                                      ("raw", "raw", cfg.s16_rice),
                                      ("planes", "planes", cfg.s16_rice)):
            print(f"phase 4: output='s16', s16_wire={wire!r}, "
                  f"s16_rice={rice_mode!r}", flush=True)
            same(name, run(name, "s16", s16_wire=wire, s16_rice=rice_mode),
                 s16, "the default wire's int16")

        print(f"phase 4: the fallback wires {FALLBACK}, output='f32' and "
              f"'s16'", flush=True)
        same("fallback_f32", run("fallback_f32", "f32", **FALLBACK), f32,
             "the default config's f32")
        same("fallback_s16", run("fallback_s16", "s16", **FALLBACK), s16,
             "the default config's int16")

        print("phase 4: the floor0 corpus, output='f32', 's16' and 'f32' "
              "under residue_transport='values'", flush=True)
        f0_f32 = run("floor0_f32", "f32", f0_corpus)
        f0_anchors = [fut.result() for fut in f0_anchor_futs]
        f0_err, f0_share, f0_lsb = 0.0, 0.0, 0
        for i, (pcm, ref) in enumerate(zip(f0_f32, f0_anchors)):
            if pcm.shape != ref.shape or not np.isfinite(pcm).all():
                raise AssertionError(f"floor0 stream {i}: shape {pcm.shape} "
                                     f"vs {ref.shape} or non-finite PCM")
            f0_err = max(f0_err,
                         float(np.abs(pcm.astype(np.float64) - ref).max()))
        print(f"  f32: max abs vs float64 anchor {f0_err:.3e} over "
              f"{len(f0_f32)} streams (floor0 is float32 LSP synthesis; "
              f"the s16 budget below is the gate)", flush=True)
        f0_s16 = run("floor0_s16", "s16", f0_corpus)
        for i, (got, pcm, ref) in enumerate(zip(f0_s16, f0_f32, f0_anchors)):
            if got.dtype != np.int16 or not np.array_equal(got,
                                                           _quantize(pcm, np)):
                raise AssertionError(f"floor0 stream {i}: s16 differs from the "
                                     "host quantization of this card's f32")
            ref_q = np.clip(np.rint(ref * 32768.0), -32768, 32767)
            diff = np.abs(got.astype(np.int64) - ref_q)
            share = float((diff > FLOOR0_LSB).mean())
            f0_share, f0_lsb = max(f0_share, share), max(f0_lsb, diff.max())
            if share > FLOOR0_SHARE:
                raise AssertionError(f"floor0 stream {i}: {share:.3e} of "
                                     f"samples over {FLOOR0_LSB} LSB")
        print(f"  s16: equals the host quantization of the f32 output; worst "
              f"stream has {f0_share:.3e} of samples over {FLOOR0_LSB} LSB "
              f"from the quantized anchor (limit {FLOOR0_SHARE:g}), max "
              f"{int(f0_lsb)} LSB", flush=True)
        same("floor0_values",
             run("floor0_values", "f32", f0_corpus,
                 residue_transport="values"),
             f0_f32, "the symbol wire's f32")
        check_entry_points(run, same, corpus, anchors, f32, s16,
                           stats_fut.result(), np, card)

        check_scale_out(path, corpus, anchors, f32, s16, np, card)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # -- phase 5: kernel times (the CPU workers have stopped), throughput
    print("phase 5: kernel, plain twin and library times (CUDA events, "
          f"mean of 20 after a warm call) [{card}]", flush=True)
    for res in checks.values():
        _time(res)
    print("phase 5: s16 (output='s16') under torch.profiler, after a warm "
          "run with a DecodeTimer", flush=True)
    _check_timer(decode_corpus, corpus)
    prof = _profile_run(lambda: decode_corpus(corpus, device="cuda",
                                              output="s16"))
    _print_profile("s16", prof, card)

    keys = ("max_abs_err", "ms", "device_ms", "device_all_ms",
            "device_launches", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def entry(name):
        src, ref, run_name, key, *check = KERNELS[name]
        e = {"name": name, "route": "cuda", "source": src, "replaces": ref,
             "run": run_name, "launches": runs[run_name][key],
             "launches_per_run": {r: c[key] for r, c in runs.items()
                                  if c[key]},
             **{k: checks[(check or [key])[0]][k] for k in keys}}
        if name == "ola_assemble":
            e["modes"] = {
                mode: {"replaces": mref, "run": mrun,
                       "launches": runs[mrun][mkey],
                       "launches_per_run": {r: c[mkey] for r, c in runs.items()
                                            if c[mkey]},
                       **{k: checks[f"ola_assemble_{mode}"][k] for k in keys},
                       **{chunk: {k: checks[f"ola_assemble_{mode}{sfx}"][k]
                                  for k in keys}
                          for chunk, sfx in K4_CHUNKS.items() if sfx}}
                for mode, (_, _, mref, mrun, mkey) in K4_MODES.items()
            }
        return e

    print(json.dumps({"kernels": [entry(name) for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
