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
   (bytes over 3.35 TB/s or operations over 67 TFLOP/s, counted from this
   run's inputs). K1-K3 on the committed corpus's chunk; K4 in its four
   modes (f32, s16, s16p and dpack, the last with rice off and on) on that
   chunk, on it prepared under the fallback config (floor1_wire="posts",
   residue_transport="values") and on the floor0 corpus's chunk; on the
   first and the last, the dpack select (K4's dpack mode) against
   ``dpack_select_plain`` of the card's q, K6 (header and planes) and K7
   (unary) in both rice modes, and the composed wire; K2's posts mode and
   K9 (value residues) on the fallback chunk; K1 (format 0) and K8
   (floor0) on the floor0 chunk. K1 runs once a bucket, K2 as its rank
   kernel then its main kernel, K4 as its chain-state scan then its tiled
   kernel. All are held with
   ``torch.equal`` (K8's twin takes K8's steps in K8's order, with the
   card's own cos/sqrt/exp; on a miss its max ulp distance and the share
   of values that differ are printed);
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
   bit-equal to the symbol wire's;
5. once the CPU workers of phases 3-4 have stopped: each kernel's time,
   its twin's and, where one PyTorch call computes the same function,
   that call's (CUDA events around 20 calls after a warm one, at phase
   3's inputs: ``ms``, the host's wall per call), and the DCT-IV product's
   (``torch.matmul``, against its bound by operations); then the kernel's
   20 calls again under torch.profiler: ``device_ms``, the device time
   per call of the kernel's own CUDA kernels, ``device_all_ms`` of every
   device op of the call, and ``device_launches``, the device ops per
   call (fills and scans around the kernel included). Then one warm and
   three timed runs each of the default f32 and s16, the fallback s16 and
   the floor0 f32: realtime factor, stage walls and device->host bytes;
   and one more s16 run under torch.profiler: the device's busy and idle
   share of its window and its top device ops by time.

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
}


def _anchor(data: bytes):
    """float64 scalar decode of one stream (runs in a worker process)."""
    from vorbispizza_tpu_torch.reader import VorbisReader

    r = VorbisReader(data)
    r.initialize()
    return r.read_all(planar=True)


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
    return {"chunks": chunks, "chunks_traced": k4,
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
             view_p=None, library_fn=None, check=None, kernel=None):
    """Run both on the same inputs; assert bit-equality of their outputs
    (or ``check(got, want)``, which returns a note); bound the work from
    ``inputs``, the compared outputs and ``ops`` (a function of the
    outputs). The result keeps the functions to time (``_time`` times
    them once the CPU workers have stopped: host contention stretches the
    launch gaps of these small kernels) and ``kernel``, the part of the
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
           **_bound(_nbytes(inputs), _nbytes(got), ops(got))}
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
    from vorbispizza_tpu_torch.ops import coupling, floor

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
    stage = [(bk, synth.residues(bk), synth.floors(bk), bk["tables"]["steps"])
             for bk in bks]
    out["couple_spectrum"] = _compare(
        "couple_spectrum",
        lambda: [coupling.couple_spectrum(r, f, s) for _, r, f, s in stage],
        lambda: [coupling.couple_spectrum_plain(r, f, s)
                 for _, r, f, s in stage],
        inputs=[t for _, r, f, s in stage for t in (r, f, s)],
        ops=lambda o: sum(r.numel() * (1 + s.shape[0])
                          for _, r, _f, s in stage),
    )
    spectra = [(bk, coupling.couple_spectrum(r, f, s)) for bk, r, f, s in stage]
    out["dct_iv"] = _dct_row(synth, spectra)
    obks = [synth.ola_bucket(bk, synth.dct(bk, sp)) for bk, sp in spectra]
    evs, L, C = bufs[4:9], sig[3], synth.channels
    out.update(_check_k4(obks, evs, L, C, K4_CHUNKS["corpus32"]))
    print(f"  dpack wire: C {C}, L {L}, NBt {C * -(-L // 128)}", flush=True)
    for rice in (False, True):
        out.update(_check_dpack(obks, evs, L, rice, dev))
    return out


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


def _ola_operands(synth, bks):
    """K4's bucket operands of a chunk, made by the kernels before it."""
    from vorbispizza_tpu_torch.ops import coupling

    return [synth.ola_bucket(bk, synth.dct(bk, coupling.couple_spectrum(
        synth.residues(bk), synth.floors(bk), bk["tables"]["steps"])))
        for bk in bks]


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
    ``dpack_select_plain`` of the card's q, K6 and (rice) K7 on the card's
    q and select, then ``dpack_wire`` on them against the composed twin,
    below nbytes (full-capacity wire). A function of its own per rice mode,
    so the kept closures bind this mode's buffers."""
    import torch

    from vorbispizza_tpu_torch.ops import ola
    from vorbispizza_tpu_torch.ops import pcm_pack as pp

    C = obks[0][0].shape[1]
    nbt = pp.wire_rows(L, C)
    hdr = pp.wire_header_bytes(C)
    cap, ucap, urow = pp.wire_caps(nbt, True)
    tag, key = (" (rice)", "_rice") if rice else (" (width-only)", "")
    tag, key = tag + suffix, key + suffix
    wire, wview = pp.wire_buffer(C, L, cap, ucap, rice, dev)
    q, wbyte, ubits = ola.ola_assemble(obks, evs, L, "dpack", rice=rice,
                                       wbyte=wview)
    out = {}
    out["dpack_select" + key] = _compare(
        "dpack_select" + tag,
        lambda: list(ola.ola_assemble(obks, evs, L, "dpack", rice=rice,
                                      wbyte=wview)),
        lambda: [q, *pp.dpack_select_plain(q, rice)],
        inputs=[t for b in obks for t in b] + list(evs),
        ops=lambda _: 36 * q.numel(), kernel="ola_assemble",
    )
    scan = pp.dpack_scan(wbyte, ubits, urow, rice)
    nb_plane = 16 * int(scan["gcum"][-1])
    n_k6 = hdr + nbt + min(nb_plane, 16 * cap)
    out["dpack_pack" + key] = _compare(
        "dpack_pack" + tag,
        lambda: pp.dpack_pack(q, wire, scan, cap, rice),
        lambda: pp.dpack_pack_plain(q, wbyte, scan, cap, rice),
        inputs=[q, wbyte, *scan.values()], ops=lambda _: 8 * q.numel(),
        kernel="dpack_pack", view_k=lambda _: [wire[:n_k6]],
        view_p=lambda w: [w[:n_k6]],
    )
    if rice:
        ub = min(4 * int(scan["ucum"][-1]), 4 * ucap)
        out["dpack_unary" + suffix] = _compare(
            "dpack_unary" + tag,
            lambda: pp.dpack_unary(q, wire, scan, cap, ucap, urow),
            lambda: pp.dpack_unary_plain(q, wbyte, ucap, urow),
            inputs=[q, wbyte, *scan.values()],
            ops=lambda _: 8 * q.numel(), kernel="dpack_unary",
            view_k=lambda _: [wire[n_k6 : n_k6 + ub]],
            view_p=lambda u: [u[:ub]],
        )
    wk = pp.dpack_wire(q, cap, ucap, urow, rice, select=(wbyte, ubits),
                       wire=wire)
    wp = pp.dpack_wire_plain(q, cap, ucap, urow, rice)
    nb = int(wk[:4].cpu().numpy().view("<i4")[0])
    if not torch.equal(wk[: hdr + nbt + nb], wp[: hdr + nbt + nb]):
        raise AssertionError(f"dpack_wire{tag}: kernels differ from twin")
    print(f"  dpack_wire{tag}: {nb} payload bytes "
          f"({nb / (2 * C * L):.4f} of raw s16), equal to the twin",
          flush=True)
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
    out.update(_check_k4(_ola_operands(synth, bks), bufs[4:9], sig[3],
                         synth.channels, K4_CHUNKS["fallback"]))
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
        ops=lambda o: sum(a[2].numel() * a[3].shape[1] * (4 * a[4] + 8)
                          for a in calls),
        check=_floor0_check,
    )}
    obks = _ola_operands(synth, bks)
    suffix = K4_CHUNKS["floor0"]
    out.update(_check_k4(obks, bufs[4:9], sig[3], synth.channels, suffix))
    for rice in (False, True):
        out.update(_check_dpack(obks, bufs[4:9], sig[3], rice, dev, suffix))
    return out


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
    from vorbispizza_tpu_torch.testing.corpus32 import audio_seconds, load_corpus

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

        def run(name, output, sources=corpus, **settings):
            with configured(**settings):
                kernels.reset_counts()
                outs = decode_corpus(sources, device="cuda", output=output)
                runs[name] = dict(kernels.COUNTS)
            stats = outs.stats
            print(f"  [{name}] launches {runs[name]}; stats "
                  f"{json.dumps(stats)}", flush=True)
            missing = [k for k in RUN_KERNELS[name] if runs[name][k] == 0]
            if missing:
                raise AssertionError(f"{name}: kernels never launched: "
                                     f"{missing}")
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
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # -- phase 5: kernel times (the CPU workers have stopped), throughput
    print("phase 5: kernel, plain twin and library times (CUDA events, "
          f"mean of 20 after a warm call) [{card}]", flush=True)
    for res in checks.values():
        _time(res)
    f0_seconds = sum(p.shape[1] for p in f0_f32) / floor0_32.RECIPE["rate"]
    for name, output, sources, seconds, settings in (
            ("f32", "f32", corpus, audio_seconds(), {}),
            ("s16", "s16", corpus, audio_seconds(), {}),
            ("fallback_s16", "s16", corpus, audio_seconds(), FALLBACK),
            ("floor0_f32", "f32", f0_corpus, f0_seconds, {})):
        print(f"phase 5: {name} (output={output!r}): one warm run, three "
              f"timed runs", flush=True)
        with configured(**settings):
            decode_corpus(sources, device="cuda", output=output)
            rtfs = []
            for rep in range(3):
                t0 = time.perf_counter()
                o = decode_corpus(sources, device="cuda", output=output)
                wall = time.perf_counter() - t0
                rtfs.append(seconds / wall)
                print(f"  run {rep}: {wall:.4f} s, {rtfs[-1]:.1f}x realtime; "
                      f"d2h {o.stats['d2h_bytes']} B; stages "
                      f"{json.dumps(o.stats['stage_s'])} [{card}]",
                      flush=True)
            print(f"  {name}: median realtime factor {sorted(rtfs)[1]:.1f}x "
                  f"over {seconds:.2f} s of audio [{card}]", flush=True)
            if name == "s16":
                prof = _profile_run(lambda: decode_corpus(
                    sources, device="cuda", output=output))
                _print_profile(name, prof, card)

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
