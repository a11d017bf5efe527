#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vorbispizza_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a),
the CUDA toolkit and PyTorch built for CUDA. It imports nothing of JAX.
Phases, each printed as it runs:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
   whether the C++ host front end is native;
2. the kernel build (nvcc, sm_90a) and its time;
3. each kernel against its plain PyTorch twin on the card, on the inputs
   of the committed corpus's first merged chunk: bit-equality, both times.
   K1-K4 on the chunk prepared as "f32"; then the chunk prepared as
   "s16df": K4's s16 and s16p modes, and on K4's q the dpack kernels K5
   (select), K6 (header and planes) and K7 (unary) in both rice modes,
   each output compared with ``torch.equal`` (the wire's header, widx,
   ch_ubit and payload bytes below nbytes);
4. the paths, each driven with the launch counts set to 0 just before it
   and read just after, over the committed 32 x 15 s stereo corpus
   (testdata/corpus32), none routing a stream to the scalar decoder:
   ``decode_corpus(corpus, device="cuda", output="f32")``, every stream
   within 1e-6 max-abs of the float64 scalar anchor; then the main path
   ``output="s16"`` under the default config (dpack wire, rice resolved
   from the measured link rate), every stream bit-equal to the host
   quantization of this card's f32 output and within 1 LSB of the
   quantized anchor; then ``s16_rice="on"`` (K7), ``s16_wire="raw"`` and
   ``s16_wire="planes"`` (K4's s16p mode), each giving identical int16;
5. one warm and three timed runs each of f32 and s16: realtime factor,
   stage walls and device->host bytes.

Any failure raises (exit code 1). Without CUDA, or without the package
beside it, it exits 2 and prints no result. The last two lines are the
kernel table and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ANCHOR_TOL = 1e-6
S16_TOL = 1  # LSB against the quantized float64 anchor
KERNELS = {
    # name: (source, reference stage it replaces, run its launches are
    # read from, launch-count key)
    "residue_expand": ("vorbispizza_tpu_torch/csrc/residue_expand.cu",
                       "vorbispizza_tpu/ops/residue_sym.py:44", "s16",
                       "residue_expand"),
    "floor1_synth": ("vorbispizza_tpu_torch/csrc/floor1_synth.cu",
                     "vorbispizza_tpu/ops/floor.py:119", "s16", "floor1_synth"),
    "couple_spectrum": ("vorbispizza_tpu_torch/csrc/couple_spectrum.cu",
                        "vorbispizza_tpu/ops/coupling.py:14", "s16",
                        "couple_spectrum"),
    "ola_assemble": ("vorbispizza_tpu_torch/csrc/ola_assemble.cu",
                     "vorbispizza_tpu/ops/ola.py:220", "s16",
                     "ola_assemble_s16"),
    "dpack_select": ("vorbispizza_tpu_torch/csrc/dpack_select.cu",
                     "vorbispizza_tpu/ops/pcm_pack.py:129", "s16",
                     "dpack_select"),
    "dpack_pack": ("vorbispizza_tpu_torch/csrc/dpack_pack.cu",
                   "vorbispizza_tpu/ops/pcm_pack.py:321", "s16", "dpack_pack"),
    "dpack_unary": ("vorbispizza_tpu_torch/csrc/dpack_unary.cu",
                    "vorbispizza_tpu/ops/pcm_pack.py:442", "rice",
                    "dpack_unary"),
}
#: K4's output modes: (reference stage, run, launch-count key)
K4_MODES = {
    "f32": ("vorbispizza_tpu/ops/ola.py:220", "f32", "ola_assemble"),
    "s16": ("vorbispizza_tpu/models/pipeline.py:819", "s16",
            "ola_assemble_s16"),
    "s16p": ("vorbispizza_tpu/models/pipeline.py:878", "planes",
             "ola_assemble_s16p"),
}
#: launch counts each run must show (the kernels on its path)
RUN_KERNELS = {
    "f32": ("residue_expand", "floor1_synth", "couple_spectrum",
            "ola_assemble"),
    "s16": ("residue_expand", "floor1_synth", "couple_spectrum",
            "ola_assemble_s16", "dpack_select", "dpack_pack"),
    "rice": ("ola_assemble_s16", "dpack_select", "dpack_pack", "dpack_unary"),
    "raw": ("ola_assemble_s16",),
    "planes": ("ola_assemble_s16p",),
}


def _anchor(data: bytes):
    """float64 scalar decode of one stream (runs in a worker process)."""
    from vorbispizza_tpu.reader import VorbisReader

    r = VorbisReader(data)
    r.initialize()
    return r.read_all(planar=True)


def _cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs (CUDA events)."""
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


def _compare(name, kernel_fn, plain_fn, view_k=None, view_p=None):
    """Run both on the same inputs; assert bit-equality of their outputs
    (``view_k``/``view_p`` map a run's result to its list of compared
    tensors); time both."""
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
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel differs from its twin "
                                 f"(max abs {err})")
    ms, plain_ms = _cuda_ms(kernel_fn), _cuda_ms(plain_fn)
    print(f"  {name}: bit-equal to its twin over {len(got)} outputs; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _first_chunk(corpus, output="f32"):
    """The first merged chunk decode_corpus forms from ``corpus``, prepared
    for ``output``."""
    from vorbispizza_tpu.config import VorbisConfig
    from vorbispizza_tpu_torch.models.corpus import (
        _front_end,
        _synthesizer_for,
        merge_streams,
    )

    fronts, cost = [], 0
    for data in corpus:
        fronts.append(_front_end(data))
        cost += sum(b.batch_cost for b in fronts[-1][3])
        if cost >= VorbisConfig.default.corpus_batch_bytes:
            break
    synth = _synthesizer_for(fronts[0][0], fronts[0][1])
    for f in fronts:
        synth.add_setup(f[0])
    plan, buckets, _ = merge_streams([f[2:4] for f in fronts])
    sig, host, total = synth.prepare_host(plan, buckets, output)
    return synth, sig, host, len(fronts)


def check_kernels(corpus, dev):
    """Phase 3: every kernel against its twin at the first chunk's shapes."""
    import torch

    from vorbispizza_tpu_torch.ops import coupling, floor, ola, residue_sym

    synth, sig, host, n_streams = _first_chunk(corpus)
    bufs = [torch.from_numpy(a).to(dev) for a in host]
    bks = synth.buckets(sig, bufs)
    print(f"  first chunk: {n_streams} streams, {len(bks)} buckets, "
          f"out_len {sig[3]}, rows " + ", ".join(
              f"{bk['Fp']}x{bk['n']}" for bk in bks), flush=True)
    res_calls = [c for bk in bks for c in synth.residue_calls(bk)
                 if c[1] is not None]
    flo_calls = [c for bk in bks for c in synth.floor_calls(bk)]
    out = {}
    out["residue_expand"] = _compare(
        "residue_expand",
        lambda: [residue_sym.expand_submap(*a) for _, a in res_calls],
        lambda: [residue_sym.expand_submap_plain(*a[:5]) for _, a in res_calls],
    )
    out["floor1_synth"] = _compare(
        "floor1_synth",
        lambda: [floor.floor1_from_ys(*a) for _, a in flo_calls],
        lambda: [floor.floor1_from_ys_plain(*a) for _, a in flo_calls],
    )
    stage = [(bk, *_stage_inputs(synth, bk), bk["tables"]["steps"])
             for bk in bks]
    out["couple_spectrum"] = _compare(
        "couple_spectrum",
        lambda: [coupling.couple_spectrum(r, f, s) for _, r, f, s in stage],
        lambda: [coupling.couple_spectrum_plain(r, f, s)
                 for _, r, f, s in stage],
    )
    ola_bks = [
        synth.ola_bucket(bk, synth.dct(bk, coupling.couple_spectrum(r, f, s)))
        for bk, r, f, s in stage
    ]
    evs = bufs[4:9]
    out["ola_assemble"] = _compare(
        "ola_assemble",
        lambda: [ola.ola_assemble(ola_bks, evs, sig[3])],
        lambda: [ola.ola_assemble_plain(ola_bks, evs, sig[3])],
    )
    out.update(check_s16_kernels(corpus, dev))
    return out


def check_s16_kernels(corpus, dev):
    """Phase 3, s16: K4's s16/s16p modes and K5-K7 on the first chunk
    prepared as "s16df" (full-capacity dpack wire)."""
    import torch

    from vorbispizza_tpu_torch.ops import coupling, ola
    from vorbispizza_tpu_torch.ops import pcm_pack as pp

    synth, sig, host, _ = _first_chunk(corpus, "s16df")
    bufs = [torch.from_numpy(a).to(dev) for a in host]
    obks = []
    for bk in synth.buckets(sig, bufs):
        res, flo = _stage_inputs(synth, bk)
        spectra = coupling.couple_spectrum(res, flo, bk["tables"]["steps"])
        obks.append(synth.ola_bucket(bk, synth.dct(bk, spectra)))
    evs, L, C = bufs[4:9], sig[3], synth.channels
    out = {}
    for mode in ("s16", "s16p"):
        out["ola_assemble_" + mode] = _compare(
            "ola_assemble_" + mode,
            lambda m=mode: [ola.ola_assemble(obks, evs, L, m)],
            lambda m=mode: [ola.ola_assemble_plain(obks, evs, L, m)],
        )
    q = ola.ola_assemble(obks, evs, L, "s16")
    nbt = pp.wire_rows(L, C)
    hdr = pp.wire_header_bytes(C)
    cap, ucap, urow = pp.wire_caps(nbt, True)
    print(f"  dpack wire: C {C}, L {L}, NBt {nbt}, caps {cap} groups, "
          f"{ucap} unary words, row {urow}", flush=True)
    for rice in (False, True):
        tag = " (rice)" if rice else " (width-only)"
        wire = torch.empty(pp.wire_bytes(C, nbt, cap, ucap, rice),
                           dtype=torch.uint8, device=dev)
        wview = wire[hdr : hdr + nbt]
        r = _compare(
            "dpack_select" + tag,
            lambda: list(pp.dpack_select(q, rice, out=wview)),
            lambda: list(pp.dpack_select_plain(q, rice)),
        )
        if not rice:
            out["dpack_select"] = r
        wbyte, ubits = pp.dpack_select(q, rice, out=wview)
        scan = pp.dpack_scan(wbyte, ubits, urow, rice)
        nb_plane = 16 * int(scan["gcum"][-1])
        n_k6 = hdr + nbt + min(nb_plane, 16 * cap)
        r = _compare(
            "dpack_pack" + tag,
            lambda: pp.dpack_pack(q, wire, scan, cap, rice),
            lambda: pp.dpack_pack_plain(q, wbyte, scan, cap, rice),
            view_k=lambda _: [wire[:n_k6]],
            view_p=lambda w: [w[:n_k6]],
        )
        if not rice:
            out["dpack_pack"] = r
        if rice:
            ub = min(4 * int(scan["ucum"][-1]), 4 * ucap)
            start = hdr + nbt + min(nb_plane, 16 * cap)
            out["dpack_unary"] = _compare(
                "dpack_unary" + tag,
                lambda: pp.dpack_unary(q, wire, scan, cap, ucap, urow),
                lambda: pp.dpack_unary_plain(q, wbyte, ucap, urow),
                view_k=lambda _: [wire[start : start + ub]],
                view_p=lambda u: [u[:ub]],
            )
        # the composed wrapper against the composed twin, below nbytes
        wk = pp.dpack_wire(q, cap, ucap, urow, rice)
        wp = pp.dpack_wire_plain(q, cap, ucap, urow, rice)
        nb = int(wk[:4].cpu().numpy().view("<i4")[0])
        if not torch.equal(wk[: hdr + nbt + nb], wp[: hdr + nbt + nb]):
            raise AssertionError(f"dpack_wire{tag}: kernels differ from twin")
        print(f"  dpack_wire{tag}: {nb} payload bytes "
              f"({nb / (2 * C * L):.4f} of raw s16), equal to the twin",
              flush=True)
    return out


def _stage_inputs(synth, bk):
    from vorbispizza_tpu_torch.ops import floor, residue_sym

    res = synth.place(bk, [
        (ch, None if a is None else residue_sym.expand_submap(*a))
        for ch, a in synth.residue_calls(bk)])
    flo = synth.place(bk, [
        (ch, floor.floor1_from_ys(*a)) for ch, a in synth.floor_calls(bk)])
    return res, flo


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

    from vorbispizza_tpu import native
    from vorbispizza_tpu_torch import decode_corpus, kernels
    from vorbispizza_tpu_torch.kernels import build
    from vorbispizza_tpu_torch.testing.corpus32 import audio_seconds, load_corpus

    corpus = load_corpus()
    # the float64 anchors decode on CPU workers while the card works
    anchor_pool = cf.ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=mp.get_context("spawn"),
    )
    try:
        anchor_futs = [anchor_pool.submit(_anchor, d) for d in corpus]

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

        # -- phase 4: the paths, each with fresh launch counts
        from vorbispizza_tpu.config import VorbisConfig
        from vorbispizza_tpu_torch.models.pipeline import BatchSynthesizer
        from vorbispizza_tpu_torch.utils import link

        runs = {}

        def run(name, output):
            kernels.reset_counts()
            outs = decode_corpus(corpus, device="cuda", output=output)
            runs[name] = dict(kernels.COUNTS)
            stats = outs.stats
            print(f"  [{name}] launches {runs[name]}; stats "
                  f"{json.dumps(stats)}", flush=True)
            missing = [k for k in RUN_KERNELS[name] if runs[name][k] == 0]
            if missing:
                raise AssertionError(f"{name}: kernels never launched: "
                                     f"{missing}")
            if stats["scalar"] or stats["batched"] != len(corpus):
                raise AssertionError(f"streams left the batch path: {stats}")
            return outs

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
            host_q = np.clip(np.rint(pcm * np.float32(32768.0)),
                             -32768, 32767).astype(np.int16)
            if got.dtype != np.int16 or not np.array_equal(got, host_q):
                raise AssertionError(f"stream {i}: s16 differs from the host "
                                     "quantization of this card's f32")
            ref_q = np.clip(np.rint(ref * 32768.0), -32768, 32767)
            lsb = max(lsb, int(np.abs(got.astype(np.int64) - ref_q).max()))
        print(f"  every stream equals the host quantization of the f32 "
              f"output; max |s16 - quantized anchor| = {lsb} LSB "
              f"(limit {S16_TOL})", flush=True)
        if lsb > S16_TOL:
            raise AssertionError(f"s16 off the anchor by {lsb} LSB")
        saved = (cfg.s16_wire, cfg.s16_rice)
        try:
            for name, wire, rice_mode in (("rice", "dpack", "on"),
                                          ("raw", "raw", saved[1]),
                                          ("planes", "planes", saved[1])):
                cfg.s16_wire, cfg.s16_rice = wire, rice_mode
                print(f"phase 4: output='s16', s16_wire={wire!r}, "
                      f"s16_rice={rice_mode!r}", flush=True)
                outs = run(name, "s16")
                if not all(np.array_equal(a, b) for a, b in zip(outs, s16)):
                    raise AssertionError(f"{name}: int16 differs from the "
                                         "default wire's")
                print(f"  identical int16 to the default wire; d2h "
                      f"{outs.stats['d2h_bytes']} B", flush=True)
        finally:
            cfg.s16_wire, cfg.s16_rice = saved
    finally:
        anchor_pool.shutdown(wait=True, cancel_futures=True)

    # -- phase 5: throughput
    for output in ("f32", "s16"):
        print(f"phase 5: output={output!r}: one warm run, three timed runs",
              flush=True)
        decode_corpus(corpus, device="cuda", output=output)
        rtfs = []
        for rep in range(3):
            t0 = time.perf_counter()
            o = decode_corpus(corpus, device="cuda", output=output)
            wall = time.perf_counter() - t0
            rtfs.append(audio_seconds() / wall)
            print(f"  run {rep}: {wall:.4f} s, {rtfs[-1]:.1f}x realtime; "
                  f"d2h {o.stats['d2h_bytes']} B; stages "
                  f"{json.dumps(o.stats['stage_s'])} [{card}]", flush=True)
        print(f"  {output}: median realtime factor {sorted(rtfs)[1]:.1f}x "
              f"over {audio_seconds():.0f} s of audio [{card}]", flush=True)

    def entry(name):
        src, ref, run_name, key = KERNELS[name]
        e = {"name": name, "route": "cuda", "source": src, "replaces": ref,
             "run": run_name, "launches": runs[run_name][key], **checks[key]}
        if name == "ola_assemble":
            e["modes"] = {
                mode: {"replaces": mref, "run": mrun,
                       "launches": runs[mrun][mkey], **checks[mkey]}
                for mode, (mref, mrun, mkey) in K4_MODES.items()
            }
        return e

    print(json.dumps({"kernels": [entry(name) for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
