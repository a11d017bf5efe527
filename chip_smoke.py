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
   of the committed corpus's first merged chunk: bit-equality, both times;
4. the main path, ``decode_corpus(corpus, device="cuda", output="f32")``
   over the committed 32 x 15 s stereo corpus (testdata/corpus32): every
   kernel launched, no stream routed to the scalar decoder, every stream
   within 1e-6 max-abs of the float64 scalar anchor;
5. one warm and three timed runs: realtime factor and stage walls.

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
KERNELS = {
    # name: (source, reference stage it replaces)
    "residue_expand": ("vorbispizza_tpu_torch/csrc/residue_expand.cu",
                       "vorbispizza_tpu/ops/residue_sym.py:44"),
    "floor1_synth": ("vorbispizza_tpu_torch/csrc/floor1_synth.cu",
                     "vorbispizza_tpu/ops/floor.py:119"),
    "couple_spectrum": ("vorbispizza_tpu_torch/csrc/couple_spectrum.cu",
                        "vorbispizza_tpu/ops/coupling.py:14"),
    "ola_assemble": ("vorbispizza_tpu_torch/csrc/ola_assemble.cu",
                     "vorbispizza_tpu/ops/ola.py:220"),
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


def _compare(name, kernel_fn, plain_fn):
    """Run both on the same inputs; assert bit-equality; time both."""
    import torch

    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
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


def _first_chunk(corpus):
    """The first merged chunk decode_corpus forms from ``corpus``."""
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
    sig, host, total = synth.prepare_host(plan, buckets, "f32")
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
    stage = []
    for bk in bks:
        res = synth.place(bk, [
            (ch, None if a is None else residue_sym.expand_submap(*a))
            for ch, a in synth.residue_calls(bk)])
        flo = synth.place(bk, [
            (ch, floor.floor1_from_ys(*a)) for ch, a in synth.floor_calls(bk)])
        stage.append((bk, res, flo, bk["tables"]["steps"]))
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
    return out


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

        # -- phase 4: the main path, against the float64 anchor
        print("phase 4: decode_corpus(corpus, device='cuda', output='f32')",
              flush=True)
        kernels.reset_counts()
        outs = decode_corpus(corpus, device="cuda", output="f32")
        counts = dict(kernels.COUNTS)
        stats = outs.stats
        print(f"  launches {counts}; stats {json.dumps(stats)}", flush=True)
        missing = [k for k, v in counts.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched: {missing}")
        if stats["scalar"] or stats["batched"] != len(corpus):
            raise AssertionError(f"streams left the batch path: {stats}")
        errs = []
        for i, (fut, pcm) in enumerate(zip(anchor_futs, outs)):
            ref = fut.result()
            if pcm.shape != ref.shape or not np.isfinite(pcm).all():
                raise AssertionError(f"stream {i}: shape {pcm.shape} vs "
                                     f"{ref.shape} or non-finite PCM")
            errs.append(float(np.abs(pcm.astype(np.float64) - ref).max()))
        print(f"  max abs vs float64 anchor over {len(errs)} streams: "
              f"{max(errs):.3e} (limit {ANCHOR_TOL:g})", flush=True)
        if max(errs) > ANCHOR_TOL:
            raise AssertionError(f"anchor error {max(errs)} > {ANCHOR_TOL}")
    finally:
        anchor_pool.shutdown(wait=True, cancel_futures=True)

    # -- phase 5: throughput
    print("phase 5: one warm run, three timed runs", flush=True)
    decode_corpus(corpus, device="cuda", output="f32")
    rtfs = []
    for rep in range(3):
        t0 = time.perf_counter()
        o = decode_corpus(corpus, device="cuda", output="f32")
        wall = time.perf_counter() - t0
        rtfs.append(audio_seconds() / wall)
        print(f"  run {rep}: {wall:.4f} s, {rtfs[-1]:.1f}x realtime; stages "
              f"{json.dumps(o.stats['stage_s'])} [{card}]", flush=True)
    print(f"  median realtime factor {sorted(rtfs)[1]:.1f}x over "
          f"{audio_seconds():.0f} s of audio [{card}]", flush=True)

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": ref,
         "launches": counts[name], **checks[name]}
        for name, (src, ref) in KERNELS.items()
    ]}
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
