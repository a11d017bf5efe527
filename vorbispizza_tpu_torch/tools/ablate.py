"""Stage ablation of the device decode on one merged chunk.

Port of vorbispizza_tpu/tools/ablate.py. Times ``BatchSynthesizer.forward``
on the first merged chunk that ``decode_corpus`` forms from a corpus (by
default the committed 32 x 15 s corpus, testdata/corpus32), then re-times
variants with one stage each snapped out by patching the pipeline-level
calls that ``forward`` makes. Differences against the full run attribute
the device time per stage:

  full_s16df     the main path: K1, K2, K3, DCT-IV, K4 (dpack mode), K6
  no_pack(s16)   K4's s16 mode, no K6
  no_quant(f32)  K4's f32 mode
  no_ola         K4 (with the select its dpack mode makes) replaced by a
                 slice of the first bucket's DCT-IV output and every block
                 at the widest rung; K6 packs it
  no_synth_math  K2, K3 and the DCT-IV skipped (the residues go to K4)
  no_res_expand  K1 (or K9) replaced by zeros
  takes_only     s16, with no_ola, no_synth_math and no_res_expand

The reference's ``pack_d2_only``, ``pack_no_mm`` and ``pack_no_gather``
have no counterpart here: the stages they cut (the candidate select, the
bit-plane matmul and the row gather) are fused into K4's dpack mode and
K6.

On a card each variant is timed with CUDA events around ``reps`` calls
after a warm call (the host's launch work included); on the CPU with the
host clock.

Usage: python -m vorbispizza_tpu_torch.tools.ablate [reps=5]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _patched(monkey: dict):
    """Temporarily replace attributes given as {(obj, name): replacement}."""
    saved = {key: getattr(*key) for key in monkey}
    try:
        for (obj, name), repl in monkey.items():
            setattr(obj, name, repl)
        yield
    finally:
        for (obj, name), orig in saved.items():
            setattr(obj, name, orig)


def _slice_ola(buckets, evs, L, mode="f32", rice=False, wbyte=None):
    """K4's stand-in: the first bucket's DCT-IV rows laid end to end and
    cut to L, in the mode's output types (no events, no window); for the
    dpack mode a constant select, every block at the widest rung."""
    d = buckets[0][0]
    C = d.shape[1]
    flat = d.transpose(0, 1).reshape(C, -1)
    pcm = F.pad(flat, (0, max(0, L - flat.shape[1])))[:, :L]
    if mode == "f32":
        return pcm.contiguous()
    q = (pcm.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
    if mode == "s16":
        return q
    from ..ops.pcm_pack import WIDTHS

    wbyte.fill_(len(WIDTHS) - 1)
    return q, wbyte, torch.zeros(wbyte.shape[0], dtype=torch.int32,
                                 device=q.device)


def _flat_couple(parts):
    """K3's stand-in: the residues as the spectra (no floor, no coupling)."""
    return None, [res for res, _, _ in parts]


def variants():
    """(name, output, patches) of each timed variant, the full run first."""
    from ..models import pipeline as pl

    BS = pl.BatchSynthesizer
    no_ola = {(pl, "ola_assemble"): _slice_ola}
    no_synth = {(BS, "floors"): lambda self, bk: None,
                (pl, "couple_spectrum_chunk"): _flat_couple,
                (BS, "dct"): lambda self, bk, spectra: spectra}
    no_res = {(BS, "residues"): lambda self, bk: torch.zeros(
        (bk["Fp"], self.channels, bk["n"] // 2), device=bk["device"])}
    return [
        ("full_s16df", "s16df", {}),
        ("no_pack(s16)", "s16", {}),
        ("no_quant(f32)", "f32", {}),
        ("no_ola", "s16df", no_ola),
        ("no_synth_math", "s16df", no_synth),
        ("no_res_expand", "s16df", no_res),
        ("takes_only", "s16", {**no_ola, **no_synth, **no_res}),
    ]


def _per_call(fn, reps: int, dev) -> float:
    """Seconds a call of ``fn`` after a warm call: CUDA events on a card,
    the host clock on the CPU."""
    fn()
    if dev.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def run_ablation(reps: int = 5, device="cuda", corpus=None, log=print):
    """Time each variant on ``corpus``'s first chunk (default corpus32).
    Returns {name: {"ms": per chunk call, "realtime": audio seconds a
    wall second, "delta_ms": the full run's ms minus this one's}}."""
    from ..device import resolve_device
    from ..models.launch import lanes, on, upload
    from ..reader import VorbisReader
    from ..testing.chunks import first_merge

    dev = resolve_device(device)
    if corpus is None:
        from ..testing.corpus32 import load_corpus

        corpus = load_corpus()
    synth, plan, buckets, lengths = first_merge(corpus)
    reader = VorbisReader(corpus[0])
    reader.initialize()
    audio_s = sum(lengths) / reader.sample_rate
    table = variants()
    stream, _ = lanes(dev)
    results = {}
    with on(dev, stream):
        wire = {}
        for output in {v[1] for v in table}:
            sig, host, _ = synth.prepare_host(plan, buckets, output,
                                              device=dev)
            wire[output] = (sig, upload(host, dev)[0])
        for name, output, monkey in table:
            sig, bufs = wire[output]
            with _patched(monkey):
                per = _per_call(lambda: synth(sig, bufs), reps, dev)
            base = results.get("full_s16df", {}).get("ms", per * 1e3)
            results[name] = {"ms": per * 1e3, "realtime": audio_s / per,
                             "delta_ms": base - per * 1e3}
            log(f"{name:16s} {per * 1e3:10.4f} ms/chunk  realtime "
                f"{audio_s / per:10.1f}x  delta_vs_full "
                f"{base - per * 1e3:9.4f} ms")
    log(f"chunk: {len(lengths)} streams, {audio_s:.2f} s of audio, "
        f"{len(buckets)} buckets; reps={reps}; device {dev}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vorbispizza_tpu_torch.tools.ablate")
    ap.add_argument("reps", nargs="?", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
    run_ablation(args.reps, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
