"""Decode Ogg Vorbis files to WAV — the reference TestApp analog
(reference TestApp/Program.cs:9, WaveWriter.cs). Port of
vorbispizza_tpu/tools/decode.py.

    python -m vorbispizza_tpu_torch.tools.decode [--scalar] [--s16]
        [--out DIR] [--device cuda] file.ogg [file2.ogg ...]

--scalar uses the streaming float64 decoder (decoder.py); by default the
batch pipeline decodes each file on --device (models/pipeline.py
decode_file_batch; "cuda" unless told otherwise, "cpu" runs the plain
twins). Output is IEEE-float WAV (or PCM16 with --s16), one file per
input, plus a one-line decode report per file.
"""

from __future__ import annotations

import argparse
import pathlib
import struct
import sys
import time

import numpy as np


def write_wav(path, pcm: np.ndarray, sample_rate: int) -> None:
    """pcm: planar [channels, samples], float32 (IEEE float WAV) or int16."""
    channels, frames = pcm.shape
    interleaved = np.ascontiguousarray(pcm.T)
    data = interleaved.tobytes()
    if pcm.dtype == np.int16:
        fmt_tag, bits = 1, 16
    else:
        fmt_tag, bits = 3, 32
    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(
            struct.pack(
                "<IHHIIHH", 16, fmt_tag, channels, sample_rate, byte_rate,
                block_align, bits,
            )
        )
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+")
    ap.add_argument("--scalar", action="store_true", help="streaming float64 decoder")
    ap.add_argument("--s16", action="store_true", help="write PCM16 instead of float WAV")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--device", default="cuda",
                    help="batch decode device: cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    from vorbispizza_tpu_torch.reader import VorbisReader

    for name in args.files:
        t0 = time.perf_counter()
        r = VorbisReader(name)
        r.initialize()
        rate = r.sample_rate
        if args.scalar:
            pcm = r.read_all(planar=True)
        else:
            from vorbispizza_tpu_torch.models.pipeline import decode_file_batch

            pcm = decode_file_batch(name, device=args.device)
        if args.s16:
            pcm = np.clip(
                np.rint(pcm.astype(np.float64) * 32768.0), -32768, 32767
            ).astype(np.int16)
        dt = time.perf_counter() - t0
        wav = out_dir / (pathlib.Path(name).stem + ".wav")
        write_wav(wav, pcm, rate)
        dur = pcm.shape[1] / rate
        print(
            f"{name}: {pcm.shape[1]} samples x{pcm.shape[0]}ch @ {rate} Hz "
            f"({dur:.2f}s) -> {wav}  [{dur / dt:.1f}x realtime]"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
