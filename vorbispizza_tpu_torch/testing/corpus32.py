"""The committed bench corpus: 32 stereo 15 s 44.1 kHz q0.5 streams.

Same recipe as the JAX package's bench corpus (``bench.py``): member ``s``
is ``encode_vorbis(make_signal(2, 15.0, rate=44100, kind="music",
seed=s), rate=44100, quality=0.5)``. libvorbisenc output is deterministic,
so the committed files reproduce byte for byte; ``MANIFEST.json`` records
the recipe and each file's sha256. Machines without libvorbisenc read the
files instead of encoding them.

Regenerate with ``python -m vorbispizza_tpu_torch.testing.corpus32``.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2] / "testdata" / "corpus32"

RECIPE = {
    "encoder": "vorbispizza_tpu_torch.testing.encode.encode_vorbis",
    "signal": "vorbispizza_tpu_torch.testing.encode.make_signal",
    "streams": 32,
    "seeds": "0..31",
    "channels": 2,
    "seconds": 15.0,
    "rate": 44100,
    "kind": "music",
    "quality": 0.5,
}


def member_name(seed: int) -> str:
    return f"s{seed:02d}.ogg"


def encode_member(seed: int) -> bytes:
    """Encode member ``seed`` with the recipe (needs libvorbisenc)."""
    from .encode import encode_vorbis, make_signal

    r = RECIPE
    return encode_vorbis(
        make_signal(r["channels"], r["seconds"], rate=r["rate"],
                    kind=r["kind"], seed=seed),
        rate=r["rate"],
        quality=r["quality"],
    )


def load_corpus(root: pathlib.Path = ROOT) -> list[bytes]:
    """The 32 members as bytes, each checked against MANIFEST.json."""
    manifest = json.loads((root / "MANIFEST.json").read_text())
    out = []
    for name, digest in manifest["sha256"].items():
        data = (root / name).read_bytes()
        if hashlib.sha256(data).hexdigest() != digest:
            raise ValueError(f"{name}: sha256 differs from MANIFEST.json")
        out.append(data)
    return out


def audio_seconds() -> float:
    return RECIPE["streams"] * RECIPE["seconds"]


def write_corpus(root: pathlib.Path = ROOT) -> None:
    root.mkdir(parents=True, exist_ok=True)
    digests = {}
    for seed in range(RECIPE["streams"]):
        data = encode_member(seed)
        (root / member_name(seed)).write_bytes(data)
        digests[member_name(seed)] = hashlib.sha256(data).hexdigest()
    manifest = {"recipe": RECIPE, "sha256": digests}
    (root / "MANIFEST.json").write_text(json.dumps(manifest, indent=1) + "\n")


if __name__ == "__main__":
    write_corpus()
