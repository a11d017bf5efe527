"""The floor0 corpus: 32 mono 15 s 44.1 kHz floor0 (LSP) streams.

Member ``s`` is ``rawstream.make_floor0_stream(n_packets=5169,
rate=44100, seed=s)``: a hand-built stream of the pre-1.0 libvorbis kind
(floor0 of order 4, residue type 0, blocksize 256), 5169 packets of 128
new samples each. Nothing is downloaded and nothing is committed: the
streams are made on a process pool at load time (a few seconds each on
one core) and each is checked against the sha256 recorded below, so any
drift in the generator shows.

Print the digests with ``python -m vorbispizza_tpu_torch.testing.floor0_32``,
or each member's distance from the float64 anchor with ``--errors
--device cuda`` (``--device cpu`` decodes with the kernels' plain twins).
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import multiprocessing as mp
import os

RECIPE = {
    "generator": "vorbispizza_tpu_torch.testing.rawstream.make_floor0_stream",
    "streams": 32,
    "seeds": "0..31",
    "n_packets": 5169,
    "rate": 44100,
}

#: member seed -> sha256 of its bytes
SHA256 = (
    "5266ce9db95b51b4e354174d32a4c93575f31aa00d58de33e8e269a1e8977ff0",
    "781499f400a574f6c402919959e23988a4ae72dc039dc6a14e874f30018b795a",
    "3c384ed79942e975e885df5e6bd0a6c36a6d4e67debd2f961463e227d2a502ad",
    "0de3d0ae4df8ae602af280910b1872cffdaf4bfab691d5003511b7bfc2595212",
    "76986370ae265dddab174931a7eca383b858f14bf4ef5c62e251efa381b9ba2c",
    "a601a4bc2a1effc6daa48da3eaaa1dcfd49014c87fe3fb52dd647404545fd236",
    "2813420a4b14cba5da4091f5b5c37ab20c93e9726cbb2b7b06da9f26778b629a",
    "4c5fec478421a38cd9621823ebff9545cb40001834fc4ee62738666894ecbac8",
    "e64b251c2d3e0b9c17025eaa2505e02277518badfeeeb4aaa75fd714cbfc9267",
    "518922dda1fdebc6fc42074bb73df33e5737841e514e7795d1524d7a92f43e40",
    "87bcaaf88ce5d761581a47d798ebab0c4fc8112d17d912bead1043a913ca0d98",
    "3cd71460f15781f9d91918489b6ae4b9d8e29ba980c3521abe2becbbed52c6f3",
    "cf10c7c6a765ad0cda463af4f4be8813980af32ec649a17165b700066b4b520d",
    "90df61b01ddf851dc49a56131b739b624894b53ad715e2c4d44913c52209924f",
    "5f73ee3629a8200011dbab869db861b5b9151a7f6c743d23275fe1bc8bdd46ae",
    "52133687ae808af0ff685264e368183cd9ae798a4dca2c40bdb7aeb5feb5445e",
    "6896aed9291f8a0b1edfe934c8c09a9fa644a27646f4b2de054aeb29543c615c",
    "57ac9c73ef8b6b0a6c9646bd92f42539db37bbdfe4e1d19916a04fc0937ca94d",
    "679c3f0cbafd3c2a6b0bbf23b704763ed1d3fe3ad47b83700a9b2176b192dca4",
    "49e7c890db92bdc3c174778c0c7df42ffe618fbafb1cb64d3bce71734ade62ff",
    "492ef8a9357e1941954b054f5bdd42d3f1d7366bd767f987650ea901f8a310bc",
    "5250931b2b55e0393d07a503e4edf7354f505d5604abc50f2402a3f105470fde",
    "3c275d9fab4105dbd0139f8e72fa45946c2c7c5dc29949b5d41a54ee53f2c715",
    "f50eafd4d7eeee87504ff9741e5594ace3ffe3a4299416f3dfddf81e4f811a95",
    "65d5b389291b520f565e171009164eb6e5a7573c317fca2ebc7d219ffbe28bbb",
    "77112b7f94017a5f4c3cb4a68b79607221cbe13d17fd795b3507ba2966a2c201",
    "ec9df3f5d000029e3a4723c712b02f487e5f07a321c3e42c36d1632ab9a804e1",
    "f25b7e75eac956afd4a4deb157dcc4daa3b35b36cbbc74fca230c46e9e80bcd1",
    "9757d5908cbf5be6464464cb7a6fcd5bf08ef7d3d6b1c76a8de416b746da9f87",
    "a458c3725803ab249830fdc750bcd4c0b2bdf27516da3b6a55ad3a2bf5943e14",
    "01f0a9a2e167e3b72646981645972c7b7c4b066c9fba5f455bc43e0c95b1c158",
    "4e5f9683ea79284d4d87ee995b69f35f267ad27eee58555180bb4860502f93f6",
)


def member(seed: int) -> bytes:
    """Member ``seed`` of the corpus (not checked)."""
    from . import rawstream

    return rawstream.make_floor0_stream(
        n_packets=RECIPE["n_packets"], rate=RECIPE["rate"], seed=seed)


def submit(pool: cf.Executor) -> list[cf.Future]:
    """Start making the 32 members on ``pool``; see ``collect``."""
    return [pool.submit(member, seed) for seed in range(RECIPE["streams"])]


def collect(futures: list[cf.Future]) -> list[bytes]:
    """The members of ``submit``, each checked against SHA256."""
    out = [f.result() for f in futures]
    for seed, data in enumerate(out):
        if hashlib.sha256(data).hexdigest() != SHA256[seed]:
            raise ValueError(f"floor0 member {seed}: sha256 differs from the "
                             "recorded digest")
    return out


def load_corpus(workers: int | None = None) -> list[bytes]:
    """The 32 members as bytes, made on ``workers`` processes (default:
    one per core, at most 8), each checked against SHA256."""
    workers = workers or min(8, os.cpu_count() or 1)
    with cf.ProcessPoolExecutor(max_workers=workers,
                                mp_context=mp.get_context("spawn")) as pool:
        return collect(submit(pool))


def _anchor(data: bytes):
    from ..reader import VorbisReader

    r = VorbisReader(data)
    r.initialize()
    return r.read_all(planar=True)


def anchor_errors(corpus, device: str, pool=None):
    """Per member of ``corpus``: (max-abs of ``decode_corpus(output="f32")``
    on ``device`` against the float64 anchor, the sample where it is, and
    the share of its s16 samples more than 2 LSB from the quantized
    anchor). Anchors decode on ``pool`` when one is given."""
    import numpy as np

    from ..models.corpus import decode_corpus

    anchors = (pool.map(_anchor, corpus) if pool is not None
               else map(_anchor, corpus))
    pcm = decode_corpus(corpus, device=device, output="f32")
    out = []
    for got, ref in zip(pcm, anchors):
        err = np.abs(got.astype(np.float64) - ref)
        q = np.clip(np.rint(got * np.float32(32768.0)), -32768, 32767)
        ref_q = np.clip(np.rint(ref * 32768.0), -32768, 32767)
        out.append((float(err.max()), int(err.argmax()),
                    float((np.abs(q - ref_q) > 2).mean())))
    return out


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--errors", action="store_true",
                    help="print each member's distance from the anchor")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="where --errors decodes (required with --errors)")
    args = ap.parse_args(argv)
    if args.errors and args.device is None:
        ap.error("--errors needs --device cuda (or cpu, the twins)")
    if not args.errors:
        for seed in range(RECIPE["streams"]):
            print(f'    "{hashlib.sha256(member(seed)).hexdigest()}",')
        return
    workers = min(8, os.cpu_count() or 1)
    with cf.ProcessPoolExecutor(max_workers=workers,
                                mp_context=mp.get_context("spawn")) as pool:
        corpus = collect(submit(pool))
        errs = anchor_errors(corpus, args.device, pool)
    for seed, (mx, at, share) in enumerate(errs):
        print(f"seed {seed}: max abs {mx:.4e} at sample {at}; "
              f"{share:.4e} of s16 samples over 2 LSB")
    print(f"all: max abs {max(e[0] for e in errs):.4e}; worst share "
          f"{max(e[2] for e in errs):.4e} ({args.device})")


if __name__ == "__main__":
    main()
