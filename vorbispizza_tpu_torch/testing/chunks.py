"""The first merged chunk that ``decode_corpus`` forms from a list of
streams, prepared on the host: the inputs of the kernel checks in
``chip_smoke.py``, of the stage ablation (tools/ablate.py), of
``entry.entry`` and of the CPU tests that follow one chunk through the
device half."""

from __future__ import annotations

from ..config import VorbisConfig
from ..models.corpus import _front_end, merge_streams, synthesizer_of


def first_merge(srcs):
    """(synth, plan, buckets, PCM lengths) of the first chunk that
    ``decode_corpus`` forms from ``srcs`` under the current config."""
    fronts, cost = [], 0
    for data in srcs:
        fronts.append(_front_end(data))
        cost += sum(b.batch_cost for b in fronts[-1][3])
        if cost >= VorbisConfig.default.corpus_batch_bytes:
            break
    plan, buckets, lengths = merge_streams([f[2:4] for f in fronts])
    return synthesizer_of(fronts), plan, buckets, lengths


def first_chunk(srcs, output: str = "f32"):
    """(synth, sig, host arrays, streams merged) of the first chunk that
    ``decode_corpus`` forms from ``srcs`` under the current config,
    prepared for ``output``."""
    synth, plan, buckets, lengths = first_merge(srcs)
    sig, host, _ = synth.prepare_host(plan, buckets, output)
    return synth, sig, host, len(lengths)
