"""The first merged chunk that ``decode_corpus`` forms from a list of
streams, prepared on the host: the inputs of the kernel checks in
``chip_smoke.py`` and of the CPU tests that follow one chunk through the
device half."""

from __future__ import annotations

from ..config import VorbisConfig
from ..models.corpus import _front_end, _synthesizer_for, merge_streams


def first_chunk(srcs, output: str = "f32"):
    """(synth, sig, host arrays, streams merged) of the first chunk that
    ``decode_corpus`` forms from ``srcs`` under the current config,
    prepared for ``output``."""
    fronts, cost = [], 0
    for data in srcs:
        fronts.append(_front_end(data))
        cost += sum(b.batch_cost for b in fronts[-1][3])
        if cost >= VorbisConfig.default.corpus_batch_bytes:
            break
    synth = _synthesizer_for(fronts[0][0], fronts[0][1])
    for f in fronts:
        synth.add_setup(f[0])
    plan, buckets, _ = merge_streams([f[2:4] for f in fronts])
    sig, host, _ = synth.prepare_host(plan, buckets, output)
    return synth, sig, host, len(fronts)
