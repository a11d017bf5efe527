"""A front-end worker's split of long streams into pieces: the pieces'
plans and their extract_batch (stats["stage_s"]["split"]), in
milliseconds per audio second; None where the program has no such stage."""

from vpbench.readers import per_audio_ms


def read(run):
    if not all("split" in (c.stats or {}).get("stage_s", {})
               for c in run.calls):
        return None
    return per_audio_ms(run, "split")
