"""Placing each piece's PCM into its stream's answer
(stats["stage_s"]["stitch"]), in milliseconds per audio second; None
where the program has no such stage."""

from vpbench.readers import per_audio_ms


def read(run):
    if not all("stitch" in (c.stats or {}).get("stage_s", {})
               for c in run.calls):
        return None
    return per_audio_ms(run, "stitch")
