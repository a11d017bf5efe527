"""Multi-device scale-out: device meshes, sharded decode steps, corpus decode.

Port of vorbispizza_tpu/parallel. The axes that exist in this workload:

- ``stream`` (data parallel): independent files / logical streams
  (parallel/corpus.py ``decode_corpus_sharded`` runs the production
  pipeline a shard a device).
- ``frame`` (sequence parallel): frames within one stream. Synthesis is
  frame-local; overlap-add couples only ADJACENT frames, so the shard
  boundary needs exactly one frame of halo (parallel/mesh.py).

A mesh may repeat a device: its shards then run one after another on
that device's dispatch stream.
"""

from .mesh import make_mesh, sharded_decode_step

__all__ = ["make_mesh", "sharded_decode_step"]
