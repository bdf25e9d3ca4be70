"""Sharded indexes over a mesh of devices (port of lab_1806_vec_db_tpu/parallel)."""

from . import sharded
from .dryrun import dryrun_multichip
from .sharded import (Mesh, ShardedFlatIndex, ShardedHNSWIndex, ShardedIVFIndex, ShardedIVFPQIndex,
                      ShardedPQFlatIndex, kmeans_step_sharded, make_mesh, shard_base)

__all__ = ["sharded", "Mesh", "make_mesh", "shard_base", "kmeans_step_sharded", "ShardedFlatIndex",
           "ShardedPQFlatIndex", "ShardedIVFIndex", "ShardedHNSWIndex", "ShardedIVFPQIndex",
           "dryrun_multichip"]
