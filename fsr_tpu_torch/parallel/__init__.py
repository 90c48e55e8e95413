"""Multi-device execution: batch sharding and row (spatial) sharding."""

from fsr_tpu_torch.parallel.sharding import Mesh, make_mesh, shard_batch, upscale_batch_sharded
from fsr_tpu_torch.parallel.spatial import spatial_shardable, upscale_spatial_sharded

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "upscale_batch_sharded",
    "spatial_shardable",
    "upscale_spatial_sharded",
]
