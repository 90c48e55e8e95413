"""Multi-device execution: batch sharding and row (spatial) sharding, with
results that stay on their devices (``Sharded``)."""

from fsr_tpu_torch.parallel.sharding import Mesh, Sharded, make_mesh, shard_batch, upscale_batch_sharded
from fsr_tpu_torch.parallel.spatial import spatial_shardable, upscale_spatial_sharded

__all__ = [
    "Mesh",
    "Sharded",
    "make_mesh",
    "shard_batch",
    "upscale_batch_sharded",
    "spatial_shardable",
    "upscale_spatial_sharded",
]
