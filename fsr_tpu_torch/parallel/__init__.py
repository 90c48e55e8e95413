"""Multi-device execution: batch sharding and row (spatial) sharding, with
results that stay on their devices (``Sharded``), eager or captured once per
device (``CapturedBatch``, ``CapturedSpatial``)."""

from fsr_tpu_torch.parallel.sharding import (
    CapturedBatch,
    Mesh,
    Sharded,
    make_mesh,
    shard_batch,
    upscale_batch_sharded,
)
from fsr_tpu_torch.parallel.spatial import CapturedSpatial, spatial_shardable, upscale_spatial_sharded

__all__ = [
    "Mesh",
    "Sharded",
    "make_mesh",
    "shard_batch",
    "upscale_batch_sharded",
    "CapturedBatch",
    "spatial_shardable",
    "upscale_spatial_sharded",
    "CapturedSpatial",
]
