"""Device meshes and batch sharding for video and dataset throughput.

Counterpart of ``fsr_tpu/parallel/sharding.py``.  The scaling axes are the
JAX package's:

- data parallelism over frames (this module): a batch of frames split
  across devices; upscaling is embarrassingly parallel, so no device talks
  to another until the outputs are gathered;
- spatial parallelism over image rows (``fsr_tpu_torch.parallel.spatial``):
  one frame split across devices with a halo exchange, for frames too large
  for one device or latency-critical single-frame pipelines.

One process drives every device of a ``Mesh``, as ``shard_map`` does in the
JAX package: launches are asynchronous, so shards on different cards
overlap, and tensors move between cards with ``Tensor.to(device)``
(peer-to-peer over NVLink on a multi-card host), ordered on the devices'
current streams.  No process group is involved.  A mesh may name one device
more than once (``[cuda:0] * 4``, ``[cpu] * 8``): the shards then run in turn
on it, which is how one card or the CPU rehearses the seams.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "axis_devices", "shard_batch", "shard_frame", "map_shards",
           "upscale_batch_sharded"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of ``torch.device``s with one named axis per dimension, as
    ``jax.sharding.Mesh``.  ``devices``: an object ndarray of devices (a
    device may repeat); ``shape``: axis name -> size."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=object)
        names = tuple(self.axis_names)
        if devs.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {devs.shape} needs {devs.ndim} distinct axis names, got {names}")
        flat = np.empty(devs.size, dtype=object)
        flat[:] = [torch.device(d) for d in devs.flat]
        object.__setattr__(self, "devices", flat.reshape(devs.shape))
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, ...] = ("batch",),
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    visible CUDA device; there is no CPU default, so with no CUDA device
    and no ``devices=`` this raises).  ``shape`` defaults to all devices on
    the first axis."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh found no CUDA device; pass devices= (e.g. [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"n_devices={n_devices} of {len(devices)} devices")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def axis_devices(mesh: Mesh, axis: str, at: Optional[Dict[str, int]] = None) -> List[torch.device]:
    """The devices along ``axis``, at index ``at[name]`` (default 0) of each
    other axis."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r} (axes {mesh.axis_names})")
    at = at or {}
    idx = tuple(slice(None) if name == axis else at.get(name, 0) for name in mesh.axis_names)
    return list(mesh.devices[idx])


def shard_batch(images: torch.Tensor, mesh: Mesh, axis: str = "batch") -> List[torch.Tensor]:
    """Split a (B, ...) batch into ``mesh.shape[axis]`` equal parts, part i
    on the i-th device along ``axis`` (copies start asynchronously)."""
    devs = axis_devices(mesh, axis)
    if images.dim() < 1 or images.shape[0] % len(devs):
        raise ValueError(f"batch of {tuple(images.shape)[:1]} does not split over {len(devs)} devices")
    return [part.to(dev, non_blocking=True) for part, dev in zip(images.chunk(len(devs)), devs)]


def shard_frame(frame, src_device, device):
    """The frame index of a call on ``src_device`` (``ops.extras.frame_index``:
    an int, or an integer tensor there), as a shard on ``device`` takes it: a
    tensor on a card is copied to the shard's device card to card, with no
    host read; an int, a CPU tensor or None stays as it is."""
    from fsr_tpu_torch.ops import extras

    if frame is None:
        return None
    f = extras.frame_index(frame, src_device)
    return f if isinstance(f, int) or f.device.type == "cpu" else f.to(device, non_blocking=True)


def map_shards(fn, images: torch.Tensor, mesh: Mesh, axis: str = "batch") -> torch.Tensor:
    """``fn(k, part)`` for share k of a (B, ...) batch on the k-th device along
    ``axis`` (``shard_batch``), the outputs gathered in one tensor on the
    batch's device."""
    outs = [fn(k, part) for k, part in enumerate(shard_batch(images, mesh, axis))]
    result = torch.empty((images.shape[0], *outs[0].shape[1:]), dtype=outs[0].dtype, device=images.device)
    for part, out in zip(result.chunk(len(outs)), outs):
        part.copy_(out)  # between cards ordered on both streams, no host wait
    return result


def upscale_batch_sharded(images: torch.Tensor, mesh: Mesh, axis: str = "batch", frame=None,
                          **upscale_kwargs) -> torch.Tensor:
    """Upscale a batch of frames, batch-sharded across the mesh.

    images: (B, C, H, W) with B divisible by the axis size.  Equivalent to
    ``fsr_tpu_torch.upscale(images, frame=frame, **upscale_kwargs)``: each
    device runs the whole kernel path on its frames (the kernels on CUDA
    devices, their plain versions or the torch path on CPU devices, as
    ``upscale`` picks), with the frame index on its own device
    (``shard_frame``), and the outputs are gathered on the input's device.
    """
    from fsr_tpu_torch import api

    return map_shards(lambda k, part: api.upscale(part, frame=shard_frame(frame, images.device, part.device),
                                                  **upscale_kwargs), images, mesh, axis)
