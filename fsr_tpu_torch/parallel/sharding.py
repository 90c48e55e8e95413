"""Device meshes, sharded tensors and batch sharding for video and dataset
throughput.

Counterpart of ``fsr_tpu/parallel/sharding.py``.  The scaling axes are the
JAX package's:

- data parallelism over frames (this module): a batch of frames split
  across devices; upscaling is embarrassingly parallel, so no device talks
  to another;
- spatial parallelism over image rows (``fsr_tpu_torch.parallel.spatial``):
  one frame split across devices with a halo exchange, for frames too large
  for one device or latency-critical single-frame pipelines.

A sharded result stays on its devices, as a sharded ``jax.Array`` does: a
``Sharded`` holds one block per device, and ``Sharded.gather`` is the one
call that copies a whole sharded tensor onto one device.

One process drives every device of a ``Mesh``, as ``shard_map`` does in the
JAX package: launches are asynchronous, so shards on different cards
overlap, and tensors move between cards with ``Tensor.to(device)``
(peer-to-peer over NVLink on a multi-card host), ordered on the devices'
current streams.  No process group is involved, which is why ``Sharded`` is
not a ``DTensor`` (one process per device).  A mesh may name one device
more than once (``[cuda:0] * 4``, ``[cpu] * 8``): the shards then run in turn
on it, which is how one card or the CPU rehearses the seams.

``CapturedBatch`` (and ``spatial.CapturedSpatial``) run a sharded call as
one captured CUDA graph per device, as JAX jits its ``shard_map``: the
graphs' static inputs are a ``Sharded`` of their own (``inputs``), which a
producer writes or ``put`` fills, as ``jax.device_put`` lays out the
jitted call's input, and a call from it copies nothing; any other input is
copied into them first.  Then the host replays one graph per card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from fsr_tpu_torch.utils.capture import CapturedFrame

__all__ = ["Mesh", "Sharded", "make_mesh", "axis_devices", "shard_batch", "shard_frame", "map_shards",
           "upscale_batch_sharded", "CapturedBatch"]


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


def _named(mesh: Mesh, spec: Tuple[Optional[str], ...], shape) -> List[Tuple[int, str]]:
    """The (dimension, axis name) pairs that ``spec`` splits, checked against
    the mesh and a global ``shape``."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} names {len(spec)} dimensions of a {len(shape)}-d tensor")
    named = [(d, a) for d, a in enumerate(spec) if a is not None]
    axes = [a for _, a in named]
    if len(set(axes)) != len(axes) or any(a not in mesh.shape for a in axes):
        raise ValueError(f"spec {spec} needs distinct axes of the mesh (axes {mesh.axis_names})")
    for d, a in named:
        if shape[d] % mesh.shape[a]:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split over the {mesh.shape[a]} devices "
                             f"of {a!r}")
    return named


def _shard_devices(mesh: Mesh, spec: Tuple[Optional[str], ...]) -> List[torch.device]:
    """The device of each block of ``spec``, in ``Sharded.shards``' order:
    row-major over the named axes, index 0 of every other axis."""
    axes = [a for a in spec if a is not None]
    devices = []
    for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        at = dict(zip(axes, idx))
        devices.append(mesh.devices[tuple(at.get(name, 0) for name in mesh.axis_names)])
    return devices


def _same_mesh(a: Mesh, b: Mesh) -> bool:
    return a is b or (a.axis_names == b.axis_names and a.devices.shape == b.devices.shape
                      and all(x == y for x, y in zip(a.devices.flat, b.devices.flat)))


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor split over the devices of a mesh: the port's counterpart of a
    ``jax.Array`` laid out by ``NamedSharding(mesh, spec)``.

    spec: one mesh-axis name or None per dimension, as ``PartitionSpec``; a
    named dimension is split into equal blocks along its axis.
    shards: one block per index along the named axes, row-major (the first
    named dimension slowest), each on the mesh's device at that index.  On
    every axis that ``spec`` does not name, the device at index 0 holds the
    block, where JAX would replicate it on every index.
    shape, dtype: the global tensor's.

    ``Sharded.put`` lays a tensor out (``jax.device_put``); ``gather`` is the
    one way back to a single tensor."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]
    shards: Tuple[torch.Tensor, ...]
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def __post_init__(self):
        spec, shards, shape = tuple(self.spec), tuple(self.shards), tuple(int(v) for v in self.shape)
        block = list(shape)
        for d, a in _named(self.mesh, spec, shape):
            block[d] //= self.mesh.shape[a]
        n = math.prod(self.mesh.shape[a] for a in spec if a is not None)
        if len(shards) != n or any(tuple(s.shape) != tuple(block) or s.dtype != self.dtype for s in shards):
            raise ValueError(f"a {shape} {self.dtype} tensor laid out as {spec} takes {n} blocks of "
                             f"{tuple(block)}, got {[(tuple(s.shape), s.dtype) for s in shards]}")
        object.__setattr__(self, "spec", spec)
        object.__setattr__(self, "shards", shards)
        object.__setattr__(self, "shape", shape)

    @classmethod
    def put(cls, tensor: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]]) -> "Sharded":
        """``tensor`` split into ``spec``'s blocks, each copied to its device
        (asynchronously; a block already on its device stays a view of
        ``tensor``): ``jax.device_put(x, NamedSharding(mesh, spec))``."""
        spec = tuple(spec)
        # A copy to the host is made blocking: the host may read it at once.
        shards = tuple(b.to(dev, non_blocking=dev.type == "cuda")
                       for b, dev in zip(_blocks(tensor, mesh, spec), _shard_devices(mesh, spec)))
        return cls(mesh, spec, shards, tuple(tensor.shape), tensor.dtype)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first shard's): each
        block moved there (``Tensor.to``), then ``torch.cat``; a gradient
        flows through both."""
        device = self.shards[0].device if device is None else torch.device(device)
        blocks = [s.to(device) for s in self.shards]
        for d, a in reversed(_named(self.mesh, self.spec, self.shape)):
            n = self.mesh.shape[a]
            blocks = [torch.cat(blocks[i:i + n], d) for i in range(0, len(blocks), n)]
        return blocks[0]


def _blocks(tensor: torch.Tensor, mesh: Mesh, spec: Tuple[Optional[str], ...]) -> List[torch.Tensor]:
    """``tensor`` split into ``spec``'s blocks, in ``Sharded.shards``' order:
    views of it, where it lies."""
    blocks = [tensor]
    for d, a in _named(mesh, spec, tensor.shape):
        blocks = [b for t in blocks for b in t.chunk(mesh.shape[a], d)]
    return blocks


def _as_sharded(x: Union[torch.Tensor, Sharded], mesh: Mesh, spec: Tuple[Optional[str], ...]) -> Sharded:
    """``x`` laid out by ``spec`` on ``mesh``: a tensor is put there
    (``Sharded.put``); a ``Sharded`` with that layout is used as it is, with
    no copy; one with any other raises."""
    if not isinstance(x, Sharded):
        return Sharded.put(x, mesh, spec)
    if x.spec != spec or not _same_mesh(x.mesh, mesh):
        raise ValueError(f"this call takes a Sharded laid out as {spec} on mesh {mesh.shape}, "
                         f"got one laid out as {x.spec} on mesh {x.mesh.shape}")
    return x


def shard_batch(images: torch.Tensor, mesh: Mesh, axis: str = "batch") -> Sharded:
    """A (B, ...) batch with B split into ``mesh.shape[axis]`` equal parts,
    part i on the i-th device along ``axis`` (copies start asynchronously):
    spec ``(axis, None, ...)``, as ``fsr_tpu.parallel.shard_batch``."""
    return Sharded.put(images, mesh, (axis,) + (None,) * (images.dim() - 1))


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


def map_shards(fn, images: Union[torch.Tensor, Sharded], mesh: Mesh, axis: str = "batch") -> Sharded:
    """``fn(k, part)`` for share k of a (B, ...) batch on the k-th device along
    ``axis`` (a tensor is put first, ``shard_batch``; a ``Sharded`` with that
    layout is used as it is).  The outputs stay on their devices: a
    ``Sharded`` laid out as ``(axis, None, ...)``."""
    x = _as_sharded(images, mesh, (axis,) + (None,) * (len(images.shape) - 1))
    outs = tuple(fn(k, part) for k, part in enumerate(x.shards))
    return Sharded(mesh, (axis,) + (None,) * (outs[0].dim() - 1), outs,
                   (outs[0].shape[0] * len(outs), *outs[0].shape[1:]), outs[0].dtype)


def upscale_batch_sharded(images: Union[torch.Tensor, Sharded], mesh: Mesh, axis: str = "batch", frame=None,
                          **upscale_kwargs) -> Sharded:
    """Upscale a batch of frames, batch-sharded across the mesh.

    images: (B, C, H, W) with B divisible by the axis size, a tensor or a
    ``Sharded`` laid out as ``(axis, None, None, None)``.  Equivalent to
    ``fsr_tpu_torch.upscale(images, frame=frame, **upscale_kwargs)``: each
    device runs the whole kernel path on its frames (the kernels on CUDA
    devices, their plain versions or the torch path on CPU devices, as
    ``upscale`` picks), with the frame index on its own device
    (``shard_frame``; a frame tensor lies on the input's device, a
    ``Sharded``'s first shard's).  No collectives: the result is a
    ``Sharded`` with the input's layout, as ``out_specs=pspec`` in the JAX
    package.
    """
    from fsr_tpu_torch import api

    src = images.shards[0].device if isinstance(images, Sharded) else images.device
    return map_shards(lambda k, part: api.upscale(part, frame=shard_frame(frame, src, part.device),
                                                  **upscale_kwargs), images, mesh, axis)


# --- captured sharded calls ----------------------------------------------------


def _on(device: torch.device):
    """The context a copy or a replay on ``device`` runs in:
    ``torch.cuda.device`` on a card, none on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _parts(x: Union[torch.Tensor, Sharded], mesh: Mesh, spec: Tuple[Optional[str], ...]) -> Tuple[torch.Tensor, ...]:
    """The blocks of ``x`` laid out by ``spec``, where they lie: a
    ``Sharded``'s shards (its layout checked, as ``_as_sharded`` does) or
    views of a tensor (``_blocks``), each copied only where a call writes it
    into its device's static input."""
    return _as_sharded(x, mesh, spec).shards if isinstance(x, Sharded) else tuple(_blocks(x, mesh, spec))


def _home(x: Union[torch.Tensor, Sharded]) -> torch.device:
    """The device of a call's input: a tensor's, a ``Sharded``'s first
    shard's (where a frame tensor of the call lies)."""
    return x.shards[0].device if isinstance(x, Sharded) else x.device


def _write(statics: Sequence[torch.Tensor], parts: Sequence[torch.Tensor]) -> None:
    """Each part copied into its static input, ordered on the static's
    device's current stream (``copy_`` guards the devices itself; from the
    host asynchronously, as ``Sharded.put``; between cards on both cards'
    current streams), a part that is its static left as it is."""
    for static, part in zip(statics, parts):
        if part is not static:
            static.copy_(part, non_blocking=static.device.type == "cuda")


def _check_like(x, shape, dtype, what: str) -> None:
    """A captured call takes one shape and dtype: raise naming both."""
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
        raise ValueError(f"{what} was captured for a {tuple(shape)} {dtype} input, "
                         f"got a {tuple(x.shape)} {x.dtype} one")


def _put_frame(frame, src, statics: Dict[torch.device, torch.Tensor]) -> None:
    """The frame index of a call on ``src`` (``ops.extras.frame_index``: an
    int, or an integer tensor there; None is 0) written into each device's
    static 0-d int32: an int filled in (wrapped to 32 bits, as a wider
    tensor is cast), a tensor copied card to card with no host read."""
    from fsr_tpu_torch.ops import extras

    f = extras.frame_index(0 if frame is None else frame, src)
    for dev, static in statics.items():
        with _on(dev):
            if isinstance(f, int):
                static.fill_((f + 2**31) % 2**32 - 2**31)
            else:
                static.copy_(f)


class _PerDevice:
    """One program per device of a sharded call, as ``shard_map`` compiles
    one for each device: ``body(j, ins, shared)`` gives shard j's output
    from its static inputs ``ins`` and the inputs ``shared`` by every shard
    on its device; a device's bodies are captured together as one
    ``CapturedFrame`` on a card (a mesh that names a card four times gives
    one graph of four shards), or called eagerly on the CPU.

    shard_inputs[j], device_inputs[device]: the static inputs, the tensors
    given themselves (shard j's device is that of its first input): the
    caller allocates them, all before any capture, so that one device's
    program may read another's.  A call writes its inputs into them, then
    ``run`` replays each device's graph on that device's current stream
    (``run_on`` one device's) and returns the shards' outputs in shard
    order: on a card the graphs' static outputs, overwritten by the next
    run.

    around[device]: (events, event), the events that device's program waits
    for before its bodies and the one it records after them, captured into
    its graph as external event nodes (``torch.cuda.Event(external=True)``,
    each recorded once before the capture): a captured wait binds to the
    event's latest record when the graph is launched, and a host wait
    enqueued after the launch to the graph's record, as enqueued on the
    host around the replay (``chip_smoke.py`` phase 18's probe)."""

    def __init__(self, body: Callable, shard_inputs: Sequence[Tuple[torch.Tensor, ...]],
                 device_inputs: Dict[torch.device, Tuple[torch.Tensor, ...]], around=None):
        groups: Dict[torch.device, List[int]] = {}
        for j, ins in enumerate(shard_inputs):
            groups.setdefault(ins[0].device, []).append(j)
        self.devices = list(groups)
        self.shard_inputs: List[Tuple[torch.Tensor, ...]] = [()] * len(shard_inputs)
        self.device_inputs: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self.captured: Dict[torch.device, CapturedFrame] = {}
        self._runs = {}
        for dev, js in groups.items():
            sizes = [len(shard_inputs[j]) for j in js]
            flat = [t for j in js for t in shard_inputs[j]] + list(device_inputs[dev])

            def program(*ins, js=tuple(js), sizes=tuple(sizes), around=(around or {}).get(dev, ((), None))):
                waits, done = around
                for event in waits:
                    torch.cuda.current_stream().wait_event(event)
                shared, at, outs = ins[sum(sizes):], 0, []
                for j, m in zip(js, sizes):
                    outs.append(body(j, ins[at:at + m], shared))
                    at += m
                if done is not None:
                    done.record(torch.cuda.current_stream())
                return tuple(outs)

            frame = self.captured[dev] = CapturedFrame(program, *flat, static=True)
            ins = tuple(flat)
            at = 0
            for j, m in zip(js, sizes):
                self.shard_inputs[j] = ins[at:at + m]
                at += m
            self.device_inputs[dev] = ins[at:]
            self._runs[dev] = (js, frame.replay if frame.graph is not None else
                               (lambda program=program, ins=ins: program(*ins)))

    def run_on(self, device: torch.device) -> Dict[int, torch.Tensor]:
        """Replay ``device``'s graph (call its program on the CPU): shard j's
        output for each shard j it hosts."""
        js, run = self._runs[device]
        return dict(zip(js, run()))

    def run(self) -> List[torch.Tensor]:
        outs: List[Optional[torch.Tensor]] = [None] * len(self.shard_inputs)
        for dev in self.devices:
            for j, out in self.run_on(dev).items():
                outs[j] = out
        return outs


class CapturedBatch:
    """``upscale_batch_sharded`` captured once per device: the counterpart
    of ``jax.jit(shard_map(upscale))`` (``fsr_tpu/parallel/sharding.py``).

    example: the (B, C, H, W) batch every call takes, a tensor or a
    ``Sharded`` laid out as ``(axis, None, None, None)``;
    upscale_kwargs: ``fsr_tpu_torch.upscale``'s options but ``frame``
    (tensors among them, a grain or a dither page, are copied once to each
    device).  Each device's shares run ``upscale`` in one captured graph on
    its static inputs, with the frame index as a static 0-d int32 there
    (``_PerDevice``; on CPU devices the same calls run eagerly).

    ``inputs``: the graphs' static shares as a ``Sharded`` in the example's
    layout, the buffers that JAX's jitted call would read of a sharded
    array.  ``put(images)`` writes a tensor (from the host, one copy per
    share straight into its static) or a ``Sharded`` in the example's layout
    and shape (else ``ValueError``) into them and returns ``inputs``; a
    producer may also write a share itself on its card's current stream
    (each card's graph reads only its own shares: the stream orders the
    write after the call before).

    A call ``(images, frame=0)`` from ``inputs`` copies no share; from any
    other input it ``put``s it first.  It writes the frame to each device
    (``sharding.shard_frame``'s rule, no host read for a tensor on the
    input's device), replays the graphs and returns a ``Sharded`` of their
    static outputs, which the next call overwrites: a caller that keeps one
    clones it."""

    def __init__(self, example: Union[torch.Tensor, Sharded], mesh: Mesh, axis: str = "batch", **upscale_kwargs):
        from fsr_tpu_torch import api

        self.mesh = mesh
        self.spec = (axis,) + (None,) * (len(example.shape) - 1)
        self.shape, self.dtype = tuple(example.shape), example.dtype
        devices = _shard_devices(mesh, self.spec)
        kw = {dev: {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in upscale_kwargs.items()}
              for dev in set(devices)}

        def body(j, share, shared):
            return api.upscale(share[0], frame=shared[0], **kw[share[0].device])

        self.programs = _PerDevice(body, [(torch.empty_like(p, device=dev).copy_(p),)
                                          for p, dev in zip(_parts(example, mesh, self.spec), devices)],
                                   {dev: (torch.zeros((), dtype=torch.int32, device=dev),) for dev in devices})
        self.inputs = Sharded(mesh, self.spec, tuple(ins[0] for ins in self.programs.shard_inputs), self.shape,
                              self.dtype)

    def put(self, images: Union[torch.Tensor, Sharded]) -> Sharded:
        """``images`` written into ``inputs`` (``jax.device_put`` into the
        jitted call's sharding): one copy per share, none for ``inputs``
        itself."""
        _check_like(images, self.shape, self.dtype, "this captured batch")
        _write(self.inputs.shards, _parts(images, self.mesh, self.spec))
        return self.inputs

    def __call__(self, images: Union[torch.Tensor, Sharded], frame=0) -> Sharded:
        self._stage(images, frame)
        outs = self.programs.run()
        return Sharded(self.mesh, self.spec, tuple(outs), (outs[0].shape[0] * len(outs), *outs[0].shape[1:]),
                       outs[0].dtype)

    def _stage(self, images, frame) -> None:
        """A call's staging before the replays: the shares, unless ``images``
        is ``inputs``, and the frame."""
        if images is not self.inputs:
            self.put(images)
        _put_frame(frame, _home(images), {dev: ins[0] for dev, ins in self.programs.device_inputs.items()})
