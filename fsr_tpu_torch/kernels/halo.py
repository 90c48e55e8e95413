"""The strip source of K1 and K2 (H1 folded into them), and peer access.

H1 is the counterpart of ``fsr_tpu/parallel/spatial.py:_exchange_halo``
(:104-119), which is no ``pallas_call``: inside each shard's body of the
jitted ``shard_map`` two ``lax.ppermute``s bring the neighbours' edge rows,
the ``jnp.where``s replicate the frame's first and last rows at its ends,
and a ``concatenate`` builds the halo'd strip.  In the port no launch of
its own builds that strip: H1 is folded into K1 and K2, which read a row
strip's rows in place from three parts, a ``StripSource``:

- ``up``: the strip above's rows (its whole shard, or only its last
  ``halo`` rows), None at the frame's top;
- ``own``: the strip's own rows, which may be a view of a larger tensor;
- ``down``: the strip below's rows (its first ``halo`` rows at least), None
  at the bottom.

The kernels index the virtual halo'd strip of ``own``'s rows plus
``2 * halo``; only the staging load's address comes from the parts
(``csrc/fsr_pixel.cuh:StripSrc``).  ``halo_rows_reference`` is the plain
version of that read, the row rule of ``parallel.spatial._exchange_halo``:
the halo'd strip as one tensor on ``own``'s device, ``up``'s last ``halo``
rows above and ``down``'s first ``halo`` rows below, the frame's first or
last row repeated at its ends.  K1's and K2's wrappers run it, then their
plain versions, for a strip on the CPU; on a card they check the parts
and lay them out for the kernel (``check``) and launch the strip-source
form, and nothing there takes the plain version.

A part may lie on another card than ``own``: the kernel reads it through its
device pointer once peer access is enabled from ``own``'s card
(``enable_peers``).  A row-sharded call captured once per card
(``parallel.spatial.CapturedSpatial``) points each strip's ``up`` and
``down`` at its neighbours' static buffers that way; the eager call moves
only the ``halo`` edge rows between cards and needs no peer access.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterable, Optional, Tuple

import torch

__all__ = ["StripSource", "halo_rows_reference", "check", "enable_peers", "can_access_peer"]


@dataclasses.dataclass(frozen=True, eq=False)
class StripSource:
    """Row strip of a row-sharded frame as K1 and K2 read it: ``own``'s rows
    with ``halo`` rows of ``up`` above and of ``down`` below (module note).
    ``shape``, ``dtype`` and ``device`` are the virtual halo'd strip's, on
    ``own``'s device."""

    up: Optional[torch.Tensor]
    own: torch.Tensor
    down: Optional[torch.Tensor]
    halo: int

    @property
    def shape(self) -> torch.Size:
        o = self.own.shape
        return torch.Size((*o[:-2], o[-2] + 2 * self.halo, o[-1]))

    @property
    def dtype(self) -> torch.dtype:
        return self.own.dtype

    @property
    def device(self) -> torch.device:
        return self.own.device

    @property
    def requires_grad(self) -> bool:
        return any(t is not None and t.requires_grad for t in (self.up, self.own, self.down))

    def dim(self) -> int:
        return self.own.dim()

    def parts(self) -> Tuple[Tuple[str, Optional[torch.Tensor]], ...]:
        return (("up", self.up), ("own", self.own), ("down", self.down))


def halo_rows_reference(src: StripSource) -> torch.Tensor:
    """The plain version of the strip read: the halo'd strip as one tensor on
    ``own``'s device (``torch.cat``; the neighbours' edge rows copied card to
    card where they lie elsewhere), the row rule of ``_exchange_halo``."""
    own, halo = src.own, src.halo
    edge = (*own.shape[:-2], halo, own.shape[-1])
    up = (src.up[..., -halo:, :].to(own.device, non_blocking=True) if src.up is not None
          else own[..., :1, :].expand(edge))
    down = (src.down[..., :halo, :].to(own.device, non_blocking=True) if src.down is not None
            else own[..., -1:, :].expand(edge))
    return torch.cat([up, own, down], dim=-2)


def _frame_stride(shape, strides) -> Optional[int]:
    """The stride between consecutive frames of a part's leading dimensions
    taken as one (0 without any), or None when they do not flatten into one
    stride (what ``view(-1, C, rows, W)`` would refuse)."""
    if len(shape) < 5:
        return strides[0] if len(shape) == 4 else 0
    lead = [(n, st) for n, st in zip(shape[:-3], strides[:-3]) if n != 1]
    if any(st != inner_st * inner_n for (_, st), (inner_n, inner_st) in zip(lead, lead[1:])):
        return None
    return lead[-1][1] if lead else 0


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


class _Parts(ctypes.Structure):
    """csrc/fsr_pixel.cuh:StripParts."""

    _fields_ = [("ptr", ctypes.c_void_p * 3), ("plane", ctypes.c_longlong * 3), ("frame", ctypes.c_longlong * 3),
                ("rows", ctypes.c_int * 3), ("halo", ctypes.c_int)]


def check(src: StripSource) -> _Parts:
    """Refuse, before any launch, a strip source the kernels do not take,
    with a ``ValueError`` naming the part: each part a CUDA tensor of
    ``own``'s dtype, frames, channel count and width, with rows of ``width``
    contiguous elements and its leading dimensions one stride; ``up`` and
    ``down`` at least ``halo`` rows, on ``own``'s card or on one that card
    can read by peer access.  Returns the parts as the kernels take them
    (``csrc/fsr_pixel.cuh:StripParts``: each part's pointer, plane and
    frame strides and rows), read in the same pass: this runs at every
    launch."""
    own, halo = src.own, src.halo
    oshape, odtype, odevice = own.shape, own.dtype, own.device
    if halo < 1 or len(oshape) < 3 or oshape[-2] < 1:
        raise ValueError(f"a strip source needs halo >= 1 and own rows (..., C, h, W), got halo {halo} and "
                         f"{tuple(oshape)}")
    ptrs, planes, frames, rows = [None] * 3, [0] * 3, [0] * 3, [0] * 3
    for i, (name, t) in enumerate(src.parts()):
        if t is None:
            continue
        shape, strides = t.shape, t.stride()
        if not _on_card(t):
            raise ValueError(f"the strip source's {name} part lies on {t.device}: a kernel launch reads CUDA tensors")
        if t.dtype != odtype:
            raise ValueError(f"the strip source's {name} part is {t.dtype}, its own rows {odtype}")
        if len(shape) != len(oshape) or shape[:-3] != oshape[:-3]:
            raise ValueError(f"the strip source's {name} part has frames {tuple(shape[:-3])}, its own rows "
                             f"{tuple(oshape[:-3])}")
        if shape[-3] != oshape[-3]:
            raise ValueError(f"the strip source's {name} part has {shape[-3]} channels, its own rows {oshape[-3]}")
        if shape[-1] != oshape[-1]:
            raise ValueError(f"the strip source's {name} part is {shape[-1]} wide, its own rows {oshape[-1]}")
        if name != "own" and shape[-2] < halo:
            raise ValueError(f"the strip source's {name} part holds {shape[-2]} rows, fewer than the halo's {halo}")
        frame = _frame_stride(shape, strides)
        if strides[-1] != 1 or (shape[-2] > 1 and strides[-2] != shape[-1]) or frame is None:
            raise ValueError(f"the strip source's {name} part needs rows of {shape[-1]} contiguous elements and "
                             f"one frame stride, got strides {strides}")
        if i != 1 and t.device != odevice and not can_access_peer(odevice, t.device):
            raise ValueError(f"the strip source's {name} part lies on {t.device}, which {odevice} cannot read "
                             "(no peer access)")
        ptrs[i], planes[i], frames[i], rows[i] = t.data_ptr(), strides[-3], frame, shape[-2]
    return _Parts(tuple(ptrs), tuple(planes), tuple(frames), tuple(rows), halo)


def can_access_peer(device: torch.device, peer: torch.device) -> bool:
    """Whether kernels on card ``device`` can read card ``peer``'s memory."""
    return torch.cuda.can_device_access_peer(device.index, peer.index)


def enable_peers(pairs: Iterable[Tuple[torch.device, torch.device]]) -> None:
    """For each (reader, owner) pair of distinct cards, let kernels on the
    reader read the owner's memory (``cudaDeviceEnablePeerAccess``; already
    enabled is fine).  Every pair is checked before any is enabled: a pair
    without peer access raises ``ValueError`` naming it (the eager
    ``upscale_spatial_sharded`` copies through the host's ``copy_`` and
    needs none).  Pairs of one device, or of CPU devices, need nothing."""
    pairs = sorted({(torch.device(a), torch.device(b)) for a, b in pairs
                    if torch.device(a).type == "cuda" and torch.device(b).type == "cuda"
                    and torch.device(a) != torch.device(b)}, key=str)
    for reader, owner in pairs:
        if not can_access_peer(reader, owner):
            raise ValueError(f"{reader} cannot read {owner}'s memory (no peer access): a captured row-sharded "
                             f"call reads its neighbours' halo rows card to card; use upscale_spatial_sharded")
    if not pairs:
        return
    from fsr_tpu_torch.kernels import _build

    lib = _build.library()
    for reader, owner in pairs:
        err = lib.fsr_enable_peer(reader.index, owner.index)
        if err != 0:
            raise RuntimeError(f"enabling peer access from {reader} to {owner} failed: cudaError {err}")
