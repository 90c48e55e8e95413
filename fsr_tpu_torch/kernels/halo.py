"""H1: the halo rows of a row strip's static buffer (CUDA kernel).

Counterpart of ``fsr_tpu/parallel/spatial.py:_exchange_halo`` (:104-119),
which is no ``pallas_call``: inside each shard's body of the jitted
``shard_map`` two ``lax.ppermute``s bring the neighbours' edge rows, the
``jnp.where``s replicate the frame's first and last rows at its ends, and a
``concatenate`` builds the halo'd strip.  A row-sharded call captured once
per card (``parallel.spatial.CapturedSpatial``) keeps one static buffer per
strip, ``(..., C, h + 2 * halo, W)``, all allocated before any card's graph
is captured: the host writes each strip's own rows (rows ``halo`` ..
``halo + h - 1``), and ``halo_rows`` fills the others from the neighbours'
buffers, as the first step of the strip in its card's graph.

``halo_rows(bufs, k, halo)`` launches ``csrc/halo.cu`` on ``bufs[k]``'s
card and counts the launch in ``halo_rows.launches`` (under CUDA graph
capture at capture: a replay counts nothing); the neighbours' buffers may
lie on other cards, read through their device pointers by peer access
(``enable_peers`` first).  For a CPU buffer it runs ``halo_rows_reference``,
the row rule of ``parallel.spatial._exchange_halo``: strip k - 1's last
``halo`` own rows above, strip k + 1's first ``halo`` below, the frame's
first or last row repeated at its ends.  Given ``frame_src`` and
``frame_dst`` (0-d int32 tensors), the same launch copies the frame index
from the source card's static into this card's.

Bound: bytes, 2 * halo rows per plane read and written (0.74 MB each way
per strip at the Performance 4K frame, batch 4, float32); at that size a
launch's latency dominates.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch

__all__ = ["halo_rows", "halo_rows_reference", "enable_peers", "can_access_peer"]


def halo_rows_reference(bufs: Sequence[torch.Tensor], k: int, halo: int, frame_src=None, frame_dst=None):
    """Plain version of H1, on any device: ``bufs[k]``'s halo rows from its
    neighbours' own rows (``copy_``, card to card where they lie on other
    cards), the edge row repeated at the frame's top and bottom; then the
    frame index, if given.  Returns ``bufs[k]``."""
    buf = bufs[k]
    h = buf.shape[-2] - 2 * halo
    edge = (*buf.shape[:-2], halo, buf.shape[-1])
    buf[..., :halo, :].copy_(bufs[k - 1][..., h:h + halo, :] if k else buf[..., halo:halo + 1, :].expand(edge))
    buf[..., halo + h:, :].copy_(bufs[k + 1][..., halo:2 * halo, :] if k + 1 < len(bufs)
                                 else buf[..., halo + h - 1:halo + h, :].expand(edge))
    if frame_src is not None:
        frame_dst.copy_(frame_src)
    return buf


def halo_rows(bufs: Sequence[torch.Tensor], k: int, halo: int, frame_src=None, frame_dst=None):
    """Fill strip k's halo rows in ``bufs[k]`` (and copy ``frame_src`` into
    ``frame_dst``): one launch of ``csrc/halo.cu`` on ``bufs[k]``'s card, on
    its current stream, for a CUDA buffer; ``halo_rows_reference`` for a CPU
    one.  ``bufs``: one frame group's contiguous buffers of one shape and
    dtype, strip by strip."""
    buf = bufs[k]
    if buf.device.type == "cpu":
        return halo_rows_reference(bufs, k, halo, frame_src, frame_dst)
    if buf.device.type != "cuda":
        raise ValueError(f"halo_rows takes CPU or CUDA buffers, got {buf.device}")
    h = buf.shape[-2] - 2 * halo
    if h < halo:
        raise ValueError(f"a strip of {tuple(buf.shape)} holds fewer than {halo} own rows")
    near = [bufs[j] for j in (k - 1, k + 1) if 0 <= j < len(bufs)]
    for t in [buf, *near]:
        if t.device.type != "cuda" or t.shape != buf.shape or t.dtype != buf.dtype or not t.is_contiguous():
            raise ValueError(f"halo_rows takes contiguous CUDA buffers of {tuple(buf.shape)} {buf.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if (frame_src is None) != (frame_dst is None) or any(
            f is not None and (f.dtype != torch.int32 or f.dim() != 0 or f.device.type != "cuda")
            for f in (frame_src, frame_dst)):
        raise ValueError("halo_rows copies a frame from one 0-d int32 CUDA tensor into another, or none")
    if frame_dst is not None and frame_dst.device != buf.device:
        raise ValueError(f"the frame is copied into {buf.device}'s static, not {frame_dst.device}'s")
    from fsr_tpu_torch.kernels import _build

    lib = _build.library()
    up = bufs[k - 1].data_ptr() if k else None
    down = bufs[k + 1].data_ptr() if k + 1 < len(bufs) else None
    planes = buf.numel() // (buf.shape[-2] * buf.shape[-1]) if buf.numel() else 0
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = lib.fsr_halo_rows(buf.data_ptr(), up, down, planes, h, halo, buf.shape[-1] * buf.element_size(),
                                None if frame_src is None else frame_src.data_ptr(),
                                None if frame_dst is None else frame_dst.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"halo kernel launch failed: cudaError {err}")
    halo_rows.launches += 1
    return buf


halo_rows.launches = 0


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
