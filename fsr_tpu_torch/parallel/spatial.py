"""Spatial (row-sharded) upscaling with a halo exchange between devices.

Counterpart of ``fsr_tpu/parallel/spatial.py``.  One frame is split along
its rows across the ``axis`` of a ``Mesh``; each device upscales its strip
after taking a few rows of halo from its neighbours' strips, copied
device-to-device (``Tensor.to``; peer-to-peer over NVLink between cards),
with edge replication at the frame's top and bottom (the sampler's CLAMP).
One process drives every device (``parallel/sharding.py``); launches are
asynchronous, so strips on different cards overlap, and each copy is
ordered before the kernels that read it on the devices' current streams.
The strips' outputs are gathered into one tensor on the input's device.

Two regimes, as in the JAX package, both bit-exact against the unsharded
kernels:

- **Exact-phase ratios** (2x/4x): every strip's coordinate mapping is a
  shifted copy of the global one, so each strip runs K1 with
  shard-local constants (``_local_constants``) and ``row_offset`` /
  ``global_rows``: the RCAS ring takes the neighbour rows from the halo and
  clamps only at the frame's first and last rows, and K1 stores the strip's
  own rows.
- **Any other ratio** (1.3x/1.5x/1.7x presets, DRS): the mapping does not
  shift cleanly across strips (float32 drift), so each strip's row tables
  are built on the host from the GLOBAL mapping (``easu_gather.shard_plan``)
  and K2 runs on them.

Each strip runs ``api._upscale``, the body of ``upscale``, with its
``Strip``: the path is picked as ``upscale`` picks it, from ``impl``, the
dtypes and the strip's device.  Every strip's epilogue dithers at global
rows and takes the strip's rows of the grain.  The torch path (CPU strips
under "auto", ``impl="torch"``, float16) runs the torch ops on each strip
with the same global row plans (``ops.easu(rows=)``), as the JAX package
runs it on XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather, fused
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.parallel.sharding import Mesh, axis_devices, shard_frame

__all__ = ["upscale_spatial_sharded", "spatial_shardable", "Strip"]

_HALO = 4   # exact-phase regime: input rows taken from each neighbour
_GHALO = 8  # any other ratio: covers float32 coordinate drift and the taps


def _constants(in_size, out_size, input_viewport=None, input_offset=(0, 0)) -> EasuConstants:
    (hin, win), (hout, wout) = in_size, out_size
    vh, vw = input_viewport if input_viewport is not None else (hin, win)
    return EasuConstants.create((vw, vh), (win, hin), (wout, hout), (input_offset[1], input_offset[0]))


def _exact_phase(in_size, out_size, n_shards: int, con: Optional[EasuConstants] = None) -> bool:
    """Exact phase structure: every strip's mapping is a shifted copy."""
    hin, _ = in_size
    hout, wout = (int(v) for v in out_size)
    st = fused._phase_structure(con or _constants(in_size, out_size), (hout, wout))
    if st is None:
        return False
    qy = st[0]
    hl_out = hout // n_shards
    # Each strip must start on phase 0 and advance by exactly its input
    # height, so every strip's coordinate pattern is identical.
    return hl_out % qy == 0 and hl_out // qy == hin // n_shards


def spatial_shardable(in_size, out_size, n_shards: int, con: Optional[EasuConstants] = None) -> bool:
    """The divisibility and strip-size conditions for row sharding (those
    of the JAX package; ``con`` carries a DRS viewport and offset).

    Any upscale ratio qualifies; the strips must divide evenly and be tall
    enough to host the halo exchange.
    """
    hin, win = in_size
    hout, wout = out_size
    if hin % n_shards or hout % n_shards:
        return False
    if hout < hin or wout < win:
        return False
    if _exact_phase(in_size, out_size, n_shards, con):
        return hin // n_shards >= _HALO
    return hin // n_shards >= _GHALO and hout // n_shards >= 2


def _local_constants(con: EasuConstants, halo: int) -> EasuConstants:
    """Shard-local constants: the global mapping shifted into the halo'd
    strip.  Strip k maps local output row y to local input row y*sy + oy +
    halo (the k-dependent term k*Hin/n cancels exactly at exact-binary
    scales); K1's ring reaches rows -1 and hl itself, so, unlike the JAX
    package's, no RCAS row is added to the strip's output."""
    return EasuConstants(
        viewport=con.viewport,
        input_size=con.input_size,
        output_size=con.output_size,
        input_offset=(con.input_offset[0], con.input_offset[1] + float(halo)),
    )


def _exchange_halo(strips, halo: int):
    """Each strip with ``halo`` neighbour rows on each side, copied from the
    neighbours' devices to its own; edge replication at the global top and
    bottom."""
    out = []
    for k, s in enumerate(strips):
        edge = (*s.shape[:-2], halo, s.shape[-1])
        up = strips[k - 1][..., -halo:, :].to(s.device, non_blocking=True) if k else s[..., :1, :].expand(edge)
        down = (strips[k + 1][..., :halo, :].to(s.device, non_blocking=True) if k + 1 < len(strips)
                else s[..., -1:, :].expand(edge))
        out.append(torch.cat([up, s, down], dim=-2))
    return out


@dataclasses.dataclass(frozen=True)
class Strip:
    """Row strip k of a row-sharded frame, as ``api._upscale`` runs it: its
    output is rows ``row0`` .. ``row0 + hl - 1`` of a ``global_rows``-row
    frame.  ``rows``: its row tables from the GLOBAL mapping
    (``easu_gather.shard_plan``), which K2 and the torch path run on;
    ``local_con``: at an exact-phase ratio, the shard-local constants K1
    runs on (``_local_constants``), else None."""

    row0: int
    global_rows: int
    rows: easu_gather.GatherPlan
    local_con: Optional[EasuConstants]


def upscale_spatial_sharded(
    image: torch.Tensor,
    out_size: Tuple[int, int],
    mesh: Mesh,
    axis: str = "sp",
    batch_axis: Optional[str] = None,
    sharpness: float = 0.25,
    apply_rcas: bool = True,
    denoise: bool = False,
    compute_dtype=torch.float32,
    epilogue: Optional[Epilogue] = None,
    frame=0,
    grain=None,
    dither_page=None,
    prologue: str = "none",
    out_dtype=None,
    impl: str = "auto",
    input_viewport: Optional[Tuple[int, int]] = None,
    input_offset: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Upscale (..., 3|4, H, W) with its rows sharded across ``mesh[axis]``.

    Any upscale ratio (1x..4x area, like FsrEasuF); the result equals
    ``fsr_tpu_torch.upscale`` of the whole frame with the same ``impl`` (on
    CUDA devices bit for bit) and is one tensor on the input's device.
    RGBA, byte I/O, the prologue, the epilogue and ``impl`` follow
    ``api.upscale``'s contract, strip by strip on each strip's device:
    "auto" runs the kernels on CUDA strips and the torch ops on CPU strips,
    "kernel" the kernels (their plain versions on CPU strips), "torch" the
    torch ops, as float16 always does.  uint8 strips stay bytes through the
    halo exchange; ``grain`` is the output-space (3, Hout, Wout) texture,
    row-sharded with the output; ``dither_page`` tiles the whole frame,
    whatever its shape; a ``frame`` tensor on the input's card is copied to
    each strip's (``sharding.shard_frame``).
    batch_axis: also split the leading batch dimension across a second mesh
    axis (dp x sp).
    input_viewport / input_offset: DRS, as ``api.upscale`` takes them.
    """
    from fsr_tpu_torch import api

    hout, wout = (int(v) for v in out_size)
    hin, win = image.shape[-2:]
    n = mesh.shape[axis]
    con = _constants((hin, win), (hout, wout), input_viewport, input_offset)
    if not spatial_shardable((hin, win), (hout, wout), n, con):
        raise ValueError(f"spatial sharding needs divisible, halo-sized strips "
                         f"(in={hin}x{win} out={hout}x{wout} shards={n})")
    api._check_args(image, compute_dtype, out_dtype, epilogue, prologue, impl)
    if grain is not None and tuple(grain.shape) != (3, hout, wout):
        raise ValueError(f"grain must be (3, {hout}, {wout}), got {tuple(grain.shape)}")

    hl, hin_l = hout // n, hin // n
    exact = _exact_phase((hin, win), (hout, wout), n, con)
    halo = _HALO if exact else _GHALO
    local_con = None
    if exact:
        local_con = _local_constants(con, halo)
        # Every strip shares this plan: its rows need no pad, so no tap of the
        # ring of an interior strip reaches K1's edge clamp instead of the halo.
        fplan = fused.plan((hin_l + 2 * halo, win), (hl, wout), local_con)
        if fplan.pads[:2] != (0, 0):
            raise ValueError(f"a {halo}-row halo cannot host the taps (row pads {fplan.pads[:2]})")
    strips = [Strip(k * hl, hout, easu_gather.shard_plan((hin, win), (hout, wout), con, n, k, halo), local_con)
              for k in range(n)]
    opts = dict(apply_rcas=apply_rcas, denoise=denoise, compute_dtype=compute_dtype, impl=impl,
                epilogue=epilogue, prologue=prologue, out_dtype=out_dtype, dither_page=dither_page)
    rcon = RcasConstants(sharpness)

    def run(x, k):
        """Strip k (halo'd, on its device) -> its hl output rows there."""
        g = None if grain is None else grain[:, k * hl:(k + 1) * hl]
        return api._upscale(x, (hl, wout), con, rcon, grain=g, frame=shard_frame(frame, image.device, x.device),
                            strip=strips[k], **opts)

    # dp x sp: frame group i (of the leading dimension) on the i-th row of
    # devices along batch_axis; without a batch dimension only the first.
    groups = [image]
    rows_of = [axis_devices(mesh, axis)]
    if batch_axis is not None and image.dim() > 3:
        m = mesh.shape[batch_axis]
        if image.shape[0] % m:
            raise ValueError(f"batch of {image.shape[0]} does not split over {m} devices of {batch_axis!r}")
        groups = list(image.chunk(m))
        rows_of = [axis_devices(mesh, axis, {batch_axis: i}) for i in range(m)]

    outs = []
    for group, devs in zip(groups, rows_of):
        parts = [group[..., k * hin_l:(k + 1) * hin_l, :].to(dev, non_blocking=True)
                 for k, dev in enumerate(devs)]
        outs.append([run(x, k) for k, x in enumerate(_exchange_halo(parts, halo))])
    first = outs[0][0]
    result = torch.empty((*image.shape[:-3], first.shape[-3], hout, wout), dtype=first.dtype, device=image.device)
    for part, strip_outs in zip(result.chunk(len(groups)) if len(groups) > 1 else [result], outs):
        for k, out in enumerate(strip_outs):
            part[..., k * hl:(k + 1) * hl, :].copy_(out)  # between cards ordered on both streams
    return result
