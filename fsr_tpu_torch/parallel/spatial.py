"""Spatial (row-sharded) upscaling with a halo exchange between devices.

Counterpart of ``fsr_tpu/parallel/spatial.py``.  One frame is split along
its rows across the ``axis`` of a ``Mesh``; each device upscales its strip
after taking a few rows of halo from its neighbours' strips, copied
device-to-device (``Tensor.to``; peer-to-peer over NVLink between cards),
with edge replication at the frame's top and bottom (the sampler's CLAMP).
One process drives every device (``parallel/sharding.py``); launches are
asynchronous, so strips on different cards overlap, and each copy is
ordered before the kernels that read it on the devices' current streams.
The input and the result are row-sharded, as JAX's ``shard_map`` takes and
returns them (``P(..., None, axis, None)``): each strip's output stays on
its device in a ``sharding.Sharded``, and a row-sharded input moves
nothing but its halo rows.

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
from typing import Optional, Tuple, Union

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather, fused
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.parallel.sharding import Mesh, Sharded, _as_sharded, shard_frame

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
    image: Union[torch.Tensor, Sharded],
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
) -> Sharded:
    """Upscale (..., 3|4, H, W) with its rows sharded across ``mesh[axis]``.

    Any upscale ratio (1x..4x area, like FsrEasuF).  ``image`` is a tensor
    or a ``Sharded`` laid out as JAX's ``spec`` (``P(*lead, None, axis,
    None)``, ``lead`` ``(batch_axis, None, ...)`` with ``batch_axis`` and a
    batch dimension, else all None), used with no copy; a ``Sharded`` laid
    out any other way raises ``ValueError``.  The result is a ``Sharded``
    with that same spec, each strip's rows on its device; its ``gather()``
    equals ``fsr_tpu_torch.upscale`` of the whole frame with the same
    ``impl`` (on CUDA devices bit for bit).
    RGBA, byte I/O, the prologue, the epilogue and ``impl`` follow
    ``api.upscale``'s contract, strip by strip on each strip's device:
    "auto" runs the kernels on CUDA strips and the torch ops on CPU strips,
    "kernel" the kernels (their plain versions on CPU strips), "torch" the
    torch ops, as float16 always does.  uint8 strips stay bytes through the
    halo exchange; ``grain`` is the output-space (3, Hout, Wout) texture,
    row-sharded with the output; ``dither_page`` tiles the whole frame,
    whatever its shape; a ``frame`` tensor on the input's card (a
    ``Sharded``'s first shard's) is copied to each strip's
    (``sharding.shard_frame``).
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
    sharded_in = isinstance(image, Sharded)
    api._check_args(image.shards[0] if sharded_in else image, compute_dtype, out_dtype, epilogue, prologue, impl)
    if grain is not None and tuple(grain.shape) != (3, hout, wout):
        raise ValueError(f"grain must be (3, {hout}, {wout}), got {tuple(grain.shape)}")
    # dp x sp: frame group i (of the leading dimension) on the i-th row of
    # devices along batch_axis; without a batch dimension only the first.
    nb = len(image.shape) - 3
    lead = (batch_axis,) + (None,) * (nb - 1) if (batch_axis is not None and nb) else (None,) * nb
    x = _as_sharded(image, mesh, (*lead, None, axis, None))
    src = x.shards[0].device if sharded_in else image.device

    hl = hout // n
    exact = _exact_phase((hin, win), (hout, wout), n, con)
    halo = _HALO if exact else _GHALO
    local_con = None
    if exact:
        local_con = _local_constants(con, halo)
        # Every strip shares this plan: its rows need no pad, so no tap of the
        # ring of an interior strip reaches K1's edge clamp instead of the halo.
        fplan = fused.plan((hin // n + 2 * halo, win), (hl, wout), local_con)
        if fplan.pads[:2] != (0, 0):
            raise ValueError(f"a {halo}-row halo cannot host the taps (row pads {fplan.pads[:2]})")
    strips = [Strip(k * hl, hout, easu_gather.shard_plan((hin, win), (hout, wout), con, n, k, halo), local_con)
              for k in range(n)]
    opts = dict(apply_rcas=apply_rcas, denoise=denoise, compute_dtype=compute_dtype, impl=impl,
                epilogue=epilogue, prologue=prologue, out_dtype=out_dtype, dither_page=dither_page)
    rcon = RcasConstants(sharpness)

    def run(s, k):
        """Strip k (halo'd, on its device) -> its hl output rows there."""
        g = None if grain is None else grain[:, k * hl:(k + 1) * hl]
        return api._upscale(s, (hl, wout), con, rcon, grain=g, frame=shard_frame(frame, src, s.device),
                            strip=strips[k], **opts)

    outs = []
    for i in range(0, len(x.shards), n):  # one frame group at a time
        outs += [run(s, k) for k, s in enumerate(_exchange_halo(x.shards[i:i + n], halo))]
    return Sharded(mesh, x.spec, tuple(outs), (*x.shape[:-3], outs[0].shape[-3], hout, wout), outs[0].dtype)
