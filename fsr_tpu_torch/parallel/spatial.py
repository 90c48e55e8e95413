"""Spatial (row-sharded) upscaling with a halo exchange between devices.

Counterpart of ``fsr_tpu/parallel/spatial.py``.  One frame is split along
its rows across the ``axis`` of a ``Mesh``; each device upscales its strip
with a few rows of halo from its neighbours' strips, with edge replication
at the frame's top and bottom (the sampler's CLAMP).  The kernels read a
strip's rows in place (``kernels.halo.StripSource``: the strip above's
rows, its own, the strip below's): a neighbour on the same device is read
where it lies, and one on another card sends only its ``halo`` edge rows,
copied card to card (``Tensor.to``; peer-to-peer over NVLink).  One process
drives every device (``parallel/sharding.py``); launches are asynchronous,
so strips on different cards overlap, and each copy is ordered before the
kernels that read it on the devices' current streams.
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
rows and takes the strip's rows of the grain.  float16 math runs K6's
strip form on the strip's row plan (``kernels/easu_h.py``), and a float16
image under float32 or bfloat16 math K1's or K2's, as above.  The torch
path (CPU strips under "auto", ``impl="torch"``, and under "auto" a strip
whose kernel form does not take its plan) runs the torch ops on each strip
with the same global row plans (``ops.easu(rows=)``), as the JAX package
runs it on XLA.

A call is three parts: the host layout of its configuration (``_layout``,
cached: strips, ``Strip``s, halo, row plans, local constants), each
strip's source (``_sources``: its own rows and its neighbours', as
``StripSource``s; ``_exchange_halo`` is the plain row rule, the halo'd
strips as fresh tensors), and the per-strip body (``_body``:
``api._upscale(..., strip=)``).  The eager call (``upscale_spatial_sharded``,
``UpscalePipeline(mesh=)``) runs the bodies on the input's own shards, with
no copy on one device; ``CapturedSpatial``, the counterpart of JAX's
``jax.jit`` over its ``shard_map``s, captures each device's bodies once as
one CUDA graph, each strip's kernel reading its halo rows from the
neighbours' static buffers card to card, as JAX's ``ppermute`` runs inside
its program (H1, folded into K1 and K2).  Its own-row buffers are a
``Sharded`` (``inputs``) that a producer writes or ``put`` fills, as
``jax.device_put`` lays out the jitted call's input: a call from it copies
no rows, and per call the host stages only the frame (and the grain rows
and page it reads), then replays one graph per device, the devices ordered
by CUDA events (``_schedule``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import easu_gather, fused
from fsr_tpu_torch.kernels import halo as halo_k
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.parallel import sharding
from fsr_tpu_torch.parallel.sharding import Mesh, Sharded, _as_sharded, shard_frame
from fsr_tpu_torch.utils import capture, profiling

__all__ = ["upscale_spatial_sharded", "spatial_shardable", "Strip", "CapturedSpatial"]

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


def _sources(strips, halo: int):
    """Each strip of a frame group as its kernel reads it, a
    ``StripSource``: its own rows (the shard itself, no copy), and its
    neighbours' rows above and below, a neighbour's shard as it is where it
    lies on the strip's device, else only its ``halo`` edge rows copied
    there; None at the frame's top and bottom."""
    out = []
    for k, s in enumerate(strips):
        up = down = None
        if k:
            up = strips[k - 1]
            up = up if up.device == s.device else up[..., -halo:, :].to(s.device, non_blocking=True)
        if k + 1 < len(strips):
            down = strips[k + 1]
            down = down if down.device == s.device else down[..., :halo, :].to(s.device, non_blocking=True)
        out.append(halo_k.StripSource(up, s, down, halo))
    return out


def _exchange_halo(strips, halo: int, into=None):
    """The plain row rule of a frame group's halo exchange: each strip with
    ``halo`` neighbour rows on each side, copied from the neighbours'
    devices to its own, with edge replication at the global top and bottom
    (``halo.halo_rows_reference`` of each ``_sources`` entry).  Returns fresh
    tensors (one ``torch.cat`` per strip), or, given ``into`` (one (...,
    h + 2 * halo, W) buffer per strip, on its device), writes the same rows
    into those buffers and returns them.  The calls themselves read the
    strips in place; this is what the plain versions read."""
    out = [halo_k.halo_rows_reference(src) for src in _sources(strips, halo)]
    if into is None:
        return out
    for buf, rows in zip(into, out):
        with sharding._on(buf.device):
            buf.copy_(rows)
    return list(into)


def _reads(devices, n: int):
    """The distinct devices of a row-sharded call, in order, and what each
    one's program reads of the others' static inputs: its strips'
    neighbours' buffers (strip ``j`` of ``devices`` is strip ``j % n`` of
    frame group ``j // n``).  The frame, the grain rows and the page each
    program reads from its own statics, which only its own device's staging
    writes."""
    order = list(dict.fromkeys(devices))
    reads = {d: set() for d in order}
    for j, d in enumerate(devices):
        reads[d].update(devices[j + i] for i in (-1, 1) if 0 <= j % n + i < n)
    return order, {d: tuple(e for e in order if e in r and e != d) for d, r in reads.items()}


def _schedule(devices, reads):
    """The host's order of a captured call's work across devices, as a pure
    function: (write steps, stage steps, replay steps).  A step is
    ``("stage", d)``, ``("replay", d)``, ``("record", d, event)`` or
    ``("wait", d, event)``; an event is ``("staged", e)`` or ``("done",
    e)``, recorded on device e's stream, and a wait on d's stream binds to
    its latest record.  ``devices``: distinct, in order; ``reads[d]``: the
    other devices whose own-row buffers d's program reads.

    The write steps make every device's buffers writable on its current
    stream (``CapturedSpatial.writable``, the start of ``put``): what
    follows there may overwrite them.  A call then stages each device's own
    statics (its frame, grain rows and page, which only its program reads)
    and records ``staged``, which covers whatever was written there before
    (by ``put``, by a producer after ``writable()``, by the call's own copy
    of an input), then replays.  Two hazards, and no host sync:

    - within a call (read after write): d's replay waits for the staging of
      every device it reads (``staged``);
    - across calls (write after read): a write on e waits for the replay, in
      the call before, of every device that reads e (``done``).

    A device that no other reads, or that reads no other, records nothing:
    its own stream orders its writes, its staging and its replay.
    ``CapturedSpatial`` runs the replay steps' waits and record inside each
    card's graph, where they bind at the graph's launch as the host's would
    there."""
    readers = {e: [d for d in devices if e in reads[d]] for e in devices}
    write = [("wait", e, ("done", d)) for e in devices for d in readers[e]]
    stage, replay = [], []
    for e in devices:
        stage.append(("stage", e))
        if readers[e]:
            stage.append(("record", e, ("staged", e)))
    for d in devices:
        replay += [("wait", d, ("staged", e)) for e in reads[d]]
        replay.append(("replay", d))
        if reads[d]:
            replay.append(("record", d, ("done", d)))
    return write, stage, replay


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


@dataclasses.dataclass(frozen=True)
class _Layout:
    """The host side of one configuration, built once (``_layout``): the
    global constants, the number of strips, the halo, a strip's output
    (hl, Wout) and each strip's ``Strip``."""

    con: EasuConstants
    n: int
    halo: int
    out_hw: Tuple[int, int]
    strips: Tuple[Strip, ...]


@functools.lru_cache(maxsize=64)
def _layout(in_hw, out_hw, n: int, input_viewport, input_offset) -> _Layout:
    """The strips of an (H, W) -> out_hw frame over ``n`` devices, cached
    per configuration (the row plans behind them are ``shard_plan``'s)."""
    profiling.count("plans_built")
    (hin, win), (hout, wout) = in_hw, out_hw
    con = _constants((hin, win), (hout, wout), input_viewport, input_offset)
    if not spatial_shardable((hin, win), (hout, wout), n, con):
        raise ValueError(f"spatial sharding needs divisible, halo-sized strips "
                         f"(in={hin}x{win} out={hout}x{wout} shards={n})")
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
    strips = tuple(Strip(k * hl, hout, easu_gather.shard_plan((hin, win), (hout, wout), con, n, k, halo), local_con)
                   for k in range(n))
    return _Layout(con, n, halo, (hl, wout), strips)


def _options(apply_rcas=True, denoise=False, compute_dtype=torch.float32, epilogue=None, prologue="none",
             out_dtype=None, impl="auto") -> dict:
    """The options a strip's ``api._upscale`` takes besides its operands."""
    return dict(apply_rcas=apply_rcas, denoise=denoise, compute_dtype=compute_dtype, epilogue=epilogue,
                prologue=prologue, out_dtype=out_dtype, impl=impl)


def _body(sharpness: float, opts: dict):
    """The per-strip body: ``body(layout, k, s, frame, grain, page)`` is
    strip k's output rows from its source ``s`` (a ``StripSource``), with
    the frame index, the strip's rows of the grain and the dither page as it
    takes them (``api._upscale(..., strip=)``)."""
    from fsr_tpu_torch import api

    rcon = RcasConstants(sharpness)
    profiling.count("plans_built")

    def body(layout: _Layout, k: int, s, frame, grain, page):
        return api._upscale(s, layout.out_hw, layout.con, rcon, grain=grain, frame=frame, dither_page=page,
                            strip=layout.strips[k], **opts)
    return body


def _prepare(image, out_size, mesh: Mesh, axis: str, batch_axis, grain, opts: dict, input_viewport, input_offset):
    """A row-sharded call's checks, its layout and its spec (JAX's
    ``P(*lead, None, axis, None)``: ``lead`` is ``(batch_axis, None, ...)``
    with ``batch_axis`` and a batch dimension, else all None)."""
    from fsr_tpu_torch import api

    hout, wout = out_size
    layout = _layout(tuple(image.shape[-2:]), (hout, wout), mesh.shape[axis],
                     None if input_viewport is None else tuple(input_viewport), tuple(input_offset))
    first = image.shards[0] if isinstance(image, Sharded) else image
    api._check_args(first, opts["compute_dtype"], opts["out_dtype"], opts["epilogue"], opts["prologue"],
                    opts["impl"])
    if grain is not None and tuple(grain.shape) != (3, hout, wout):
        raise ValueError(f"grain must be (3, {hout}, {wout}), got {tuple(grain.shape)}")
    # dp x sp: frame group i (of the leading dimension) on the i-th row of
    # devices along batch_axis; without a batch dimension only the first.
    nb = len(image.shape) - 3
    lead = (batch_axis,) + (None,) * (nb - 1) if (batch_axis is not None and nb) else (None,) * nb
    return layout, (*lead, None, axis, None)


def _result(mesh: Mesh, spec, outs, in_shape, out_size) -> Sharded:
    return Sharded(mesh, spec, tuple(outs), (*in_shape[:-3], outs[0].shape[-3], *out_size), outs[0].dtype)


def _run(image, out_size, mesh: Mesh, axis: str, batch_axis, frame, grain, page, body, opts: dict,
         input_viewport=None, input_offset=(0, 0)) -> Sharded:
    """The eager row-sharded call: the input laid out on the mesh, then per
    frame group each strip's source (``_sources``: its own shard and its
    neighbours', only their edge rows copied between devices) and ``body``
    on each strip's device, the frame copied there
    (``sharding.shard_frame``)."""
    out_size = tuple(int(v) for v in out_size)
    layout, spec = _prepare(image, out_size, mesh, axis, batch_axis, grain, opts, input_viewport, input_offset)
    x = _as_sharded(image, mesh, spec)
    src = x.shards[0].device if isinstance(image, Sharded) else image.device
    n, hl = layout.n, layout.out_hw[0]
    outs = []
    for i in range(0, len(x.shards), n):  # one frame group at a time
        for k, s in enumerate(_sources(x.shards[i:i + n], layout.halo)):
            g = None if grain is None else grain[:, k * hl:(k + 1) * hl]
            outs.append(body(layout, k, s, shard_frame(frame, src, s.device), g, page))
    return _result(mesh, x.spec, outs, x.shape, out_size)


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
    "auto" runs the kernels on CUDA strips (K6's strip form for float16
    math) and the torch ops on CPU strips, "kernel" the kernels (their
    plain versions on CPU strips), "torch" the torch ops.
    uint8 strips stay bytes through the
    halo exchange; ``grain`` is the output-space (3, Hout, Wout) texture,
    row-sharded with the output; ``dither_page`` tiles the whole frame,
    whatever its shape; a ``frame`` tensor on the input's card (a
    ``Sharded``'s first shard's) is copied to each strip's
    (``sharding.shard_frame``).
    batch_axis: also split the leading batch dimension across a second mesh
    axis (dp x sp).
    input_viewport / input_offset: DRS, as ``api.upscale`` takes them.
    ``CapturedSpatial`` runs the same call as one captured graph per device.
    """
    opts = _options(apply_rcas, denoise, compute_dtype, epilogue, prologue, out_dtype, impl)
    return _run(image, out_size, mesh, axis, batch_axis, frame, grain, dither_page, _body(sharpness, opts), opts,
                input_viewport, input_offset)


class CapturedSpatial:
    """``upscale_spatial_sharded`` captured once per device: the
    counterpart of ``jax.jit`` over the JAX package's ``shard_map``s
    (``fsr_tpu/parallel/spatial.py``).

    example: a tensor or a ``Sharded`` in the call's layout, at the shape
    and dtype every call takes; options: ``upscale_spatial_sharded``'s, but
    ``frame``, which each call takes, and ``grain``, which here is an
    example of the call's (a call takes one when the epilogue has grain).
    The host layout (``_layout``) is built once.  Every strip's buffer of
    its own rows (``buffers``, each of a shard's shape) is allocated before
    any device's program is captured; each device holds those of the strips
    it hosts, its rows of the grain when the epilogue has grain, a 0-d int32
    frame, and the dither page when the epilogue reads one.  All the strips
    a device hosts run in one ``CapturedFrame`` there
    (``sharding._PerDevice``), so ``[cuda:0] * 4`` gives one graph of four
    strips; each strip's body reads its source as a
    ``kernels.halo.StripSource`` over the buffers: its own, and its
    neighbours' above and below, read in place by K1 or K2 (by peer access
    where they lie on other cards; H1 folded into the kernels).
    Neighbouring cards without peer access raise ``ValueError`` at
    construction (``halo.enable_peers``): the eager
    ``upscale_spatial_sharded`` is for such hosts.  On CPU devices the same
    staging and bodies run eagerly, each strip read by its plain version.

    ``inputs``: the strips' own-row buffers as a ``Sharded`` in the call's
    layout, the buffers that JAX's jitted call would read of a sharded
    array.  ``put(image, grain=None)`` writes a tensor (from the host, one
    copy per strip straight into its buffer) or a ``Sharded`` of the
    example's shape, dtype and layout (else ``ValueError``, naming both)
    into them, and the grain rows when given, and returns ``inputs``.  A
    producer may write ``inputs.shards[k]`` itself, on that device's current
    stream, after ``writable()``: it enqueues there the waits for the
    replays of the call before that read that buffer (the devices whose
    strips neighbour its strips) and returns ``inputs``; ``put`` is
    ``writable()`` and the copies.

    A call ``(image, frame=0, grain=None)`` from ``inputs`` copies no rows;
    from any other input it ``put``s the rows first.  It stages the grain
    rows given to it (a capture with grain needs them from any other input;
    from ``inputs`` without grain the rows stand as last written), the page,
    and the frame, on the first strip's device and, when the programs read
    it (a hash dither, the pipeline's after-pass), on every device
    (``sharding._put_frame``: no host read for a tensor on the input's
    device).  Then each device's graph replays on its current stream,
    ordered across devices by events (``_schedule``), never by a host sync:
    each graph waits for its neighbours' ``staged`` events and records its
    ``done`` event itself (external event nodes,
    ``sharding._PerDevice``'s ``around``).
    Returns a ``Sharded`` of the static outputs, overwritten by the next
    call (``CapturedFrame``'s contract: clone what you keep).
    ``from_pipeline`` captures ``UpscalePipeline(mesh=)``."""

    def __init__(self, example: Union[torch.Tensor, Sharded], out_size, mesh: Mesh, axis: str = "sp",
                 batch_axis: Optional[str] = None, sharpness: float = 0.25, grain=None, dither_page=None,
                 input_viewport=None, input_offset=(0, 0), **options):
        opts = _options(**options)
        self._build(example, out_size, mesh, axis, batch_axis, _body(sharpness, opts), opts, grain, dither_page, None,
                    input_viewport, input_offset)

    @classmethod
    def from_pipeline(cls, pipe, example: Union[torch.Tensor, Sharded], grain=None) -> "CapturedSpatial":
        """``pipe`` (an ``UpscalePipeline`` with a mesh) captured over its
        per-strip body, the bf16 after-pass included
        (``UpscalePipeline._strip_body``, which its eager mesh path runs
        too); ``grain``: an example of the calls' grain (without one the
        capture runs the chain without grain, as the pipeline does).  The
        dither page, where the chain reads one, is staged per call from the
        frame."""
        if pipe.mesh is None:
            raise ValueError("from_pipeline captures an UpscalePipeline(mesh=...); this one has no mesh")
        opts, after = pipe._options(bool(pipe.grain_amount) and grain is not None)
        epi = opts["epilogue"]
        paged = epi is not None and epi.needs_dither_tex
        page_of = (lambda dev, frame: pipe._page(dev, frame, opts)) if paged else None
        self = cls.__new__(cls)
        self._build(example, pipe.out_size, pipe.mesh, pipe.spatial_axis, pipe.batch_axis,
                    pipe._strip_body(opts, after), opts, grain, None, page_of, None, (0, 0), after)
        return self

    def _build(self, example, out_size, mesh, axis, batch_axis, body, opts, grain, page, page_of, input_viewport,
               input_offset, after=False):
        out_size = tuple(int(v) for v in out_size)
        layout, spec = _prepare(example, out_size, mesh, axis, batch_axis, grain, opts, input_viewport,
                                input_offset)
        epi = opts["epilogue"]
        self.mesh, self.spec, self.layout, self.out_size = mesh, spec, layout, out_size
        self.shape, self.dtype = tuple(example.shape), example.dtype
        self.takes_grain = epi is not None and epi.needs_grain
        self._page_of = page_of
        paged = epi is not None and epi.needs_dither_tex
        if paged and page is None and page_of is None:
            raise ValueError("epilogue.dither_texture requires dither_page")
        parts = sharding._parts(example, mesh, spec)
        devices = sharding._shard_devices(mesh, spec)
        n, halo, (hl, wout) = layout.n, layout.halo, layout.out_hw
        home = devices[0]
        order, reads = _reads(devices, n)
        halo_k.enable_peers((d, e) for d, r in reads.items() for e in r)
        self._write_steps, self._stage_steps, replay = _schedule(order, reads)
        # The replay steps' waits and records run inside each card's graph
        # (external event nodes, which bind as the host's would at launch);
        # the host issues the graphs' launches, the write and stage steps.
        self._events = {step[2]: torch.cuda.Event(external=True) for step in self._stage_steps + replay
                        if step[0] == "record"}
        self._replay_steps = [step for step in replay if step[0] == "replay"]
        around = {d: (tuple(self._events[("staged", e)] for e in reads[d]), self._events.get(("done", d)))
                  for d in order}
        for (_, e), event in self._events.items():  # created on its card, so that a capture can name it
            event.record(torch.cuda.current_stream(e))
        self._strips_on = {d: [j for j, e in enumerate(devices) if e == d] for d in order}
        # Every strip's own rows, allocated before any capture so that each
        # device's program can name its neighbours'.
        self.buffers = bufs = [torch.empty(p.shape, dtype=p.dtype, device=dev) for p, dev in zip(parts, devices)]
        sharding._write(bufs, parts)
        self.inputs = Sharded(mesh, spec, tuple(bufs), self.shape, self.dtype)
        shard_inputs = []
        for j, dev in enumerate(devices):
            rows = torch.zeros((3, hl, wout), dtype=torch.float32, device=dev)
            if grain is not None:
                k = j % n
                rows.copy_(grain[:, k * hl:(k + 1) * hl])
            shard_inputs.append((bufs[j], rows) if self.takes_grain else (bufs[j],))
        src = parts[0].device
        if page_of is not None:
            page = page_of(src, 0)
        shared = {dev: (torch.zeros((), dtype=torch.int32, device=dev),)
                  + ((torch.as_tensor(page, device=dev).to(torch.float32).clone(
                      memory_format=torch.contiguous_format),) if paged else ())
                  for dev in order}
        # The devices whose static frame a call writes: the first strip's, and
        # every one when the programs read the frame.
        reads_frame = after or (epi is not None and epi.needs_frame)
        self._frame_devices = order if reads_frame else [home]

        def settle():  # construction leaves no copy or warm-up in flight on any card
            for d in order:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

        settle()  # the buffers complete before any program reads a neighbour's

        def strip(j, ins, shared):
            k = j % n
            src = halo_k.StripSource(bufs[j - 1] if k else None, ins[0], bufs[j + 1] if k + 1 < n else None, halo)
            capture.keep(tuple(t for t in (src.up, src.down) if t is not None))  # what the graph reads
            return body(layout, k, src, shared[0], ins[1] if self.takes_grain else None,
                        shared[1] if paged else None)

        with profiling.trace_annotation("fsr.capture", "cards", len(order), always=True):
            self.programs = sharding._PerDevice(strip, shard_inputs, shared, around)
            settle()

    def writable(self) -> Sharded:
        """``inputs``, each buffer writable on its device's current stream
        once the replays of the call before that read it are done (``done``
        waits enqueued there, no host sync).  Its span opens the call that
        the next ``__call__`` continues."""
        with profiling.trace_annotation("fsr.spatial", leads=True):
            self._issue(self._write_steps, None)
        return self.inputs

    def put(self, image: Union[torch.Tensor, Sharded], grain=None) -> Sharded:
        """``image`` (and ``grain``'s rows, given) written into the statics
        after ``writable()``: ``jax.device_put`` into the jitted call's
        sharding.  Returns ``inputs``."""
        sharding._check_like(image, self.shape, self.dtype, "this captured call")
        self._check_grain(grain)
        parts = sharding._parts(image, self.mesh, self.spec)
        self.writable()
        sharding._write(self.buffers, parts)
        if grain is not None:
            self._put_grain(grain, range(len(self.buffers)))
        return self.inputs

    def __call__(self, image: Union[torch.Tensor, Sharded], frame=0, grain=None) -> Sharded:
        with profiling.trace_annotation("fsr.spatial"):
            self._stage(image, frame, grain)
            outs = [None] * len(self.buffers)

            def replay(dev):
                for j, out in self.programs.run_on(dev).items():
                    outs[j] = out

            self._issue(self._replay_steps, replay)
            return _result(self.mesh, self.spec, outs, self.shape, self.out_size)

    def _issue(self, steps, run) -> None:
        """Issue ``_schedule``'s steps from the host: events waited for and
        recorded on the devices' current streams, ``run(device)`` for a stage
        or a replay."""
        streams = {}
        for step in steps:
            kind, dev = step[:2]
            if kind == "wait":
                stream = streams[dev] if dev in streams else streams.setdefault(dev, torch.cuda.current_stream(dev))
                stream.wait_event(self._events[step[2]])
            elif kind == "record":
                stream = streams[dev] if dev in streams else streams.setdefault(dev, torch.cuda.current_stream(dev))
                self._events[step[2]].record(stream)
            else:
                run(dev)

    def _check_grain(self, grain) -> None:
        if grain is not None and tuple(grain.shape) != (3, *self.out_size):
            raise ValueError(f"this captured call takes a grain of {(3, *self.out_size)}, got {tuple(grain.shape)}")

    def _put_grain(self, grain, strips) -> None:
        """Each of ``strips``' rows of the grain into its static, on its
        device's current stream (only its own program reads it)."""
        if not self.takes_grain:
            return
        n, hl = self.layout.n, self.layout.out_hw[0]
        for j in strips:
            static = self.programs.shard_inputs[j][1]
            k = j % n
            static.copy_(grain[:, k * hl:(k + 1) * hl])

    def _stage(self, image, frame, grain=None) -> None:
        """A call's checks and its staging, before the replays: the rows put
        (``put``, after ``writable()``'s waits) unless ``image`` is
        ``inputs``; then on each device (``_schedule``'s stage steps) its
        strips' grain rows, the page, and the frame on the devices that hold
        one (``_frame_devices``)."""
        own = image is self.inputs
        if not own:
            sharding._check_like(image, self.shape, self.dtype, "this captured call")
            if self.takes_grain and grain is None:
                raise ValueError("this call was captured with grain: pass grain=")
        self._check_grain(grain)
        if not own:
            self.put(image)
        src = sharding._home(image)
        page = None if self._page_of is None else self._page_of(src, frame)

        def stage(dev):  # each copy runs on its destination's current stream
            with profiling.trace_annotation("fsr.spatial", "card", dev.index):
                ins = self.programs.device_inputs[dev]
                if grain is not None:
                    self._put_grain(grain, self._strips_on[dev])
                if page is not None:
                    ins[1].copy_(page)
                if dev in self._frame_devices:
                    sharding._put_frame(frame, src, {dev: ins[0]})

        self._issue(self._stage_steps, stage)
