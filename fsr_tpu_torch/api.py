"""Top-level user API: ``upscale()``, ``sharpen()`` and ``UpscalePipeline``.

Counterpart of ``fsr_tpu/api.py``.  ``upscale``: constant setup on the host,
then EASU and RCAS either fused in the hand-written CUDA kernels (K1 at
integer ratios, with the edge pad folded into its loads; K2 at any other
upscale; no intermediate image in device memory) or as two plain-torch ops.  The SRTM prologue, the K5
epilogue (SRTM^-1/gamma2, LFGA grain, TEPD dither), byte I/O and RGBA's
bilinear alpha run inside those kernels, or as ``ops.extras`` passes and a
bilinear pass on the torch path.  float16 math runs K6 (EASU "mixed" and
FsrRcasH in one launch, alpha inside), with the prologue, the epilogue and
integer outputs as torch passes around it, where the JAX package runs two
jitted XLA programs; K1 and K2 take a float16 image under float32 or
bfloat16 math.  ``sharpen``: RCAS alone, in the CUDA kernel K3
(float16 too) or as the plain-torch op.
``UpscalePipeline``: the sample's frame tail in one kernel call.

Layouts: planar channels-first (..., C, H, W) as in ``fsr_tpu``; (..., H,
W, C) inputs are accepted with ``layout="HWC"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fsr_tpu_torch import autodiff
from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.core.presets import PRESETS
from fsr_tpu_torch.kernels import dispatch, halo
from fsr_tpu_torch.kernels import epilogue as epilogue_mod
from fsr_tpu_torch.kernels import rcas as rcas_kernel
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.ops import easu as easu_ops
from fsr_tpu_torch.ops import extras
from fsr_tpu_torch.ops import rcas as rcas_ops

__all__ = ["upscale", "sharpen", "UpscalePipeline"]

_IMPLS = ("auto", "torch", "kernel")
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)


def _resolve_out_size(
    in_size: Tuple[int, int],
    out_size: Optional[Tuple[int, int]],
    scale: Optional[float],
    preset: Optional[str],
) -> Tuple[int, int]:
    if out_size is not None:
        return (int(out_size[0]), int(out_size[1]))
    if preset is not None:
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; available: {sorted(PRESETS)}")
        scale = PRESETS[preset].scale
    if scale is None:
        raise ValueError("provide one of out_size=, scale=, or preset=")
    return (round(in_size[0] * scale), round(in_size[1] * scale))


def _check_impl(impl):
    if impl not in _IMPLS:
        raise ValueError(f"impl must be 'auto', 'torch' or 'kernel', got {impl!r}")


def _apply_epilogue(out, epi, frame, grain, dither_page=None, origin=(0, 0)):
    """Torch-path twin of the kernels' fused epilogue (``fsr_tpu/api.py``
    ``_apply_epilogue_xla``): the ``ops.extras`` chain in float32 on the
    operands the kernels take, the result back in ``out``'s dtype.

    origin: (row0, col0), the global coordinate of out[..., 0, 0]; a row
    strip of a row-sharded frame passes its first row, so its dither
    positions are the whole frame's (strips split rows only: col0 is 0)."""
    row0, col0 = (int(v) for v in origin)
    if col0:
        raise ValueError(f"the epilogue takes a row origin only (row strips), got col0={col0}")
    args = epilogue_mod.bind(epi, tuple(out.shape[-2:]), frame, grain, dither_page, out.device, row0)
    return epilogue_mod.apply(out.to(torch.float32), args).to(out.dtype)


def upscale(
    image: torch.Tensor,
    out_size: Optional[Tuple[int, int]] = None,
    scale: Optional[float] = None,
    preset: Optional[str] = None,
    sharpness: float = 0.25,
    apply_rcas: bool = True,
    denoise: bool = False,
    compute_dtype=torch.float32,
    impl: str = "auto",
    layout: str = "CHW",
    input_viewport: Optional[Tuple[int, int]] = None,
    input_offset: Tuple[int, int] = (0, 0),
    epilogue: Optional[Epilogue] = None,
    frame=None,
    grain=None,
    grain_planar=None,
    prologue: str = "none",
    out_dtype=None,
    dither_page=None,
) -> torch.Tensor:
    """FSR 1.0 upscale: EASU + optional RCAS.

    image: (..., 3, H, W) planar (layout="CHW", default) or (..., H, W, 3)
      (layout="HWC"), float32, bfloat16 or float16 with values in [0, 1],
      or uint8 (decoded v/255; on the kernel path inside the kernel, so the
      source stays bytes).  A fourth channel is alpha: bilinear with the
      same coordinate mapping, never sharpened (the RCAS passthrough rule,
      ffx_fsr1.h:688-705), never touched by the prologue or the epilogue,
      and stored by the colour's rule; on the kernel path it is resolved
      inside the same launch.
    out_size / scale / preset: target size (one of the three).  Presets:
      ultra_quality 1.3x, quality 1.5x, balanced 1.7x, performance 2.0x.
    sharpness: RCAS sharpness in stops (0 = maximum; sample default 0.25).
    compute_dtype: float32 | bfloat16 | float16.  On the kernel path
      bfloat16 is the storage type and the math runs in float32; on the
      torch path colour accumulation runs in bfloat16.  float16 stores
      float16, with colour accumulation in float16 and the direction
      estimation in float32 (``ops.easu`` "mixed"), then FsrRcasH: on the
      kernel path one K6 launch computes it, bit-equal to the torch path.
      A float16 image under float32 or bfloat16 math runs K1 or K2, which
      widen it (or round it to bfloat16) at their loads.
    impl: "auto" | "torch" | "kernel".  "auto" takes the kernel path for a
      CUDA tensor and the plain-torch path for a CPU tensor; "torch" is the
      plain-torch path on any device; "kernel" forces the kernel path (on
      CPU tensors the kernels' plain versions).  The kernel path runs K1
      (one launch) at integer per-axis ratios (1, 2 or 4: the Performance
      preset) and K2 at every other upscale (the other presets, native 1x,
      DRS ratios, odd extents), K6 for compute_dtype=float16 at any
      upscale.  A configuration no kernel takes (a downscale) runs the
      plain-torch path under "auto", as the JAX package's "auto" runs its
      XLA path, and raises under "kernel".
    input_viewport / input_offset: Dynamic Resolution Scaling — the viewport
      (h, w) actually rendered inside the container image, and its offset
      (FsrEasuConOffset, ffx_fsr1.h:205-225).
    epilogue: optional ``Epilogue`` of output post-ops (SRTM^-1 / gamma2
      transform, LFGA grain, TEPD dithered quantize), fused into the
      kernels' store on the kernel path and run as ``ops.extras`` passes on
      the torch path.  ``frame`` is the TEPD hash's frame index; ``grain``
      is (3, Hout, Wout) in {-0.5..0.5}; ``dither_page`` is a (th, tw) page
      of dither positions tiled over the output when
      ``epilogue.dither_texture``.  ``grain_planar`` (the TPU kernel's
      phase-planar grain layout) has no counterpart: pass ``grain``.
    prologue: "none" | "srtm" — the SRTM reversible tonemap on the input
      before EASU, fused into the kernels' tap loads on the kernel path.
    out_dtype: uint8 encodes floor(sat(v)*255 + 0.5) (the D3D UNORM rule;
      with dither_bits=8 the byte is the display code), uint16 the 10-bit
      codes floor(sat(v)*1023 + 0.5); otherwise it must match compute_dtype.

    Gradients: ``upscale`` is differentiable in a floating ``image`` (not
    through uint8/uint16 outputs).  The torch path differentiates its ops
    (the bit tricks carry the ideal functions' derivatives); the kernel path
    runs the same kernel forward and differentiates the torch path's twin
    of the call (``autodiff.kernel_with_torch_vjp``): its backward launches
    no kernel.  Alpha takes the bilinear gradient; grain, frame and dither
    page take none; a TEPD dither's floor gives zero almost everywhere.

    Returns the upscaled image in out_dtype (default compute_dtype), in the
    input's layout.
    """
    if layout == "HWC":
        image = image.movedim(-1, -3)
    elif layout != "CHW":
        raise ValueError(f"unknown layout {layout!r}")
    _check_args(image, compute_dtype, out_dtype, epilogue, prologue, impl)
    if grain_planar is not None:
        raise ValueError("grain_planar is the TPU kernel's grain layout; pass grain=(3, Hout, Wout)")

    hin, win = image.shape[-2:]
    vp = input_viewport if input_viewport is not None else (hin, win)
    out_hw = _resolve_out_size(vp, out_size, scale, preset)
    con = EasuConstants.create(
        input_viewport_in_pixels=(vp[1], vp[0]),
        input_size_in_pixels=(win, hin),
        output_size_in_pixels=(out_hw[1], out_hw[0]),
        input_offset_in_pixels=(input_offset[1], input_offset[0]),
    )
    out = _upscale(image, out_hw, con, RcasConstants(sharpness_stops=float(sharpness)), apply_rcas=apply_rcas,
                   denoise=denoise, compute_dtype=compute_dtype, impl=impl, epilogue=epilogue, frame=frame,
                   grain=grain, prologue=prologue, out_dtype=out_dtype, dither_page=dither_page)
    if layout == "HWC":
        out = out.movedim(-3, -1)
    return out


def _check_args(image, compute_dtype, out_dtype, epilogue, prologue, impl):
    """``upscale``'s checks of its image and options (also those of each
    row-sharded call, ``parallel.spatial``), before any launch."""
    _check_impl(impl)
    if image.dtype not in _FLOATS + (torch.uint8,):
        raise ValueError(f"image must be float32, bfloat16, float16 or uint8, got {image.dtype}")
    if compute_dtype not in _FLOATS:
        raise ValueError(f"compute_dtype must be float32, bfloat16 or float16, got {compute_dtype}")
    if image.dim() < 3 or image.shape[-3] not in (3, 4):
        raise ValueError(f"image must be (..., 3 or 4, H, W), got {tuple(image.shape)}")
    if out_dtype is not None and out_dtype not in (torch.uint8, torch.uint16, compute_dtype):
        raise ValueError(
            f"out_dtype must be uint8/uint16 or match compute_dtype (got {out_dtype} vs {compute_dtype})"
        )
    if epilogue is not None and not isinstance(epilogue, Epilogue):
        raise TypeError(f"epilogue must be an Epilogue, got {type(epilogue).__name__}")
    if epilogue is not None and epilogue.dither_bits == 10 and out_dtype == torch.uint8:
        # 10-bit TEPD codes k/1023 are not representable as x255 UNORM bytes.
        raise ValueError("uint8 output cannot hold 10-bit codes")
    if prologue not in ("none", "srtm"):
        raise ValueError(f"unknown prologue {prologue!r}")


def _on_card(image) -> bool:
    """Whether ``impl="auto"`` looks for a kernel: the image lies on a card."""
    return image.device.type == "cuda"


def _upscale(image, out_hw, con, rcon, *, apply_rcas, denoise, compute_dtype, impl, epilogue, frame, grain,
             prologue, out_dtype, dither_page, strip=None):
    """``upscale`` after its checks (``_check_args``), on a planar image:
    the kernel path (``dispatch.upscale_fused``: K1, K2 or, for float16
    math, K6) or the torch path, picked from ``impl``, the dtypes and the
    image's device.  As ``fsr_tpu/api.py:178-189``, "auto" on a card takes
    the kernel path only where it takes the configuration
    (``dispatch.supported``) and the torch path elsewhere, chosen before any
    launch; "kernel" raises there.

    strip: a ``parallel.spatial.Strip`` when the image is one halo'd row
    strip of a row-sharded frame and ``out_hw`` its (hl, Wout) output rows:
    the strip form of K1 (shard-local constants with ``row_offset``/
    ``global_rows`` at an exact-phase ratio), else of K2, or of K6 for
    float16 math, the latter two on its row tables from the global mapping
    (``dispatch.upscale_fused(strip=)``); the torch path runs EASU over the
    same tables for its rows -1 .. hl, then RCAS on its own rows.  ``grain``
    is then the strip's rows, and the epilogue dithers at global rows.  The
    strip may be a ``kernels.halo.StripSource``: the kernels read its rows
    in place; the torch path and a kernel forward under autograd take its
    halo'd rows as one tensor (``halo.halo_rows_reference``)."""
    kw = dict(epilogue=epilogue, frame=frame, grain=grain, prologue=prologue, out_dtype=out_dtype,
              dither_page=dither_page)
    if impl == "kernel" or (impl == "auto" and _on_card(image)
                            and dispatch.supported(image, out_hw, con, compute_dtype, out_dtype, strip)):
        def kernel(x):
            return dispatch.upscale_fused(x, out_hw, con, rcon, apply_rcas, denoise, compute_dtype, strip=strip, **kw)

        if not image.requires_grad or out_dtype in (torch.uint8, torch.uint16):
            return kernel(image)
        if isinstance(image, halo.StripSource):
            image = halo.halo_rows_reference(image)

        # As fsr_tpu/api.py:269-278: the kernel forward, the backward through
        # this call on the torch path (RGBA whole, so alpha takes its
        # bilinear gradient there).
        def twin(x):
            return _upscale(x, out_hw, con, rcon, apply_rcas=apply_rcas, denoise=denoise,
                            compute_dtype=compute_dtype, impl="torch", strip=strip, **kw)

        return autodiff.kernel_with_torch_vjp(kernel, twin, image)

    if isinstance(image, halo.StripSource):
        image = halo.halo_rows_reference(image)
    # As fsr_tpu/api.py:196-215, :302-309: alpha is a bilinear pass of its
    # own (a byte decoded first), encoded like the colour, concatenated.
    # A strip's row plan: the 'f' row and fraction of its output rows -1 .. hl.
    rows = None if strip is None else (strip.rows.rows[1], strip.rows.py)
    rgb, alpha = image, None
    if image.shape[-3] == 4:
        rgb, a_src = image[..., :3, :, :], image[..., 3:4, :, :]
        if a_src.dtype == torch.uint8:
            a_src = epilogue_mod.decode(a_src)
        alpha = easu_ops.bilinear(a_src, out_hw, con,
                                  rows=None if rows is None else (rows[0][1:-1], rows[1][1:-1]))
    if rgb.dtype == torch.uint8:
        rgb = epilogue_mod.decode(rgb)
    if prologue == "srtm":
        rgb = extras.srtm(rgb)
    if strip is None:
        out = easu_ops.easu(rgb, out_hw, con, compute_dtype=compute_dtype)
        if apply_rcas:
            out = rcas_ops.rcas(out, rcon, denoise=denoise, compute_dtype=compute_dtype)
    else:
        out = easu_ops.easu(rgb, (out_hw[0] + 2, out_hw[1]), con, compute_dtype=compute_dtype, rows=rows)
        out = rcas_ops.rcas_strip(out, rcon, denoise, compute_dtype) if apply_rcas else out[..., 1:-1, :]
    if epilogue is not None:
        origin = (0 if strip is None else strip.row0, 0)
        out = _apply_epilogue(out, epilogue, frame, grain, dither_page=dither_page, origin=origin)
    if out_dtype is not None:
        out = epilogue_mod.store(out, out_dtype)
    if alpha is not None:
        out = torch.cat([out, epilogue_mod.store(alpha, out.dtype)], dim=-3)
    return out


def sharpen(
    image: torch.Tensor,
    sharpness: float = 0.25,
    denoise: bool = False,
    compute_dtype=None,
    impl: str = "auto",
    layout: str = "CHW",
    border: str = "clamp",
) -> torch.Tensor:
    """Standalone RCAS sharpening (no scaling): the reference supports RCAS
    as an independent pass (ffx_fsr1.h:602-608).

    image: (..., 3, H, W) or (..., 4, H, W) with alpha (layout="CHW"), or
      channels last (layout="HWC"); float32, bfloat16 or float16 with
      values in [0, 1], or uint8.
    compute_dtype: float32 | bfloat16 | float16 | None (the image's dtype).
      On the kernel path it is the storage type and the math runs in
      float32 (float16 too, as the JAX kernel runs it; the result stays
      float16); on the torch path the arithmetic runs in it (float16:
      FsrRcasH).  A uint8 image sharpens in float32 and returns uint8
      (UNORM8 codes) whatever it says, on both paths, so byte outputs agree
      across impl.
    impl: "auto" | "torch" | "kernel".  "auto" runs K3 for a CUDA tensor and
      the plain-torch op for a CPU tensor; "torch" the plain-torch op on any
      device; "kernel" K3 (on a CPU tensor its plain version).
    border: "clamp" (edge replication) or "zero" (the sample's out-of-bounds
      imageLoad, which darkens the 1-pixel border; kept for A/B parity).

    Alpha is passed through verbatim.  Gradients: differentiable in a
    floating image; on the kernel path K3 runs forward and the backward
    differentiates the torch path's ``ops.rcas`` on the RGB planes
    (``autodiff.kernel_with_torch_vjp``); alpha's gradient is the identity.
    """
    _check_impl(impl)
    if layout == "HWC":
        image = image.movedim(-1, -3)
    elif layout != "CHW":
        raise ValueError(f"unknown layout {layout!r}")
    if image.dtype not in _FLOATS + (torch.uint8,):
        raise ValueError(f"image must be float32, bfloat16, float16 or uint8, got {image.dtype}")
    if compute_dtype not in (None,) + _FLOATS:
        raise ValueError(f"compute_dtype must be float32, bfloat16 or float16, got {compute_dtype}")
    if image.dim() < 3 or image.shape[-3] not in (3, 4):
        raise ValueError(f"image must be (..., 3 or 4, H, W), got {tuple(image.shape)}")
    rcon = RcasConstants(sharpness_stops=float(sharpness))

    if impl == "kernel" or (impl == "auto" and image.device.type == "cuda"):
        def kernel(x):
            return rcas_kernel.rcas_fused(x, rcon, denoise=denoise, compute_dtype=compute_dtype, border=border)

        def twin(x):
            return rcas_ops.rcas(x, rcon, denoise=denoise, compute_dtype=compute_dtype, border=border)

        rgb = image[..., :3, :, :]
        out = autodiff.kernel_with_torch_vjp(kernel, twin, rgb) if rgb.requires_grad else kernel(rgb)
        if image.shape[-3] == 4:
            out = torch.cat([out, image[..., 3:4, :, :].to(out.dtype)], dim=-3)
    elif image.dtype == torch.uint8:
        # The kernel sharpens bytes in float32 before the UNORM encode; the
        # torch path does the same, so byte outputs agree across impl.
        out = rcas_ops.rcas(epilogue_mod.decode(image), rcon, denoise=denoise,
                            compute_dtype=torch.float32, border=border)
        out = epilogue_mod.encode_unorm8(out)
    else:
        out = rcas_ops.rcas(image, rcon, denoise=denoise, compute_dtype=compute_dtype, border=border)

    if layout == "HWC":
        out = out.movedim(-3, -1)
    return out


class UpscalePipeline:
    """Full post-process chain, mirroring the sample's frame tail:

    (optional SRTM for HDR) -> EASU -> RCAS -> (optional SRTM^-1 back to
    HDR, or gamma2 -> linear output squaring) -> (optional LFGA grain)
    -> (optional TEPD dither to 8/10-bit gamma-2.0).

    Construct once with static configuration; each call is one ``upscale``
    (on a CUDA tensor: one launch of K1 or K2, with the whole chain inside).

    hdr_srtm / hdr_out: the reference pairs the reversible tonemap with its
    inverse around the filter chain for HDR inputs (ffx_fsr1.h:1039-1041);
    hdr_out=True applies SRTM^-1 after sharpening so the pipeline returns
    HDR values (requires hdr_srtm).
    gamma2_out: square the output (gamma-2.0 -> linear), the sample's HDR
    swapchain mode (Sample.x == 1, FSR_Pass.hlsl:78-79).
    dither_texture: optional (pages, th, tw) or (th, tw) dither texture,
    page-indexed by frame (the sample's temporal blue noise,
    FSR_Tonemapping.hlsl:86-88; see fsr_tpu_torch.utils.noise); any page
    shape tiles the output.  Default: the TEPD golden-ratio ordered dither.
    The dither fuses into the kernel whenever the output dtype can hold the
    codes (float32 storage, uint8 for 8-bit, uint16 for either); otherwise
    (bfloat16 storage without an integer output) it runs as an
    ``ops.extras`` after-pass on the output's device, as the JAX package
    runs its XLA after-pass.
    impl: "auto" | "torch" | "kernel", as ``upscale``.
    mesh / spatial_axis / batch_axis: run the chain row-sharded across
    ``mesh[spatial_axis]`` (and the batch across ``mesh[batch_axis]``), each
    strip through the same kernel launches, with the dither at global rows
    (``parallel.spatial.upscale_spatial_sharded``, which also takes the
    image as a ``Sharded``).  The result is a ``parallel.Sharded`` whose
    strips stay on their devices, as JAX's sharded result does; its
    ``gather()`` equals the single-device pipeline's result.  The bf16
    after-pass runs per strip, on the strip's device, over its rows of the
    dither pattern.  Without a mesh the result is a tensor.
    ``parallel.spatial.CapturedSpatial.from_pipeline`` captures the mesh
    path once per device (the same per-strip body, ``_strip_body``).
    """

    def __init__(
        self,
        out_size: Tuple[int, int],
        sharpness: float = 0.25,
        apply_rcas: bool = True,
        denoise: bool = False,
        hdr_srtm: bool = False,
        hdr_out: bool = False,
        gamma2_out: bool = False,
        grain_amount: float = 0.0,
        dither_bits: Optional[int] = None,
        dither_texture=None,
        compute_dtype=torch.float32,
        impl: str = "auto",
        out_dtype=None,
        mesh=None,
        spatial_axis: str = "sp",
        batch_axis: Optional[str] = None,
    ):
        if out_dtype in (torch.uint8, torch.uint16):
            if hdr_out:
                raise ValueError("integer output cannot hold HDR values")
            if dither_bits == 10 and out_dtype == torch.uint8:
                raise ValueError("uint8 output cannot hold 10-bit codes")
        if hdr_out and not hdr_srtm:
            raise ValueError("hdr_out=True requires hdr_srtm=True")
        if hdr_out and gamma2_out:
            raise ValueError("hdr_out and gamma2_out are exclusive output modes")
        if hdr_out and dither_bits is not None:
            raise ValueError("TEPD dithering expects {0..1} input, not HDR out")
        _check_impl(impl)
        self.out_size = tuple(out_size)
        self.sharpness = sharpness
        self.apply_rcas = apply_rcas
        self.denoise = denoise
        self.hdr_srtm = hdr_srtm
        self.hdr_out = hdr_out
        self.gamma2_out = gamma2_out
        self.grain_amount = grain_amount
        self.dither_bits = dither_bits
        self.dither_texture = (
            torch.as_tensor(dither_texture, dtype=torch.float32) if dither_texture is not None else None
        )
        self._textures = {}  # device -> the texture there
        self.compute_dtype = compute_dtype
        self.impl = impl
        self.out_dtype = out_dtype
        self.mesh = mesh
        self.spatial_axis = spatial_axis
        self.batch_axis = batch_axis

    def _texture(self, device) -> Optional[torch.Tensor]:
        """The dither texture as (pages, th, tw) on ``device`` (moved once per
        device: a sharded call reads it on each strip's)."""
        if self.dither_texture is None:
            return None
        tex = self._textures.get(device)
        if tex is None:
            tex = self.dither_texture.to(device)
            tex = self._textures[device] = tex if tex.dim() == 3 else tex[None]
        return tex

    def _after_pass(self, x: torch.Tensor, frame, row0: int = 0) -> torch.Tensor:
        """The TEPD quantize over ``x``, rows ``row0``.. of the output, with
        the dither positions computed on ``x``'s device; then the store."""
        hw, origin = tuple(x.shape[-2:]), (row0, 0)
        tex = self._texture(x.device)
        if tex is not None:
            dit = extras.texture_dither(hw, frame, tex, origin=origin)
        else:
            dit = extras.tepd_dither(hw, frame, origin=origin, device=x.device)
        x = extras.tepd_quantize(x.to(torch.float32), dit, bits=self.dither_bits)
        return x if self.out_dtype is None else epilogue_mod.store(x, self.out_dtype)

    def _options(self, use_grain: bool):
        """The upscale options of a call, with grain or without, and whether
        the dither runs as an after-pass."""
        # TEPD codes are k/255 or k/1023 levels: bfloat16 storage cannot hold
        # them, so the dither fuses into the kernel only when the output
        # dtype can (float32, uint8 for 8-bit, uint16 for either).
        fuse = self.dither_bits is not None and (
            self.compute_dtype == torch.float32 or (self.out_dtype == torch.uint8 and self.dither_bits == 8)
            or self.out_dtype == torch.uint16
        )
        epi = Epilogue(
            transform="srtm_inv" if self.hdr_out else "gamma2" if self.gamma2_out else "none",
            grain_amount=self.grain_amount if use_grain else 0.0,
            dither_bits=self.dither_bits if fuse else None,
            dither_texture=fuse and self.dither_texture is not None,
        )
        opts = dict(
            apply_rcas=self.apply_rcas,
            denoise=self.denoise,
            compute_dtype=self.compute_dtype,
            impl=self.impl,
            epilogue=None if epi.is_noop else epi,
            prologue="srtm" if self.hdr_srtm else "none",
            out_dtype=self.out_dtype if (fuse or self.dither_bits is None) else None,
        )
        return opts, self.dither_bits is not None and not fuse

    def _page(self, device, frame, opts) -> Optional[torch.Tensor]:
        """The frame's page of the dither texture on ``device`` when the
        kernel reads one: a view for an int frame; for a frame tensor there,
        gathered there (no host read; in a ``CapturedFrame`` the page is
        written inside the graph, at an address that stays put, and a
        ``CapturedSpatial`` copies it into each card's static page per
        call)."""
        epi = opts["epilogue"]
        return extras.select_page(self._texture(device), frame) if epi is not None and epi.dither_texture else None

    def _strip_body(self, opts, after: bool):
        """The chain on one row strip (``parallel.spatial._body``), then the
        after-pass over the strip's rows of the dither pattern: what the mesh
        path runs per strip, eagerly or captured
        (``parallel.spatial.CapturedSpatial.from_pipeline``)."""
        from fsr_tpu_torch.parallel import spatial

        strip = spatial._body(self.sharpness, opts)
        if not after:
            return strip

        def body(layout, k, s, frame, grain, page):
            return self._after_pass(strip(layout, k, s, frame, grain, page), frame, layout.strips[k].row0)
        return body

    def __call__(self, image, grain=None, frame=0):
        from fsr_tpu_torch.parallel import sharding, spatial

        use_grain = bool(self.grain_amount) and grain is not None
        opts, after = self._options(use_grain)
        grain = grain if use_grain else None
        device = image.shards[0].device if isinstance(image, sharding.Sharded) else image.device
        page = self._page(device, frame, opts)
        if self.mesh is None:
            x = upscale(image, out_size=self.out_size, sharpness=self.sharpness, frame=frame, grain=grain,
                        dither_page=page, **opts)
            return self._after_pass(x, frame) if after else x
        return spatial._run(image, self.out_size, self.mesh, self.spatial_axis, self.batch_axis, frame, grain, page,
                            self._strip_body(opts, after), opts)
