#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on a mismatch, so any failure exits non-zero):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from fsr_tpu_torch/csrc (timed);
  3. K4 edge_pad bit-equal to edge_pad_reference on the card, for every
     dtype pair it takes, output rows of every length modulo its 16-byte
     vector, 1, 3 and 4 planes, a 1x1 source under larger pads and a row
     strip's pads; same-type pads also bit-equal to F.pad(mode="replicate")
     for each dtype F.pad takes on CUDA;
  4. K1 upscale_fused against upscale_fused_reference on the card (f32
     within 6e-5; bf16 by median/p99 and max <= 2**-8), including the
     hazard cases (isolated bright pixel, DRS offset, all-black frame); the
     quad path (2x) bit-equal to the generic staged path on the same frames,
     and K1 on the K4-padded frame (upscale_padded) bit-equal to K1 on the
     image;
  5. fsr_tpu_torch.upscale(preset="performance") against the port's numpy
     oracle at 540p -> 1080p f32 (max-abs <= 2e-5);
  6. the Performance path: upscale(x, preset="performance") on a (4, 3,
     1080, 1920) CUDA tensor in f32 and bf16, held against
     upscale_fused_reference (the phase-4 limits), with launch counts (one
     K1, no K4) and CUDA-event times of each kernel beside its plain
     version (K4 timed on its own at this shape);
  7. K2 easu_gather against easu_gather_reference (the phase-4 limits) at
     every preset ratio, native 1x, a ragged ratio, 2x with an odd width, a
     DRS offset, bf16, EASU-only, denoise, batch 2 and the hazard cases;
  8. K3 rcas_fused against rcas_fused_reference (the same limits; uint8
     bit-equal): clamp and zero borders, denoise, bf16, an isolated pixel, a
     ragged image; then every storage type at widths of every residue of
     its 16-byte vector and from an unaligned row start;
  9. upscale(preset="quality") at 720p -> 1080p and sharpen at 1080p, f32,
     against the numpy oracle (max-abs <= 2e-5);
 10. the Quality path: upscale(x, preset="quality") on a (4, 3, 1440, 2560)
     CUDA tensor (-> 4K) and sharpen(y) on a (4, 3, 2160, 3840) one, in f32
     and bf16, held against their plain versions, with launch counts (K2 on
     the Quality path and K1 not; K3 on sharpen) and CUDA-event times;
 11. with --trace only: a torch.profiler trace of the Performance path, the
     Quality path and sharpen (device time per kernel, busy time and idle
     share of the window);
 12. K1 and K2 with each Epilogue variant (kernels/epilogue.py) and the SRTM
     prologue, float32 and bfloat16 storage, uint8 in and uint8/uint16 out,
     against their plain versions: float outputs by the phase-4 limits
     (SRTM^-1 outputs after the forward tonemap), codes and dithered outputs
     identical or at most 1e-4 of the values off by one code or dither
     step; K3 and K4 on uint8 bit-equal;
 13. the README's pipeline paths on batches of 4 (launch counts exactly one
     per kernel, held against the kernels' plain versions by the phase-12
     limits and against the plain-torch pipeline, CUDA-event times beside
     the same upscale without the epilogue and the plain versions): (a) the
     HDR frame tail UpscalePipeline((2160, 3840), hdr_srtm=True,
     grain_amount=0.3, dither_bits=10) on float32 1080p frames (K1),
     (b) the display path (grain, 8-bit dither, uint8 out, bf16 storage) on
     uint8 1440p frames (K2), (c) the byte video path upscale(frame_u8,
     scale=2.0, out_dtype=uint8) (K1 on bytes), and sharpen on uint8 4K
     frames (K3);
 14. with --trace only: traces of (a) and (b), which must show only their
     kernels;
 15. K1 and K2 on RGBA (f32 and bf16 storage, uint8 in with uint8/uint16
     out, RCAS off/on/denoise, the SRTM prologue, the HDR-tail and display
     epilogues; K2 also at a DRS offset and a ragged ratio) against their
     plain versions: alpha bit-equal, RGB bit-equal to the 3-channel call of
     the same kernel and within the phase-12 limits of the plain version;
 16. the RGBA paths on batches of 4: (d) upscale(rgba, preset="performance")
     on (4, 4, 1080, 1920) float32 and uint8 (-> uint8), exactly one K1
     each, (e) upscale(rgba, preset="quality") on (4, 4, 1440, 2560)
     bfloat16, exactly one K2; the same checks, and CUDA-event times of each
     kernel and the same call on the RGB slice, taken in turn (with --trace,
     traces of both, which must show only those kernels);
 17. float16: upscale(x.half(), preset="performance", compute_dtype=float16)
     at 540p -> 1080p on the torch path (no kernel launch), "mixed" against
     the float32 oracle and ops.easu "strict" against the float16 oracle by
     the docs/FIDELITY.md f16 rows; sharpen on (4, 3, 2160, 3840) float16
     through K3 (one launch), within one half step of its plain version;
     times of both, the float16 upscale at batch 4 beside K1;
 18. row-sharded execution (fsr_tpu_torch.parallel) on meshes of the card
     repeated: at small sizes K1 with row_offset/global_rows (2x, 4x,
     2x rows by 1x columns; 2, 4 and 8 strips) and K2 with per-strip row
     plans (1.5x, 1.3x, ~1.7x, a DRS offset; 2, 3 and 4 strips), and each
     storage type, code, epilogue and RGBA option on 4 strips, each
     bit-equal to the unsharded kernel output and within phase 12's limits
     of the same sharded call on the plain versions; at full width, batch 4,
     (i) Performance f32 and (ii) Quality bf16 on 4 strips, (iii) the HDR
     tail (a) and (iv) the display path (b) with a dither page through
     UpscalePipeline(mesh=), (v) Performance f32 on dp=2 x sp=2, each with
     exactly 4 launches of each of its kernels and bit-equal to the
     unsharded call; CUDA-event times of each beside its unsharded twin and
     of the strips' kernels beside the unsharded kernel, taken in turn; with
     several cards, (i) and (ii) across them too, with each card's busy time
     from a trace; with --trace, a trace of each full-width run;
 19. the probes (fsr_tpu_torch/kernels/probes.py, through tools_torch/
     ablation): P1 opmix_replay (RCAS on and off) and P2 opmix_replay_shared
     on the K4-padded one-tile frame, on small grids and then on K1's
     headline grid (120, 135, 4), one launch each, against
     upscale_padded_reference (within 6e-5) and against K1 on the same
     frame; P3 fma_rate (float32 and half2, 4 and 8 chains) against its plain
     recurrence; P4 fp16_probe's three modes (0 and 2 bit-equal, 1 within a
     float16 step per FMA); then every probe, K1 float32 and K1 bfloat16
     timed in turn, with nvidia-smi's clocks, power and temperature before
     and after: K1 - P1 (its global tap loads against shared-memory
     ones), P1 - P2 (its recompute), whether P2 <= P1 <= K1, P2 against its
     op floor, the achieved FMA rates, K1's utilization;
 20. autodiff on the card, batch 1: (i) upscale(preset="performance") f32
     1080p -> 4K, (ii) preset="quality" f32 1440p -> 4K, (iii) sharpen f32
     at 4K, (iv) performance bf16; each forward launches exactly one K1, K2
     or K3 (no K4) and its backward none (the torch twin,
     fsr_tpu_torch/autodiff.py); the gradient under sum(out) bit-equal to
     impl="torch"'s, under sum(out**2) within tests/test_torch_grad.py's
     limits; forward and backward ms (CUDA events) and the peak memory per
     call; at 540p -> 1080p the card's gradient within 1e-5 * max|g| of the
     port's CPU gradient; then examples_torch/train_through_fsr.py's inverse
     problem, 3 Adam steps at 1080p -> 4K, one K1 launch each, the
     displayed MSE lower after them than at the box-downsample baseline;
     with --trace, a trace of each case's forward and backward.
 21. the application layer on the card, from seeded numpy data in a
     temporary directory: (i) fsr_tpu_torch.cli --preset performance on a
     1080p PNG -> 4K with --benchmark 5 --results (one K1 per run, no K4;
     the PNG's codes equal to upscale(x, preset="performance")'s; the
     CLI's device ms beside the library call's), (ii) --preset quality
     --dtype bfloat16 from 1440p (one K2), (iii) --hdr --grain 0.2 and
     --gamma2-out --grain 0.2 --dither-bits 10, --frame 3 (one K1 each),
     against the same CLI call on the plain kernels by phase 12's limits,
     and --hdr --dither-bits 10 refused as the reference refuses it;
     (iv) examples_torch/sample_app.py at 3840x2160, Quality: a 5-frame
     flythrough with CSV and two screenshots (one K2 per frame), a frame
     and the HDR chain against the plain kernels, the frame's traced
     kernel table and K2's share of it; (v) video_upscale, 16 frames
     1080p -> 4K in batches of 8 (one K1 per batch); (vi)
     dataset_preprocessing, u8 batches of 4 per card on make_mesh() (one
     K1 per card per batch); (vii) frame_graph at
     1080p -> 4K (one K1) and its kernel table; (viii) tools_torch/
     quality_study.py on the card within 0.01 dB of its CPU run; (ix) the
     native host layer built with cc, bit-equal to the numpy constants.
The card's name and power limit, a JSON object describing the kernels
(times per call, and bound_ms: the larger of the bytes over 3.35 TB/s and
the float32 operations the function needs, counted (EASU_OPS, RCAS_OPS),
over 67 TFLOP/s; half2's over 134) and the JSON result line
are the last three lines.  Exits non-zero with no result when CUDA is
unavailable.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

F32_TOL = 6e-5
# The kernels' readings (K* and the library call) bracket this many calls
# queued back to back per CUDA-event sample (profiling.cuda_time_ms): each
# call's host work overlaps the kernels before it, so they read device time
# per call.  The "call" readings stay one call each (latency, host included).
KQ = dict(queue=10)
BF16_MAX = 2.0 ** -8
BF16_MEDIAN = 1.0 / 1250.0
BF16_P99 = 1.25 / 255.0
ORACLE_TOL = 2e-5
CODE_SHARE = 1e-4
TORCH_SHARE = 1e-3
MAIN_SHAPE = (4, 3, 1080, 1920)
QUALITY_SHAPE = (4, 3, 1440, 2560)
SHARPEN_SHAPE = (4, 3, 2160, 3840)
# docs/FIDELITY.md f16 rows: mixed against the float32 oracle, strict
# against the float16 oracle.
F16_MIXED = dict(median=1.0 / 2040.0, p99=5.0 / 255.0, share=0.04)
F16_STRICT = dict(median=1e-3, p999=5e-3, share=0.002)
F16_ULP = 2.0 ** -11  # one float16 step in [0.5, 1)
# P3 against its plain recurrence (phase 19), relative: float32 (64 FMAs
# against a mul and an add each); half2 two float16 steps.
P3_F32_REL = 1e-5
P3_HALF2_REL = 2.0 ** -9
# Phase 20's gradient limits, those of tests/test_torch_grad.py: the kernel
# path against the torch path under a squared loss (float32; bfloat16 by p99
# and median relative to max|g|), the card against the CPU (float32).
GRAD_SQ_RTOL, GRAD_SQ_ATOL = 5e-3, 5e-4
GRAD_BF16_SQ_P99, GRAD_BF16_SQ_MEDIAN = 3e-2, 2e-3
GRAD_REL = 1e-5

# The least time the card could take (the kernels line's bound_ms): the
# larger of the bytes a kernel must move over the HBM3 rate and its
# float32 operations over the float32 rate outside the tensor cores (H100
# SXM data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
HALF2_OPS_PER_S = 134e12  # float16 pairs (__hfma2), twice the float32 rate
# float32 operations the function needs (FMA = 2), per output pixel: EASU
# and RCAS counted from the kernels' torch twins, convention 2 of
# tools_torch/ablation/fused_roofline.py (each aten op weighted by its output
# elements; a bit trick at its CUDA cost, 1 or 2 integer ops; the texel
# response and luma per source texel, a quarter per pixel at 2x);
# tests/test_torch_probes.py holds these to the count.  The
# TEPD dither, LFGA grain and RGBA's bilinear alpha per output pixel, and
# the SRTM prologue per source texel, are estimated from the sources
# (PERF.md section 3).  The kernels do more than this (K1 recomputes EASU
# on a one-pixel ring around each 30x30 tile, 1.138x; K2 around each 32x32
# tile, 1.129x; both run the prologue once per staged texel, and a block's
# window re-reads the texels of its neighbours' windows): that recompute is
# the kernels' cost, not the function's, so the bound leaves it out.
EASU_OPS = 392.75
RCAS_OPS = 96
EASU_RCAS_OPS = EASU_OPS + RCAS_OPS
SRTM_OPS_PER_TEXEL = 10
TEPD_OPS = 60
LFGA_OPS = 12
ALPHA_OPS = 8


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _compare(got: torch.Tensor, want: torch.Tensor, what: str, bf16_max=None) -> float:
    """Phase 4's limits: float32 by max-abs; bfloat16 (or float32 values
    held to bf16 limits with a max of `bf16_max`) by median, p99 and max."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    d = (got.float() - want.float()).abs()
    mx = d.max().item()
    f32_limits = got.dtype == torch.float32 and bf16_max is None
    bf16_max = BF16_MAX if bf16_max is None else bf16_max
    if f32_limits:
        ok = mx <= F32_TOL
        print(f"  {what}: max-abs {mx:.3e} (limit {F32_TOL:g})")
    else:
        flat = d.flatten()
        if flat.numel() > 1 << 24:
            flat = flat[:: flat.numel() // (1 << 24) + 1]
        med = flat.median().item()
        p99 = torch.quantile(flat, 0.99).item()
        ok = mx <= bf16_max and med <= BF16_MEDIAN and p99 <= BF16_P99
        print(f"  {what}: max-abs {mx:.3e} median {med:.3e} p99 {p99:.3e} "
              f"(limits {bf16_max:g}, {BF16_MEDIAN:g}, {BF16_P99:g})")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return mx


def _compare_steps(got: torch.Tensor, want: torch.Tensor, bits, what: str) -> float:
    """Codes and dithered outputs: identical, or at most CODE_SHARE of the
    values off, each by one code (one dither step: a whole 8-bit step in
    10-bit codes).  Returns the largest difference in output units."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    if got.dtype in (torch.uint8, torch.uint16):
        max_code = 255 if got.dtype == torch.uint8 else 1023
        limit = 1.0 if bits is None else float(-(-max_code // (2 ** bits - 1)))
        d = (got.to(torch.int32) - want.to(torch.int32)).abs().double()
        scale = 1.0 / max_code
    else:
        # one step; in bf16 storage plus the bf16 step of the rounded code
        limit = 1.01 / (2 ** bits - 1) + (BF16_MAX if got.dtype == torch.bfloat16 else 0.0)
        g, w = got.double(), want.double()
        d = torch.where(torch.isnan(g) & torch.isnan(w), 0.0, (g - w).abs()).nan_to_num(nan=float("inf"))
        scale = 1.0
    off = int((d > 0).sum())
    mx = d.max().item()
    share = off / d.numel()
    print(f"  {what}: {off} of {d.numel()} values off (share {share:.2e}, limit {CODE_SHARE:g}), "
          f"max {mx:g} (limit {limit:g})")
    if share > CODE_SHARE or mx > limit:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return mx * scale


def _compare_epilogue(got: torch.Tensor, want: torch.Tensor, epi, what: str) -> float:
    """Phase 12's limits.  Float outputs as phase 4; an SRTM^-1 output after
    the forward tonemap (the inverse multiplies a difference by (1 + y)^2 at
    output y; the tonemap maps both back to the domain the kernel computed
    in; in bf16 storage a value and its max3 each round before the tonemap,
    so the max limit is two bf16 steps); codes and dithered outputs by
    ``_compare_steps``."""
    from fsr_tpu_torch.ops.extras import srtm

    bits = epi.dither_bits if epi is not None else None
    if got.dtype in (torch.uint8, torch.uint16) or bits is not None:
        return _compare_steps(got, want, bits, what)
    if epi is not None and epi.transform == "srtm_inv":
        bf16_out = got.dtype == torch.bfloat16
        got, want = (srtm(t.float()) for t in (got, want))
        return _compare(got, want, what + " (after the forward tonemap)",
                        2 * BF16_MAX + F32_TOL if bf16_out else None)
    return _compare(got, want, what)


def _compare_torch_path(got: torch.Tensor, want: torch.Tensor, what: str, step=None) -> None:
    """A fused path against the plain-torch pipeline, whose forms are not the
    kernels' fast ones: at most TORCH_SHARE of the values at another code or
    dither step, each by at most `step`.  step=None: bf16 arithmetic on the
    torch side, so its codes are held by the bf16 contract of
    docs/FIDELITY.md (median 1/510, p99 5/255) plus one dither step: median
    <= 1 code and p99 <= 6 codes."""
    d = (got.double() - want.double()).abs()
    if step is None:
        flat = d.flatten()[:: d.numel() // (1 << 24) + 1]
        med, p99 = flat.median().item(), torch.quantile(flat, 0.99).item()
        print(f"  {what} vs the plain-torch pipeline: code differences median {med:g} p99 {p99:g} "
              f"max {d.max().item():g} (limits 1, 6)")
        if med > 1 or p99 > 6:
            raise AssertionError(f"{what}: disagrees with the plain-torch pipeline")
        return
    share = (d > 1e-6).double().mean().item()
    print(f"  {what} vs the plain-torch pipeline: share {share:.2e} at another code or step "
          f"(limit {TORCH_SHARE:g}), max {d.max().item():g} (limit {step:g})")
    if share > TORCH_SHARE or d.max().item() > step:
        raise AssertionError(f"{what}: disagrees with the plain-torch pipeline")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(bound_ms, bound_by): the byte floor or the operation floor,
    whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _kernel_entry(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops, library_ms=None,
                  ops_per_s=F32_OPS_PER_S):
    """One entry of the kernels line; the bound from this run's shapes."""
    bound_ms, bound_by = _bound(nbytes, ops, ops_per_s)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def _f16_stats(got: torch.Tensor, want: np.ndarray, what: str, row: dict) -> None:
    """A float16 output held by a docs/FIDELITY.md f16 row."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    d = np.abs(got.float().cpu().numpy() - want.astype(np.float32))
    stats = {"median": float(np.median(d)), "p99": float(np.percentile(d, 99)),
             "p999": float(np.percentile(d, 99.9)), "share": float((d > 1.0 / 255.0).mean())}
    print(f"  {what}: median {stats['median']:.3e} p99 {stats['p99']:.3e} p99.9 {stats['p999']:.3e} "
          f"share over 1/255 {stats['share']:.4f} max {d.max():.3e} (limits {row})")
    if any(stats[k] > v for k, v in row.items()):
        raise AssertionError(f"{what}: outside the docs/FIDELITY.md f16 row")


def _back_to_back_ms(fn, n: int = 10) -> float:
    """Device time per call of n calls queued back to back (host launch
    overhead hidden behind the queue), from one CUDA-event pair."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _wrappers() -> dict:
    """The kernel wrappers, each with its launch count."""
    from fsr_tpu_torch.kernels import easu_gather, fused, pad, probes
    from fsr_tpu_torch.kernels import rcas as rcas_k

    return {"K4": pad.edge_pad, "K1": fused.upscale_padded, "K2": easu_gather.easu_gather,
            "K3": rcas_k.rcas_fused, "P1": probes.opmix_replay, "P2": probes.opmix_replay_shared,
            "P3": probes.fma_rate, "P4": probes.fp16_probe}


def _drive(fn, need):
    """Run fn with every count at 0; fail unless each kernel in `need`
    launched exactly once (a dict: exactly need[k] times) and no other
    kernel launched.  Returns fn's result and the counts."""
    wrappers = _wrappers()
    want = need if isinstance(need, dict) else {k: 1 for k in need}
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {k: w.launches for k, w in wrappers.items()}
    if got != {k: want.get(k, 0) for k in wrappers}:
        raise AssertionError(f"launch counts {got}: the path must launch exactly {want}")
    return out, got


@contextlib.contextmanager
def _plain_kernels():
    """K1's (both entry points), K2's and K4's plain versions in place of
    their wrappers, so that a path runs on the card with the same inputs and
    no kernel."""
    from fsr_tpu_torch.kernels import easu_gather, fused, pad

    saved = pad.edge_pad, fused.upscale_padded, fused.upscale_fused, easu_gather.easu_gather
    pad.edge_pad = pad.edge_pad_reference
    fused.upscale_padded = fused.upscale_padded_reference
    fused.upscale_fused = fused.upscale_fused_reference
    easu_gather.easu_gather = easu_gather.easu_gather_reference
    try:
        yield
    finally:
        pad.edge_pad, fused.upscale_padded, fused.upscale_fused, easu_gather.easu_gather = saved


def _check_sharded(got, want, plain, epi, what) -> float:
    """A sharded output: bit-equal to the unsharded kernel output `want`,
    and within phase 12's limits of the plain versions' `plain` (RGBA's
    alpha bit-equal)."""
    if got.shape != want.shape or got.dtype != want.dtype or got.device != want.device:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} {got.device} vs "
                             f"{tuple(want.shape)} {want.dtype} {want.device}")
    if not torch.equal(got, want):
        off = int((got != want).sum())
        raise AssertionError(f"{what}: {off} values differ from the unsharded kernel output")
    if got.shape[-3] == 4:
        if not torch.equal(got[..., 3, :, :], plain[..., 3, :, :]):
            raise AssertionError(f"{what}: alpha not bit-equal to the plain version")
        got, plain = got[..., :3, :, :], plain[..., :3, :, :]
    return _compare_epilogue(got, plain, epi, what + " vs the plain versions")


def _row_sharded(dev, card: str, gen, trace: bool) -> list:
    """Phase 18: row-sharded (and dp x sp) execution through
    ``fsr_tpu_torch.parallel`` on meshes of the card repeated, and across
    cards where there are several; with ``trace``, a profiler trace of each
    full-width run.  Returns its entries of the kernels line."""
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import easu_gather, fused
    from fsr_tpu_torch.kernels.epilogue import Epilogue
    from fsr_tpu_torch.parallel import sharding, spatial
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, cuda_times_in_turn, device_trace

    f32, bf16, u8, u16 = torch.float32, torch.bfloat16, torch.uint8, torch.uint16
    cards = torch.cuda.device_count()
    print(f"phase 18: row-sharded execution (fsr_tpu_torch.parallel) on meshes of {dev} repeated; "
          + (f"across {cards} cards too" if cards > 1 else "one card: no run across cards"))

    def mesh(n, names=("sp",), shape=None):
        return sharding.make_mesh(n, names, shape, devices=[dev] * n)

    def src(kind, in_hw):
        x = torch.rand((2, 4 if kind.startswith("rgba") else 3, *in_hw), generator=gen, device=dev)
        return {"hdr": lambda: x * 16, "u8": lambda: (x * 255).to(u8),
                "rgba u8": lambda: (x * 255).to(u8)}.get(kind, lambda: x)()

    # Small sizes: every seam phase (2x, 4x, 1x columns; 1.3x/1.5x/1.7x
    # and a DRS offset on K2), the storage types, codes, the epilogue and
    # RGBA, each held bit-equal to the unsharded kernel output and within
    # phase 12's limits of the same sharded path on the plain versions.
    drs = dict(input_viewport=(92, 138), input_offset=(2, 3))
    options = [
        ("bf16", "float", dict(compute_dtype=bf16)),
        ("u8 ->u8", "u8", dict(out_dtype=u8)),
        ("f32 ->u16", "float", dict(out_dtype=u16)),
        ("RGBA", "rgba", {}),
        ("RGBA u8 ->u8", "rgba u8", dict(out_dtype=u8)),
        ("SRTM + srtm_inv", "hdr", dict(prologue="srtm", epilogue=Epilogue(transform="srtm_inv"))),
        ("gamma2 + grain + hash dither10", "float",
         dict(epilogue=Epilogue(transform="gamma2", grain_amount=0.3, dither_bits=10), frame=5)),
        ("grain + page dither8, u8 ->u8, bf16", "u8",
         dict(epilogue=Epilogue(grain_amount=0.25, dither_bits=8, dither_texture=True), out_dtype=u8,
              compute_dtype=bf16)),
        ("denoise", "float", dict(denoise=True, sharpness=0.5)),
        ("EASU only", "float", dict(apply_rcas=False)),
    ]
    k1_2x, k1_4x, k2_15 = ((96, 160), (192, 320)), ((48, 80), (192, 320)), ((144, 240), (216, 360))
    small = ([("K1 2x", *k1_2x, n, "float", {}) for n in (2, 4, 8)]
             + [("K1 4x", *k1_4x, n, "float", {}) for n in (2, 4, 8)]
             + [("K1 2x rows, 1x columns", (64, 128), (128, 128), 4, "float", {})]
             + [(f"K1 2x {name}", *k1_2x, 4, kind, kw) for name, kind, kw in options]
             + [("K2 1.5x", *k2_15, n, "float", {}) for n in (2, 3, 4)]
             + [("K2 1.3x", (120, 130), (156, 169), n, "float", {}) for n in (2, 3, 4)]
             + [("K2 ~1.7x", (84, 130), (144, 221), n, "float", {}) for n in (2, 3, 4)]
             + [("K2 DRS offset", (96, 144), (132, 192), n, "float", drs) for n in (2, 3, 4)]
             + [(f"K2 1.5x {name}", *k2_15, 4, kind, kw) for name, kind, kw in options])
    small_err = {"K1": 0.0, "K2": 0.0}
    for what, in_hw, out_hw, n, kind, kw in small:
        x = src(kind, in_hw)
        kw = dict(kw, grain=torch.rand((3, *out_hw), generator=gen, device=dev) - 0.5,
                  dither_page=torch.rand((24, 40), generator=gen, device=dev))
        kname = what[:2]
        need = {kname: n}
        got, _ = _drive(lambda: spatial.upscale_spatial_sharded(x, out_hw, mesh(n), **kw), need)
        want = ft.upscale(x, out_size=out_hw, impl="kernel", **kw)
        with _plain_kernels():
            plain = spatial.upscale_spatial_sharded(x, out_hw, mesh(n), **kw)
        torch.cuda.synchronize()
        label = f"{what}, sp={n}"
        err = _check_sharded(got, want, plain, kw.get("epilogue"), label)
        print(f"  {label}: launches {need}, bit-equal to the unsharded kernel output")
        if got.dtype == f32 and kw.get("epilogue") is None:
            small_err[kname] = max(small_err[kname], err)

    # Full width, batch 4, at the slice's sizes: 1080p (Performance 2x)
    # and 1440p (Quality 1.5x) to 4K.
    out4k = (2 * MAIN_SHAPE[2], 2 * MAIN_SHAPE[3])
    nframes = MAIN_SHAPE[0]
    frames = torch.rand(MAIN_SHAPE, generator=gen, device=dev)
    qframes = torch.rand(QUALITY_SHAPE, generator=gen, device=dev).to(bf16)
    hdr = frames * 16
    q8 = (qframes.float() * 255).to(u8)
    grain4k = torch.rand((3, *out4k), generator=gen, device=dev) - 0.5
    tex = torch.rand((2, 64, 64), generator=gen, device=dev)
    tail = dict(hdr_srtm=True, grain_amount=0.3, dither_bits=10, impl="kernel")
    disp = dict(grain_amount=0.25, dither_bits=8, out_dtype=u8, compute_dtype=bf16, dither_texture=tex,
                impl="kernel")
    pipe_a, pipe_b = ft.UpscalePipeline(out4k, **tail), ft.UpscalePipeline(out4k, **disp)
    pipes_a = ft.UpscalePipeline(out4k, mesh=mesh(4), **tail)
    pipes_b = ft.UpscalePipeline(out4k, mesh=mesh(4), **disp)
    dpsp = mesh(4, ("dp", "sp"), (2, 2))
    runs = [
        # name, sharded call, unsharded call, launches, sharded call on a mesh (None: no run across cards)
        ("(i) performance f32, sp=4", lambda: spatial.upscale_spatial_sharded(frames, out4k, mesh(4)),
         lambda: ft.upscale(frames, preset="performance", impl="kernel"), {"K1": 4},
         lambda m: spatial.upscale_spatial_sharded(frames, out4k, m)),
        ("(ii) quality bf16, sp=4",
         lambda: spatial.upscale_spatial_sharded(qframes, out4k, mesh(4), compute_dtype=bf16),
         lambda: ft.upscale(qframes, preset="quality", compute_dtype=bf16, impl="kernel"), {"K2": 4},
         lambda m: spatial.upscale_spatial_sharded(qframes, out4k, m, compute_dtype=bf16)),
        ("(iii) HDR tail (a), sp=4", lambda: pipes_a(hdr, grain=grain4k, frame=7),
         lambda: pipe_a(hdr, grain=grain4k, frame=7), {"K1": 4}, None),
        ("(iv) display (b) with a dither page, u8 ->u8, sp=4", lambda: pipes_b(q8, grain=grain4k, frame=7),
         lambda: pipe_b(q8, grain=grain4k, frame=7), {"K2": 4}, None),
        ("(v) performance f32, dp=2 x sp=2",
         lambda: spatial.upscale_spatial_sharded(frames, out4k, dpsp, axis="sp", batch_axis="dp"),
         lambda: ft.upscale(frames, preset="performance", impl="kernel"), {"K1": 4}, None),
    ]
    full = {}
    print(f"  full width, batch {nframes}, on {card}; mesh [{dev}] * 4:")
    for name, call, unsharded, need, _ in runs:
        out, got_n = _drive(call, need)
        want = unsharded()
        torch.cuda.synchronize()
        if out.shape != want.shape or out.dtype != want.dtype or out.device != want.device:
            raise AssertionError(f"{name}: {tuple(out.shape)} {out.dtype} vs {tuple(want.shape)} {want.dtype}")
        off = int((out != want).sum())
        if off:
            raise AssertionError(f"{name}: {off} values differ from the unsharded call")
        print(f"  {name}: out {tuple(out.shape)} {out.dtype}; launches {got_n}; bit-equal to the unsharded "
              f"call (0 of {out.numel()} values off)")
        full[name] = dict(launches=got_n, nbytes=_nbytes(out))
        del out, want
    # (i) and (ii) held against the same sharded call on the plain versions.
    for (name, call, *_), key in zip(runs[:2], ("K1", "K2")):
        out = call()
        with _plain_kernels():
            plain = call()
        torch.cuda.synchronize()
        err = _compare(out, plain, f"{name} vs the plain versions")
        if out.dtype == f32:
            small_err[key] = max(small_err[key], err)
        del out, plain

    # Times per 4K frame: each sharded call in turn with its unsharded twin.
    for name, call, unsharded, _, _ in runs:
        t = cuda_times_in_turn({"sharded": call, "unsharded": unsharded})
        full[name]["t"] = t
        print(f"    {name}: sharded {t['sharded'] / nframes:.4f} ms/frame, unsharded "
              f"{t['unsharded'] / nframes:.4f} ms/frame ({t['sharded'] / t['unsharded'] - 1:+.1%})")
        if trace:
            tr = device_trace(call, 5)
            print(f"      traced, 5 sharded calls back to back: device busy {tr['busy_ms']:.4f} ms of a "
                  f"{tr['window_ms']:.4f} ms window, idle share {tr['idle_share']:.4f}")
            for kname, ms in sorted(tr["kernels"].items(), key=lambda kv: -kv[1]):
                print(f"      {ms:.4f} ms/call ({ms / nframes:.4f} ms/frame) {kname[:100]}")

    # The strips' kernels alone, in turn with the unsharded kernel.
    (ph, pw), (qh, qw) = MAIN_SHAPE[2:], QUALITY_SHAPE[2:]
    pcon = EasuConstants.create((pw, ph), None, out4k[::-1])
    qcon = EasuConstants.create((qw, qh), None, out4k[::-1])
    rcon = RcasConstants(0.25)
    n, hl = 4, out4k[0] // 4
    strips = spatial._exchange_halo([frames[..., k * ph // n:(k + 1) * ph // n, :] for k in range(n)], spatial._HALO)
    lcon = spatial._local_constants(pcon, spatial._HALO)
    qstrips = spatial._exchange_halo([qframes[..., k * qh // n:(k + 1) * qh // n, :] for k in range(n)],
                                     spatial._GHALO)
    gplans = [easu_gather.shard_plan((qh, qw), out4k, qcon, n, k, spatial._GHALO) for k in range(n)]

    def k1_strips(fn=fused.upscale_fused):
        return [fn(s, (hl, out4k[1]), lcon, rcon, row_offset=k * hl, global_rows=out4k[0])
                for k, s in enumerate(strips)]

    def k2_strips(fn=easu_gather.easu_gather):
        return [fn(s, (hl, out4k[1]), qcon, rcon, True, False, bf16, row_plan=gplans[k], row_offset=k * hl)
                for k, s in enumerate(qstrips)]

    tk = cuda_times_in_turn({
        "K1 x4 strips": k1_strips, "K1 unsharded": lambda: fused.upscale_fused(frames, out4k, pcon, rcon),
        "K2 x4 strips": k2_strips,
        "K2 unsharded": lambda: easu_gather.easu_gather(qframes, out4k, qcon, rcon, True, False, bf16)}, **KQ)
    tk["K1 x4 strips, plain"] = cuda_time_ms(lambda: k1_strips(fused.upscale_fused_reference), warmup=1, iters=3)
    tk["K2 x4 strips, plain"] = cuda_time_ms(lambda: k2_strips(easu_gather.easu_gather_reference),
                                             warmup=1, iters=3)
    for k, v in tk.items():
        print(f"    {k:>20}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
    print("  sharded: one call on the mesh (strip copies, n launches of each kernel, the output gather); "
          "K* x4 strips: the strips' kernels alone, in turn with the unsharded kernel (3 rounds, median)")
    if cards > 1:
        nc = 4 if cards >= 4 else 2
        real = sharding.make_mesh(nc, ("sp",))
        print(f"  across {nc} cards ({', '.join(str(d) for d in real.devices.flat)}):")
        for name, _, unsharded, need, on in runs:
            if on is None:
                continue
            want_n = {k: nc for k in need}
            out, got_n = _drive(lambda: on(real), want_n)
            if not torch.equal(out, unsharded()):
                raise AssertionError(f"{name} across {nc} cards: differs from the unsharded call")
            t = cuda_times_in_turn({"across cards": lambda: on(real), "one card, sp=4": lambda: on(mesh(4)),
                                 "unsharded": unsharded})
            tr = device_trace(lambda: on(real), 5)
            print(f"    {name.replace('sp=4', f'sp={nc}')}: launches {got_n}, bit-equal to the unsharded call; "
                  + ", ".join(f"{k} {v / nframes:.4f} ms/frame" for k, v in t.items())
                  + f"; traced over 5 calls: busy {tr['busy_ms']:.4f} of {tr['window_ms']:.4f} ms, "
                  "per card " + ", ".join(f"{i}: {ms:.4f}" for i, ms in tr["busy_ms_by_device"].items()))
            for kname, ms in sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:8]:
                print(f"      {ms:.4f} ms/call, all cards: {kname[:100]}")
            del out

    npix = nframes * out4k[0] * out4k[1]
    k1_full, k2_full = full[runs[0][0]], full[runs[1][0]]
    return [
        _kernel_entry("upscale_fused (K1), row-sharded: performance f32, sp=4", "fsr_tpu_torch/csrc/fused.cu",
                      "fsr_tpu/kernels/fused.py:403", k1_full["launches"]["K1"], small_err["K1"],
                      tk["K1 x4 strips"], tk["K1 x4 strips, plain"], _nbytes(*strips) + k1_full["nbytes"],
                      EASU_RCAS_OPS * npix),
        _kernel_entry("easu_gather (K2), row-sharded: quality bf16, sp=4", "fsr_tpu_torch/csrc/easu_gather.cu",
                      "fsr_tpu/kernels/easu_gather.py:350", k2_full["launches"]["K2"], small_err["K2"],
                      tk["K2 x4 strips"], tk["K2 x4 strips, plain"], _nbytes(*qstrips) + k2_full["nbytes"],
                      EASU_RCAS_OPS * npix),
    ]


def _clocks() -> str:
    """The card's SM clock and its maximum, power draw and temperature."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _probes(dev, card: str) -> list:
    """Phase 19: the probes P1-P4 (kernels/probes.py) through their tools
    (tools_torch/ablation), held against their plain versions, then timed in
    turn with K1.  Returns their entries of the kernels line."""
    from fsr_tpu_torch.kernels import fused, probes
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, cuda_times_in_turn
    from tools_torch.ablation import fp16_probe, fused_roofline, opmix_floor

    f32, f16 = torch.float32, torch.float16
    print(f"phase 19: the probes P1-P4 on {card}")
    sharp = opmix_floor.SHARP
    image = opmix_floor.tiny_frame(dev)
    padded, fplan = opmix_floor.operand(image)
    tile = probes.TILE
    plain = {rcas: fused.upscale_padded_reference(padded, fplan, tile, sharp, rcas) for rcas in (True, False)}
    k1 = {rcas: fused.upscale_padded(padded, fplan, tile, sharp, rcas) for rcas in (True, False)}
    replays = [
        # name, wrapper key, RCAS, the tool's keywords
        ("P1", "P1", True, {}),
        ("P1 EASU only", "P1", False, {"rcas": False}),
        ("P2", "P2", True, {"shared": True}),
    ]
    err = {}

    def held(name, got, rcas, what):
        e = _compare(got, plain[rcas], f"{name} {what} vs upscale_padded_reference")
        d = (got - k1[rcas]).abs().max().item()
        print(f"  {name} {what} vs K1 on the same padded frame: max-abs {d:.3e} (limit {F32_TOL:g})"
              + (", bit-equal" if d == 0 else ""))
        if not d <= F32_TOL:
            raise AssertionError(f"{name} {what}: disagrees with K1")
        err[name] = max(err.get(name, 0.0), e)

    # Small grids, then the headline grid through the tool's path (K4 pads
    # the frame, one launch of the replay).
    for grid in ((1, 1, 1), (3, 2, 2)):
        for name, key, rcas, kw in replays:
            if key == "P2":
                fn = lambda: probes.opmix_replay_shared(padded, fplan, sharp, grid)
            else:
                fn = lambda: probes.opmix_replay(padded, fplan, sharp, rcas, grid)
            got, _ = _drive(fn, {key: 1})
            held(name, got, rcas, f"grid {grid}")
    runs = {}
    for name, key, rcas, kw in replays:
        got, n = _drive(lambda: opmix_floor.replay(image, **kw), {"K4": 1, key: 1})
        held(name, got, rcas, f"grid {probes.HEADLINE_GRID}, launches {n}")
        runs[name] = dict(launches=n[key], out=got)
    d = (runs["P2"]["out"] - runs["P1"]["out"]).abs().max().item()
    print(f"  P2 vs P1: max-abs {d:.3e}" + (", bit-equal" if d == 0 else ""))

    # P3: both types and chain counts at the reading size, against the plain
    # recurrence: float32 within P3_F32_REL relative (the kernel's FMAs round
    # once, the plain version's mul and add twice); half2 within P3_HALF2_REL
    # (two float16 steps: the plain version rounds each step once from
    # float32, which holds this block's products and sums, so bit-equality is
    # expected).
    x = fused_roofline.fma_input(dev)
    fma = {}
    for dt in (f32, f16):
        for chains in (4, 8):
            got, n = _drive(lambda: fused_roofline.fma_run(x, dt, chains), {"P3": 1})
            want = probes.fma_rate_reference(x, dt, chains)
            rel = ((got.float() - want.float()).abs() / want.float().abs()).max().item()
            limit = P3_F32_REL if dt == f32 else P3_HALF2_REL
            off = int((got != want).sum())
            print(f"  P3 {dt} x{chains} chains, {fused_roofline.fma_reps(dt, chains)} repeats: launches {n}; "
                  f"vs the plain recurrence max relative {rel:.3e} (limit {limit:g}), {off} of {got.numel()} differ")
            if not (torch.isfinite(got.float()).all() and rel <= limit):
                raise AssertionError(f"P3 {dt} x{chains}: disagrees with its plain version")
            fma[(dt, chains)] = dict(launches=n["P3"], err=rel)

    # P4: the three float16 modes, one launch each.
    h = fp16_probe.probe_input(dev)
    outs, n4 = _drive(lambda: [probes.fp16_probe(h, m) for m in range(3)], {"P4": 3})
    p4_err = 0.0
    for mode, got in enumerate(outs):
        a = fp16_probe.agreement(mode, got, probes.fp16_probe_reference(h, mode))
        print(f"  P4 mode {mode} ({probes.FP16_MODES[mode]}): {'runs and agrees' if a['ok'] else 'DISAGREES'}, "
              f"max-abs {a['max_abs']:.3e} (limit {a['limit']:.3e}), {a['off']} of {got.numel()} values differ")
        if not a["ok"]:
            raise AssertionError(f"P4 mode {mode}: disagrees with its plain version")
        p4_err = max(p4_err, a["max_abs"])

    # The readings, in turn with K1, with the card's clocks before and after.
    fns = opmix_floor.reading_fns(dev)
    for (dt, chains) in fma:
        fns[f"P3 {'f32' if dt == f32 else 'half2'} x{chains}"] = (
            lambda dt=dt, chains=chains: fused_roofline.fma_run(x, dt, chains))
    for mode in range(3):
        fns[f"P4 mode {mode}"] = lambda mode=mode: probes.fp16_probe(h, mode)
    before = _clocks()
    ms = cuda_times_in_turn(fns, 5)
    after = _clocks()
    print(f"  readings in turn (5 rounds, CUDA-event medians, ms per call); clocks.sm, clocks.max.sm, power.draw, "
          f"temperature before: {before}; after: {after}")
    for k, v in ms.items():
        print(f"    {k:>16}: {v:.4f} ms")
    for line in opmix_floor.report(ms):
        print("  " + line)
    best = {}
    for (dt, chains), r in fma.items():
        name = f"P3 {'f32' if dt == f32 else 'half2'} x{chains}"
        r["flops"] = fused_roofline.fma_flops(x, dt, chains)
        tf = r["flops"] / (ms[name] * 1e-3) / 1e12
        peak = fused_roofline.PEAK_TFLOPS[dt]
        print(f"  {name}: {tf:.2f} TFLOP/s ({tf / 2:.2f} T el-ops/s, FMA = 1), {tf / peak:.1%} of the data "
              f"sheet's {peak:g}")
        if dt not in best or tf > best[dt][1]:
            best[dt] = (chains, tf)

    ops = fused_roofline.ops_per_pixel()
    npix = opmix_floor.headline_pixels()
    for conv, c in ops.items():
        print(f"  ops per pixel, {conv}: " + ", ".join(f"{k} {v:g}" for k, v in c.items()))
    rate = best[f32][1] * 1e12
    for dt in ("f32", "bf16"):
        t = ms[f"K1 {dt}"] * 1e-3
        u2 = ops["convention 2"]["per_px"] * npix / rate / t
        u1 = ops["convention 1"]["per_px"] * npix / (rate / 2) / t
        print(f"  K1 {dt}: utilization at the achieved float32 rate {u2:.1%} (convention 2), "
              f"{u1:.1%} (convention 1, FMA = 1)")

    # Plain versions' times, and the kernels line's entries.
    plain_ms = {rcas: cuda_time_ms(lambda: fused.upscale_padded_reference(padded, fplan, tile, sharp, rcas),
                                   warmup=1, iters=5) for rcas in (True, False)}
    src, nb = "fsr_tpu_torch/csrc/probes.cu", _nbytes(padded) + _nbytes(plain[True])
    entries = [
        _kernel_entry("opmix_replay (P1): K1's math stream, no global tap loads", src,
                      "tools/ablation/opmix_floor.py:73", runs["P1"]["launches"], err["P1"], ms["P1"],
                      plain_ms[True], nb, opmix_floor.stream_ops("replay") * npix),
        _kernel_entry("opmix_replay (P1), EASU only", src, "tools/ablation/opmix_floor.py:73",
                      runs["P1 EASU only"]["launches"], err["P1 EASU only"], ms["P1 EASU only"], plain_ms[False], nb,
                      opmix_floor.stream_ops("replay easu_only") * npix),
        _kernel_entry("opmix_replay_shared (P2): the shared-dataflow floor", src,
                      "tools/ablation/opmix_floor.py:179", runs["P2"]["launches"], err["P2"], ms["P2"],
                      plain_ms[True], nb, opmix_floor.stream_ops("shared") * npix),
    ]
    for dt, what, rate in ((f32, "f32", F32_OPS_PER_S), (f16, "half2", HALF2_OPS_PER_S)):
        chains = best[dt][0]
        r = fma[(dt, chains)]
        entries.append(_kernel_entry(
            f"fma_rate (P3), {what}, {chains} chains", src, "tools/ablation/fused_roofline.py:108", r["launches"],
            r["err"], ms[f"P3 {what} x{chains}"],
            cuda_time_ms(lambda: probes.fma_rate_reference(x, dt, chains), warmup=1, iters=3),
            _nbytes(x) + x.numel() * (4 if dt == f32 else 2), r["flops"], ops_per_s=rate))
    p4_plain = sum(cuda_time_ms(lambda: probes.fp16_probe_reference(h, m)) for m in range(3))
    entries.append(_kernel_entry(
        "fp16_probe (P4): f16 load, f16 FMA chain, f16 store", src, "tools/ablation/fp16_probe.py:41",
        n4["P4"], p4_err, sum(ms[f"P4 mode {m}"] for m in range(3)), p4_plain,
        3 * _nbytes(h) + _nbytes(*outs), 0))
    return entries


def _autodiff(dev, card: str, trace: bool) -> None:
    """Phase 20: gradients on the card.  Each case runs its kernel forward
    (exactly one launch) and the torch twin's backward (no launch); the
    gradient is held against the torch path's (bit-equal under a linear
    loss, within the CPU tests' limits under a squared one) and, at 540p ->
    1080p, against the port's CPU gradient; then the training example's
    inverse problem takes 3 Adam steps at 1080p -> 4K.  With ``trace``, a
    profiler trace of one forward and backward of each case: the device's
    busy time, idle share and its largest kernels."""
    import fsr_tpu_torch as ft
    from examples_torch import train_through_fsr as trainer
    from fsr_tpu_torch.utils.profiling import device_trace

    f32, bf16 = torch.float32, torch.bfloat16
    wrappers = {k: w for k, w in _wrappers().items() if k in ("K1", "K2", "K3", "K4")}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k: w.launches for k, w in wrappers.items()}

    def grad(fn, x0, square, impl):
        x = x0.clone().requires_grad_()
        out = fn(x, impl).float()
        (out * out if square else out).sum().backward()
        return x.grad

    print(f"phase 20: autodiff on the card ({card}): kernel forward, torch twin backward, batch 1")
    gen = torch.Generator(device=dev).manual_seed(20)
    cases = [
        # name, input shape, dtype, the call, its kernel
        ("(i) performance f32 1080p->4K", (1, 3, 1080, 1920), f32,
         lambda x, impl: ft.upscale(x, preset="performance", impl=impl), "K1"),
        ("(ii) quality f32 1440p->4K", (1, 3, 1440, 2560), f32,
         lambda x, impl: ft.upscale(x, preset="quality", impl=impl), "K2"),
        ("(iii) sharpen f32 4K", (1, 3, 2160, 3840), f32, lambda x, impl: ft.sharpen(x, impl=impl), "K3"),
        ("(iv) performance bf16 1080p->4K", (1, 3, 1080, 1920), bf16,
         lambda x, impl: ft.upscale(x, preset="performance", compute_dtype=bf16, impl=impl), "K1"),
    ]
    for what, shape, dt, fn, kernel in cases:
        x0 = torch.rand(shape, generator=gen, device=dev).to(dt)
        grad(fn, x0, False, "kernel")  # warm-up
        torch.cuda.synchronize()
        fwd, bwd = [], []
        for _ in range(3):
            x = x0.clone().requires_grad_()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            reset()
            ev[0].record()
            loss = fn(x, "kernel").float().sum()
            ev[1].record()
            n_fwd = counts()
            reset()
            ev[2].record()
            loss.backward()
            ev[3].record()
            n_bwd = counts()
            fwd.append(ev[0].elapsed_time(ev[1]))
            bwd.append(ev[2].elapsed_time(ev[3]))
            want = {k: int(k == kernel) for k in wrappers}
            if n_fwd != want or any(n_bwd.values()):
                raise AssertionError(f"{what}: forward launches {n_fwd} (want {want}), backward {n_bwd} (want none)")
        peak = torch.cuda.max_memory_allocated()
        g_k = x.grad
        del x, loss
        g_t = grad(fn, x0, False, "torch")
        if not torch.isfinite(g_k).all() or not torch.equal(g_k, g_t):
            raise AssertionError(f"{what}: the kernel path's gradient is not the torch path's, bit for bit "
                                 f"({int((g_k != g_t).sum())} values differ)")
        del g_t
        gq_k, gq_t = grad(fn, x0, True, "kernel"), grad(fn, x0, True, "torch")
        scale = gq_t.abs().max().item()
        if dt == f32:
            ok = torch.allclose(gq_k, gq_t, rtol=GRAD_SQ_RTOL, atol=GRAD_SQ_ATOL)
            limits = f"rtol {GRAD_SQ_RTOL:g}, atol {GRAD_SQ_ATOL:g}"
            stats = f"max {(gq_k - gq_t).abs().max().item():.3e}"
        else:
            d = ((gq_k - gq_t).abs() / scale).flatten().float()
            d = d[:: d.numel() // (1 << 24) + 1]
            p99, med = torch.quantile(d, 0.99).item(), d.median().item()
            ok = p99 <= GRAD_BF16_SQ_P99 and med <= GRAD_BF16_SQ_MEDIAN
            limits = f"p99 {GRAD_BF16_SQ_P99:g}, median {GRAD_BF16_SQ_MEDIAN:g} of max|g|"
            stats = f"p99 {p99:.3e} median {med:.3e} of max|g|"
        print(f"  {what}: forward {statistics.median(fwd):.3f} ms ({kernel} x1), backward "
              f"{statistics.median(bwd):.3f} ms (no kernel), peak {peak / 2**30:.2f} GiB "
              f"({(peak - before) / 2**30:.2f} GiB above the {before / 2**30:.2f} GiB held before the call); "
              f"linear-loss gradient bit-equal to impl='torch'; squared loss {stats} (limits {limits}), "
              f"max|g| {scale:.3e}; {card}")
        if not ok or not torch.isfinite(gq_k).all():
            raise AssertionError(f"{what}: squared-loss gradient outside the CPU tests' limits")
        del gq_k, gq_t
        if trace:
            tr = device_trace(lambda: grad(fn, x0, False, "kernel"), 1)
            top = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:8]
            print(f"    traced forward + backward: busy {tr['busy_ms']:.3f} ms of {tr['window_ms']:.3f}, "
                  f"idle share {tr['idle_share']:.3f}; largest kernels (ms):")
            for name, ms in top:
                print(f"      {ms:9.3f}  {name[:110]}")
        del x0

    # The card's kernel-path gradient against the port's CPU gradient.
    img = np.random.default_rng(20).uniform(0, 1, (1, 3, 540, 960)).astype(np.float32)
    g_card = grad(lambda x, impl: ft.upscale(x, preset="performance", impl=impl), torch.from_numpy(img).to(dev),
                  False, "kernel").cpu()
    g_cpu = grad(lambda x, impl: ft.upscale(x, preset="performance", impl=impl), torch.from_numpy(img), False,
                 "torch")
    d, scale = (g_card - g_cpu).abs().max().item(), g_cpu.abs().max().item()
    print(f"  540p->1080p performance f32: card (K1 + twin) vs CPU (torch path) gradient max-abs {d:.3e}, "
          f"{d / scale:.3e} of max|g| {scale:.3e} (limit {GRAD_REL:g})")
    if not torch.isfinite(g_card).all() or d > GRAD_REL * scale:
        raise AssertionError("the card's gradient disagrees with the CPU's")

    # examples_torch/train_through_fsr.py's inverse problem at 1080p -> 4K.
    hi = torch.from_numpy(trainer.make_scene(np.random.default_rng(0), (2160, 3840))).to(dev)
    prob = trainer.Inverse(hi, lr=3e-3)
    mse = [prob.loss()]
    for step in range(3):
        reset()
        t0 = time.perf_counter()
        loss = prob.step()
        ms = (time.perf_counter() - t0) * 1e3
        n = counts()
        # The step's own forward is the same K1 call on the same render.
        if loss != mse[-1] or n != {k: int(k == "K1") for k in wrappers}:
            raise AssertionError(f"training step {step}: MSE {loss} (before it {mse[-1]}), launches {n}")
        mse.append(prob.loss())
        print(f"  training step {step}: displayed MSE {loss:.6e} -> {mse[-1]:.6e}, {ms:.1f} ms "
              f"(host clock, one K1 launch), {card}")
    print(f"  displayed MSE after 3 steps: {mse[-1] / mse[0]:.4f} of the box-downsample baseline's")
    if not mse[-1] < mse[0]:
        raise AssertionError(f"the displayed MSE did not fall over the 3 steps: {mse}")


def _app_layer(dev, card: str) -> None:
    """Phase 21: the application layer on the card, from seeded numpy data
    written to a temporary directory: the CLI (Performance with its
    benchmark, Quality bf16, the pipeline flags), the sample app's
    flythrough and HDR chain at 4K, the video, dataset and frame-graph
    examples, the quality study against its CPU run, and the native host
    layer against the numpy constants.  Each path's launches are counted
    (exactly its K1 or K2 launches, no K4) and its output held against the
    same call on the kernels' plain versions or the library call."""
    import io
    import os
    import re
    import tempfile

    import fsr_tpu_torch as ft
    from examples_torch import dataset_preprocessing, frame_graph, sample_app, video_upscale
    from fsr_tpu_torch import cli
    from fsr_tpu_torch.core import native
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels.epilogue import Epilogue
    from fsr_tpu_torch.parallel import sharding
    from fsr_tpu_torch.utils import image as im
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, device_trace
    from tools_torch import quality_study

    print(f"phase 21: the application layer on the card ({card})")
    rng = np.random.default_rng(21)
    out4k = (2160, 3840)
    parts = []  # (part, start time): the seconds each part takes

    def part(name):
        parts.append((name, time.perf_counter()))

    def run_cli(argv, need):
        """cli.main under _drive, its stderr echoed; returns the stderr."""
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            rc, got = _drive(lambda: cli.main(argv), need)
        text = buf.getvalue()
        for line in text.splitlines():
            print(f"    cli: {line}")
        if rc != 0:
            raise AssertionError(f"cli.main({argv}) returned {rc}")
        print(f"    launches {got}")
        return text

    def table(kernels, what):
        print(f"  {what}: device ms per call by kernel ({card}):")
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {ms:9.4f}  {name[:100]}")
        print(f"    {sum(kernels.values()):9.4f}  total, {len(kernels)} kernels")
        return sum(kernels.values())

    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        im.save_image(path("in1080.png"), rng.uniform(0, 1, (3, 1080, 1920)).astype(np.float32))
        im.save_image(path("in1440.png"), rng.uniform(0, 1, (3, 1440, 2560)).astype(np.float32))

        def cli_input(name):
            return torch.from_numpy(np.ascontiguousarray(im.load_image(path(name)))).to(dev)

        def png_codes(name):
            return im.to_uint8(im.load_image(path(name)))

        part("(i)")
        # (i) Performance, with the CLI's benchmark: one K1 per run() (the
        # output, the device reading's warm-up and queued calls, the wall
        # clock's calls), no K4.
        n = 5
        runs = 1 + cli.BENCH_WARMUP + n * cli.BENCH_QUEUE + n
        text = run_cli([path("in1080.png"), path("perf.png"), "--preset", "performance", "--benchmark", str(n),
                        "--results", path("perf.csv")], {"K1": runs})
        cli_ms = float(re.search(r"device ([0-9.]+) ms/frame", text).group(1))
        rows = open(path("perf.csv")).read().split()
        if rows[0] != "frame,ms" or len(rows) != n + 1:
            raise AssertionError(f"(i) the benchmark CSV: {rows}")
        x = cli_input("in1080.png")
        lib = ft.upscale(x, preset="performance")
        want = im.to_uint8(lib.cpu().numpy())
        got = png_codes("perf.png")
        print(f"  (i) cli --preset performance 1080p -> 4K f32: {runs} runs, {runs} K1 launches, no K4; PNG codes "
              f"{'equal' if np.array_equal(got, want) else 'DIFFER'} to upscale(x, preset='performance')'s")
        if got.shape != (3, *out4k) or not np.array_equal(got, want):
            raise AssertionError("(i) the CLI's output is not the library call's")
        lib_ms = cuda_time_ms(lambda: ft.upscale(x, preset="performance"), **KQ)
        print(f"  (i) device ms per frame: the CLI's {cli_ms:.4f}, the library call's {lib_ms:.4f} "
              f"(10 calls queued per sample), {card}")
        del x, lib

        part("(ii)")
        # (ii) Quality, bfloat16 storage: one K2.
        run_cli([path("in1440.png"), path("quality.png"), "--preset", "quality", "--dtype", "bfloat16"], {"K2": 1})
        x = cli_input("in1440.png")
        want = im.to_uint8(ft.upscale(x, preset="quality", compute_dtype=torch.bfloat16).float().cpu().numpy())
        got = png_codes("quality.png")
        print(f"  (ii) cli --preset quality --dtype bfloat16 1440p -> 4K: PNG codes "
              f"{'equal' if np.array_equal(got, want) else 'DIFFER'} to the library call's")
        if got.shape != (3, *out4k) or not np.array_equal(got, want):
            raise AssertionError("(ii) the CLI's output is not the library call's")
        del x

        part("(iii)")
        # (iii) The pipeline flags, against the same CLI call on the plain
        # kernels by phase 12's limits.  The reference's pipeline refuses
        # TEPD on HDR output (--hdr --dither-bits), and so does the port's:
        # the HDR tail and the dithered output are two calls.
        cases = [("hdr", ["--hdr", "--grain", "0.2"], Epilogue(transform="srtm_inv", grain_amount=0.2)),
                 ("dither10", ["--gamma2-out", "--grain", "0.2", "--dither-bits", "10"],
                  Epilogue(transform="gamma2", grain_amount=0.2, dither_bits=10))]
        for name, flags, epi in cases:
            argv = ["--preset", "performance", *flags, "--frame", "3"]
            run_cli([path("in1080.png"), path(f"{name}.npy"), *argv], {"K1": 1})
            with _plain_kernels():
                run_cli([path("in1080.png"), path(f"{name}_plain.npy"), *argv], {})
            got, want = (torch.from_numpy(np.load(path(f))) for f in (f"{name}.npy", f"{name}_plain.npy"))
            _compare_epilogue(got, want, epi, f"(iii) cli {' '.join(flags)} --frame 3 vs the plain kernels")
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                cli.main([path("in1080.png"), path("bad.npy"), "--hdr", "--dither-bits", "10"])
        except ValueError as e:
            print(f"  (iii) --hdr --dither-bits 10 refused, as by the reference: {e}")
        else:
            raise AssertionError("(iii) --hdr --dither-bits 10 ran; the reference refuses it")

        part("(iv)")
        # (iv) The sample app at 4K, Quality (render 2560x1440, K2): a
        # 5-frame flythrough with its CSV and two screenshots, one K2 per
        # frame; a frame against the plain kernels and its kernel table; the
        # HDR chain against the plain kernels.
        over = {"globals": {"width": out4k[1], "height": out4k[0], "preset": "quality"},
                "scenes": [{"BenchmarkSettings": {"fps": 2, "warmUpFrames": 1, "resultsFilename": path("bench.csv"),
                                                  "screenShotName": path("shot")}}]}
        cfg = sample_app.merge_config(sample_app.DEFAULT_CONFIG, over)
        bench = cfg["scenes"][0]["BenchmarkSettings"]
        app = sample_app.SampleApp(cfg)
        if app.render_hw != (1440, 2560) or app.device.type != "cuda":
            raise AssertionError(f"(iv) render {app.render_hw} on {app.device}")
        rows, got = _drive(lambda: sample_app.run_benchmark(app, bench), {"K2": 1 + 5})
        shots = [r["screenshot"] for r in rows if "screenshot" in r]
        if len(rows) != 5 or shots != ["shot_0.png", "shot_1.png"] or not all(
                os.path.exists(path(s)) for s in shots) or len(open(path("bench.csv")).read().split()) != 6:
            raise AssertionError(f"(iv) the flythrough: {rows}")
        print(f"  (iv) sample app, quality 2560x1440 -> 3840x2160: {len(rows)} frames + 1 warm-up, launches {got}; "
              f"wall ms per frame (host clock, synchronised) {[r['ms'] for r in rows]}, median "
              f"{statistics.median(r['ms'] for r in rows):.3f}, {card}")
        cam = sample_app.camera_at(bench["keyFrames"], 1.0)
        for hdr in (False, True):
            if hdr:
                app = sample_app.SampleApp(sample_app.merge_config(cfg, {"globals": {"hdr": True}}))
            out, _ = _drive(lambda: app.render_frame(cam, 1.0, 3), {"K2": 1})
            with _plain_kernels():
                want = app.render_frame(cam, 1.0, 3)
            what = "HDR chain (TEPD10 tonemap, gamma2 out)" if hdr else "frame"
            _compare(out, want, f"(iv) sample app {what} vs the plain kernels")
            if out.shape != (3, *out4k) or (hdr and not 0.0 <= out.min().item() <= out.max().item() <= 1.0):
                raise AssertionError(f"(iv) {what}: {tuple(out.shape)}, range {out.min().item()}..{out.max().item()}")
            if not hdr:
                # app.profile's trace, read in full: its kernel table, the
                # device operations per frame and the device's idle share.
                tr = device_trace(lambda: app.render_frame(cam, 0.0, 3))
                kernels = tr["kernels"]
                if set(app.profile(cam, 3)) != set(kernels):
                    raise AssertionError("(iv) app.profile's kernels are not the trace's")
                total = table(kernels, f"(iv) sample app {what}, traced (5 frames)")
                k2 = sum(ms for name, ms in kernels.items() if "gather_kernel" in name)
                print(f"  (iv) K2 {k2:.4f} of the frame's {total:.4f} device ms ({k2 / total:.1%}); the scene "
                      f"stand-in and the tonemap (torch ops) the rest")
                print(f"  (iv) traced frame: {tr['ops_per_call']:g} device operations per frame, window "
                      f"{tr['window_ms'] / 5:.4f} ms per frame (host clock), busy {tr['busy_ms'] / 5:.4f}, "
                      f"idle share {tr['idle_share']:.4f}, {card}")
        del app, out, want

        part("(v)")
        # (v) Video: 16 frames 1080p -> 4K in batches of 8, one K1 per batch.
        clip = video_upscale.synthetic_clip(16, (1080, 1920))
        up = video_upscale.VideoUpscaler(out4k, dev)
        up.run(clip[:8], 8)  # warm-up at the timed batch, the copy back included
        t0 = time.perf_counter()
        video, got = _drive(lambda: up.run(clip, 8), {"K1": 2})
        dt = time.perf_counter() - t0
        with _plain_kernels():
            want = up.process(torch.from_numpy(clip[:8]).to(dev), 0)
        _compare_steps(torch.from_numpy(video[:8]).to(dev), want, 8,
                       "(v) video's first batch (8 frames) vs the plain kernels")
        if video.shape != (16, 3, *out4k) or not np.isfinite(video).all():
            raise AssertionError(f"(v) video {video.shape}")
        print(f"  (v) video 16 frames 1080p -> 4K, batches of 8: launches {got}, {dt:.3f} s, {16 / dt:.1f} frames/s "
              f"(host clock, the clip's copies both ways included), {card}")
        del clip, video, want

        part("(vi)")
        # (vi) Dataset: batches of 4 u8 frames per card, 1080p -> 4K u8 with
        # TEPD, on make_mesh(): one K1 per card per batch.
        n_cards = torch.cuda.device_count()
        dataset_preprocessing.run(1, 4, (1080, 1920), out4k)  # warm-up at the timed batch
        (outs, dt, n_dev), got = _drive(lambda: dataset_preprocessing.run(4, 4, (1080, 1920), out4k),
                                        {"K1": 4 * n_cards})
        mesh = sharding.make_mesh()
        batch0 = torch.from_numpy(next(dataset_preprocessing.synthetic_corpus(1, 4 * n_dev, (1080, 1920))))
        with _plain_kernels():
            want = dataset_preprocessing.preprocess(batch0, 0, out4k, mesh)
        _compare_steps(outs[0], want, 8, "(vi) dataset batch 0 vs the plain kernels")
        total = sum(o.shape[0] for o in outs)
        print(f"  (vi) dataset {total} u8 frames 1080p -> 4K u8 on {n_dev} card(s): launches {got}, {dt:.3f} s, "
              f"{total / dt:.1f} frames/s (host clock, host transfer and the corpus's generation included), {card}")
        del outs, want, batch0

        part("(vii)")
        # (vii) The frame graph at 1080p -> 4K: one K1; its kernel table.
        scene = torch.from_numpy(frame_graph.render_scene((1080, 1920), 7)).to(dev)
        out, got = _drive(lambda: frame_graph.frame_tail(scene, out4k), {"K1": 1})
        with _plain_kernels():
            want = frame_graph.frame_tail(scene, out4k)
        _compare(out, want, "(vii) frame graph tail vs the plain kernels")
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = frame_graph.main(["--render", "1080", "1920", "--display", *map(str, out4k), "--out-dir", tmp])
        print("\n".join(f"    frame_graph: {line}" for line in buf.getvalue().splitlines()))
        if rc != 0 or not os.path.exists(path("frame_graph_display.png")):
            raise AssertionError(f"(vii) frame_graph.main returned {rc}")
        del scene, out, want

        part("(viii)")
        # (viii) The quality study: on the card (2x at 512x512: K1) within
        # 0.01 dB of the same study on the CPU.
        card_rows, got = _drive(lambda: quality_study.study(dev), {"K1": 6})
        cpu_rows = quality_study.study(torch.device("cpu"))
        worst = max(abs(a - b) for r, c in zip(card_rows, cpu_rows) for a, b in zip(r[1:], c[1:]))
        for r, c in zip(card_rows, cpu_rows):
            print(f"  (viii) {r[0]:10s} bilinear / EASU / EASU+RCAS dB: card {r[1]:.4f} / {r[2]:.4f} / {r[3]:.4f}, "
                  f"CPU {c[1]:.4f} / {c[2]:.4f} / {c[3]:.4f}")
        print(f"  (viii) launches {got}; largest difference {worst:.2e} dB (limit 0.01)")
        if worst > 0.01:
            raise AssertionError("(viii) the card's quality study disagrees with the CPU's")

    part("(ix)")
    # (ix) The native host layer, built with cc, bit-equal to the numpy
    # constants (tests/test_native.py's configurations).
    if native.load() is None:
        raise AssertionError("(ix) the native host layer did not build: no cc")
    configs = [(960, 540, 960, 540, 1920, 1080), (1920, 1080, 1920, 1080, 3840, 2160),
               (2954, 1662, 2954, 1662, 3840, 2160), (1280, 720, 1920, 1080, 2560, 1440)]
    for vw, vh, iw, ih, ow, oh in configs:
        if not np.array_equal(native.easu_con((vw, vh), (iw, ih), (ow, oh)),
                              EasuConstants.create((vw, vh), (iw, ih), (ow, oh)).as_uint4()):
            raise AssertionError(f"(ix) native easu_con differs at {(vw, vh, iw, ih, ow, oh)}")
    if not np.array_equal(native.easu_con((1280, 720), (1920, 1080), (2560, 1440), (64.0, 32.0)),
                          EasuConstants.create((1280, 720), (1920, 1080), (2560, 1440), (64, 32)).as_uint4()):
        raise AssertionError("(ix) native easu_con with an offset differs")
    for s in (0.0, 0.125, 0.25, 0.5, 1.0, 2.0):
        if not np.array_equal(native.rcas_con(s), RcasConstants(s).as_uint4()):
            raise AssertionError(f"(ix) native rcas_con differs at {s}")
    print(f"  (ix) native host layer {native.library_path().parent.name}: the {len(configs)} configurations, "
          "the offset and 6 sharpness values bit-equal to the numpy constants")
    part("end")
    print("  phase 21 seconds per part: " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(parts, parts[1:])))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", action="store_true",
                        help="add phases 11 and 14 and phase 16's, 18's and 20's traces: torch.profiler "
                             "traces of the main paths")
    args = parser.parse_args()
    trace = args.trace
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import _build, easu_gather, fused, pad
    from fsr_tpu_torch.kernels import rcas as rcas_k
    from fsr_tpu_torch.reference import scalar as ref
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, cuda_times_in_turn, device_trace

    dev = torch.device("cuda:0")
    laps = []  # (phase, start time): the seconds each phase takes

    def lap(phase):
        laps.append((phase, time.perf_counter()))

    # --- 1. the card -------------------------------------------------------
    lap("1")
    card = _card()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # --- 2. build ------------------------------------------------------------
    lap("2")
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2: built {_build.build_dir().name} in {time.perf_counter() - t0:.1f} s")
    entries, spills, entry = 0, [], None
    for line in (_build.build_dir() / "build.log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
        if "Compiling entry" in line:
            entry, entries = line.split("'")[1], entries + 1
        elif "spill stores" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill stores"):
            spills.append(f"{entry}: {line.strip()}")
    print(f"  ptxas: {entries} kernel instantiations, {len(spills)} with a stack frame or spills")
    for line in spills:
        print("    " + line)

    rng = np.random.default_rng(0)

    def rand(shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)

    # --- 3. K4 -------------------------------------------------------------
    lap("3")
    print("phase 3: K4 edge_pad vs edge_pad_reference (bit-equal) and vs F.pad(mode='replicate')")
    k4_err = 0.0
    f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8
    main_con = EasuConstants.create((1920, 1080), None, (3840, 2160))
    main_plan = fused.plan(MAIN_SHAPE[-2:], (2160, 3840), main_con)
    # A K1 row strip's pads (phase 18's 4 strips of the Performance frame).
    from fsr_tpu_torch.parallel import spatial
    strip_pads = fused.plan((MAIN_SHAPE[2] // 4 + 2 * spatial._HALO, MAIN_SHAPE[3]), (540, 3840),
                            spatial._local_constants(main_con, spatial._HALO)).pads
    pairs = ((f32, f32), (f32, bf16), (bf16, f32), (bf16, bf16), (u8, u8))
    k4_cases = [((2, 3, 67, 131), (3, 5, 2, 7)), ((1, 3, 1, 1), (5, 7, 9, 20)), ((3, 1, 1), (2, 0, 0, 40)),
                ((2, 4, 9, 23), (1, 2, 3, 4)), ((1, 4, 270 + 2 * spatial._HALO, 480), strip_pads)]
    # Output rows of every length modulo each vector (4 float32, 8 bfloat16,
    # 16 uint8 elements), so that row starts take every 16-byte residue and
    # the source shift every value; 3 and 4 planes.
    k4_cases += [((2, 3 + r % 2, 5, 32 + r - r % 5 - r % 3), (1, 2, r % 5, r % 3)) for r in range(16)]
    checks = 0
    pad.edge_pad.launches = 0  # K4's launches in the kernels line: this phase's
    for shape, pads in [(MAIN_SHAPE, main_plan.pads)] + k4_cases:
        x32 = rand(shape)
        srcs = {f32: x32, bf16: x32.to(bf16), u8: (x32 * 255).to(u8)}
        for sdt, dt in pairs:
            src = srcs[sdt]
            got = pad.edge_pad(src, pads, dt)
            want = pad.edge_pad_reference(src, pads, dt)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K4 {shape} {sdt}->{dt} pads {pads}: not bit-equal")
            if sdt == dt:  # F.pad pads without converting
                pt, pb, pl, pr = pads
                fp = torch.nn.functional.pad(src.unsqueeze(0) if src.dim() == 3 else src, (pl, pr, pt, pb),
                                             mode="replicate")
                if not torch.equal(fp.reshape(got.shape), got):
                    raise AssertionError(f"K4 {shape} {dt} pads {pads}: differs from F.pad")
            k4_err = max(k4_err, (got.float() - want.float()).abs().max().item())
            checks += 1
        print(f"  {tuple(shape)} pads {pads}: bit-equal")
    k4_launches = pad.edge_pad.launches
    print(f"  {checks} pads ({len(k4_cases) + 1} shapes x {', '.join(f'{a}->{b}' for a, b in pairs)}) bit-equal "
          f"to the plain version; the same-type pads also to F.pad; {k4_launches} K4 launches")

    # --- 4. K1 -------------------------------------------------------------
    lap("4")
    print("phase 4: K1 upscale_fused vs upscale_fused_reference")

    def con_for(in_hw, out_hw):
        return EasuConstants.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))

    k1_err = 0.0
    cases = [
        ("2x ragged", (1, 3, 67, 131), (134, 262), torch.float32, True, False, 0.25),
        ("2x 540p", (1, 3, 540, 960), (1080, 1920), torch.float32, True, False, 0.25),
        ("2x 540p bf16", (1, 3, 540, 960), (1080, 1920), torch.bfloat16, True, False, 0.25),
        ("2x 540p easu-only", (1, 3, 540, 960), (1080, 1920), torch.float32, False, False, 0.25),
        ("2x 540p denoise", (1, 3, 540, 960), (1080, 1920), torch.float32, True, True, 0.5),
        ("2x 540p bf16 denoise", (1, 3, 540, 960), (1080, 1920), torch.bfloat16, True, True, 0.5),
        ("2x batch 2", (2, 3, 270, 480), (540, 960), torch.float32, True, False, 0.25),
        ("4x", (1, 3, 135, 240), (540, 960), torch.float32, True, False, 0.25),
        ("2x rows 1x cols", (1, 3, 64, 128), (128, 128), torch.float32, True, False, 0.25),
    ]
    quads = 0

    def paths_agree(x, out_hw, con, rcon, rcas, denoise, dt, got, what):
        """The generic staged path bit-equal to ``got`` (the quad path where
        the plan takes it), and K1 on the K4-padded frame bit-equal too."""
        nonlocal quads
        fplan = fused.plan(tuple(x.shape[-2:]), out_hw, con)
        gen_ = fused.upscale_fused(x, out_hw, con, rcon, rcas, denoise, dt, path="generic")
        padded = pad.edge_pad(x, fplan.pads, dt)
        sharp_ = float(rcon.sharpness)
        on_padded = fused.upscale_padded(padded, fplan, out_hw, sharp_, rcas, denoise)
        torch.cuda.synchronize()
        quad = fused.quad_ok(fused.source_plan(fplan))
        if not torch.equal(gen_, got):
            raise AssertionError(f"{what}: the generic staged path differs from the "
                                 f"{'quad' if quad else 'generic'} path in {int((gen_ != got).sum())} values")
        if not torch.equal(on_padded, got):
            raise AssertionError(f"{what}: K1 on the K4-padded frame differs from K1 on the image")
        quads += quad
        print(f"  {what}: {'quad path bit-equal to the generic staged path' if quad else 'generic path'}; "
              "bit-equal to K1 on the K4-padded frame")

    for what, shape, out_hw, dt, rcas, denoise, stops in cases:
        x = rand(shape)
        con, rcon = con_for(shape[-2:], out_hw), RcasConstants(stops)
        got = fused.upscale_fused(x, out_hw, con, rcon, rcas, denoise, dt)
        want = fused.upscale_fused_reference(x, out_hw, con, rcon, rcas, denoise, dt)
        torch.cuda.synchronize()
        err = _compare(got, want, what)
        paths_agree(x.to(dt), out_hw, con, rcon, rcas, denoise, dt, got, what)
        if dt == torch.float32:
            k1_err = max(k1_err, err)

    # Hazard cases: isolated bright pixel (RCAS NaN-drop branch), DRS offset
    # constant, all-black frame (direction zero-protect).
    bright = torch.zeros((3, 32, 130), device=dev)
    bright[:, 16, 60] = 0.5
    black = torch.zeros((3, 64, 128), device=dev)
    drs = rand((3, 67, 131))
    hazards = [
        ("isolated bright pixel", bright, (64, 260), con_for((32, 130), (64, 260)), 0.0),
        ("all-black frame", black, (128, 256), con_for((64, 128), (128, 256)), 0.25),
        ("DRS input_offset", drs, (120, 256),
         EasuConstants.create((128, 60), (131, 67), (256, 120), (2, 3)), 0.25),
    ]
    for what, x, out_hw, con, stops in hazards:
        rcon = RcasConstants(stops)
        got = fused.upscale_fused(x, out_hw, con, rcon, True, False, torch.float32)
        want = fused.upscale_fused_reference(x, out_hw, con, rcon, True, False, torch.float32)
        torch.cuda.synchronize()
        k1_err = max(k1_err, _compare(got, want, what))
        paths_agree(x, out_hw, con, rcon, True, False, torch.float32, got, what)
    if quads < 8:
        raise AssertionError(f"only {quads} phase-4 cases took the quad path")

    # --- 5. oracle ---------------------------------------------------------
    lap("5")
    img = rng.uniform(0, 1, (3, 540, 960)).astype(np.float32)
    con = con_for((540, 960), (1080, 1920))
    oracle = ref.rcas_ref(ref.easu_ref(img, (1080, 1920), con), RcasConstants(0.25))
    x = torch.from_numpy(img).to(dev)
    out = ft.upscale(x, preset="performance")
    dev_oracle = np.abs(out.cpu().numpy() - oracle).max()
    print(f"phase 5: upscale(preset='performance') vs numpy oracle, 540p->1080p f32: "
          f"max-abs {dev_oracle:.3e} (limit {ORACLE_TOL:g})")
    if not dev_oracle <= ORACLE_TOL:
        raise AssertionError("port disagrees with the oracle")
    outb = ft.upscale(x.to(torch.bfloat16), preset="performance", compute_dtype=torch.bfloat16)
    db = np.abs(outb.float().cpu().numpy() - oracle)
    print(f"  bf16 storage vs oracle: median {np.median(db):.3e} p99 {np.percentile(db, 99):.3e} "
          f"max {db.max():.3e}")

    # --- 6. main path --------------------------------------------------------
    lap("6")
    drive = _drive
    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.rand(MAIN_SHAPE, generator=gen, device=dev)
    nframes = MAIN_SHAPE[0]
    out_shape = MAIN_SHAPE[:-2] + (2160, 3840)
    launches = {"K1": 0, "K2": 0, "K3": 0}
    con = EasuConstants.create((1920, 1080), None, (3840, 2160))
    rcon = RcasConstants(0.25)
    print(f"phase 6: main path upscale(x, preset='performance') on {MAIN_SHAPE}")
    for dt in (torch.float32, torch.bfloat16):
        x = frames.to(dt)
        out, n = drive(lambda: ft.upscale(x, preset="performance", compute_dtype=dt), ("K1",))
        if tuple(out.shape) != out_shape or out.dtype != dt or out.device != x.device:
            raise AssertionError(f"main path {dt}: got {tuple(out.shape)} {out.dtype} {out.device}")
        launches["K1"] += n["K1"]
        print(f"  {dt}: out {tuple(out.shape)}; launches {n}")
        # The batch and the 4K tile grid held against the plain version.
        want = fused.upscale_fused_reference(x, (2160, 3840), con, rcon, True, False, dt)
        err = _compare(out, want, f"main path {dt} vs upscale_fused_reference")
        if dt == torch.float32:
            k1_err = max(k1_err, err)
        del want

    timings = {}
    for dt in (torch.float32, torch.bfloat16):
        x = frames.to(dt)
        t = {
            "call": cuda_time_ms(lambda: ft.upscale(x, preset="performance", compute_dtype=dt)),
            "call_b2b": _back_to_back_ms(lambda: ft.upscale(x, preset="performance", compute_dtype=dt)),
            "call_plain": cuda_time_ms(
                lambda: fused.upscale_fused_reference(x, (2160, 3840), con, rcon, True, False, dt),
                warmup=1, iters=5),
            "K4": cuda_time_ms(lambda: pad.edge_pad(x, main_plan.pads, dt), **KQ),
            "K4_plain": cuda_time_ms(lambda: pad.edge_pad_reference(x, main_plan.pads, dt)),
            "K1": cuda_time_ms(lambda: fused.upscale_fused(x, (2160, 3840), con, rcon, True, False, dt), **KQ),
            "K1 generic path": cuda_time_ms(
                lambda: fused.upscale_fused(x, (2160, 3840), con, rcon, True, False, dt, path="generic"), **KQ),
        }
        if dt == torch.float32:
            # The one PyTorch call that computes K4's function (timed, never
            # called by the port): F.pad takes (left, right, top, bottom).
            pt, pb, pl, pr = main_plan.pads
            t["K4_library"] = cuda_time_ms(
                lambda: torch.nn.functional.pad(x, (pl, pr, pt, pb), mode="replicate"), **KQ)
            padded = pad.edge_pad(x, main_plan.pads, dt)
            if not torch.equal(torch.nn.functional.pad(x, (pl, pr, pt, pb), mode="replicate"), padded):
                raise AssertionError("F.pad(mode='replicate') does not compute K4's function")
            main_bytes = {"K4": _nbytes(x, padded), "K1": _nbytes(x) * 5}
            del padded
        timings[dt] = t
        print(f"  times {dt}, median CUDA-event ms per 4K frame (batch {nframes}) on {card}:")
        for k, v in t.items():
            print(f"    {k:>10}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
    t32 = timings[torch.float32]
    print("  call: median latency of one call (host work included); call_b2b: per call with "
          "10 calls queued back to back; call_plain: K1's plain version (K4's and K1's); K1: the "
          "kernel alone (the quad path), 10 calls queued per sample, K1 generic path: the same on its "
          "generic staged path; K4: "
          "the pad alone, not on this path; *_plain: plain torch versions on the card")
    print(f"  f32 output rate: {nframes * 2160 * 3840 / (t32['call'] * 1e-3) / 1e6:.1f} Mpix/s; "
          f"bf16: {nframes * 2160 * 3840 / (timings[torch.bfloat16]['call'] * 1e-3) / 1e6:.1f} Mpix/s")

    # --- 7. K2 ------------------------------------------------------------
    lap("7")
    print("phase 7: K2 easu_gather vs easu_gather_reference")
    k2_err = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    gather_cases = [
        # what, input shape, out_hw, storage, rcas, denoise, stops, (viewport, offset)
        ("ultra_quality 1.3x", (1, 3, 831, 1477), (1080, 1920), f32, True, False, 0.25, None),
        ("quality 1.5x", (1, 3, 720, 1280), (1080, 1920), f32, True, False, 0.25, None),
        ("balanced 1.7x", (1, 3, 635, 1129), (1080, 1920), f32, True, False, 0.25, None),
        ("native 1x", (1, 3, 540, 960), (540, 960), f32, True, False, 0.25, None),
        ("ragged ~1.7x", (1, 3, 64, 114), (108, 192), f32, True, False, 0.25, None),
        ("2x odd width", (1, 3, 270, 480), (540, 961), f32, True, False, 0.25, None),
        ("DRS 1.5x offset", (1, 3, 400, 700), (540, 960), f32, True, False, 0.25, ((360, 640), (8, 16))),
        ("quality bf16", (1, 3, 720, 1280), (1080, 1920), bf16, True, False, 0.25, None),
        ("quality easu-only", (1, 3, 720, 1280), (1080, 1920), f32, False, False, 0.25, None),
        ("quality denoise", (1, 3, 720, 1280), (1080, 1920), f32, True, True, 0.5, None),
        ("quality bf16 denoise", (1, 3, 720, 1280), (1080, 1920), bf16, True, True, 0.5, None),
        ("batch 2", (2, 3, 360, 640), (540, 960), f32, True, False, 0.25, None),
    ]
    for what, shape, out_hw, dt, rcas_on, denoise, stops, drs in gather_cases:
        x = rand(shape)
        if drs is None:
            con = con_for(shape[-2:], out_hw)
        else:
            (vh, vw), (oy, ox) = drs
            con = EasuConstants.create((vw, vh), (shape[-1], shape[-2]), (out_hw[1], out_hw[0]), (ox, oy))
        rcon = RcasConstants(stops)
        got = easu_gather.easu_gather(x, out_hw, con, rcon, rcas_on, denoise, dt)
        want = easu_gather.easu_gather_reference(x, out_hw, con, rcon, rcas_on, denoise, dt)
        torch.cuda.synchronize()
        err = _compare(got, want, what)
        if dt == torch.float32:
            k2_err = max(k2_err, err)
    gbright = torch.zeros((3, 32, 130), device=dev)
    gbright[:, 16, 60] = 0.5
    for what, x, out_hw, stops in (
        ("isolated bright pixel", gbright, (48, 195), 0.0),
        ("all-black frame", torch.zeros((3, 64, 128), device=dev), (96, 192), 0.25),
    ):
        con, rcon = con_for(x.shape[-2:], out_hw), RcasConstants(stops)
        got = easu_gather.easu_gather(x, out_hw, con, rcon, True)
        want = easu_gather.easu_gather_reference(x, out_hw, con, rcon, True)
        torch.cuda.synchronize()
        k2_err = max(k2_err, _compare(got, want, what))

    # --- 8. K3 ------------------------------------------------------------
    lap("8")
    print("phase 8: K3 rcas_fused vs rcas_fused_reference")
    k3_err = 0.0
    rbright = torch.zeros((3, 40, 130), device=dev)
    rbright[:, 20, 60] = 0.5
    rcas_cases = [
        # what, image, storage, border, denoise, stops
        ("clamp 1080p", rand((1, 3, 1080, 1920)), f32, "clamp", False, 0.25),
        ("zero 1080p", rand((1, 3, 1080, 1920)), f32, "zero", False, 0.25),
        ("denoise 1080p", rand((1, 3, 1080, 1920)), f32, "clamp", True, 0.5),
        ("zero denoise ragged", rand((2, 3, 67, 131)), f32, "zero", True, 0.5),
        ("bf16 1080p", rand((1, 3, 1080, 1920)), bf16, "clamp", False, 0.25),
        ("bf16 zero denoise", rand((1, 3, 1080, 1920)).to(bf16), bf16, "zero", True, 0.5),
        ("isolated pixel", rbright, f32, "clamp", False, 0.0),
        ("ragged 67x131", rand((3, 67, 131)), f32, "clamp", False, 0.25),
    ]
    for what, x, dt, border, denoise, stops in rcas_cases:
        rcon = RcasConstants(stops)
        got = rcas_k.rcas_fused(x, rcon, denoise, dt, border)
        want = rcas_k.rcas_fused_reference(x, rcon, denoise, dt, border)
        torch.cuda.synchronize()
        err = _compare(got, want, what)
        if dt == torch.float32:
            k3_err = max(k3_err, err)
    # K3 stages and stores 16-byte vectors: every storage type at widths of
    # every residue of its vector (ragged rows, two tiles wide, two tiles
    # high), and from a row start one element past an aligned address.
    f16 = torch.float16
    ragged = 0
    for tname, sdt, dt in (("f32", f32, f32), ("bf16", bf16, bf16), ("f16", f16, f16), ("u8", u8, None),
                           ("f32 under bf16", f32, bf16), ("bf16 under f16", bf16, f16)):
        vec = 16 // torch.empty((), dtype=dt or sdt).element_size()
        shapes = [((1, 3, 20, 129 + r), r) for r in range(vec)] + [((2, 3, 20, 256), None)]
        for shape, r in shapes:
            x = rand(shape)
            x = (x * 255).to(u8) if sdt == u8 else x.to(sdt)
            if r is None:  # the same values one element into their storage
                buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
                buf[1:] = x.flatten()
                x = buf[1:].view(shape)
                if x.data_ptr() % 16 == 0:
                    raise AssertionError("the shifted view is aligned")
            border, denoise = ("zero", True) if (r or 0) % 2 else ("clamp", False)
            rcon = RcasConstants(0.25)
            got = rcas_k.rcas_fused(x, rcon, denoise, dt, border)
            want = rcas_k.rcas_fused_reference(x, rcon, denoise, dt, border)
            torch.cuda.synchronize()
            what = f"K3 {tname} {tuple(shape)} {border} denoise={denoise}" + (", unaligned start" if r is None else "")
            if sdt == u8:
                if not torch.equal(got, want):
                    raise AssertionError(f"{what}: not bit-equal")
            else:
                err = _compare(got, want, what)
                if got.dtype == f32:
                    k3_err = max(k3_err, err)
            ragged += 1
    print(f"  {ragged} ragged and unaligned K3 calls within their limits (uint8 bit-equal)")

    # --- 9. oracle: Quality and sharpen ---------------------------------------
    lap("9")
    img = rng.uniform(0, 1, (3, 720, 1280)).astype(np.float32)
    oracle = ref.rcas_ref(ref.easu_ref(img, (1080, 1920), con_for((720, 1280), (1080, 1920))),
                          RcasConstants(0.25))
    out = ft.upscale(torch.from_numpy(img).to(dev), preset="quality")
    dq = np.abs(out.cpu().numpy() - oracle).max()
    print(f"phase 9: upscale(preset='quality') vs numpy oracle, 720p->1080p f32: "
          f"max-abs {dq:.3e} (limit {ORACLE_TOL:g})")
    img = rng.uniform(0, 1, (3, 1080, 1920)).astype(np.float32)
    oracle = ref.rcas_ref(img, RcasConstants(0.25))
    out = ft.sharpen(torch.from_numpy(img).to(dev))
    ds = np.abs(out.cpu().numpy() - oracle).max()
    print(f"  sharpen vs numpy oracle, 1080p f32: max-abs {ds:.3e} (limit {ORACLE_TOL:g})")
    if not (dq <= ORACLE_TOL and ds <= ORACLE_TOL):
        raise AssertionError("port disagrees with the oracle")
    del oracle, img

    # --- 10. the Quality path and sharpen -------------------------------------
    lap("10")
    qframes = torch.rand(QUALITY_SHAPE, generator=gen, device=dev)
    sframes = torch.rand(SHARPEN_SHAPE, generator=gen, device=dev)
    qcon = EasuConstants.create((2560, 1440), None, (3840, 2160))
    rcon = RcasConstants(0.25)  # upscale's and sharpen's default sharpness
    print(f"phase 10: Quality path upscale(x, preset='quality') on {QUALITY_SHAPE}, "
          f"sharpen(y) on {SHARPEN_SHAPE}")
    for dt in (torch.float32, torch.bfloat16):
        x = qframes.to(dt)
        out, n = drive(lambda: ft.upscale(x, preset="quality", compute_dtype=dt), ("K2",))
        if tuple(out.shape) != QUALITY_SHAPE[:-2] + (2160, 3840) or out.dtype != dt:
            raise AssertionError(f"quality path {dt}: got {tuple(out.shape)} {out.dtype}")
        launches["K2"] += n["K2"]
        print(f"  quality {dt}: out {tuple(out.shape)}; launches {n}")
        want = easu_gather.easu_gather_reference(x, (2160, 3840), qcon, rcon, True, False, dt)
        err = _compare(out, want, f"quality path {dt} vs easu_gather_reference")
        if dt == torch.float32:
            k2_err = max(k2_err, err)
        del want
        y = sframes.to(dt)
        out, n = drive(lambda: ft.sharpen(y), ("K3",))
        if tuple(out.shape) != SHARPEN_SHAPE or out.dtype != dt:
            raise AssertionError(f"sharpen {dt}: got {tuple(out.shape)} {out.dtype}")
        launches["K3"] += n["K3"]
        print(f"  sharpen {dt}: out {tuple(out.shape)}; launches {n}")
        want = rcas_k.rcas_fused_reference(y, rcon)
        err = _compare(out, want, f"sharpen {dt} vs rcas_fused_reference")
        if dt == torch.float32:
            k3_err = max(k3_err, err)
        del want

    qtimings = {}
    for dt in (torch.float32, torch.bfloat16):
        x = qframes.to(dt)
        y = sframes.to(dt)
        t = {
            "call": cuda_time_ms(lambda: ft.upscale(x, preset="quality", compute_dtype=dt)),
            "call_b2b": _back_to_back_ms(lambda: ft.upscale(x, preset="quality", compute_dtype=dt)),
            "K2": cuda_time_ms(lambda: easu_gather.easu_gather(x, (2160, 3840), qcon, rcon, True, False, dt), **KQ),
            "K2_plain": cuda_time_ms(
                lambda: easu_gather.easu_gather_reference(x, (2160, 3840), qcon, rcon, True, False, dt),
                warmup=1, iters=5),
            "sharpen_call": cuda_time_ms(lambda: ft.sharpen(y)),
            "sharpen_b2b": _back_to_back_ms(lambda: ft.sharpen(y)),
            "K3": cuda_time_ms(lambda: rcas_k.rcas_fused(y, rcon), **KQ),
            "K3_plain": cuda_time_ms(lambda: rcas_k.rcas_fused_reference(y, rcon), warmup=1, iters=5),
        }
        qtimings[dt] = t
        print(f"  times {dt}, median CUDA-event ms per 4K frame (batch {nframes}) on {card}:")
        for k, v in t.items():
            print(f"    {k:>12}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
    print("  call: one upscale(preset='quality') call (host work included); call_b2b: per call "
          "with 10 calls queued back to back; sharpen_*: the same for sharpen; K2, K3: the "
          "kernels alone, 10 calls queued per sample; *_plain: their plain torch versions on the card")

    # --- 11. trace (--trace only) ---------------------------------------------
    lap("11")
    if trace:
        print(f"phase 11: torch.profiler traces on {card}")
        paths = (
            ("performance", frames, lambda x, dt: ft.upscale(x, preset="performance", compute_dtype=dt)),
            ("quality", qframes, lambda x, dt: ft.upscale(x, preset="quality", compute_dtype=dt)),
            ("sharpen", sframes, lambda x, dt: ft.sharpen(x)),
        )
        for name, src, fn in paths:
            for dt in (torch.float32, torch.bfloat16):
                x = src.to(dt)
                for calls in (1, 5):
                    tr = device_trace(lambda: fn(x, dt), calls)
                    print(f"  {name} {dt}, {calls} call(s) back to back: device busy "
                          f"{tr['busy_ms']:.4f} ms of a {tr['window_ms']:.4f} ms window, "
                          f"idle share {tr['idle_share']:.4f}")
                    for kname, ms in sorted(tr["kernels"].items(), key=lambda kv: -kv[1]):
                        print(f"    {ms:.4f} ms/call ({ms / nframes:.4f} ms/frame) {kname}")

    # --- 12. the prologue, the epilogue and byte I/O ---------------------------
    lap("12")
    from fsr_tpu_torch.kernels import epilogue as epilogue_mod
    from fsr_tpu_torch.kernels.epilogue import Epilogue

    u8, u16 = torch.uint8, torch.uint16
    rcon = RcasConstants(0.25)
    print("phase 12: K1 and K2 with the SRTM prologue, the K5 epilogue and byte I/O vs their plain versions")
    epilogues = [
        ("no epilogue", None),
        ("gamma2", Epilogue(transform="gamma2")),
        ("srtm_inv", Epilogue(transform="srtm_inv")),
        ("grain", Epilogue(grain_amount=0.3)),
        ("dither10", Epilogue(dither_bits=10)),
        ("gamma2+grain+dither8", Epilogue(transform="gamma2", grain_amount=0.25, dither_bits=8)),
        ("page dither8", Epilogue(dither_bits=8, dither_texture=True)),
    ]
    io_cases = [
        # what, source, storage, out dtype, prologue
        ("f32", "float", f32, None, "none"),
        ("HDR srtm f32", "hdr", f32, None, "srtm"),
        ("bf16", "float", bf16, None, "none"),
        ("u8 bf16 ->u8", "u8", bf16, u8, "none"),
        ("u8 f32 ->u16", "u8", f32, u16, "none"),
        ("HDR srtm bf16 ->u16", "hdr", bf16, u16, "srtm"),
    ]
    page = torch.rand((96, 160), generator=gen, device=dev)  # any page shape tiles the output
    epi_err = {"K1": 0.0, "K2": 0.0}
    for kname, fn, ref_fn, in_hw in (("K1", fused.upscale_fused, fused.upscale_fused_reference, (540, 960)),
                                     ("K2", easu_gather.easu_gather, easu_gather.easu_gather_reference,
                                      (720, 1280))):
        out_hw = (1080, 1920)
        con = con_for(in_hw, out_hw)
        x = rand((1, 3, *in_hw))
        srcs = {"float": x, "hdr": x * 16, "u8": (x * 255).to(u8)}
        grain = rand((3, *out_hw)) - 0.5
        for ename, epi in epilogues:
            for iname, src, dt, od, pro in io_cases:
                if epi is not None and epi.dither_bits == 10 and od == u8:
                    continue  # uint8 cannot hold 10-bit codes
                kw = dict(epilogue=epi, frame=7, grain=grain, dither_page=page, prologue=pro, out_dtype=od)
                got = fn(srcs[src], out_hw, con, rcon, True, False, dt, **kw)
                want = ref_fn(srcs[src], out_hw, con, rcon, True, False, dt, **kw)
                torch.cuda.synchronize()
                err = _compare_epilogue(got, want, epi, f"{kname} {ename}, {iname}")
                if got.dtype == f32 and (epi is None or epi.dither_bits is None):
                    epi_err[kname] = max(epi_err[kname], err)
    y8 = (rand((2, 3, 1080, 1920)) * 255).to(u8)
    for border in ("clamp", "zero"):
        for denoise in (False, True):
            got = rcas_k.rcas_fused(y8, rcon, denoise, None, border)
            want = rcas_k.rcas_fused_reference(y8, rcon, denoise, None, border)
            torch.cuda.synchronize()
            if got.dtype != u8 or not torch.equal(got, want):
                raise AssertionError(f"K3 uint8 {border} denoise={denoise}: not bit-equal")
            print(f"  K3 uint8 {border} denoise={denoise}: bit-equal")
    for pads in (main_plan.pads, (3, 5, 2, 7)):
        got, want = pad.edge_pad(y8, pads, u8), pad.edge_pad_reference(y8, pads, u8)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K4 uint8 pads {pads}: not bit-equal")
        print(f"  K4 uint8 pads {pads}: bit-equal")

    # --- 13. the README's pipeline paths -------------------------------------
    lap("13")
    out4k = (2160, 3840)
    pcon = EasuConstants.create((1920, 1080), None, (3840, 2160))
    hdr = torch.rand(MAIN_SHAPE, generator=gen, device=dev) * 16
    grain4k = torch.rand((3, *out4k), generator=gen, device=dev) - 0.5
    q8 = (qframes * 255).to(u8)
    m8 = (frames * 255).to(u8)
    s8 = (sframes * 255).to(u8)
    epi_a = Epilogue(grain_amount=0.3, dither_bits=10)
    epi_b = Epilogue(grain_amount=0.25, dither_bits=8)
    pipe_a = ft.UpscalePipeline(out4k, hdr_srtm=True, grain_amount=0.3, dither_bits=10)
    pipe_b = ft.UpscalePipeline(out4k, grain_amount=0.25, dither_bits=8, out_dtype=u8, compute_dtype=bf16)
    torch_a = ft.UpscalePipeline(out4k, hdr_srtm=True, grain_amount=0.3, dither_bits=10, impl="torch")
    torch_b = ft.UpscalePipeline(out4k, grain_amount=0.25, dither_bits=8, out_dtype=u8,
                                 compute_dtype=bf16, impl="torch")
    paths = [
        # name, call, kernels it launches, plain version, plain-torch pipeline, torch-path step,
        # epilogue, {timed kernel and its plain version}, {the same upscale without the epilogue}
        ("(a) HDR frame tail, f32 1080p -> 4K", lambda: pipe_a(hdr, grain=grain4k, frame=7), ("K1",),
         lambda: fused.upscale_fused_reference(hdr, out4k, pcon, rcon, epilogue=epi_a, frame=7, grain=grain4k,
                                               prologue="srtm"),
         lambda: torch_a(hdr, grain=grain4k, frame=7), 1.01 / 1023.0, epi_a,
         {"K1": lambda: fused.upscale_fused(hdr, out4k, pcon, rcon, epilogue=epi_a, frame=7, grain=grain4k,
                                            prologue="srtm"),
          "K1_plain": lambda: fused.upscale_fused_reference(hdr, out4k, pcon, rcon, epilogue=epi_a, frame=7,
                                                            grain=grain4k, prologue="srtm"),
          "K1 SRTM prologue only": lambda: fused.upscale_fused(hdr, out4k, pcon, rcon, prologue="srtm"),
          "K1 grain + TEPD epilogue only": lambda: fused.upscale_fused(hdr, out4k, pcon, rcon, epilogue=epi_a,
                                                                       frame=7, grain=grain4k),
          "K1 neither": lambda: fused.upscale_fused(hdr, out4k, pcon, rcon)},
         {"upscale, no prologue or epilogue": lambda: ft.upscale(hdr, out_size=out4k)}),
        ("(b) display, u8 1440p -> 4K u8, bf16", lambda: pipe_b(q8, grain=grain4k, frame=7), ("K2",),
         lambda: easu_gather.easu_gather_reference(q8, out4k, qcon, rcon, True, False, bf16, epilogue=epi_b,
                                                   frame=7, grain=grain4k, out_dtype=u8),
         lambda: torch_b(q8, grain=grain4k, frame=7), None, epi_b,
         {"K2": lambda: easu_gather.easu_gather(q8, out4k, qcon, rcon, True, False, bf16, epilogue=epi_b,
                                                frame=7, grain=grain4k, out_dtype=u8)},
         {"upscale u8 -> bf16, no epilogue": lambda: ft.upscale(q8, out_size=out4k, compute_dtype=bf16),
          "upscale bf16 -> bf16 (phase 10's path)": lambda: ft.upscale(qframes.to(bf16), out_size=out4k,
                                                                         compute_dtype=bf16)}),
        ("(c) byte video, u8 1080p -> 4K u8", lambda: ft.upscale(m8, scale=2.0, out_dtype=u8), ("K1",),
         lambda: fused.upscale_fused_reference(m8, out4k, pcon, rcon, out_dtype=u8),
         lambda: ft.upscale(m8, scale=2.0, out_dtype=u8, impl="torch"), 1.0, None,
         {"K1": lambda: fused.upscale_fused(m8, out4k, pcon, rcon, out_dtype=u8),
          "K1_plain": lambda: fused.upscale_fused_reference(m8, out4k, pcon, rcon, out_dtype=u8)},
         {"upscale f32 -> f32 (phase 6's path)": lambda: ft.upscale(frames, out_size=out4k)}),
        ("sharpen u8 4K", lambda: ft.sharpen(s8), ("K3",), lambda: rcas_k.rcas_fused_reference(s8, rcon),
         lambda: ft.sharpen(s8, impl="torch"), 1.0, None,
         {"K3": lambda: rcas_k.rcas_fused(s8, rcon),
          "K3_plain": lambda: rcas_k.rcas_fused_reference(s8, rcon)},
         {"sharpen f32 (phase 10's path)": lambda: ft.sharpen(sframes)}),
    ]
    print(f"phase 13: the README pipeline paths on batches of {nframes}, on {card}")
    path_runs = {}
    for name, call, need, plain, plain_torch, step, epi, kernel_fns, bare_fns in paths:
        out, n = drive(call, need)
        print(f"  {name}: out {tuple(out.shape)} {out.dtype}; launches {n}")
        err = _compare_epilogue(out, plain(), epi, f"{name} vs the kernels' plain versions")
        _compare_torch_path(out, plain_torch(), name, step)
        t = {"call": cuda_time_ms(call), "call_b2b": _back_to_back_ms(call)}
        for k, f_ in kernel_fns.items():
            t[k] = cuda_time_ms(f_, warmup=1, iters=5) if k.endswith("_plain") else cuda_time_ms(f_, **KQ)
        t["plain"] = cuda_time_ms(plain, warmup=1, iters=3)
        t["plain-torch pipeline"] = cuda_time_ms(plain_torch, warmup=1, iters=3)
        for k, f_ in bare_fns.items():
            t[k] = cuda_time_ms(f_)
        path_runs[name] = dict(launches=n, err=err, t=t)
        for k, v in t.items():
            print(f"    {k:>40}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
        del out
    print("  call: median latency of one call (host work included); call_b2b: per call with 10 calls "
          "queued back to back; K*: the kernel alone, 10 calls queued per sample; plain: the kernels' "
          "plain versions; the rest: "
          "the same upscale without the prologue and epilogue, for the epilogue's cost")

    # --- 14. trace of the pipeline paths (--trace only) -------------------------
    lap("14")
    if trace:
        print(f"phase 14: torch.profiler traces of the pipeline paths on {card}")
        for name, call, kinds in ((paths[0][0], paths[0][1], ("fused_kernel",)),
                                  (paths[1][0], paths[1][1], ("gather_kernel",))):
            for calls in (1, 5):
                tr = device_trace(call, calls)
                print(f"  {name}, {calls} call(s) back to back: device busy {tr['busy_ms']:.4f} ms of a "
                      f"{tr['window_ms']:.4f} ms window, idle share {tr['idle_share']:.4f}")
                for kname, ms in sorted(tr["kernels"].items(), key=lambda kv: -kv[1]):
                    print(f"    {ms:.4f} ms/call ({ms / nframes:.4f} ms/frame) {kname}")
                extra = [k for k in tr["kernels"] if not any(kind in k for kind in kinds)]
                if extra:
                    raise AssertionError(f"{name}: the trace shows more than {kinds}: {extra}")

    # --- 15. RGBA on K1 and K2 -----------------------------------------------
    lap("15")
    print("phase 15: K1 and K2 on RGBA vs their plain versions and the 3-channel call of the same kernel")
    epi_tail = Epilogue(grain_amount=0.3, dither_bits=10)
    epi_disp = Epilogue(grain_amount=0.25, dither_bits=8)
    rgba_cases = [
        # what, source kind, storage, out dtype, rcas, denoise, prologue, epilogue
        ("f32", "float", f32, None, True, False, "none", None),
        ("f32 EASU only", "float", f32, None, False, False, "none", None),
        ("f32 denoise", "float", f32, None, True, True, "none", None),
        ("bf16", "float", bf16, None, True, False, "none", None),
        ("u8 ->u8", "u8", f32, u8, True, False, "none", None),
        ("u8 ->u16", "u8", f32, u16, True, False, "none", None),
        ("HDR srtm f32", "hdr", f32, None, True, False, "srtm", None),
        ("HDR tail: srtm, grain, dither10", "hdr", f32, None, True, False, "srtm", epi_tail),
        ("display: u8, grain, dither8, bf16 ->u8", "u8", bf16, u8, True, False, "none", epi_disp),
    ]
    k1_fns = (fused.upscale_fused, fused.upscale_fused_reference)
    k2_fns = (easu_gather.easu_gather, easu_gather.easu_gather_reference)
    rgba_geoms = [
        # kernel, (wrapper, plain version), input (h, w), output (h, w), constants, cases
        ("K1", k1_fns, (270, 480), (540, 960), con_for((270, 480), (540, 960)), rgba_cases),
        ("K2", k2_fns, (360, 640), (540, 960), con_for((360, 640), (540, 960)), rgba_cases),
        ("K2 DRS offset", k2_fns, (400, 700), (540, 960),
         EasuConstants.create((640, 360), (700, 400), (960, 540), (16, 8)), rgba_cases[:1]),
        ("K2 ragged ~1.7x", k2_fns, (64, 114), (108, 192), con_for((64, 114), (108, 192)), rgba_cases[:1]),
    ]
    rgba_err = {"K1": 0.0, "K2": 0.0}
    for kname, (fn, ref_fn), in_hw, out_hw, con, cases in rgba_geoms:
        x = rand((1, 3, *in_hw))
        a = rand((1, 1, *in_hw))
        srcs = {"float": torch.cat([x, a], 1), "hdr": torch.cat([x * 16, a], 1),
                "u8": (torch.cat([x, a], 1) * 255).to(u8)}
        grain = rand((3, *out_hw)) - 0.5
        for what, src, dt, od, rcas_on, denoise, pro, epi in cases:
            x4 = srcs[src]
            kw = dict(epilogue=epi, frame=7, grain=grain, prologue=pro, out_dtype=od)
            got = fn(x4, out_hw, con, rcon, rcas_on, denoise, dt, **kw)
            got3 = fn(x4[:, :3].contiguous(), out_hw, con, rcon, rcas_on, denoise, dt, **kw)
            want = ref_fn(x4, out_hw, con, rcon, rcas_on, denoise, dt, **kw)
            torch.cuda.synchronize()
            label = f"{kname} RGBA {what}"
            if got.shape != want.shape or got.shape[1] != 4:
                raise AssertionError(f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
            if not torch.equal(got[:, :3], got3):
                raise AssertionError(f"{label}: RGB differs from the 3-channel call")
            if not torch.equal(got[:, 3], want[:, 3]):
                raise AssertionError(f"{label}: alpha not bit-equal to the plain version")
            err = _compare_epilogue(got[:, :3], want[:, :3], epi, f"{label}, RGB")
            print(f"  {label}: RGB bit-equal to the 3-channel call, alpha bit-equal to the plain version")
            if got.dtype == f32 and epi is None:
                rgba_err[kname[:2]] = max(rgba_err[kname[:2]], err)

    # --- 16. the RGBA paths at full width -------------------------------------
    lap("16")
    rgba_frames = torch.cat([frames, torch.rand(MAIN_SHAPE[:1] + (1,) + MAIN_SHAPE[2:], generator=gen,
                                                device=dev)], 1)
    rgba_q = torch.cat([qframes, torch.rand(QUALITY_SHAPE[:1] + (1,) + QUALITY_SHAPE[2:], generator=gen,
                                            device=dev)], 1).to(bf16)
    rgba8 = (rgba_frames * 255).to(u8)
    print(f"phase 16: the RGBA paths on batches of {nframes}, on {card}")
    rgba_paths = [
        # name, image, upscale kwargs, kernels, plain version, constants
        ("(d) performance f32", rgba_frames, dict(preset="performance"), ("K1",),
         lambda x: fused.upscale_fused_reference(x, out4k, pcon, rcon)),
        ("(d) performance u8 ->u8", rgba8, dict(preset="performance", out_dtype=u8), ("K1",),
         lambda x: fused.upscale_fused_reference(x, out4k, pcon, rcon, out_dtype=u8)),
        ("(e) quality bf16", rgba_q, dict(preset="quality", compute_dtype=bf16), ("K2",),
         lambda x: easu_gather.easu_gather_reference(x, out4k, qcon, rcon, True, False, bf16)),
    ]
    rgba_runs = {}
    for name, x4, kw, need, plain in rgba_paths:
        out, n = drive(lambda: ft.upscale(x4, **kw), need)
        if tuple(out.shape) != (nframes, 4) + out4k or out.dtype != kw.get("out_dtype", x4.dtype):
            raise AssertionError(f"{name}: got {tuple(out.shape)} {out.dtype}")
        print(f"  {name}: out {tuple(out.shape)} {out.dtype}; launches {n}")
        out_bytes = _nbytes(out)
        want = plain(x4)
        if not torch.equal(out[:, 3], want[:, 3]):
            raise AssertionError(f"{name}: alpha not bit-equal to the plain version")
        if out.dtype == u8:
            err = _compare_steps(out[:, :3], want[:, :3], None, f"{name} vs the plain version, RGB")
        else:
            err = _compare(out[:, :3], want[:, :3], f"{name} vs the plain version, RGB")
        del want
        x3 = x4[:, :3].contiguous()
        if not torch.equal(out[:, :3], ft.upscale(x3, **kw)):
            raise AssertionError(f"{name}: RGB differs from the same call on the RGB slice")
        print(f"  {name}: alpha bit-equal to the plain version, RGB bit-equal to the call on the RGB slice")
        del out
        # Each RGBA time is taken in turn with its RGB-slice twin, so that
        # alpha's cost is read under the same clocks and card state.
        t = cuda_times_in_turn({"call": lambda: ft.upscale(x4, **kw),
                             "call on the RGB slice": lambda: ft.upscale(x3, **kw)})
        od = kw.get("out_dtype")
        if "K1" in need:
            t.update(cuda_times_in_turn({
                "K1": lambda: fused.upscale_fused(x4, out4k, pcon, rcon, out_dtype=od),
                "K1 RGB": lambda: fused.upscale_fused(x3, out4k, pcon, rcon, out_dtype=od)}, **KQ))
            t["K1_plain"] = cuda_time_ms(lambda: plain(x4), warmup=1, iters=3)
            nbytes = _nbytes(x4) + out_bytes
        else:
            q16 = qframes.to(bf16)  # phase 10's frames, beside the RGB slice of the RGBA frames
            t.update(cuda_times_in_turn({
                "K2": lambda: easu_gather.easu_gather(x4, out4k, qcon, rcon, True, False, bf16),
                "K2 RGB": lambda: easu_gather.easu_gather(x3, out4k, qcon, rcon, True, False, bf16),
                "K2 phase 10": lambda: easu_gather.easu_gather(q16, out4k, qcon, rcon, True, False, bf16)}, **KQ))
            del q16
            t["K2_plain"] = cuda_time_ms(lambda: plain(x4), warmup=1, iters=3)
            nbytes = _nbytes(x4) + out_bytes
        rgba_runs[name] = dict(launches=n, err=err, t=t, nbytes=nbytes)
        for k, v in t.items():
            print(f"    {k:>22}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
        print("    alpha's cost: " + ", ".join(
            f"{k} {t[k] / t[k + ' RGB'] - 1:+.1%}" for k in ("K4", "K1", "K2") if k in t))
    print("  call: median latency of one upscale call; K*: the kernel alone on the RGBA frames, 10 calls "
          "queued per sample; "
          "* RGB: the same on the RGB slice, for alpha's cost (the two taken in turn, 3 rounds, "
          "median); K*_plain: the plain version")
    if trace:
        kinds_of = {"K1": "fused_kernel", "K2": "gather_kernel"}
        for name, x4, kw, need, _ in rgba_paths:
            kinds = tuple(kinds_of[k] for k in need)
            for what, x in (("RGBA", x4), ("the RGB slice", x4[:, :3].contiguous())):
                tr = device_trace(lambda: ft.upscale(x, **kw), 5)
                print(f"  trace {name} on {what}, 5 calls back to back: device busy {tr['busy_ms']:.4f} ms "
                      f"of a {tr['window_ms']:.4f} ms window, idle share {tr['idle_share']:.4f}")
                for kname, ms in sorted(tr["kernels"].items(), key=lambda kv: -kv[1]):
                    print(f"    {ms:.4f} ms/call ({ms / nframes:.4f} ms/frame) {kname}")
                extra = [k for k in tr["kernels"] if not any(kind in k for kind in kinds)]
                if extra:
                    raise AssertionError(f"{name}: the trace shows more than {kinds}: {extra}")

    # --- 17. float16 ------------------------------------------------------------
    lap("17")
    from fsr_tpu_torch.ops import easu as easu_ops
    from fsr_tpu_torch.ops import rcas as rcas_ops

    f16 = torch.float16
    print("phase 17: float16 (the torch path for upscale, K3 for sharpen)")
    img = rng.uniform(0, 1, (3, 540, 960)).astype(np.float32)
    con = con_for((540, 960), (1080, 1920))
    x16 = torch.from_numpy(img).to(dev).half()
    oracle32 = ref.easu_ref(img, (1080, 1920), con)
    out, _ = drive(lambda: ft.upscale(x16, preset="performance", compute_dtype=f16, apply_rcas=False), ())
    if out.dtype != f16 or tuple(out.shape) != (3, 1080, 1920):
        raise AssertionError(f"float16 upscale: got {tuple(out.shape)} {out.dtype}")
    _f16_stats(out, oracle32, "upscale f16 mixed EASU 540p->1080p vs the f32 oracle", F16_MIXED)
    out, _ = drive(lambda: ft.upscale(x16, preset="performance", compute_dtype=f16), ())
    full32 = ref.rcas_ref(oracle32, RcasConstants(0.25))
    _f16_stats(out, full32, "upscale f16 mixed EASU+RCAS vs the f32 oracle",
               {k: v for k, v in F16_MIXED.items() if k != "median"})
    e16 = easu_ops.easu(x16, (1080, 1920), con, compute_dtype=f16, precision="strict")
    strict = rcas_ops.rcas(e16, RcasConstants(0.25))
    oracle16 = ref.easu_ref_f16(img, (1080, 1920), con)
    _f16_stats(e16, oracle16, "ops.easu f16 strict 540p->1080p vs the f16 oracle", F16_STRICT)
    _f16_stats(strict, ref.rcas_ref(oracle16, RcasConstants(0.25), dtype=np.float16),
               "ops.easu strict + ops.rcas f16 vs the f16 oracle", F16_STRICT)
    del oracle32, full32, oracle16, e16, strict, img

    y16 = sframes.half()
    out, n = drive(lambda: ft.sharpen(y16), ("K3",))
    if out.dtype != f16 or tuple(out.shape) != SHARPEN_SHAPE:
        raise AssertionError(f"sharpen f16: got {tuple(out.shape)} {out.dtype}")
    want = rcas_k.rcas_fused_reference(y16, rcon)
    d = (out.float() - want.float()).abs()
    k3_f16 = dict(launches=n["K3"], err=d.max().item(), off=int((d > 0).sum()))
    print(f"  sharpen f16 4K: launches {n}; vs rcas_fused_reference max-abs {k3_f16['err']:.3e} "
          f"(limit one half step, {F16_ULP:g}), {k3_f16['off']} of {d.numel()} values differ")
    if not torch.isfinite(out).all() or k3_f16["err"] > F16_ULP:
        raise AssertionError("sharpen f16: K3 disagrees with its plain version")
    del out, want, d
    y_bf16 = sframes.to(bf16)
    k3_f16["t"] = {
        "sharpen_call": cuda_time_ms(lambda: ft.sharpen(y16)),
        "K3": cuda_time_ms(lambda: rcas_k.rcas_fused(y16, rcon), **KQ),
        "K3 bf16": cuda_time_ms(lambda: rcas_k.rcas_fused(y_bf16, rcon), **KQ),
        "K3_plain": cuda_time_ms(lambda: rcas_k.rcas_fused_reference(y16, rcon), warmup=1, iters=5),
    }
    # The float16 upscale runs the torch path: its cost beside K1's.
    f16_frames = frames.half()
    k3_f16["t"]["upscale f16 (torch path)"] = cuda_time_ms(
        lambda: ft.upscale(f16_frames, preset="performance", compute_dtype=f16), warmup=1, iters=3)
    del f16_frames
    k3_f16["t"]["K1 f32 (phase 6's kernel)"] = cuda_time_ms(lambda: fused.upscale_fused(frames, out4k, pcon, rcon),
                                                            **KQ)
    print(f"  times on {card}, batch {nframes}:")
    for k, v in k3_f16["t"].items():
        print(f"    {k:>26}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")

    t32, q32 = timings[torch.float32], qtimings[torch.float32]
    ta, tb, tc, ts = (path_runs[p[0]] for p in paths)
    td, td8, te = (rgba_runs[p[0]] for p in rgba_paths)
    npix = nframes * out4k[0] * out4k[1]
    out4k_f32 = npix * 3 * 4
    src = {"K4": "fsr_tpu_torch/csrc/edge_pad.cu", "K1": "fsr_tpu_torch/csrc/fused.cu",
           "K2": "fsr_tpu_torch/csrc/easu_gather.cu", "K3": "fsr_tpu_torch/csrc/rcas.cu"}
    rep = {"K4": "fsr_tpu/kernels/pad.py:50", "K1": "fsr_tpu/kernels/fused.py:403",
           "K2": "fsr_tpu/kernels/easu_gather.py:350", "K3": "fsr_tpu/kernels/rcas_pallas.py:42"}
    kernels = [
        _kernel_entry("edge_pad (K4), phase 3's pads; timed at the Performance shape, off the K1 paths",
                      src["K4"], rep["K4"], k4_launches, k4_err, t32["K4"], t32["K4_plain"], main_bytes["K4"], 0,
                      t32["K4_library"]),
        _kernel_entry("upscale_fused (K1)", src["K1"], rep["K1"], launches["K1"], k1_err, t32["K1"],
                      t32["call_plain"], main_bytes["K1"], EASU_RCAS_OPS * npix),
        _kernel_entry("easu_gather (K2)", src["K2"], rep["K2"], launches["K2"], k2_err, q32["K2"],
                      q32["K2_plain"], _nbytes(qframes) + out4k_f32, EASU_RCAS_OPS * npix),
        _kernel_entry("rcas_fused (K3)", src["K3"], rep["K3"], launches["K3"], k3_err, q32["K3"],
                      q32["K3_plain"], 2 * _nbytes(sframes), RCAS_OPS * npix),
        _kernel_entry("upscale_fused (K1) + SRTM prologue + K5 epilogue: HDR frame tail (a)", src["K1"],
                      rep["K1"], ta["launches"]["K1"], max(epi_err["K1"], ta["err"]), ta["t"]["K1"],
                      ta["t"]["K1_plain"], _nbytes(hdr, grain4k) + out4k_f32,
                      (EASU_RCAS_OPS + LFGA_OPS + TEPD_OPS) * npix + SRTM_OPS_PER_TEXEL * hdr.numel() // 3),
        _kernel_entry("easu_gather (K2) + K5 epilogue, uint8 in and out: display path (b)", src["K2"],
                      rep["K2"], tb["launches"]["K2"], max(epi_err["K2"], tb["err"]), tb["t"]["K2"],
                      tb["t"]["plain"], _nbytes(q8, grain4k) + npix * 3,
                      (EASU_RCAS_OPS + LFGA_OPS + TEPD_OPS) * npix),
        _kernel_entry("upscale_fused (K1), uint8 in and out: byte video path (c)", src["K1"], rep["K1"],
                      tc["launches"]["K1"], tc["err"], tc["t"]["K1"], tc["t"]["K1_plain"],
                      _nbytes(m8) + npix * 3, EASU_RCAS_OPS * npix),
        _kernel_entry("rcas_fused (K3), uint8: sharpen on bytes", src["K3"], rep["K3"],
                      ts["launches"]["K3"], ts["err"], ts["t"]["K3"], ts["t"]["K3_plain"],
                      2 * _nbytes(s8), RCAS_OPS * npix),
        _kernel_entry("upscale_fused (K1), RGBA: performance path (d)", src["K1"], rep["K1"],
                      td["launches"]["K1"], max(rgba_err["K1"], td["err"]), td["t"]["K1"], td["t"]["K1_plain"],
                      td["nbytes"], (EASU_RCAS_OPS + ALPHA_OPS) * npix),
        _kernel_entry("upscale_fused (K1), RGBA, uint8 in and out: performance path (d)", src["K1"], rep["K1"],
                      td8["launches"]["K1"], td8["err"], td8["t"]["K1"], td8["t"]["K1_plain"], td8["nbytes"],
                      (EASU_RCAS_OPS + ALPHA_OPS) * npix),
        _kernel_entry("easu_gather (K2), RGBA, bf16: quality path (e)", src["K2"], rep["K2"],
                      te["launches"]["K2"], max(rgba_err["K2"], te["err"]), te["t"]["K2"], te["t"]["K2_plain"],
                      te["nbytes"], (EASU_RCAS_OPS + ALPHA_OPS) * npix),
        _kernel_entry("rcas_fused (K3), float16: sharpen on halves", src["K3"], rep["K3"], k3_f16["launches"],
                      k3_f16["err"], k3_f16["t"]["K3"], k3_f16["t"]["K3_plain"], 2 * _nbytes(y16),
                      RCAS_OPS * npix),
    ]

    # --- 18. row-sharded and batch-sharded execution ---------------------------
    lap("18")
    kernels += _row_sharded(dev, card, gen, trace)

    # --- 19. the probes P1-P4 ----------------------------------------------------
    lap("19")
    kernels += _probes(dev, card)

    # --- 20. autodiff ----------------------------------------------------------------
    lap("20")
    _autodiff(dev, card, trace)

    # --- 21. the application layer ----------------------------------------------------
    lap("21")
    _app_layer(dev, card)
    laps.append(("end", time.perf_counter()))
    print("seconds per phase: " + ", ".join(f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(laps, laps[1:]))
          + f"; {laps[-1][1] - laps[0][1]:.1f} in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
