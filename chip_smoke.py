#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on a mismatch, so any failure exits non-zero):
  1. card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from fsr_tpu_torch/csrc (timed);
  3. K4 edge_pad bit-equal to edge_pad_reference on the card;
  4. K1 upscale_fused against upscale_fused_reference on the card (f32
     within 6e-5; bf16 by median/p99 and max <= 2**-8), including the
     hazard cases (isolated bright pixel, DRS offset, all-black frame);
  5. fsr_tpu_torch.upscale(preset="performance") against the port's numpy
     oracle at 540p -> 1080p f32 (max-abs <= 2e-5);
  6. the Performance path: upscale(x, preset="performance") on a (4, 3,
     1080, 1920) CUDA tensor in f32 and bf16, held against
     upscale_fused_reference (the phase-4 limits), with launch counts and
     CUDA-event times of each kernel beside its plain version;
  7. K2 easu_gather against easu_gather_reference (the phase-4 limits) at
     every preset ratio, native 1x, a ragged ratio, 2x with an odd width, a
     DRS offset, bf16, EASU-only, denoise, batch 2 and the hazard cases;
  8. K3 rcas_fused against rcas_fused_reference (the same limits): clamp
     and zero borders, denoise, bf16, an isolated pixel, a ragged image;
  9. upscale(preset="quality") at 720p -> 1080p and sharpen at 1080p, f32,
     against the numpy oracle (max-abs <= 2e-5);
 10. the Quality path: upscale(x, preset="quality") on a (4, 3, 1440, 2560)
     CUDA tensor (-> 4K) and sharpen(y) on a (4, 3, 2160, 3840) one, in f32
     and bf16, held against their plain versions, with launch counts (K2 on
     the Quality path and K1, K4 not; K3 on sharpen) and CUDA-event times;
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
     grain_amount=0.3, dither_bits=10) on float32 1080p frames (K4 + K1),
     (b) the display path (grain, 8-bit dither, uint8 out, bf16 storage) on
     uint8 1440p frames (K2), (c) the byte video path upscale(frame_u8,
     scale=2.0, out_dtype=uint8) (K4 + K1 on bytes), and sharpen on uint8 4K
     frames (K3);
 14. with --trace only: traces of (a) and (b), which must show only their
     kernels.
The last two lines are a JSON object describing the kernels and the JSON
result line.  Exits non-zero with no result when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

F32_TOL = 6e-5
BF16_MAX = 2.0 ** -8
BF16_MEDIAN = 1.0 / 1250.0
BF16_P99 = 1.25 / 255.0
ORACLE_TOL = 2e-5
CODE_SHARE = 1e-4
TORCH_SHARE = 1e-3
MAIN_SHAPE = (4, 3, 1080, 1920)
QUALITY_SHAPE = (4, 3, 1440, 2560)
SHARPEN_SHAPE = (4, 3, 2160, 3840)


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", action="store_true",
                        help="add phases 11 and 14: torch.profiler traces of the main paths")
    trace = parser.parse_args().trace
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
    from fsr_tpu_torch.kernels import _build, easu_gather, fused, pad
    from fsr_tpu_torch.kernels import rcas as rcas_k
    from fsr_tpu_torch.reference import scalar as ref
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, device_trace

    dev = torch.device("cuda:0")

    # --- 1. the card -------------------------------------------------------
    card = _card()
    print(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # --- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2: built {_build.build_dir().name} in {time.perf_counter() - t0:.1f} s")
    for line in (_build.build_dir() / "build.log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    rng = np.random.default_rng(0)

    def rand(shape):
        return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)

    # --- 3. K4 -------------------------------------------------------------
    print("phase 3: K4 edge_pad vs edge_pad_reference (bit-equal)")
    k4_err = 0.0
    main_plan = fused.plan(MAIN_SHAPE[-2:], (2160, 3840),
                           EasuConstants.create((1920, 1080), None, (3840, 2160)))
    for shape, pads in ((MAIN_SHAPE, main_plan.pads), ((2, 3, 67, 131), (3, 5, 2, 7))):
        x32 = rand(shape)
        for src, dt in ((x32, torch.float32), (x32, torch.bfloat16),
                        (x32.to(torch.bfloat16), torch.bfloat16)):
            got = pad.edge_pad(src, pads, dt)
            want = pad.edge_pad_reference(src, pads, dt)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K4 {shape} {src.dtype}->{dt} pads {pads}: not bit-equal")
            k4_err = max(k4_err, (got.float() - want.float()).abs().max().item())
            print(f"  {tuple(shape)} {src.dtype}->{dt} pads {pads}: bit-equal")

    # --- 4. K1 -------------------------------------------------------------
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
    for what, shape, out_hw, dt, rcas, denoise, stops in cases:
        x = rand(shape)
        con, rcon = con_for(shape[-2:], out_hw), RcasConstants(stops)
        got = fused.upscale_fused(x, out_hw, con, rcon, rcas, denoise, dt)
        want = fused.upscale_fused_reference(x, out_hw, con, rcon, rcas, denoise, dt)
        torch.cuda.synchronize()
        err = _compare(got, want, what)
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

    # --- 5. oracle ---------------------------------------------------------
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
    wrappers = {"K4": pad.edge_pad, "K1": fused.upscale_padded,
                "K2": easu_gather.easu_gather, "K3": rcas_k.rcas_fused}

    def drive(fn, need):
        """Run fn with every count at 0; fail unless each kernel in `need`
        launched exactly once and no other kernel launched."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: w.launches for k, w in wrappers.items()}
        if any(n != (k in need) for k, n in got.items()):
            raise AssertionError(f"launch counts {got}: the path must launch exactly one of each of {need}")
        return out, got

    gen = torch.Generator(device=dev).manual_seed(0)
    frames = torch.rand(MAIN_SHAPE, generator=gen, device=dev)
    nframes = MAIN_SHAPE[0]
    out_shape = MAIN_SHAPE[:-2] + (2160, 3840)
    launches = {"K4": 0, "K1": 0, "K2": 0, "K3": 0}
    con = EasuConstants.create((1920, 1080), None, (3840, 2160))
    rcon = RcasConstants(0.25)
    sharp = float(rcon.sharpness)
    print(f"phase 6: main path upscale(x, preset='performance') on {MAIN_SHAPE}")
    for dt in (torch.float32, torch.bfloat16):
        x = frames.to(dt)
        out, n = drive(lambda: ft.upscale(x, preset="performance", compute_dtype=dt), ("K4", "K1"))
        if tuple(out.shape) != out_shape or out.dtype != dt or out.device != x.device:
            raise AssertionError(f"main path {dt}: got {tuple(out.shape)} {out.dtype} {out.device}")
        launches["K4"] += n["K4"]
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
        padded = pad.edge_pad(x, main_plan.pads, dt)
        t = {
            "call": cuda_time_ms(lambda: ft.upscale(x, preset="performance", compute_dtype=dt)),
            "call_b2b": _back_to_back_ms(lambda: ft.upscale(x, preset="performance", compute_dtype=dt)),
            "call_plain": cuda_time_ms(
                lambda: fused.upscale_fused_reference(x, (2160, 3840), con, rcon, True, False, dt),
                warmup=1, iters=5),
            "K4": cuda_time_ms(lambda: pad.edge_pad(x, main_plan.pads, dt)),
            "K4_plain": cuda_time_ms(lambda: pad.edge_pad_reference(x, main_plan.pads, dt)),
            "K1": cuda_time_ms(lambda: fused.upscale_padded(padded, main_plan, (2160, 3840), sharp)),
            "K1_plain": cuda_time_ms(
                lambda: fused.upscale_padded_reference(padded, main_plan, (2160, 3840), sharp),
                warmup=1, iters=5),
        }
        timings[dt] = t
        print(f"  times {dt}, median CUDA-event ms per 4K frame (batch {nframes}) on {card}:")
        for k, v in t.items():
            print(f"    {k:>10}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
    t32 = timings[torch.float32]
    print("  call: median latency of one call (host work included); call_b2b: per call with "
          "10 calls queued back to back; K4, K1: the kernels alone; *_plain: their plain "
          "torch versions on the card")
    print(f"  f32 output rate: {nframes * 2160 * 3840 / (t32['call'] * 1e-3) / 1e6:.1f} Mpix/s; "
          f"bf16: {nframes * 2160 * 3840 / (timings[torch.bfloat16]['call'] * 1e-3) / 1e6:.1f} Mpix/s")

    # --- 7. K2 ------------------------------------------------------------
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

    # --- 9. oracle: Quality and sharpen ---------------------------------------
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
            "K2": cuda_time_ms(lambda: easu_gather.easu_gather(x, (2160, 3840), qcon, rcon, True, False, dt)),
            "K2_plain": cuda_time_ms(
                lambda: easu_gather.easu_gather_reference(x, (2160, 3840), qcon, rcon, True, False, dt),
                warmup=1, iters=5),
            "sharpen_call": cuda_time_ms(lambda: ft.sharpen(y)),
            "sharpen_b2b": _back_to_back_ms(lambda: ft.sharpen(y)),
            "K3": cuda_time_ms(lambda: rcas_k.rcas_fused(y, rcon)),
            "K3_plain": cuda_time_ms(lambda: rcas_k.rcas_fused_reference(y, rcon), warmup=1, iters=5),
        }
        qtimings[dt] = t
        print(f"  times {dt}, median CUDA-event ms per 4K frame (batch {nframes}) on {card}:")
        for k, v in t.items():
            print(f"    {k:>12}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
    print("  call: one upscale(preset='quality') call (host work included); call_b2b: per call "
          "with 10 calls queued back to back; sharpen_*: the same for sharpen; K2, K3: the "
          "kernels alone; *_plain: their plain torch versions on the card")

    # --- 11. trace (--trace only) ---------------------------------------------
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
    sharp = float(rcon.sharpness)
    args_a = epilogue_mod.bind(epi_a, out4k, 7, grain4k, None, dev)
    args_b = epilogue_mod.bind(epi_b, out4k, 7, grain4k, None, dev)
    hdr_padded = pad.edge_pad(hdr, main_plan.pads, f32)
    m8_padded = pad.edge_pad(m8, main_plan.pads, u8)
    paths = [
        # name, call, kernels it launches, plain version, plain-torch pipeline, torch-path step,
        # epilogue, {timed kernel and its plain version}, {the same upscale without the epilogue}
        ("(a) HDR frame tail, f32 1080p -> 4K", lambda: pipe_a(hdr, grain=grain4k, frame=7), ("K4", "K1"),
         lambda: fused.upscale_fused_reference(hdr, out4k, pcon, rcon, epilogue=epi_a, frame=7, grain=grain4k,
                                               prologue="srtm"),
         lambda: torch_a(hdr, grain=grain4k, frame=7), 1.01 / 1023.0, epi_a,
         {"K1": lambda: fused.upscale_padded(hdr_padded, main_plan, out4k, sharp, prologue="srtm", epi=args_a),
          "K1_plain": lambda: fused.upscale_padded_reference(hdr_padded, main_plan, out4k, sharp,
                                                             prologue="srtm", epi=args_a),
          "K1 SRTM prologue only": lambda: fused.upscale_padded(hdr_padded, main_plan, out4k, sharp,
                                                                prologue="srtm"),
          "K1 grain + TEPD epilogue only": lambda: fused.upscale_padded(hdr_padded, main_plan, out4k, sharp,
                                                                        epi=args_a),
          "K1 neither": lambda: fused.upscale_padded(hdr_padded, main_plan, out4k, sharp),
          "K4": lambda: pad.edge_pad(hdr, main_plan.pads, f32)},
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
        ("(c) byte video, u8 1080p -> 4K u8", lambda: ft.upscale(m8, scale=2.0, out_dtype=u8), ("K4", "K1"),
         lambda: fused.upscale_fused_reference(m8, out4k, pcon, rcon, out_dtype=u8),
         lambda: ft.upscale(m8, scale=2.0, out_dtype=u8, impl="torch"), 1.0, None,
         {"K1": lambda: fused.upscale_padded(m8_padded, main_plan, out4k, sharp, out_dtype=u8),
          "K1_plain": lambda: fused.upscale_padded_reference(m8_padded, main_plan, out4k, sharp, out_dtype=u8),
          "K4": lambda: pad.edge_pad(m8, main_plan.pads, u8),
          "K4_plain": lambda: pad.edge_pad_reference(m8, main_plan.pads, u8)},
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
            t[k] = cuda_time_ms(f_, warmup=1, iters=5) if k.endswith("_plain") else cuda_time_ms(f_)
        t["plain"] = cuda_time_ms(plain, warmup=1, iters=3)
        t["plain-torch pipeline"] = cuda_time_ms(plain_torch, warmup=1, iters=3)
        for k, f_ in bare_fns.items():
            t[k] = cuda_time_ms(f_)
        path_runs[name] = dict(launches=n, err=err, t=t)
        for k, v in t.items():
            print(f"    {k:>40}: {v / nframes:.4f} ms/frame ({v:.3f} ms/call)")
        del out
    print("  call: median latency of one call (host work included); call_b2b: per call with 10 calls "
          "queued back to back; K*: the kernel alone; plain: the kernels' plain versions; the rest: "
          "the same upscale without the prologue and epilogue, for the epilogue's cost")

    # --- 14. trace of the pipeline paths (--trace only) -------------------------
    if trace:
        print(f"phase 14: torch.profiler traces of the pipeline paths on {card}")
        for name, call, kinds in ((paths[0][0], paths[0][1], ("edge_pad_kernel", "fused_kernel")),
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

    t32, q32 = timings[torch.float32], qtimings[torch.float32]
    ta, tb, tc, ts = (path_runs[p[0]] for p in paths)
    kernels = [
        {"name": "edge_pad (K4)", "route": "cuda", "source": "fsr_tpu_torch/csrc/edge_pad.cu",
         "replaces": "fsr_tpu/kernels/pad.py:50", "launches": launches["K4"],
         "max_abs_err": k4_err, "ms": t32["K4"], "plain_ms": t32["K4_plain"]},
        {"name": "upscale_fused (K1)", "route": "cuda", "source": "fsr_tpu_torch/csrc/fused.cu",
         "replaces": "fsr_tpu/kernels/fused.py:403", "launches": launches["K1"],
         "max_abs_err": k1_err, "ms": t32["K1"], "plain_ms": t32["K1_plain"]},
        {"name": "easu_gather (K2)", "route": "cuda", "source": "fsr_tpu_torch/csrc/easu_gather.cu",
         "replaces": "fsr_tpu/kernels/easu_gather.py:350", "launches": launches["K2"],
         "max_abs_err": k2_err, "ms": q32["K2"], "plain_ms": q32["K2_plain"]},
        {"name": "rcas_fused (K3)", "route": "cuda", "source": "fsr_tpu_torch/csrc/rcas.cu",
         "replaces": "fsr_tpu/kernels/rcas_pallas.py:42", "launches": launches["K3"],
         "max_abs_err": k3_err, "ms": q32["K3"], "plain_ms": q32["K3_plain"]},
        {"name": "upscale_fused (K1) + SRTM prologue + K5 epilogue: HDR frame tail (a)", "route": "cuda",
         "source": "fsr_tpu_torch/csrc/fused.cu", "replaces": "fsr_tpu/kernels/fused.py:403",
         "launches": ta["launches"]["K1"], "max_abs_err": max(epi_err["K1"], ta["err"]),
         "ms": ta["t"]["K1"], "plain_ms": ta["t"]["K1_plain"]},
        {"name": "easu_gather (K2) + K5 epilogue, uint8 in and out: display path (b)", "route": "cuda",
         "source": "fsr_tpu_torch/csrc/easu_gather.cu", "replaces": "fsr_tpu/kernels/easu_gather.py:350",
         "launches": tb["launches"]["K2"], "max_abs_err": max(epi_err["K2"], tb["err"]),
         "ms": tb["t"]["K2"], "plain_ms": tb["t"]["plain"]},
        {"name": "upscale_fused (K1), uint8 in and out: byte video path (c)", "route": "cuda",
         "source": "fsr_tpu_torch/csrc/fused.cu", "replaces": "fsr_tpu/kernels/fused.py:403",
         "launches": tc["launches"]["K1"], "max_abs_err": tc["err"],
         "ms": tc["t"]["K1"], "plain_ms": tc["t"]["K1_plain"]},
        {"name": "edge_pad (K4), uint8: byte video path (c)", "route": "cuda",
         "source": "fsr_tpu_torch/csrc/edge_pad.cu", "replaces": "fsr_tpu/kernels/pad.py:50",
         "launches": tc["launches"]["K4"], "max_abs_err": 0.0,
         "ms": tc["t"]["K4"], "plain_ms": tc["t"]["K4_plain"]},
        {"name": "rcas_fused (K3), uint8: sharpen on bytes", "route": "cuda",
         "source": "fsr_tpu_torch/csrc/rcas.cu", "replaces": "fsr_tpu/kernels/rcas_pallas.py:42",
         "launches": ts["launches"]["K3"], "max_abs_err": ts["err"],
         "ms": ts["t"]["K3"], "plain_ms": ts["t"]["K3_plain"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
