"""Command-line demo app: upscale an image file with FSR on the card.

Counterpart of ``fsr_tpu/cli.py``, flag for flag: the L3 analog of the
reference's FSRSample application: two-level configuration (JSON file +
command-line overrides, mirroring OnParseCommandLine's JSON-merge scheme,
sample/src/DX12/FSRSample.cpp:46-126), mode selection {fsr, bilinear,
native} (State::m_nUpscaleType), quality presets, RCAS toggle/sharpness,
and a benchmark loop that writes a per-frame-timing CSV
(BenchmarkLoop/resultsFilename analog).

The image goes to the CUDA device (``--impl auto``: K1 at integer ratios,
K2 at any other); ``--cpu`` runs the plain-torch path on the CPU.  With no
CUDA device and no ``--cpu`` the CLI prints an error and returns 2.

Usage:
  python -m fsr_tpu_torch.cli IN OUT [--preset quality] [--scale 2.0]
      [--mode fsr|bilinear|native] [--sharpness 0.25] [--no-rcas]
      [--denoise] [--dtype float32|bfloat16|float16] [--impl auto|torch|kernel]
      [--hdr] [--gamma2-out] [--grain AMOUNT] [--dither-bits 8|10]
      [--blue-noise] [--frame N] [--cpu]
      [--config cfg.json] [--benchmark N --results out.csv]
      [--compare out.png]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# --benchmark N: the device reading brackets BENCH_QUEUE calls queued back
# to back per CUDA-event sample, N samples after BENCH_WARMUP calls; then N
# calls each timed alone on the host clock, synchronised.
BENCH_WARMUP = 3
BENCH_QUEUE = 10


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fsr_tpu_torch", description=__doc__)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--config", help="JSON config file; CLI flags override it")
    p.add_argument("--preset", default=None,
                   choices=["ultra_quality", "quality", "balanced", "performance", "native"])
    p.add_argument("--scale", type=float, default=None)
    p.add_argument("--out-size", type=int, nargs=2, default=None, metavar=("H", "W"))
    p.add_argument("--mode", default="fsr", choices=["fsr", "bilinear", "native"])
    p.add_argument("--sharpness", type=float, default=0.25,
                   help="RCAS sharpness in stops (0 = max)")
    p.add_argument("--no-rcas", action="store_true")
    p.add_argument("--denoise", action="store_true")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "float16"])
    p.add_argument("--impl", default="auto", choices=["auto", "torch", "kernel"])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain-torch path), not the card")
    p.add_argument("--hdr", action="store_true",
                   help="treat input as HDR: SRTM tonemap in, SRTM^-1 out "
                        "(fused into the kernel)")
    p.add_argument("--gamma2-out", action="store_true",
                   help="square the output (gamma-2.0 -> linear, the "
                        "sample's HDR swapchain mode)")
    p.add_argument("--grain", type=float, default=0.0, metavar="AMOUNT",
                   help="LFGA film grain amount (0..1); grain texture is "
                        "seeded per --frame")
    p.add_argument("--dither-bits", type=int, default=None, choices=[8, 10],
                   help="TEPD dithered quantize to 8/10-bit gamma-2.0")
    p.add_argument("--blue-noise", action="store_true",
                   help="dither with temporal blue-noise pages (the "
                        "sample's quality option) instead of the "
                        "golden-ratio hash; requires --dither-bits")
    p.add_argument("--frame", type=int, default=0,
                   help="temporal frame index for grain/dither")
    p.add_argument("--benchmark", type=int, default=0, metavar="N",
                   help="time N upscale iterations and report")
    p.add_argument("--results", default=None, help="benchmark CSV output path")
    p.add_argument("--compare", default=None,
                   help="also write a side-by-side bilinear|fsr comparison image")
    p.add_argument("--magnify", type=int, nargs=3, default=None,
                   metavar=("CY", "CX", "ZOOM"),
                   help="zoom the --compare strip to a nearest-neighbor "
                        "magnified crop at output coords (CY, CX) — the "
                        "sample's MagnifierPS pixel-inspection flow")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
        for k, v in cfg.items():
            k = k.replace("-", "_")
            if hasattr(args, k) and build_parser().get_default(k) == getattr(args, k):
                setattr(args, k, v)

    import numpy as np
    import torch

    from fsr_tpu_torch import api
    from fsr_tpu_torch.core.constants import EasuConstants
    from fsr_tpu_torch.ops import easu as easu_ops
    from fsr_tpu_torch.utils import image as im

    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device; pass --cpu to run on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[args.dtype]
    img = im.load_image(args.input)
    hin, win = img.shape[-2:]
    if args.out_size:
        out_hw = tuple(args.out_size)
    elif args.scale:
        out_hw = (round(hin * args.scale), round(win * args.scale))
    else:
        from fsr_tpu_torch.core.presets import PRESETS

        out_hw = tuple(round(d * PRESETS[args.preset or "performance"].scale) for d in (hin, win))

    # load_image returns a strided view: copy it whole to the device.
    x = torch.from_numpy(np.ascontiguousarray(img[:3])).to(device)

    if args.blue_noise and args.dither_bits is None:
        print("error: --blue-noise requires --dither-bits", file=sys.stderr)
        return 2
    use_pipeline = (args.hdr or args.gamma2_out or args.grain
                    or args.dither_bits is not None)
    if use_pipeline and args.mode != "fsr":
        print(f"error: --hdr/--gamma2-out/--grain/--dither-bits require "
              f"--mode fsr (got --mode {args.mode})", file=sys.stderr)
        return 2
    pipe = grain_tex = None
    if use_pipeline and args.mode == "fsr":
        dither_tex = None
        if args.blue_noise:
            from fsr_tpu_torch.utils.noise import temporal_blue_noise

            dither_tex = temporal_blue_noise(pages=8)
        pipe = api.UpscalePipeline(
            out_hw, sharpness=args.sharpness, apply_rcas=not args.no_rcas,
            denoise=args.denoise, hdr_srtm=args.hdr, hdr_out=args.hdr,
            gamma2_out=args.gamma2_out, grain_amount=args.grain,
            dither_bits=args.dither_bits, dither_texture=dither_tex,
            compute_dtype=dtype, impl=args.impl,
        )
        if args.grain:
            grng = np.random.default_rng(args.frame)
            grain_tex = torch.from_numpy(
                grng.uniform(-0.5, 0.5, (3, *out_hw)).astype(np.float32)
            ).to(device)

    def run():
        if args.mode == "native":
            return x
        if args.mode == "bilinear":
            con = EasuConstants.create((win, hin), None, (out_hw[1], out_hw[0]))
            return easu_ops.bilinear(x, out_hw, con)
        if pipe is not None:
            return pipe(x, grain=grain_tex, frame=args.frame)
        return api.upscale(
            x, out_size=out_hw, sharpness=args.sharpness,
            apply_rcas=not args.no_rcas, denoise=args.denoise,
            compute_dtype=dtype, impl=args.impl,
        )

    out = run().to(torch.float32).cpu().numpy()

    if args.benchmark:
        rows = []
        device_ms = None
        if device.type == "cuda":
            # The headline is device time per call (calls queued, so the
            # host work of one overlaps the kernels of the one before); the
            # CSV keeps per-frame wall clock, synchronised before it stops.
            from fsr_tpu_torch.utils.profiling import cuda_time_ms

            device_ms = cuda_time_ms(run, warmup=BENCH_WARMUP, iters=args.benchmark, queue=BENCH_QUEUE)
        for i in range(args.benchmark):
            t0 = time.perf_counter()
            run()
            if device.type == "cuda":
                torch.cuda.synchronize()
            rows.append((i, (time.perf_counter() - t0) * 1e3))
        ms = [t for _, t in rows]
        headline = (
            f"device {device_ms:.4f} ms/frame, " if device_ms is not None else ""
        )
        print(f"benchmark: {args.benchmark} frames on {device}, {headline}"
              f"wall median {np.median(ms):.3f} ms, min {min(ms):.3f} ms",
              file=sys.stderr)
        if args.results:
            with open(args.results, "w") as f:
                f.write("frame,ms\n")
                f.writelines(f"{i},{t:.4f}\n" for i, t in rows)

    im.save_image(args.output, out)
    print(f"{args.input} {img.shape[-2:]} -> {args.output} {out.shape[-2:]} "
          f"mode={args.mode} impl={args.impl} device={device}", file=sys.stderr)

    if args.compare:
        con = EasuConstants.create((win, hin), None, (out_hw[1], out_hw[0]))
        bil = easu_ops.bilinear(x, out_hw, con).cpu().numpy()
        a, b = bil, out
        if args.magnify:
            cy, cx, zoom = args.magnify
            a = im.magnify(a, (cy, cx), zoom=zoom)
            b = im.magnify(b, (cy, cx), zoom=zoom)
        im.save_image(args.compare, im.side_by_side(a, b))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
