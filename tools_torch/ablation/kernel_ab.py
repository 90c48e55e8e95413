"""K4 and K2 against a parent commit's K4 and K2 on the H100, timed in turn.

    python3 tools_torch/ablation/kernel_ab.py [--parent DIR] [--define NAME=VALUE ...]

Builds three kinds of kernel library, in parallel: this checkout's, the
parent's from DIR (default ``_parent``: a ``git archive`` of the parent
commit unpacked at the root of the checkout; its C interfaces are this
tree's, so the package's wrappers drive either), and this checkout's again
with each ``--define`` (a preprocessor variant, e.g. ``FSR_K2_TILE_H=16``
for K2's tile height).  Then, at the main paths' shapes (batch 4 -> 4K):
K4 on the Performance source (float32, bfloat16, uint8 for the byte path
(c), RGBA float32 and uint8 for (d)) beside ``F.pad(mode="replicate")``,
and K2 on the Quality paths (float32, bfloat16, the display path (b):
uint8 in, grain, 8-bit dither, uint8 out, bfloat16 storage; RGBA bfloat16
(e)), each library's kernel in turn (5 rounds, CUDA-event medians).  Every
library's output is held against this tree's: K4 bit-equal (and to
``edge_pad_reference``); K2 by its largest difference and the values that
differ.  Prints ms per 4K frame, each kernel's bound (bytes over 3.35 TB/s,
or K2's counted operations over 67 TFLOP/s, chip_smoke's rule), the ptxas
lines of K4 and of K2 with RCAS, and the static SASS counts of K2 and K1
(``opmix_floor.sass_counts``) for each library, with the card's name and
power limit.  Exits non-zero without a card or parent sources, or when a
K4 disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import os
import pathlib
import re
import subprocess
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import _build, easu_gather, fused, pad
from fsr_tpu_torch.kernels.epilogue import Epilogue

ROOT = pathlib.Path(__file__).resolve().parents[2]
NFRAMES = 4
OUT4K = (2160, 3840)
PERF_IN = (1080, 1920)
QUALITY_IN = (1440, 2560)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The function's float32 ops per output pixel, as chip_smoke.py counts them
# (EASU_RCAS_OPS; LFGA_OPS + TEPD_OPS; ALPHA_OPS).
EASU_RCAS_OPS = 488.75
EPI_OPS = 12 + 60
ALPHA_OPS = 8
# ptxas entries printed: every K4, and K2 with RCAS and no denoise.
PTXAS_KERNELS = re.compile(r"edge_pad_kernel|gather_kernelI.*Lb1ELb0EL")


@contextlib.contextmanager
def using(lib):
    """The package's kernel wrappers launch from ``lib`` inside the block."""
    saved = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = saved


def on(lib, fn):
    def run():
        with using(lib):
            return fn()
    return run


def ptxas_lines(build_dir: pathlib.Path) -> list:
    """(entry, stack line, usage line) of PTXAS_KERNELS in a build's log."""
    out, entry, stack = [], None, ""
    for line in (build_dir / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, stack = m.group(1), ""
        elif entry and "stack frame" in line:
            stack = line.strip()
        elif entry and "Used" in line:
            if PTXAS_KERNELS.search(entry):
                out.append(f"{entry}: {stack}; {line.split(':', 1)[1].strip()}")
            entry = None
    return out


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def k4_cases(dev, gen):
    """(name, source, pads, out dtype): the K4 calls of the main paths."""
    con = EasuConstants.create(PERF_IN[::-1], None, OUT4K[::-1])
    pads = fused.plan(PERF_IN, OUT4K, con).pads
    x = torch.rand((NFRAMES, 3, *PERF_IN), generator=gen, device=dev)
    x4 = torch.cat([x, torch.rand((NFRAMES, 1, *PERF_IN), generator=gen, device=dev)], 1)
    u8, bf16 = torch.uint8, torch.bfloat16
    return [("Performance f32", x, pads, torch.float32),
            ("Performance bf16", x.to(bf16), pads, bf16),
            ("(c) u8", (x * 255).to(u8), pads, u8),
            ("(d) RGBA f32", x4, pads, torch.float32),
            ("(d) RGBA u8", (x4 * 255).to(u8), pads, u8)]


def k2_cases(dev, gen):
    """(name, call taking no arguments, source, ops per output pixel): the
    K2 calls of the Quality paths."""
    con = EasuConstants.create(QUALITY_IN[::-1], None, OUT4K[::-1])
    rcon = RcasConstants(0.25)
    bf16, u8 = torch.bfloat16, torch.uint8
    x = torch.rand((NFRAMES, 3, *QUALITY_IN), generator=gen, device=dev)
    xb = x.to(bf16)
    x8 = (x * 255).to(u8)
    x4 = torch.cat([x, torch.rand((NFRAMES, 1, *QUALITY_IN), generator=gen, device=dev)], 1).to(bf16)
    grain = torch.rand((3, *OUT4K), generator=gen, device=dev) - 0.5
    epi = Epilogue(grain_amount=0.25, dither_bits=8)

    def k2(img, dt, **kw):
        return lambda: easu_gather.easu_gather(img, OUT4K, con, rcon, True, False, dt, **kw)

    return [("Quality f32", k2(x, torch.float32), x, EASU_RCAS_OPS),
            ("Quality bf16", k2(xb, bf16), xb, EASU_RCAS_OPS),
            ("(b) display u8", k2(x8, bf16, epilogue=epi, frame=7, grain=grain, out_dtype=u8), x8,
             EASU_RCAS_OPS + EPI_OPS),
            ("(e) RGBA bf16", k2(x4, bf16), x4, EASU_RCAS_OPS + ALPHA_OPS)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=str(ROOT / "_parent"),
                        help="root of the parent commit's checkout (default _parent)")
    parser.add_argument("--define", action="append", default=[],
                        help="a -D variant of this tree's kernels to time beside them (repeatable)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; the readings are device times", file=sys.stderr)
        return 1
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn
    from tools_torch.ablation import opmix_floor

    parent = pathlib.Path(args.parent).resolve() / "fsr_tpu_torch" / "csrc"
    if not parent.is_dir():
        print(f"kernel_ab: no parent sources at {parent}", file=sys.stderr)
        return 1
    here = ROOT / "fsr_tpu_torch" / "csrc"
    builds = {"this tree": (here, _build.NVCC_FLAGS), "parent": (parent, _build.NVCC_FLAGS)}
    for d in args.define:
        builds[d] = (here, _build.NVCC_FLAGS + (f"-D{d}",))
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda b: _build.load(*b), builds.values())))
    cname = card()
    print(f"card: {cname}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for name, (csrc, flags) in builds.items():
        print(f"ptxas, {name} ({_build.build_dir(csrc, flags).name}):")
        for line in ptxas_lines(_build.build_dir(csrc, flags)):
            print("  " + line)

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    print(f"K4, ms per 4K frame (batch {NFRAMES}), in turn, 5 rounds, on {cname}:")
    for what, x, pads, dt in k4_cases(dev, gen):
        want = pad.edge_pad_reference(x, pads, dt)
        for name, lib in libs.items():
            got = on(lib, lambda: pad.edge_pad(x, pads, dt))()
            if not torch.equal(got, want):
                print(f"  {what}, {name}: NOT bit-equal to edge_pad_reference")
                ok = False
        fns = {name: on(lib, lambda lib=lib: pad.edge_pad(x, pads, dt)) for name, lib in libs.items()}
        if x.dtype == dt:  # F.pad pads without converting
            pt, pb, pl, pr = pads
            fns["F.pad"] = lambda: torch.nn.functional.pad(x.to(dt), (pl, pr, pt, pb), mode="replicate")
        t = cuda_times_in_turn(fns, 5)
        bound = (x.numel() * x.element_size() + want.numel() * want.element_size()) / HBM_BYTES_PER_S * 1e3
        print(f"  {what}: " + ", ".join(f"{k} {v / NFRAMES:.4f}" for k, v in t.items())
              + f"; bound {bound / NFRAMES:.4f} (bytes)")
        del want

    print(f"K2, ms per 4K frame (batch {NFRAMES}), in turn, 5 rounds, on {cname}:")
    npix = NFRAMES * OUT4K[0] * OUT4K[1]
    for what, call, x, ops in k2_cases(dev, gen):
        ref = on(libs["this tree"], call)()
        for name, lib in libs.items():
            got = on(lib, call)()
            d = (got.float() - ref.float()).abs()
            off = int((d > 0).sum())
            print(f"  {what}, {name} vs this tree: max-abs {d.max().item():.3e}, {off} of {d.numel()} values differ")
        t = cuda_times_in_turn({name: on(lib, call) for name, lib in libs.items()}, 5)
        nbytes = x.numel() * x.element_size() + ref.numel() * ref.element_size()
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops * npix / F32_OPS_PER_S * 1e3
        bound = f"{max(by_bytes, by_ops) / NFRAMES:.4f} ({'bytes' if by_bytes >= by_ops else 'operations'})"
        print(f"  {what}: " + ", ".join(f"{k} {v / NFRAMES:.4f}" for k, v in t.items())
              + f"; bound {bound}; this tree / parent {t['this tree'] / t['parent']:.3f}")
        del ref

    for name, (csrc, flags) in builds.items():
        print(f"SASS (static), {name}:")
        counts = opmix_floor.sass_counts(_build.library_path(csrc, flags))
        for line in opmix_floor.sass_lines({k: v for k, v in counts.items() if k.startswith(("K1", "K2"))}):
            print("  " + line)
    print(cname)
    if not ok:
        print("kernel_ab: K4 disagrees with its plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
