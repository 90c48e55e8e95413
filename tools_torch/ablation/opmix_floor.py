"""Op-mix replay of K1 on the H100: K1's time split into its memory path, its
per-pixel recompute and its instruction issue.

Counterpart of tools/ablation/opmix_floor.py.  Two kernels run K1's math
on the K4-padded source of one K1 tile (an 8 x 16 frame upscaled 2x to
16 x 32, ``tiny_frame``) held in shared memory, on K1's grid for the
headline (batch-4 1080p -> 4K, ``probes.HEADLINE_GRID``), so they issue the
headline's math with its taps read from shared memory (LDS), not from
global memory (LDG):

- P2 (``probes.opmix_replay_shared``): the luma and texel responses once
  per texel of each block's source window: the fewest operations of K1's
  math;
- P1 (``probes.opmix_replay``): K1's own per-pixel stream (each pixel
  computes its twelve lumas and four texel responses; the 1.195x ring
  recompute); ``rcas=False`` without RCAS (no ring).

Block (0, 0, 0) of a replay stores the tile; the others store only a pixel
that takes a value no output takes, so the math stays live and the stores
cost nothing.  ``readings`` takes P2, P1, P1 EASU-only and K1 (float32 and
bfloat16 storage) in turn, so every difference is read under the same
clocks: K1 - P1 is what K1's global tap loads cost over shared-memory
loads of the same taps, P1 - P2 the cost of the per-pixel recompute, and P2
against the convention-2 op floor (``stream_ops``,
``fused_roofline.ops_per_pixel``) the instruction-issue efficiency.  The
replays are what they claim only if P2 <= P1 <= K1 (``report`` says
whether) for the per-pixel K1 that they replay; K1 now stages its source
window and runs quads at 2x, so a K1 below P1 reads as the staged design
beating the per-pixel design's shared-memory floor, not as a fault of the
replays.  ``sass_counts`` reads the built kernels' SASS (``cuobjdump``):
the replays' float instructions beside K1's, their LDS beside K1's LDG.
The plan is fixed by fsr_pixel.cuh's TILE_H x TILE_W, not by a tile sweep.

Run on a machine with an H100, from the root of a checkout:
    python3 tools_torch/ablation/opmix_floor.py
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import fused, pad, probes
from tools_torch.ablation import fused_roofline

# One K1 tile's source at 2x: 8 x 16 texels to the (16, 32) tile.
TINY_IN = (probes.TILE[0] // 2, probes.TILE[1] // 2)
SHARP = float(RcasConstants(0.25).sharpness)
# Tile and ring (fsr_pixel.cuh RING_H x RING_W) per tile pixel: the share of
# EASU pixels that K1 (and P1, P2) compute for RCAS.
RING = (probes.TILE[0] + 2) * (probes.TILE[1] + 2) / (probes.TILE[0] * probes.TILE[1])
# The data sheet's float32 rate outside the tensor cores (H100 SXM, 700 W).
F32_TFLOPS = fused_roofline.PEAK_TFLOPS[torch.float32]
# sass_counts: the kernels it reads (a label, a piece of the mangled name:
# K1 is fused_kernel<float, float, RCAS, no denoise, RGB> in the per-pixel
# design (a parent build's), fused_kernel<float, float, float, QUAD, no
# denoise, RGB> in the staged one (quad and generic paths), K3
# rcas_kernel<T, T, clamp, no denoise> for float32 and uint8, K2 its
# <float, float, float, ...> twin, staged_gather_kernel since K2 stages its
# source footprint and gather_kernel in a build of the per-pixel design
# before it, the length prefixes keeping the two apart) and the
# instructions it prints.
SASS_KERNELS = (("K1 f32", "fused_kernelIffLb1ELb0ELb0E"), ("P1", "replay_kernelILb1E"),
                ("P1 EASU only", "replay_kernelILb0E"), ("P2", "replay_shared_kernel"),
                ("K2 f32", "20staged_gather_kernelIfffLb1ELb0ELb0E"),
                ("K2 f32 per-pixel", "13gather_kernelIfffLb1ELb0ELb0E"),
                ("K1 f32 quad", "fused_kernelIfffLb1ELb0ELb0E"), ("K1 f32 generic", "fused_kernelIfffLb0ELb0ELb0E"),
                ("K3 f32", "rcas_kernelIffLb0ELb0E"), ("K3 u8", "rcas_kernelIhhLb0ELb0E"),
                ("K6 f16", "easu_h_kernelI6__halfLb1ELb0ELb0E"))
SASS_OPS = ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "MUFU", "IMAD", "IADD3", "LOP3", "LEA", "SHF",
            "LDS", "LDG", "LDC", "STS", "STG", "BAR")
# K6's table (sass_lines(counts, HALF_SASS_OPS)): its half arithmetic, the
# packing of pairs (PRMT, F2FP), MUFU (h2rcp), its float32 math, and CALL
# (a float32 division's slow path is a called subroutine).
HALF_SASS_OPS = ("HADD2", "HMUL2", "HMNMX2", "HFMA2", "HSETP2", "PRMT", "F2FP", "MUFU", "FADD", "FMUL", "FFMA",
                 "FMNMX", "LDS", "STS", "STG", "BAR", "CALL")
# Half arithmetic counted by lanes (parse_half_lanes): an instruction whose
# every register source selects one half (R2.H0_H0) computes one lane.
HALF_ARITH = ("HADD2", "HMUL2", "HMNMX2", "HFMA2")
# One instruction of cuobjdump -sass: "/*0a30*/  @!P0 FFMA.FTZ R1, ..."
_SASS_LINE = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_]*)")
# Its modifiers and operands.
_SASS_OPERANDS = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?\w+\s+)?([A-Z][A-Z0-9_]*)((?:\.\w+)*)\s+([^;]*);")


def tiny_frame(device, seed: int = 0) -> torch.Tensor:
    """The (3, 8, 16) float32 frame of one K1 tile, uniform from ``seed``."""
    x = np.random.default_rng(seed).uniform(0, 1, (3, *TINY_IN)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def operand(image: torch.Tensor):
    """(padded, plan): the frame's K1 plan at 2x and its K4-padded source."""
    con = EasuConstants.create(TINY_IN[::-1], None, probes.TILE[::-1])
    fplan = fused.plan(TINY_IN, probes.TILE, con)
    return pad.edge_pad(image, fplan.pads, torch.float32), fplan


def replay(image: torch.Tensor, shared: bool = False, rcas: bool = True, grid=probes.HEADLINE_GRID
           ) -> torch.Tensor:
    """The replay's path: K4 pads the frame, then P1 (``shared``: P2) runs
    on ``grid``; returns the (3, 16, 32) tile."""
    padded, fplan = operand(image)
    if shared:
        return probes.opmix_replay_shared(padded, fplan, SHARP, grid)
    return probes.opmix_replay(padded, fplan, SHARP, rcas, grid)


def stream_ops(kind: str) -> float:
    """Operations per output pixel (convention 2, FMA = 2) of the stream a
    replay issues: "replay" (P1: per pixel of the tile and its ring, 12
    lumas, 4 texel responses and the resolve; RCAS per tile pixel),
    "replay easu_only" (P1 without RCAS: no ring), "shared" (P2: the
    window's lumas and responses once per texel, amortised over the tile's
    pixels; the resolve on tile and ring; RCAS)."""
    c = fused_roofline.ops_per_pixel()["convention 2"]
    unshared = c["easu_resolve"] + 4 * c["texel_response"] + 12 * c["luma"]
    if kind == "replay":
        return RING * unshared + c["rcas_resolve"]
    if kind == "replay easu_only":
        return unshared
    if kind == "shared":
        _, _, rows, cols = probes.window(operand(tiny_frame("cpu"))[1])
        per_tile = rows * cols * c["luma"] + (rows - 2) * (cols - 2) * c["texel_response"]
        return per_tile / (probes.TILE[0] * probes.TILE[1]) + RING * c["easu_resolve"] + c["rcas_resolve"]
    raise ValueError(f"unknown stream {kind!r}")


def headline_pixels(grid=probes.HEADLINE_GRID) -> int:
    """Output pixels a replay's grid computes: one tile per block."""
    return int(np.prod(grid)) * probes.TILE[0] * probes.TILE[1]


def reading_fns(device="cuda") -> dict:
    """The readings' thunks, each one launch at the headline: P2, P1, P1
    EASU-only and K1 (float32 and bfloat16 storage)."""
    padded, fplan = operand(tiny_frame(device))
    k1 = {dt: fused_roofline.headline_k1(dt, device)[0] for dt in (torch.float32, torch.bfloat16)}
    return {
        "P2": lambda: probes.opmix_replay_shared(padded, fplan, SHARP),
        "P1": lambda: probes.opmix_replay(padded, fplan, SHARP),
        "P1 EASU only": lambda: probes.opmix_replay(padded, fplan, SHARP, rcas=False),
        "K1 f32": k1[torch.float32],
        "K1 bf16": k1[torch.bfloat16],
    }


def readings(device="cuda", rounds: int = 5) -> dict:
    """ms per call of each of ``reading_fns`` at the headline, taken in
    turn ``rounds`` times (CUDA-event medians)."""
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn

    return cuda_times_in_turn(reading_fns(device), rounds)


def _by_kernel(lines, kernels):
    """({label: empty Counter}, [(label, line)]) for the lines of each
    function of a ``cuobjdump -sass`` listing that a (label, pattern) of
    ``kernels`` names (a regular expression; a plain substring of the
    mangled name in ``SASS_KERNELS``)."""
    counts, body, cur = {}, [], None
    for line in lines:
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            cur = next((label for label, key in kernels if re.search(key, name)), None)
            if cur is not None:
                counts[cur] = collections.Counter()
        elif cur is not None:
            body.append((cur, line))
    return counts, body


def _ops(selected) -> dict:
    counts, body = selected
    for label, line in body:
        m = _SASS_LINE.match(line)
        if m:
            counts[label][m.group(1)] += 1
    return counts


def _lanes(selected) -> dict:
    counts, body = selected
    for label, line in body:
        m = _SASS_OPERANDS.match(line)
        if not m or m.group(1) not in HALF_ARITH or ".F32" in m.group(2):
            continue
        regs = [op for op in m.group(3).split(",")[1:] if re.search(r"\bR\d+", op)]
        if regs:
            one = all(re.search(r"\.H[01]_H[01]\b", op) for op in regs)
            counts[label]["one lane" if one else "two lanes"] += 1
    return counts


def parse_sass(lines, kernels=SASS_KERNELS) -> dict:
    """{label: Counter of SASS mnemonics (modifiers dropped)} for each
    kernel of ``kernels`` in a ``cuobjdump -sass`` listing."""
    return _ops(_by_kernel(lines, kernels))


def parse_half_lanes(lines, kernels=SASS_KERNELS) -> dict:
    """{label: Counter of "one lane" and "two lanes"}: the ``HALF_ARITH``
    instructions (conversions such as HADD2.F32 and constant moves with no
    register source left out) of each kernel ``parse_sass`` names, one lane
    where every register source selects one half."""
    return _lanes(_by_kernel(lines, kernels))


def sass_tables(library=None, kernels=SASS_KERNELS) -> tuple:
    """(``parse_sass``, ``parse_half_lanes``) of one ``cuobjdump -sass`` of
    the library at path ``library`` (default: the package's, built first).
    The counts are static: each instruction of a kernel's code once, a tile
    loop's body once.  They show whether nvcc kept the replays' math (their
    float instructions beside K1's), that their taps are LDS where K1's are
    LDG, K2's instruction mix beside K1's, and whether a kernel's half
    arithmetic is paired."""
    from fsr_tpu_torch.kernels import _build

    if library is None:
        _build.library()
        library = _build.library_path()
    cmd = [_build.cuda_tool("cuobjdump"), "-sass", str(library)]
    with subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True) as proc:
        counts, body = _by_kernel(proc.stdout, kernels)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited with {proc.returncode}")
    return _ops((counts, body)), _lanes(({k: collections.Counter() for k in counts}, body))


def sass_counts(library=None, kernels=SASS_KERNELS) -> dict:
    """``parse_sass`` of the library at path ``library`` (``sass_tables``)."""
    return sass_tables(library, kernels)[0]


def sass_lines(counts: dict, ops=SASS_OPS) -> list:
    """``sass_counts`` as a table: one row per kernel, a column per op of
    ``ops``."""
    lines = [f"{'SASS (static)':<14}" + "".join(f"{op:>7}" for op in ops) + f"{'all':>7}"]
    for label, c in counts.items():
        lines.append(f"{label:<14}" + "".join(f"{c[op]:>7}" for op in ops) + f"{sum(c.values()):>7}")
    return lines


def report(ms: dict) -> list:
    """The JAX tool's lines (opmix_floor.py:295-307) from ``readings``, per
    4K frame (a headline call is 4 frames), and whether P2 <= P1 <= K1."""
    nf = probes.HEADLINE_GRID[2]
    t = {k: v / nf for k, v in ms.items()}
    fs, fl, fe = t["P2"], t["P1"], t["P1 EASU only"]
    px = headline_pixels() / nf
    lines = [f"plan: one {probes.TILE[0]} x {probes.TILE[1]} tile per block, grid {probes.HEADLINE_GRID}; "
             "ms per 4K frame"]
    for name, key in (("shared-dataflow floor (P2)", "P2"), ("per-pixel replay (P1, K1's math)", "P1"),
                      ("per-pixel replay, EASU only", "P1 EASU only")):
        lines.append(f"{name + ':':<40} {t[key]:.4f} ms")
    for dt in ("f32", "bf16"):
        km = t[f"K1 {dt}"]
        lines += [
            f"K1 ({dt} storage):{'':<23} {km:.4f} ms",
            f"  K1 - P2 (memory path + recompute):    {km - fs:.4f} ms ({(km - fs) / km:.1%} of K1)",
            f"  K1 - P1 (LDG against LDS):            {km - fl:.4f} ms ({(km - fl) / km:.1%} of K1)",
            f"  P1 / K1:                              {fl / km:.1%}",
            f"  P2 <= P1 <= K1:                       {'holds' if fs <= fl <= km else 'FAILS'}",
        ]
    lines += [
        f"P1 - P2 (per-pixel recompute):           {fl - fs:.4f} ms ({(fl - fs) / fl:.1%} of P1)",
        f"ops per pixel (convention 2): P2 {stream_ops('shared'):.2f}, P1 {stream_ops('replay'):.2f}, "
        f"P1 EASU only {stream_ops('replay easu_only'):.2f}",
        f"op rate at the shared floor (P2):        {stream_ops('shared') * px / (fs * 1e-3) / 1e12:.2f} TFLOP/s "
        f"(data sheet {F32_TFLOPS:g})",
        f"op rate of P1:                           {stream_ops('replay') * px / (fl * 1e-3) / 1e12:.2f} TFLOP/s",
        f"op rate of P1 EASU only:                 "
        f"{stream_ops('replay easu_only') * px / (fe * 1e-3) / 1e12:.2f} TFLOP/s",
    ]
    return lines


def main():
    if not torch.cuda.is_available():
        print("opmix_floor: no CUDA device; the readings are device times", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    for line in report(readings()) + sass_lines(sass_counts()):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
