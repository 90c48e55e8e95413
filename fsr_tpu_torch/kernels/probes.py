"""P1-P4: the measurement probes (CUDA kernels, ``csrc/probes.cu``).

Counterparts of the JAX package's probe tools, each measuring on the card
what its TPU tool measures:

- ``opmix_replay`` (P1, ``tools/ablation/opmix_floor.py:replay_ms``): K1's
  math stream over one tile's padded operand held in shared memory, on K1's
  grid, with no global tap loads.  ``rcas=False`` is the EASU-only reading.
- ``opmix_replay_shared`` (P2, ``opmix_floor.py:replay_shared_ms``): the
  same with the luma and texel responses computed once per texel of the
  block's source window: the fewest operations of K1's math.
- ``fma_rate`` (P3, ``tools/ablation/fused_roofline.py:vpu_rate_teops``):
  independent FMA chains in float32 or half2, the achieved FMA rate.
- ``fp16_probe`` (P4, ``tools/ablation/fp16_probe.py``): float16 load,
  FMA chain and store.

Each wrapper launches its kernel for a CUDA tensor (and counts the launch
in ``.launches``) or raises; a CPU tensor runs the plain version:
``fused.upscale_padded_reference`` for P1 and P2 (every block computes the
one tile K1 computes for the tiny frame), the recurrence in torch for P3,
the three modes in torch for P4 (float16 arithmetic as the float32 result
rounded once to float16 per step).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from fsr_tpu_torch.kernels import fused
from fsr_tpu_torch.kernels import pad

__all__ = [
    "TILE",
    "HEADLINE_GRID",
    "CHAIN",
    "window",
    "opmix_replay",
    "opmix_replay_shared",
    "fma_rate",
    "fma_rate_reference",
    "fp16_probe",
    "fp16_probe_reference",
]

# One K1 tile, (TILE_H, TILE_W) of csrc/fsr_pixel.cuh: the replays' output.
TILE = (16, 32)
# K1's grid for a batch-4 1080p -> 4K call: (3840 / 32, 2160 / 16, 4) blocks.
HEADLINE_GRID = (120, 135, 4)
# P3's chain length; the start scales and the multiplier of the JAX probe
# (fused_roofline.py:125-127): chain c starts at a * (1 + 1e-7 c).
CHAIN = 64
FMA_MULTIPLIER = 1.0000001
FMA_SCALES = tuple(1.0 + 1e-7 * c for c in range(8))
_GRID_MAX = 65535


def _cuda_or_cpu(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on any other."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} takes a CPU or CUDA tensor, got {x.device}")
    return x.device.type == "cuda"


def _library():
    from fsr_tpu_torch.kernels import _build

    return _build.library()


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_err(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _check_operand(operand: torch.Tensor, fplan: fused.FusedPlan, grid, what: str) -> bool:
    cuda = _cuda_or_cpu(operand, what)
    if operand.dtype != torch.float32:
        raise TypeError(f"{what} takes a float32 operand, got {operand.dtype}")
    if operand.dim() != 3 or operand.shape[0] != 3 or not operand.is_contiguous():
        raise ValueError(f"{what} needs a contiguous (3, Hp, Wp) operand, got {tuple(operand.shape)}")
    hp, wp = operand.shape[1:]
    if not (fused._covers(fplan.qy, fplan.ry, 0, TILE[0] - 1, hp)
            and fused._covers(fplan.qx, fplan.rx, 0, TILE[1] - 1, wp)):
        raise ValueError(f"{what}: the operand does not cover the plan's tap reach for one tile")
    if len(grid) != 3 or min(grid) < 1 or max(grid[1:]) > _GRID_MAX:
        raise ValueError(f"{what}: grid must be three block counts, y and z at most {_GRID_MAX}, got {grid}")
    return cuda


def _plan_args(fplan: fused.FusedPlan):
    return ((ctypes.c_int * 4)(*fplan.ry), (ctypes.c_int * 4)(*fplan.rx),
            (ctypes.c_float * 4)(*fplan.py), (ctypes.c_float * 4)(*fplan.px))


def window(fplan: fused.FusedPlan) -> Tuple[int, int, int, int]:
    """P2's source window (r0, c0, rows, cols) in the padded operand: the
    texels the taps of one tile and its clamped ring reach (rows 0 .. TILE_H
    - 1, columns 0 .. TILE_W - 1 after the clamp)."""

    def axis(q, r, n):
        f = fused._taps(q, r, np.arange(n))
        return int(f.min()) - 1, int(f.max() - f.min()) + 4

    r0, rows = axis(fplan.qy, fplan.ry, TILE[0])
    c0, cols = axis(fplan.qx, fplan.rx, TILE[1])
    return r0, c0, rows, cols


def _replay(operand, fplan, sharp, rcas, grid, shared, what):
    cuda = _check_operand(operand, fplan, grid, what)
    if not cuda:
        return fused.upscale_padded_reference(operand, fplan, TILE, sharp, rcas)
    out = torch.empty((3, *TILE), dtype=torch.float32, device=operand.device)
    lib = _library()
    hp, wp = operand.shape[1:]
    head = (operand.data_ptr(), out.data_ptr(), hp, wp, TILE[0], TILE[1], fplan.qy, fplan.qx,
            *_plan_args(fplan), float(sharp))
    with torch.cuda.device(operand.device):
        if shared:
            win = (ctypes.c_int * 4)(*window(fplan))
            err = lib.fsr_opmix_replay_shared(*head, win, *grid, _stream(operand))
        else:
            err = lib.fsr_opmix_replay(*head, int(rcas), *grid, _stream(operand))
    _check_err(err, what)
    return out


def opmix_replay(operand: torch.Tensor, fplan: fused.FusedPlan, sharp: float, rcas: bool = True,
                 grid=HEADLINE_GRID) -> torch.Tensor:
    """P1: K1's math stream for one tile, on a grid of ``grid`` (x, y, z)
    blocks that each compute the tile from ``operand`` (the K4-padded
    (3, Hp, Wp) float32 source of a one-tile frame, ``fplan`` its K1 plan)
    held in shared memory.  Returns the (3, 16, 32) float32 tile, EASU+RCAS
    (``rcas=False``: EASU only), as block (0, 0, 0) stores it."""
    out = _replay(operand, fplan, sharp, rcas, grid, False, "opmix_replay")
    if operand.device.type == "cuda":
        opmix_replay.launches += 1
    return out


def opmix_replay_shared(operand: torch.Tensor, fplan: fused.FusedPlan, sharp: float,
                        grid=HEADLINE_GRID) -> torch.Tensor:
    """P2: as ``opmix_replay`` with RCAS, with the luma and the texel
    responses computed once per texel of the block's source window
    (``window``) in shared memory: the fewest operations of K1's math."""
    out = _replay(operand, fplan, sharp, True, grid, True, "opmix_replay_shared")
    if operand.device.type == "cuda":
        opmix_replay_shared.launches += 1
    return out


opmix_replay.launches = 0
opmix_replay_shared.launches = 0


def fma_rate_reference(x: torch.Tensor, dtype=torch.float32, chains: int = 4) -> torch.Tensor:
    """Plain version of P3: ``chains`` chains per element of ``x`` rounded to
    ``dtype``, chain c from a * s[c], then ``CHAIN - 1`` steps acc * m + a,
    summed over the chains in order (fused_roofline.py:124-131).  float32
    rounds the product and the sum apart; float16 rounds each step once,
    from float32 (which holds the float16 products and these sums)."""
    if dtype == torch.float32:
        def fma(b, c, d):
            return b * c + d
    else:
        def fma(b, c, d):
            return (b.float() * c.float() + d.float()).to(dtype)

    def const(v):
        return torch.tensor(v, dtype=dtype, device=x.device)

    a = x.to(dtype)
    zero, one, m = const(0.0), const(1.0), const(FMA_MULTIPLIER)
    accs = [fma(a, const(s), zero) for s in FMA_SCALES[:chains]]
    for _ in range(CHAIN - 1):
        accs = [fma(acc, m, a) for acc in accs]
    out = accs[0]
    for acc in accs[1:]:
        out = fma(out, one, acc)
    return out


def fma_rate(x: torch.Tensor, dtype=torch.float32, chains: int = 4, reps: int = 1) -> torch.Tensor:
    """P3: ``chains`` (4 or 8) independent FMA chains of ``CHAIN`` per
    element of the float32 tensor ``x``, in ``dtype``: float32 (``fmaf``) or
    float16 (``__hfma2`` on pairs of ``x`` rounded to float16; an even
    element count).  ``reps`` repeats the whole grid (each repeat stores the
    same values).  Returns the per-element sums over the chains in
    ``dtype``, shaped as ``x``."""
    cuda = _cuda_or_cpu(x, "fma_rate")
    if x.dtype != torch.float32:
        raise TypeError(f"fma_rate takes float32 values, got {x.dtype}")
    if dtype not in (torch.float32, torch.float16):
        raise TypeError(f"fma_rate runs float32 or float16 arithmetic, got {dtype}")
    if chains not in (4, 8):
        raise ValueError(f"fma_rate runs 4 or 8 chains, got {chains}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("fma_rate needs a contiguous, non-empty tensor")
    if dtype == torch.float16 and x.numel() % 2:
        raise ValueError("fma_rate in float16 takes pairs: an even element count")
    if not 1 <= reps <= _GRID_MAX:
        raise ValueError(f"reps must be in 1..{_GRID_MAX}, got {reps}")
    if not cuda:
        return fma_rate_reference(x, dtype, chains)
    xs = x.to(dtype)
    out = torch.empty_like(xs)
    n = xs.numel() // (1 if dtype == torch.float32 else 2)
    if n >= 2 ** 31:
        raise ValueError("fma_rate takes fewer than 2**31 elements")
    scales = (ctypes.c_float * 8)(*FMA_SCALES)
    with torch.cuda.device(x.device):
        err = _library().fsr_fma_rate(xs.data_ptr(), out.data_ptr(), pad.DTYPE_CODES[dtype], n, chains,
                                      reps, FMA_MULTIPLIER, scales, _stream(x))
    _check_err(err, "fma_rate")
    fma_rate.launches += 1
    return out


fma_rate.launches = 0

FP16_MODES = ("f16 load -> f32 x 2", "f16 FMA chain -> f32", "f32 x 0.5 -> f16 store")


def fp16_probe_reference(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Plain version of P4 (fp16_probe.py:55-66): mode 0 x * 2 in float32;
    mode 1 acc = x, then 8 steps acc * x + 0.125, each the float32 result
    rounded once to float16, as float32; mode 2 x * 0.5 as float16."""
    xf = x.float()
    if mode == 0:
        return xf * 2.0
    if mode == 1:
        acc = x
        for _ in range(8):
            acc = (acc.float() * xf + 0.125).half()
        return acc.float()
    return (xf * 0.5).half()


def fp16_probe(x: torch.Tensor, mode: int) -> torch.Tensor:
    """P4: mode 0, 1 or 2 (``FP16_MODES``) on the float16 tensor ``x``:
    float32 out for modes 0 and 1, float16 for mode 2."""
    cuda = _cuda_or_cpu(x, "fp16_probe")
    if x.dtype != torch.float16:
        raise TypeError(f"fp16_probe takes float16, got {x.dtype}")
    if mode not in (0, 1, 2):
        raise ValueError(f"fp16_probe mode is 0, 1 or 2, got {mode}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("fp16_probe needs a contiguous, non-empty tensor")
    if not cuda:
        return fp16_probe_reference(x, mode)
    out = torch.empty(x.shape, dtype=torch.float16 if mode == 2 else torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().fsr_fp16_probe(x.data_ptr(), out.data_ptr(), x.numel(), mode, _stream(x))
    _check_err(err, "fp16_probe")
    fp16_probe.launches += 1
    return out


fp16_probe.launches = 0
