"""K1's time by stage on the H100: the quad path with one stage knocked out.

    python3 tools_torch/ablation/fused_stage_ablation.py

Counterpart of ``tools/ablation/fused_stage_ablation.py``, mode for mode.
The JAX tool knocks a stage out through ``easu_math._ABLATION_STAGES``; here
each mode is a build of this checkout's kernels with one ``FSR_ABL_*``
macro (``csrc/fsr_pixel.cuh:ABLATION_MASK``), which replaces the stage with
a cheap stand-in that depends on the data, so that nvcc cannot drop the
stages upstream of it.  The output is WRONG under every mode: this
attributes device time to stages, it does not validate.  "norcas" builds
nothing: it is the production kernel with ``apply_rcas=False``.

Every variant is built in parallel (``_build.load`` with the macro, as
``kernel_ab.py --define`` builds, without the sources of ``KNOCKOUT_SKIP``:
no knockout reading launches a strip form or K6), and each library must report exactly its
own macro in ``fsr_ablation_mask()`` (a misspelt ``-D`` would build the
production kernel); the production library must report none.  Then, on
the JAX tool's frames (1080p -> 4K, float32 source under bfloat16 storage,
RCAS at sharpness 0.25), here a batch of ``kernel_ab.NFRAMES``: each mode's
output against production's (its largest difference must be > 0, or the
knockout did nothing); production and every mode timed in turn
(``cuda_times_in_turn``, ``kernel_ab.QUEUE`` calls queued per sample:
device time), ms per 4K frame and the difference from production; and the
static SASS counts of the timed kernel (K1's quad path, bfloat16 storage)
beside production's (``opmix_floor.sass_counts``), so the reader sees what
math is left.  Exits non-zero without a card, when a build fails, when a
mask is wrong or when a knockout changes nothing.

``build`` and ``sweep`` serve ``gather_ablation.py`` and ``chip_smoke.py``
too.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import _build, fused
from tools_torch.ablation import kernel_ab

# (name, as the JAX tool's MODES; what it removes; macro, or None for the
# production build; RCAS applied).
MODES = [
    ("", "full kernel (baseline)", None, True),
    ("set", "the four texel responses (their lumas stand in)", "FSR_ABL_K1_SET", True),
    ("norm", "direction normalisation, stretch and lobe chain", "FSR_ABL_K1_NORM", True),
    ("weights", "per-tap d2 + weight polynomial (accumulation FMAs kept)", "FSR_ABL_K1_WEIGHTS", True),
    ("poly", "per-tap weight polynomial (d2 kept)", "FSR_ABL_K1_POLY", True),
    ("dering", "min/max dering clamp", "FSR_ABL_K1_DERING", True),
    ("rcaslimit", "RCAS limiter (resolve kept)", "FSR_ABL_RCASLIMIT", True),
    ("norcas", "the RCAS pass (apply_rcas=False, no build)", None, False),
]
IN_HW, OUT_HW = (1080, 1920), (2160, 3840)
# The timed kernel in cuobjdump's listing: K1 <float source, bfloat16
# storage and output, quad path, no denoise, RGB>.
SASS_KERNEL = r"fused_kernelIf13__nv_bfloat16S\w*?_Lb1ELb0ELb0EE"


def check_mask(lib, macro) -> None:
    """Raise unless ``lib`` was built with exactly ``macro`` (None: none)."""
    got, want = _build.ablation_mask(lib), frozenset([macro] if macro else [])
    if got != want:
        raise RuntimeError(f"library reports the knockouts {sorted(got)}, expected {sorted(want)}")


# A knockout library's sources left out: the strip-source forms and K6,
# which no knockout reading launches (the whole-frame K1 and K2 are timed).
KNOCKOUT_SKIP = ("easu_gather_strip.cu", "easu_h.cu", "easu_h_strip.cu", "fused_strip.cu")


def build(macros) -> tuple:
    """({macro: library}, {macro: build seconds}): this checkout's kernels
    (but ``KNOCKOUT_SKIP``) built once per macro, all in parallel, each
    checked by its mask."""
    here = kernel_ab.ROOT / "fsr_tpu_torch" / "csrc"

    def one(macro):
        t0 = time.perf_counter()
        lib = _build.load(here, _build.NVCC_FLAGS + (f"-D{macro}",), KNOCKOUT_SKIP)
        return lib, time.perf_counter() - t0

    macros = list(macros)
    with concurrent.futures.ThreadPoolExecutor(max(len(macros), 1)) as pool:
        done = dict(zip(macros, pool.map(one, macros)))
    libs = {m: lib for m, (lib, _) in done.items()}
    for m, lib in libs.items():
        check_mask(lib, m)
    return libs, {m: s for m, (_, s) in done.items()}


def sass_path(macro):
    here = kernel_ab.ROOT / "fsr_tpu_torch" / "csrc"
    if macro is None:
        return _build.library_path(here)
    return _build.library_path(here, _build.NVCC_FLAGS + (f"-D{macro}",), KNOCKOUT_SKIP)


def sweep(modes, call, sass_kernel, nframes, cname) -> bool:
    """Build, check, time and count ``modes`` (``MODES``' form), each mode's
    output ``call(apply_rcas)`` under its library; print one line per mode.
    ``sass_kernel(apply_rcas)`` is the timed kernel's pattern in the
    listing.  Returns False when a knockout leaves the output as it was."""
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn
    from tools_torch.ablation import opmix_floor

    prod = _build.library()
    check_mask(prod, None)
    libs, secs = build(m for _, _, m, _ in modes if m)
    print(f"built {len(libs)} knockout libraries in parallel: "
          + ", ".join(f"{m} {s:.1f} s" for m, s in secs.items()))
    fns, outs = {}, {}
    for name, _, macro, rcas in modes:
        fns[name or "base"] = kernel_ab.on(libs[macro] if macro else prod, lambda rcas=rcas: call(rcas))
    for k, fn in fns.items():
        outs[k] = fn()
    torch.cuda.synchronize()
    dev = {k: (o.float() - outs["base"].float()).abs().max().item() for k, o in outs.items()}
    del outs
    t = cuda_times_in_turn(fns, 5, queue=kernel_ab.QUEUE)
    sass = {}
    for name, _, macro, rcas in modes:
        label = name or "base"
        counts = opmix_floor.sass_counts(sass_path(macro), [(label, sass_kernel(rcas))])
        if label not in counts:
            raise RuntimeError(f"{label}: no kernel matching {sass_kernel(rcas)} in the listing")
        sass[label] = counts[label]
    base = t["base"] / nframes
    print(f"ms per 4K frame (batch {nframes}), in turn, 5 rounds, {kernel_ab.QUEUE} calls queued per sample, "
          f"on {cname}:")
    ok = True
    for name, desc, macro, _ in modes:
        label = name or "base"
        ms = t[label] / nframes
        if name:
            print(f"{name:>10}: {ms:.4f} ms  ({ms - base:+.4f} vs base)  max-abs vs base {dev[label]:.3e}  ({desc})")
            ok = ok and dev[label] > 0.0
        else:
            print(f"{'base':>10}: {ms:.4f} ms  ({desc})")
    print("SASS (static) of the timed kernel:")
    for line in opmix_floor.sass_lines(sass):
        print("  " + line)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_stage_ablation: no CUDA device; the readings are device times", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    cname = kernel_ab.card()
    con = EasuConstants.create(IN_HW[::-1], None, OUT_HW[::-1])
    rcon = RcasConstants(0.25)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((kernel_ab.NFRAMES, 3, *IN_HW), generator=gen, device=dev)

    def call(rcas):
        return fused.upscale_fused(x, OUT_HW, con, rcon, rcas, False, torch.bfloat16)

    print(f"K1 by stage: 1080p -> 4K, float32 source, bfloat16 storage; card {cname}")
    ok = sweep(MODES, call, lambda rcas: SASS_KERNEL, kernel_ab.NFRAMES, cname)
    print(cname)
    if not ok:
        print("fused_stage_ablation: a knockout left the output as it was", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
