"""K1, K2, K3, K4 and K6 against a parent commit's on the H100, timed in turn.

    python3 tools_torch/ablation/kernel_ab.py [--parent DIR] [--source NAME=DIR ...]
                                              [--define NAME=VALUE ...] [--sections k4,k2,k1,k3,k6,k6tail]
                                              [--build-times]

Builds four kinds of kernel library, in parallel: this checkout's, the
parent's from DIR (default ``_parent``: a ``git archive`` of the parent
commit unpacked at the root of the checkout), each ``--source``'s (another
checkout's, or a step of a change, from DIR/fsr_tpu_torch/csrc, timed
under NAME), and this checkout's again with each ``--define`` (a
preprocessor variant, e.g. ``FSR_K2_TILE_H=16`` for K2's tile height,
``FSR_K1_MIN_BLOCKS=4`` for K1's register cap;
``FSR_K1_TILE_H=32,FSR_K1_TILE_W=32`` sets two macros at once).  The
package's wrappers drive every library's K1, K2, K3, K4 and K6, whose C
interfaces are the same in the parent (a parent from before the K1
redesign, whose K1 took a K4-padded source, cannot be driven; one from
before K6 is left out of K6's section).  ``--sections`` runs a subset.
``--build-times`` builds the libraries one after another instead, each
alone on the machine's cores, and prints each build's seconds and its
sources' (``_build.source_seconds``); a library already built is not
timed.

K6, the float16 upscale (batch 4 -> 4K, float16 sources): Performance,
Quality, RGBA, RCAS off and denoise, every library's output held
bit-equal to the others' and to ``easu_h_reference`` (the torch path's
float16 ops on the card), then each library's K6 timed in turn, with its
bound (74.75 float32 and 541 float16 operations per pixel, the halves at
the half2 rate; RGBA 8 float32 more) and each library's time over the
parent's.  Then float16 row strips (the Performance and Quality frames in
four strips, as ``parallel.spatial`` cuts them): each library's K6 on the
halo'd strips (K2's per-strip row tables), the libraries with K6's
strip-source form also on the strips read in place, in turn with the
unsharded K6, every output bit-equal to this tree's unsharded K6; and this
tree's K1 (Performance) and K2 (Quality, bfloat16 storage) strip forms on
the float16 frames in turn with the same strips of the frames widened to
float32, each bit-equal to its unsharded call.  Then K6 with the frame tail
(``k6tail``, the libraries that have its tail forms): the float16
configurations (a16) HDR tail, (b16) display, (c16) bytes, (d16) RGBA
display and (u16) gamma2 + 10-bit TEPD, each held to ``easu_h_reference``
(at most 1e-4 of the values one step off) and timed in turn with each
library's bare K6 on the same frames; the tail forms' ptxas lines (a
float16 source with RCAS) and their instantiations with a stack frame or
spills are printed after each library's.

K1, at the Performance shapes (batch 4, 1080p -> 4K): Performance float32
and bfloat16, the HDR tail (a) (SRTM prologue, grain, 10-bit dither), the
byte path (c) (uint8 in and out), RGBA (d) float32 and uint8, and four
row strips (i) (this tree's also read in place, the strip-source form);
per path, in turn: each library's K1 on its quad and
generic paths, K2 on the same frames (the staging-only yardstick), and
with Performance float32 this tree's K1 without RCAS and the probes P1 and
P2.  Every library's quad and generic paths and K2's output are held
against this tree's quad path (largest difference, values that differ).  K3, at 4K:
float32, bfloat16, float16 and uint8 storage, each library in turn, after
every library's output is held against this tree's on every border and
denoise setting (bit-equal expected).  Before those, as before, at the main paths'
shapes (batch 4 -> 4K):
K4 on the Performance source (float32, bfloat16, uint8 for the byte path
(c), RGBA float32 and uint8 for (d)) beside ``F.pad(mode="replicate")``,
and K2 on the Quality paths (float32; the benchmark's: uint8 in and out,
float32 storage; bfloat16; the display path (b): uint8 in, grain, 8-bit
dither, uint8 out, bfloat16 storage; RGBA bfloat16 (e)) and at 1.3x, 1.7x
and native 1x (float32), each library's kernel in turn (5 rounds,
CUDA-event medians of ``QUEUE`` calls queued back to back: device time per
call), then on four row strips of the Quality frames (halo'd, and read in
place).  Every library's output is held against this tree's: K4 bit-equal
(and to ``edge_pad_reference``); K2 bit-equal, or its largest difference
and the values that differ, the strips against this tree's unsharded
call.  Prints ms per 4K frame, each kernel's bound (bytes over 3.35 TB/s,
or K2's counted operations over 67 TFLOP/s, chip_smoke's rule), the ptxas
lines of K4, of K1, K2 and K3 with RCAS and no denoise and of K6 on
float16 sources, and the static SASS counts of K1, K2 and K3
(``opmix_floor.sass_counts``) and of K6 (its half arithmetic, packing,
MUFU and CALL, and its half instructions by lanes,
``opmix_floor.sass_tables``) for each library, with the card's name
and power limit.  Exits non-zero without a card or parent sources, when a
K4 disagrees with its plain version, when a K2 other than the parent's
differs from this tree's, when this tree's (or a variant's) K1
quad and generic paths differ from this tree's quad path, when a K3
differs from this tree's, or when a K6 is not bit-equal to its plain
version.
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
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.core.presets import render_resolution
from fsr_tpu_torch.kernels import _build, easu_gather, easu_h, fused, pad
from fsr_tpu_torch.kernels import rcas as rcas_k
from fsr_tpu_torch.kernels.epilogue import Epilogue

ROOT = pathlib.Path(__file__).resolve().parents[2]
NFRAMES = 4
OUT4K = (2160, 3840)
PERF_IN = (1080, 1920)
QUALITY_IN = (1440, 2560)
# Calls queued back to back per timing sample (profiling.cuda_time_ms): each
# call's host work overlaps the kernels before it, so a reading is the
# device time per call, the wrappers' host work left out.
QUEUE = 10
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The function's float32 ops per output pixel, as chip_smoke.py counts them
# (EASU_RCAS_OPS; LFGA_OPS + TEPD_OPS; ALPHA_OPS).
EASU_RCAS_OPS = 488.75
EPI_OPS = 12 + 60
ALPHA_OPS = 8
# K6's function per output pixel by type (chip_smoke.py's EASU_H_OPS +
# RCAS_H_OPS), the halves at the half2 rate.
K6_F32_OPS, K6_HALF_OPS = 73.75 + 1, 413 + 128
HALF2_OPS_PER_S = 134e12
# ptxas entries printed: every K4; K2 with RCAS and no denoise; K1 float32
# with no denoise (<S, T, O, QUAD, DENOISE, RGBA>), each K1 and K2 also in
# its strip-source form; K3 with the clamp border and no denoise; K6 on a
# float16 source, also in its strip-source form.
PTXAS_KERNELS = re.compile(r"edge_pad_kernel|gather_kernel(_strip)?I.*Lb1ELb0EL"
                           r"|fused_kernel(_strip)?IfffLb[01]ELb0ELb[01]EE|rcas_kernelI.*Lb0ELb0EE"
                           r"|easu_h_kernel(_strip)?I6__half")
# K6's tail forms on a float16 source with RCAS and no denoise, every output
# type, in both forms (printed apart: a parent from before them has none).
TAIL_PTXAS = re.compile(r"easu_h_kernel(_strip)?_tailI6__halfLb1ELb0ELb[01]E")
SECTIONS = ("k4", "k2", "k1", "k3", "k6", "k6tail")

# The strip-source forms' SASS, beside the whole-frame kernels' (a parent
# from before them has none).
STRIP_SASS = (("K1 f32 quad, strip", "fused_kernel_stripIfffLb1ELb0ELb0E"),
              ("K1 f32 generic, strip", "fused_kernel_stripIfffLb0ELb0ELb0E"),
              ("K2 f32, strip", "staged_gather_kernel_stripIfffLb1ELb0ELb0E"),
              ("K6 f16, strip", "easu_h_kernel_stripI6__halfLb1ELb0ELb0E"))


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


def ptxas_lines(build_dir: pathlib.Path, kernels=PTXAS_KERNELS) -> list:
    """(entry, stack line, usage line) of ``kernels`` in a build's log."""
    out, entry, stack = [], None, ""
    for line in (build_dir / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, stack = m.group(1), ""
        elif entry and "stack frame" in line:
            stack = line.strip()
        elif entry and "Used" in line:
            if kernels.search(entry):
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
    K2 calls of the Quality paths, the benchmark's (uint8 in and out,
    float32 storage, no epilogue), and the other ratios K2 serves at 4K
    (1.3x, 1.7x, native 1x; float32)."""
    con = EasuConstants.create(QUALITY_IN[::-1], None, OUT4K[::-1])
    rcon = RcasConstants(0.25)
    f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8
    x = torch.rand((NFRAMES, 3, *QUALITY_IN), generator=gen, device=dev)
    xb = x.to(bf16)
    x8 = (x * 255).to(u8)
    x4 = torch.cat([x, torch.rand((NFRAMES, 1, *QUALITY_IN), generator=gen, device=dev)], 1).to(bf16)
    grain = torch.rand((3, *OUT4K), generator=gen, device=dev) - 0.5
    epi = Epilogue(grain_amount=0.25, dither_bits=8)

    def k2(img, dt, con=con, **kw):
        return lambda: easu_gather.easu_gather(img, OUT4K, con, rcon, True, False, dt, **kw)

    cases = [("Quality f32", k2(x, f32), x, EASU_RCAS_OPS),
             ("Quality u8 (the benchmark's)", k2(x8, f32, out_dtype=u8), x8, EASU_RCAS_OPS),
             ("Quality bf16", k2(xb, bf16), xb, EASU_RCAS_OPS),
             ("(b) display u8", k2(x8, bf16, epilogue=epi, frame=7, grain=grain, out_dtype=u8), x8,
              EASU_RCAS_OPS + EPI_OPS),
             ("(e) RGBA bf16", k2(x4, bf16), x4, EASU_RCAS_OPS + ALPHA_OPS)]
    for name, ratio in (("1.3x f32", 1.3), ("1.7x f32", 1.7), ("native 1x f32", 1.0)):
        in_hw = render_resolution(OUT4K, ratio)
        xr = torch.rand((NFRAMES, 3, *in_hw), generator=gen, device=dev)
        cases.append((name, k2(xr, f32, EasuConstants.create(in_hw[::-1], None, OUT4K[::-1])), xr, EASU_RCAS_OPS))
    return cases


def k2_strips(dev, gen):
    """(name, {form: call giving the strips' outputs}, the unsharded call):
    the Quality f32 frames in four row strips, as ``parallel.spatial`` cuts
    them, on the halo'd strips and read in place."""
    from fsr_tpu_torch.parallel import spatial

    layout = spatial._layout(QUALITY_IN, OUT4K, 4, None, (0, 0))
    rcon = RcasConstants(0.25)
    x = torch.rand((NFRAMES, 3, *QUALITY_IN), generator=gen, device=dev)
    sources, strips = _four(x, layout.halo)

    def run(of):
        return lambda: [easu_gather.easu_gather(s, layout.out_hw, layout.con, rcon, True, False, torch.float32,
                                                row_plan=st.rows, row_offset=st.row0)
                        for s, st in zip(of, layout.strips)]

    return ("Quality f32, 4 strips", {"halo'd strips": run(strips), "read in place": run(sources)},
            lambda: easu_gather.easu_gather(x, OUT4K, layout.con, rcon, True, False, torch.float32))


def k1_cases(dev, gen):
    """(name, source, keywords of ``upscale_fused`` beside the storage type,
    storage type, ops per output pixel): the K1 paths at the Performance
    shapes."""
    f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8
    x = torch.rand((NFRAMES, 3, *PERF_IN), generator=gen, device=dev)
    x4 = torch.cat([x, torch.rand((NFRAMES, 1, *PERF_IN), generator=gen, device=dev)], 1)
    grain = torch.rand((3, *OUT4K), generator=gen, device=dev) - 0.5
    tail = dict(prologue="srtm", epilogue=Epilogue(grain_amount=0.3, dither_bits=10), frame=7, grain=grain)
    return [("Performance f32", x, {}, f32, EASU_RCAS_OPS),
            ("Performance bf16", x.to(bf16), {}, bf16, EASU_RCAS_OPS),
            ("(a) HDR tail", x * 16, tail, f32, EASU_RCAS_OPS + EPI_OPS),
            ("(c) u8", (x * 255).to(u8), dict(out_dtype=u8), f32, EASU_RCAS_OPS),
            ("(d) RGBA f32", x4, {}, f32, EASU_RCAS_OPS + ALPHA_OPS),
            ("(d) RGBA u8", (x4 * 255).to(u8), dict(out_dtype=u8), f32, EASU_RCAS_OPS + ALPHA_OPS)]


def k1_strips(x, con):
    """(i): the Performance frames in four row strips, as
    ``parallel.spatial`` cuts them: (halo'd strips, the same strips as
    strip sources read in place from views of the frames, as the eager call
    passes them, and from own-row buffers, as the captured call does, their
    constants, output rows per strip)."""
    from fsr_tpu_torch.parallel import spatial

    n, h = 4, x.shape[-2]
    own = [x[..., k * h // n:(k + 1) * h // n, :] for k in range(n)]
    strips = spatial._exchange_halo(own, spatial._HALO)
    lcon = spatial._local_constants(con, spatial._HALO)
    hl = OUT4K[0] // n
    buffers = [o.clone() for o in own]
    return strips, spatial._sources(own, spatial._HALO), spatial._sources(buffers, spatial._HALO), lcon, hl


def k1_section(libs, dev, gen, cname) -> bool:
    """K1's paths, each library's in turn (see the module note).  Returns
    False when this tree's or a variant's quad or generic path differs from
    this tree's quad path."""
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn
    from tools_torch.ablation import opmix_floor

    con = EasuConstants.create(PERF_IN[::-1], None, OUT4K[::-1])
    rcon = RcasConstants(0.25)
    npix = NFRAMES * OUT4K[0] * OUT4K[1]
    ok = True
    print(f"K1, ms per 4K frame (batch {NFRAMES}), in turn, 5 rounds, {QUEUE} calls queued per sample, on {cname}:")
    for what, x, kw, dt, ops in k1_cases(dev, gen):
        def new(path, kw=kw, x=x, dt=dt):
            return lambda: fused.upscale_fused(x, OUT4K, con, rcon, True, False, dt, path=path, **kw)

        fns = {}
        for name, lib in libs.items():
            fns[f"{name} quad"] = on(lib, new("auto"))
            fns[f"{name} generic"] = on(lib, new("generic"))
        fns["K2"] = on(libs["this tree"], lambda kw=kw, x=x, dt=dt: easu_gather.easu_gather(
            x, OUT4K, con, rcon, True, False, dt, **kw))
        if what == "Performance f32":
            # EASU alone (the store pass without RCAS): the RCAS pass's share.
            for name, path in (("quad", "auto"), ("generic", "generic")):
                fns[f"this tree {name}, EASU only"] = on(libs["this tree"], lambda path=path: fused.upscale_fused(
                    x, OUT4K, con, rcon, False, False, dt, path=path))
            for k, fn in opmix_floor.reading_fns(dev).items():
                if k in ("P1", "P2"):
                    fns[k] = on(libs["this tree"], fn)
        outs = {k: fns[k]() for k in fns if k not in ("P1", "P2") and "EASU only" not in k}
        ref = outs["this tree quad"]
        for k, out in outs.items():
            d = (out.float() - ref.float()).abs()
            print(f"  {what}, {k} vs this tree quad: max-abs {d.max().item():.3e}, "
                  f"{int((d > 0).sum())} of {d.numel()} values differ")
            if k.endswith((" quad", " generic")) and not k.startswith("parent") and not torch.equal(out, ref):
                ok = False
        t = cuda_times_in_turn(fns, 5, queue=QUEUE)
        nbytes = x.numel() * x.element_size() + ref.numel() * ref.element_size()
        if kw.get("grain") is not None:
            nbytes += kw["grain"].numel() * kw["grain"].element_size()
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops * npix / F32_OPS_PER_S * 1e3
        bound = f"{max(by_bytes, by_ops) / NFRAMES:.4f} ({'bytes' if by_bytes >= by_ops else 'operations'})"
        print(f"  {what}: " + ", ".join(f"{k} {v / NFRAMES:.4f}" for k, v in t.items())
              + f"; bound {bound}; this tree quad / parent quad {t['this tree quad'] / t['parent quad']:.3f}")
        del outs, ref

    # (i): four row strips of the Performance f32 frames, each library's
    # launches per strip on the halo'd strips and, where the library has
    # the strip-source form, read in place, in turn with the unsharded call.
    x = k1_cases(dev, gen)[0][1]
    strips, sources, buffers, lcon, hl = k1_strips(x, con)
    rows = dict(global_rows=OUT4K[0])

    def new_strips(path, of=strips):
        return lambda: [fused.upscale_fused(s, (hl, OUT4K[1]), lcon, rcon, path=path, row_offset=k * hl, **rows)
                        for k, s in enumerate(of)]

    fns = {}
    for name, lib in libs.items():
        fns[f"{name} quad"] = on(lib, new_strips("auto"))
        fns[f"{name} generic"] = on(lib, new_strips("generic"))
        if hasattr(lib, "fsr_upscale_fused_strip"):
            fns[f"{name} quad, read in place"] = on(lib, new_strips("auto", sources))
            fns[f"{name} generic, read in place"] = on(lib, new_strips("generic", sources))
            fns[f"{name} quad, read in place from own-row buffers"] = on(lib, new_strips("auto", buffers))
    fns["this tree unsharded"] = on(libs["this tree"], lambda: fused.upscale_fused(x, OUT4K, con, rcon))
    whole = fns["this tree unsharded"]()
    for k in list(fns)[:-1]:
        got = torch.cat(fns[k](), dim=-2)
        same = torch.equal(got, whole)
        print(f"  (i) four strips, {k}: " + ("bit-equal to this tree's unsharded call" if same else
              f"{int((got != whole).sum())} values differ from this tree's unsharded call"))
        if not k.startswith("parent") and not same:
            ok = False
    t = cuda_times_in_turn(fns, 5, queue=QUEUE)
    print("  (i) four strips: " + ", ".join(f"{k} {v / NFRAMES:.4f}" for k, v in t.items()))
    return ok


def k3_section(libs, dev, gen, cname) -> bool:
    """K3 at 4K on each storage type, each library's in turn, after every
    library's output is held against this tree's on every border and
    denoise setting.  Returns False when one differs."""
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn

    rcon = RcasConstants(0.25)
    ok = True
    x = torch.rand((NFRAMES, 3, *OUT4K), generator=gen, device=dev)
    small = torch.rand((2, 3, 67, 131), generator=gen, device=dev)
    print(f"K3, ms per 4K frame (batch {NFRAMES}), in turn, 5 rounds, {QUEUE} calls queued per sample, on {cname}:")
    for what, conv in (("f32", lambda t: t), ("bf16", lambda t: t.to(torch.bfloat16)),
                       ("f16", lambda t: t.half()), ("u8", lambda t: (t * 255).to(torch.uint8))):
        y, ys = conv(x), conv(small)
        checks = [(y, False, "clamp")] + [(ys, dn, b) for dn in (False, True) for b in ("clamp", "zero")]
        off = 0
        for img, dn, border in checks:
            ref = on(libs["this tree"], lambda: rcas_k.rcas_fused(img, rcon, dn, None, border))()
            for name, lib in libs.items():
                got = on(lib, lambda: rcas_k.rcas_fused(img, rcon, dn, None, border))()
                if not torch.equal(got, ref):
                    off += 1
                    print(f"  {what} {tuple(img.shape)} {border} denoise={dn}: {name} NOT bit-equal to this tree")
        ok = ok and off == 0
        t = cuda_times_in_turn({name: on(lib, lambda lib=lib: rcas_k.rcas_fused(y, rcon)) for name, lib in libs.items()},
                               5, queue=QUEUE)
        bound = 2 * y.numel() * y.element_size() / HBM_BYTES_PER_S * 1e3
        print(f"  {what}: " + ", ".join(f"{k} {v / NFRAMES:.4f}" for k, v in t.items())
              + f"; bound {bound / NFRAMES:.4f} (bytes); this tree / parent {t['this tree'] / t['parent']:.3f}; "
              + ("every library bit-equal to this tree on " + f"{len(checks)} border/denoise cases" if off == 0 else
                 "DIFFERS"))
    return ok


def k6_cases(dev, gen):
    """(name, float16 source, constants, apply_rcas, denoise): K6 at the
    main paths' shapes."""
    f16 = torch.float16
    pcon = EasuConstants.create(PERF_IN[::-1], None, OUT4K[::-1])
    qcon = EasuConstants.create(QUALITY_IN[::-1], None, OUT4K[::-1])
    x = torch.rand((NFRAMES, 3, *PERF_IN), generator=gen, device=dev).to(f16)
    q = torch.rand((NFRAMES, 3, *QUALITY_IN), generator=gen, device=dev).to(f16)
    x4 = torch.cat([x, torch.rand((NFRAMES, 1, *PERF_IN), generator=gen, device=dev).to(f16)], 1)
    return [("Performance f16", x, pcon, True, False), ("Quality f16", q, qcon, True, False),
            ("RGBA f16", x4, pcon, True, False), ("RCAS off f16", x, pcon, False, False),
            ("denoise f16", x, pcon, True, True)]


def k6_section(libs, dev, gen, cname) -> bool:
    """K6 on the float16 paths, each library's in turn, after every
    library's output is held bit-equal to ``easu_h_reference``.  Returns
    False when one is not."""
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn

    rcon = RcasConstants(0.25)
    libs = {k: v for k, v in libs.items() if hasattr(v, "fsr_easu_h")}
    npix = NFRAMES * OUT4K[0] * OUT4K[1]
    ok = True
    print(f"K6, ms per 4K frame (batch {NFRAMES}), in turn, 5 rounds, {QUEUE} calls queued per sample, on {cname}:")
    for what, x, con, rc, dn in k6_cases(dev, gen):
        want = easu_h.easu_h_reference(x, OUT4K, con, rcon, rc, dn).view(torch.int16)

        def call(x=x, con=con, rc=rc, dn=dn):
            return easu_h.easu_h(x, OUT4K, con, rcon, rc, dn)

        for name, lib in libs.items():
            got = on(lib, call)().view(torch.int16)
            off = int((got != want).sum())
            print(f"  {what}, {name} vs easu_h_reference: {off} of {got.numel()} values differ")
            ok = ok and off == 0
        del want, got
        t = cuda_times_in_turn({name: on(lib, call) for name, lib in libs.items()}, 5, queue=QUEUE)
        f32_ops = K6_F32_OPS + (ALPHA_OPS if x.shape[1] == 4 else 0)
        by_ops = (f32_ops / F32_OPS_PER_S + K6_HALF_OPS / HALF2_OPS_PER_S) * npix * 1e3
        by_bytes = (x.numel() + npix * x.shape[1]) * 2 / HBM_BYTES_PER_S * 1e3
        bound = max(by_ops, by_bytes)
        print(f"  {what}: " + ", ".join(f"{k} {v / NFRAMES:.4f} ({bound / v:.1%} of its bound)" for k, v in t.items())
              + f"; bound {bound / NFRAMES:.4f} ({'operations' if by_ops >= by_bytes else 'bytes'}); "
              + ", ".join(f"{k} / parent {v / t['parent']:.3f}" for k, v in t.items() if k != "parent" and "parent" in t))
    return f16_strips(libs, dev, gen, cname) and ok


def k6_tail_section(libs, dev, gen, cname) -> bool:
    """K6 with the frame tail (the libraries that have it) on the float16
    configurations at batch 4 -> 4K: (a16) the HDR tail, (b16) the display
    path, (c16) bytes, (d16) RGBA display, (u16) gamma2 + 10-bit TEPD into
    UNORM10; each held to ``easu_h_reference`` (float16 values and codes
    at most 1e-4 of them one step off), then timed in turn with every
    library's bare K6 on the same frames.  Returns False when one
    disagrees."""
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn

    f16, u8, u16 = torch.float16, torch.uint8, torch.uint16
    rcon = RcasConstants(0.25)
    pcon = EasuConstants.create(PERF_IN[::-1], None, OUT4K[::-1])
    qcon = EasuConstants.create(QUALITY_IN[::-1], None, OUT4K[::-1])
    p = torch.rand((NFRAMES, 3, *PERF_IN), generator=gen, device=dev)
    p16, p8 = p.to(f16), (p * 255).to(u8)
    q8 = (torch.rand((NFRAMES, 3, *QUALITY_IN), generator=gen, device=dev) * 255).to(u8)
    r8 = (torch.rand((NFRAMES, 4, *QUALITY_IN), generator=gen, device=dev) * 255).to(u8)
    grain = torch.rand((3, *OUT4K), generator=gen, device=dev) - 0.5
    display = dict(epilogue=Epilogue(grain_amount=0.25, dither_bits=8), grain=grain, frame=3, out_dtype=u8)
    cases = [("(a16) HDR tail, f16 1080p", p16, pcon,
              dict(prologue="srtm", epilogue=Epilogue(transform="srtm_inv", grain_amount=0.25), grain=grain)),
             ("(b16) display, u8 1440p", q8, qcon, display), ("(c16) bytes, u8 1080p", p8, pcon, dict(out_dtype=u8)),
             ("(d16) RGBA display, u8 1440p", r8, qcon, display),
             ("(u16) gamma2 + TEPD10, f16 1080p", p16, pcon,
              dict(epilogue=Epilogue(transform="gamma2", dither_bits=10), frame=3, out_dtype=u16))]
    tails = {k: v for k, v in libs.items() if hasattr(v, "fsr_easu_h_tail")}
    bare = {k: v for k, v in libs.items() if hasattr(v, "fsr_easu_h")}
    ok = True
    print(f"K6 with the frame tail, ms per 4K frame (batch {NFRAMES}), in turn with the bare K6 on the same frames, "
          f"5 rounds, {QUEUE} calls queued per sample, on {cname}:")
    for what, x, con, kw in cases:
        want = easu_h.easu_h_reference(x, OUT4K, con, rcon, **kw)

        def call(x=x, con=con, kw=kw):
            return easu_h.easu_h(x, OUT4K, con, rcon, **kw)

        for name, lib in tails.items():
            got = on(lib, call)()
            if got.dtype == f16:
                d = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
            else:
                d = (got.int() - want.int()).abs()
            off, step = int((d > 0).sum()), int(d.max())
            print(f"  {what}, {name} vs easu_h_reference: {off} of {d.numel()} values differ "
                  f"(share {off / d.numel():.2e}), largest {step} step(s)")
            ok = ok and off <= 1e-4 * d.numel() and step <= 1
        del want
        fns = {f"{name} with the tail": on(lib, call) for name, lib in tails.items()}
        fns.update({f"{name} bare": on(lib, lambda x=x, con=con: easu_h.easu_h(x, OUT4K, con, rcon))
                    for name, lib in bare.items()})
        t = cuda_times_in_turn(fns, 5, queue=QUEUE)
        print(f"  {what}: " + ", ".join(f"{k} {v / NFRAMES:.4f}" for k, v in t.items()) + "; "
              + ", ".join(f"{k} / its bare {v / t[k.replace('with the tail', 'bare')]:.3f}" for k, v in t.items()
                          if "with the tail" in k))
    return ok


def _four(x, halo):
    """Frames x in four row strips as ``parallel.spatial`` cuts them: (strip
    sources read in place from views of the frames, the halo'd strips)."""
    from fsr_tpu_torch.parallel import spatial

    h = x.shape[-2] // 4
    own = [x[..., k * h:(k + 1) * h, :] for k in range(4)]
    return spatial._sources(own, halo), spatial._exchange_halo(own, halo)


def f16_strips(libs, dev, gen, cname) -> bool:
    """The float16 row strips of the module note, each reading in turn (5
    rounds).  Returns False when a strip differs from its unsharded call."""
    from fsr_tpu_torch.parallel import spatial
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn

    rcon = RcasConstants(0.25)
    here = libs["this tree"]
    ok = True

    def check(what, fns, want):
        nonlocal ok
        for k, fn in fns.items():
            same = torch.equal(torch.cat(fn(), dim=-2), want)
            ok = ok and same
            print(f"  {what}, {k}: " + ("bit-equal to this tree's unsharded call" if same else "DIFFERS"))
        t = cuda_times_in_turn(fns, 5, queue=QUEUE)
        print(f"  {what}: " + ", ".join(f"{k} {v / NFRAMES:.4f}" for k, v in t.items()))

    print(f"float16 row strips, 4 strips, ms per 4K frame (batch {NFRAMES}), in turn, 5 rounds, {QUEUE} calls queued "
          f"per sample, on {cname}:")
    for what, x, con, _, _ in k6_cases(dev, gen)[:2]:
        layout = spatial._layout(tuple(x.shape[-2:]), OUT4K, 4, None, (0, 0))
        sources, strips = _four(x, layout.halo)

        def k6(of):
            return lambda: [easu_h.easu_h(s, layout.out_hw, layout.con, rcon, row_plan=st.rows)
                            for s, st in zip(of, layout.strips)]

        fns = {}
        for name, lib in libs.items():
            if hasattr(lib, "fsr_easu_h"):
                fns[f"{name} K6 unsharded"] = on(lib, lambda x=x, con=con: [easu_h.easu_h(x, OUT4K, con, rcon)])
                fns[f"{name} K6 x4 halo'd strips"] = on(lib, k6(strips))
            if hasattr(lib, "fsr_easu_h_strip"):
                fns[f"{name} K6 x4 strips read in place"] = on(lib, k6(sources))
        check(what, fns, on(here, lambda: easu_h.easu_h(x, OUT4K, con, rcon))())
    # K1 and K2 strip forms, float16 against float32 frames (this tree).
    bf16 = torch.bfloat16
    for what, in_hw, dt in (("Performance, K1", PERF_IN, torch.float32), ("Quality, K2 bf16", QUALITY_IN, bf16)):
        layout = spatial._layout(in_hw, OUT4K, 4, None, (0, 0))
        x16 = torch.rand((NFRAMES, 3, *in_hw), generator=gen, device=dev).half()
        fns = {}
        for src, x in (("float16 source", x16), ("float32 source", x16.float())):
            sources, _ = _four(x, layout.halo)

            def strips(sources=sources):
                if layout.strips[0].local_con is not None:
                    return [fused.upscale_fused(s, layout.out_hw, st.local_con, rcon, row_offset=st.row0,
                                                global_rows=OUT4K[0]) for s, st in zip(sources, layout.strips)]
                return [easu_gather.easu_gather(s, layout.out_hw, layout.con, rcon, True, False, dt, row_plan=st.rows,
                                                row_offset=st.row0) for s, st in zip(sources, layout.strips)]

            fns[f"this tree x4 strips read in place, {src}"] = on(here, strips)
        k1 = layout.strips[0].local_con is not None
        whole = (lambda: fused.upscale_fused(x16, OUT4K, layout.con, rcon)) if k1 else \
            (lambda: easu_gather.easu_gather(x16, OUT4K, layout.con, rcon, True, False, dt))
        fns["this tree unsharded, float16 source"] = on(here, lambda: [whole()])
        check(what, fns, on(here, whole)())
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=str(ROOT / "_parent"),
                        help="root of the parent commit's checkout (default _parent)")
    parser.add_argument("--source", action="append", default=[],
                        help="NAME=DIR: another checkout's kernels (DIR/fsr_tpu_torch/csrc) to build and time "
                             "beside this tree's under NAME (repeatable)")
    parser.add_argument("--sections", default=",".join(SECTIONS),
                        help=f"the sections to run, comma-separated (default {','.join(SECTIONS)})")
    parser.add_argument("--define", action="append", default=[],
                        help="a -D variant of this tree's kernels to time beside them (repeatable; "
                             "NAME=VALUE,NAME=VALUE for several macros in one variant)")
    parser.add_argument("--build-times", action="store_true",
                        help="build the libraries one after another and print each build's seconds (the default "
                             "builds them all at once)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; the readings are device times", file=sys.stderr)
        return 1
    from tools_torch.ablation import opmix_floor

    parent = pathlib.Path(args.parent).resolve() / "fsr_tpu_torch" / "csrc"
    if not parent.is_dir():
        print(f"kernel_ab: no parent sources at {parent}", file=sys.stderr)
        return 1
    here = ROOT / "fsr_tpu_torch" / "csrc"
    builds = {"this tree": (here, _build.NVCC_FLAGS), "parent": (parent, _build.NVCC_FLAGS)}
    for spec in args.source:
        name, _, path = spec.partition("=")
        csrc = pathlib.Path(path).resolve() / "fsr_tpu_torch" / "csrc"
        if not name or not csrc.is_dir():
            print(f"kernel_ab: no sources at {csrc} for --source {spec!r}", file=sys.stderr)
            return 1
        builds[name] = (csrc, _build.NVCC_FLAGS)
    sections = set(args.sections.split(","))
    if not sections <= set(SECTIONS):
        print(f"kernel_ab: unknown sections {sorted(sections - set(SECTIONS))}", file=sys.stderr)
        return 1
    for d in args.define:
        builds[d] = (here, _build.NVCC_FLAGS + tuple(f"-D{x}" for x in d.split(",")))
    if args.build_times:
        # One library at a time, each nvcc of a build on the machine's cores
        # alone: the build's wall time and its slowest sources.
        libs = {}
        for name, (csrc, flags) in builds.items():
            fresh = not _build.library_path(csrc, flags).exists()
            t0 = time.perf_counter()
            libs[name] = _build.load(csrc, flags)
            print(f"build, {name}: " + (f"{time.perf_counter() - t0:.1f} s; nvcc seconds per source: "
                                        f"{_build.source_seconds(_build.build_dir(csrc, flags))}" if fresh
                                        else "already built, not timed"))
    else:
        with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
            libs = dict(zip(builds, pool.map(lambda b: _build.load(*b), builds.values())))
    cname = card()
    print(f"card: {cname}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for name, (csrc, flags) in builds.items():
        print(f"ptxas, {name} ({_build.build_dir(csrc, flags).name}):")
        for line in ptxas_lines(_build.build_dir(csrc, flags)):
            print("  " + line)
        tails = ptxas_lines(_build.build_dir(csrc, flags), re.compile(r"easu_h_kernel(_strip)?_tailI"))
        if tails:
            spilled = [t for t in tails if not t.split(": ", 1)[1].startswith("0 bytes stack frame, 0 bytes spill")]
            print(f"ptxas, {name}, K6's tail forms: {len(tails)} instantiations, {len(spilled)} with a stack frame or "
                  "spills; on a float16 source with RCAS:")
            for line in (t for t in tails if TAIL_PTXAS.search(t.split(":", 1)[0])):
                print("  " + line)
            for line in spilled:
                print("  spilled: " + line)

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = k2_ok = k1_ok = k3_ok = k6_ok = tail_ok = True
    if "k4" in sections:
        ok = k4_section(libs, dev, gen, cname)
    if "k2" in sections:
        k2_ok = k2_section(libs, dev, gen, cname)
    if "k1" in sections:
        k1_ok = k1_section(libs, dev, gen, cname)
    if "k3" in sections:
        k3_ok = k3_section(libs, dev, gen, cname)
    if "k6" in sections:
        k6_ok = k6_section(libs, dev, gen, cname)
    if "k6tail" in sections:
        tail_ok = k6_tail_section(libs, dev, gen, cname)

    for name, (csrc, flags) in builds.items():
        print(f"SASS (static), {name}:")
        path = _build.library_path(csrc, flags)
        counts, lanes = opmix_floor.sass_tables(path, opmix_floor.SASS_KERNELS + STRIP_SASS)
        for line in opmix_floor.sass_lines({k: v for k, v in counts.items() if k.startswith(("K1", "K2", "K3"))}):
            print("  " + line)
        k6s = {k: v for k, v in counts.items() if k.startswith("K6")}
        if k6s:
            for line in opmix_floor.sass_lines(k6s, opmix_floor.HALF_SASS_OPS):
                print("  " + line)
            for k in k6s:
                print(f"  {k} half arithmetic ({'/'.join(opmix_floor.HALF_ARITH)}): {lanes[k]['two lanes']} on two "
                      f"lanes, {lanes[k]['one lane']} on one")
    print(cname)
    for good, what in ((ok, "K4 disagrees with its plain version"), (k2_ok, "a K2 differs from this tree's"),
                       (k1_ok, "K1's quad and generic paths differ"),
                       (k3_ok, "a K3 differs from this tree's"), (k6_ok, "a K6 is not bit-equal to its plain version"),
                       (tail_ok, "K6 with the frame tail disagrees with its plain version")):
        if not good:
            print(f"kernel_ab: {what}", file=sys.stderr)
    return 0 if ok and k2_ok and k1_ok and k3_ok and k6_ok and tail_ok else 1


def k4_section(libs, dev, gen, cname) -> bool:
    """K4 on the Performance sources, each library's in turn, beside
    ``F.pad``.  Returns False when a K4 is not bit-equal to its plain
    version."""
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn

    ok = True
    print(f"K4, ms per 4K frame (batch {NFRAMES}), in turn, 5 rounds, {QUEUE} calls queued per sample, on {cname}:")
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
        t = cuda_times_in_turn(fns, 5, queue=QUEUE)
        bound = (x.numel() * x.element_size() + want.numel() * want.element_size()) / HBM_BYTES_PER_S * 1e3
        print(f"  {what}: " + ", ".join(f"{k} {v / NFRAMES:.4f}" for k, v in t.items())
              + f"; bound {bound / NFRAMES:.4f} (bytes)")
        del want
    return ok


def k2_section(libs, dev, gen, cname) -> bool:
    """K2 on the Quality paths and the other ratios, each library's in turn,
    every output held against this tree's, then four row strips of the
    Quality frames against this tree's unsharded call.  Returns False when
    a library other than the parent differs from this tree."""
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn

    ok = True
    print(f"K2, ms per 4K frame (batch {NFRAMES}), in turn, 5 rounds, {QUEUE} calls queued per sample, on {cname}:")
    npix = NFRAMES * OUT4K[0] * OUT4K[1]
    for what, call, x, ops in k2_cases(dev, gen):
        ref = on(libs["this tree"], call)()
        for name, lib in libs.items():
            got = on(lib, call)()
            d = (got.float() - ref.float()).abs()
            off = int((d > 0).sum())
            print(f"  {what}, {name} vs this tree: " + ("bit-equal" if torch.equal(got, ref) else
                  f"max-abs {d.max().item():.3e}, {off} of {d.numel()} values differ"))
            ok = ok and (name == "parent" or torch.equal(got, ref))
        t = cuda_times_in_turn({name: on(lib, call) for name, lib in libs.items()}, 5, queue=QUEUE)
        nbytes = x.numel() * x.element_size() + ref.numel() * ref.element_size()
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops * npix / F32_OPS_PER_S * 1e3
        bound = f"{max(by_bytes, by_ops) / NFRAMES:.4f} ({'bytes' if by_bytes >= by_ops else 'operations'})"
        print(f"  {what}: " + ", ".join(f"{k} {v / NFRAMES:.4f}" for k, v in t.items())
              + f"; bound {bound}; this tree / parent {t['this tree'] / t['parent']:.3f}")
        del ref
    what, forms, whole = k2_strips(dev, gen)
    want = on(libs["this tree"], whole)()
    fns = {}
    for name, lib in libs.items():
        for form, call in forms.items():
            if form == "read in place" and not hasattr(lib, "fsr_easu_gather_strip"):
                continue
            fns[f"{name} {form}"] = on(lib, call)
            same = torch.equal(torch.cat(fns[f"{name} {form}"](), dim=-2), want)
            print(f"  {what}, {name} {form}: " + ("bit-equal to this tree's unsharded call" if same else "DIFFERS"))
            ok = ok and (name == "parent" or same)
    fns["this tree unsharded"] = on(libs["this tree"], whole)
    t = cuda_times_in_turn(fns, 5, queue=QUEUE)
    print(f"  {what}: " + ", ".join(f"{k} {v / NFRAMES:.4f}" for k, v in t.items()))
    return ok


if __name__ == "__main__":
    raise SystemExit(main())
