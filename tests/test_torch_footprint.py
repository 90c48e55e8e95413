"""K2's per-block source footprint (``kernels/easu_gather.py:footprint``,
the rule of ``csrc/easu_gather.cu:stage``) on the port's own plans, on the
CPU.

The kernel stages, per block, the source rectangle from the first ring
pixel's first tap to the last ring pixel's last tap, which bounds every tap
of the block only because the tables are non-decreasing.  For every block
of every plan below, every tap row and column of every tile and ring pixel
must lie inside the block's footprint, and the footprint must fit the
kernel's compile-time maximum: the presets 1.3x/1.5x/1.7x/2x/1x, DRS
viewports and offsets, odd and ragged extents, and row strips of
``shard_plan`` for n = 2, 3, 4.  The device rule is written out here once
more, block by block, and ``footprint`` must agree with it.

Also: the build module's other trees and flags (``_build.load``'s
directories), the SASS labels that keep K2's two designs apart, and the
parent A/B tool's host parts (``tools_torch/ablation/kernel_ab.py``).
"""

import numpy as np
import pytest
import torch

from fsr_tpu_torch.core.constants import EasuConstants
from fsr_tpu_torch.core.presets import PRESETS, render_resolution
from fsr_tpu_torch.kernels import _build
from fsr_tpu_torch.kernels import easu_gather as tgather
from fsr_tpu_torch.parallel import spatial
from tools_torch.ablation import kernel_ab, opmix_floor

TH, TW = tgather.TILE


def _con(in_hw, out_hw, viewport=None, offset=(0, 0)):
    vp = viewport or in_hw
    return EasuConstants.create((vp[1], vp[0]), (in_hw[1], in_hw[0]), (out_hw[1], out_hw[0]),
                                (offset[1], offset[0]))


def _preset_cases():
    cases = []
    for display in ((1080, 1920), (540, 960)):
        for name, p in PRESETS.items():
            cases.append((f"{name} {display}", render_resolution(display, p.scale), display, None, (0, 0)))
    return cases


# (id, input (h, w), output (h, w), viewport, offset)
PLANS = _preset_cases() + [
    ("DRS viewport + offset", (96, 160), (128, 256), (64, 120), (8, 16)),
    ("DRS 1.5x offset", (400, 700), (540, 960), (360, 640), (8, 16)),
    ("DRS offset, no viewport", (96, 144), (132, 192), None, (2, 3)),
    ("ragged ~1.7x", (64, 114), (108, 192), None, (0, 0)),
    ("2x odd width", (270, 480), (540, 961), None, (0, 0)),
    ("4x tiny", (5, 7), (20, 28), None, (0, 0)),
    ("1.3x wide", (100, 300), (130, 390), None, (0, 0)),
]

# (id, input, output, strips n): row strips, as phase 18 of chip_smoke.py
# and parallel.spatial cut them.
STRIPS = [(f"{what} sp={n}", in_hw, out_hw, n)
          for what, in_hw, out_hw in (("1.5x", (144, 240), (216, 360)), ("1.3x", (120, 130), (156, 169)),
                                      ("~1.7x", (84, 130), (144, 221)), ("quality 1080p", (720, 1280), (1080, 1920)))
          for n in (2, 3, 4)]


def _device_rule(gplan):
    """csrc/easu_gather.cu:stage, block by block: (r0, r1) per block row and
    (c0, c1) per block column."""
    hout, wout = gplan.rows.shape[1] - 2, gplan.cols.shape[1]
    rows = lambda k, y: int(gplan.rows[k][y + 1])  # the row tables start at output row -1
    rr = [(rows(0, y0 - 1), rows(3, min(y0 + TH, hout))) for y0 in range(0, hout, TH)]
    cc = [(int(gplan.cols[0][max(x0 - 1, 0)]), int(gplan.cols[3][min(x0 + TW, wout - 1)]))
          for x0 in range(0, wout, TW)]
    return rr, cc


def _check(gplan):
    hout, wout = gplan.rows.shape[1] - 2, gplan.cols.shape[1]
    # The tables are non-decreasing in the output coordinate and the tap.
    for t in (gplan.rows, gplan.cols):
        assert (np.diff(t, axis=1) >= 0).all() and (np.diff(t, axis=0) >= 0).all()
    rr, cc = _device_rule(gplan)
    fp = tgather.footprint(gplan)
    np.testing.assert_array_equal(fp.r0, [a for a, _ in rr])
    np.testing.assert_array_equal(fp.h, [b - a + 1 for a, b in rr])
    np.testing.assert_array_equal(fp.c0, [a for a, _ in cc])
    np.testing.assert_array_equal(fp.w, [b - a + 1 for a, b in cc])
    assert fp.fits
    # Every tap of every tile and ring pixel, block by block (the footprint
    # is a rectangle: a pixel's taps are its tap rows by its tap columns).
    for i, (r0, r1) in enumerate(rr):
        assert r1 - r0 + 1 <= tgather.FOOTPRINT_MAX[0]
        ys = [min(max(y, -1), hout) + 1 for y in range(i * TH - 1, i * TH + TH + 1)]
        taps = gplan.rows[:, ys]
        assert taps.min() >= r0 and taps.max() <= r1, (i, r0, r1, taps.min(), taps.max())
    for j, (c0, c1) in enumerate(cc):
        assert c1 - c0 + 1 <= tgather.FOOTPRINT_MAX[1]
        xs = [min(max(x, 0), wout - 1) for x in range(j * TW - 1, j * TW + TW + 1)]
        taps = gplan.cols[:, xs]
        assert taps.min() >= c0 and taps.max() <= c1, (j, c0, c1, taps.min(), taps.max())
    return fp


@pytest.mark.parametrize("case", PLANS, ids=lambda c: c[0])
def test_every_tap_lies_in_its_blocks_footprint(case):
    _, in_hw, out_hw, viewport, offset = case
    con = _con(in_hw, out_hw, viewport, offset)
    fp = _check(tgather.plan(in_hw, out_hw, con))
    assert tgather.supported((3, *in_hw), out_hw, con, torch.float32)
    assert fp.h.min() >= 1 and fp.w.min() >= 1


@pytest.mark.parametrize("case", STRIPS, ids=lambda c: c[0])
def test_row_strips_taps_lie_in_their_blocks_footprints(case):
    _, in_hw, out_hw, n = case
    con = _con(in_hw, out_hw)
    for k in range(n):
        gp = tgather.shard_plan(in_hw, out_hw, con, n, k, spatial._GHALO)
        assert gp.rows.shape[1] == out_hw[0] // n + 2
        _check(gp)


def test_native_1x_fills_the_maximum():
    # At 1x every output pixel has its own texel: the ring's (TH + 2) x
    # (TW + 2) pixels and their taps -1..2 are exactly FOOTPRINT_MAX.
    fp = tgather.footprint(tgather.plan((540, 960), (540, 960), _con((540, 960), (540, 960))))
    assert (fp.h.max(), fp.w.max()) == tgather.FOOTPRINT_MAX == (TH + 5, TW + 5)


def test_a_downscaling_viewport_does_not_fit():
    # The image and the output are 100 x 100, but the constants map a 200 x
    # 200 viewport onto it: two texels per pixel, a downscale.
    con = EasuConstants.create((200, 200), (100, 100), (100, 100))
    assert not tgather.footprint(tgather.plan((100, 100), (100, 100), con)).fits
    assert not tgather.supported((3, 100, 100), (100, 100), con, torch.float32)


def test_build_dirs_of_other_trees_and_flags():
    base = _build.build_dir()
    assert _build.build_dir(flags=_build.NVCC_FLAGS + ("-DFSR_K2_TILE_H=16",)) != base
    assert _build.library_path() == base / "libfsr_kernels.so"
    assert _build.library.cache_info().currsize == 0  # nothing built on the CPU


def test_knockout_builds_leave_out_only_what_exists_and_no_declared_entry():
    """The knockout libraries leave out the strip forms' and K6's sources
    (``fused_stage_ablation.KNOCKOUT_SKIP``): each named source exists, the
    build directory differs from the full build's, and every entry point
    that ``_build._declare`` declares unconditionally comes from a source
    that stays (the ones it guards with ``hasattr`` may go)."""
    import inspect
    import re

    from tools_torch.ablation import fused_stage_ablation

    skip = fused_stage_ablation.KNOCKOUT_SKIP
    names = {p.name for p in _build._sources()}
    assert set(skip) <= names
    kept = {p.name for p in _build._sources(skip=skip)}
    assert kept == names - set(skip) and any(n.endswith(".cuh") for n in kept)
    flags = _build.NVCC_FLAGS + ("-DFSR_ABL_K1_POLY",)
    assert _build.build_dir(flags=flags, skip=skip) != _build.build_dir(flags=flags)
    assert _build.build_dir(skip=()) == _build.build_dir()
    declared = inspect.getsource(_build._declare).split("# Sources from before", 1)[0]
    entries = set(re.findall(r"lib\.(fsr_\w+)\.argtypes", declared))
    assert {"fsr_upscale_fused", "fsr_easu_gather", "fsr_opmix_replay"} <= entries
    csrc = _build._CSRC
    for entry in entries:
        where = [n for n in names if n.endswith(".cu") and f"int {entry}(" in (csrc / n).read_text()]
        assert where and not set(where) & set(skip), (entry, where)


SASS_LISTING = """\
\t\tFunction : _ZN12_GLOBAL__N_120staged_gather_kernelIfffLb1ELb0ELb0EEEvPKT_PT1_NS_12GatherParamsE
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   FFMA R1, R2, R3, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_113gather_kernelIfffLb1ELb0ELb0EEEvPKT_PT1_NS_12GatherParamsE
        /*0000*/                   LDG.E.CONSTANT R1, desc[UR4][R2.64] ;
\t\tFunction : _ZN12_GLOBAL__N_120staged_gather_kernelIfffLb1ELb1ELb0EEEvPKT_PT1_NS_12GatherParamsE
        /*0000*/                   FFMA R1, R2, R3, R4 ;
"""


def test_sass_labels_keep_k2s_designs_apart():
    counts = opmix_floor.parse_sass(SASS_LISTING.splitlines(True))
    # The denoise instantiation is not counted.
    assert counts == {"K2 f32": {"LDS": 1, "FFMA": 1}, "K2 f32 per-pixel": {"LDG": 1}}


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115edge_pad_kernelIffEEvPKT_PT0_liiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115edge_pad_kernelIffEEvPKT_PT0_liiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120staged_gather_kernelIfffLb1ELb1ELb0EEEvPKT_PT1_NS_12GatherParamsE' for 'sm_90a'
ptxas info    : Used 70 registers, used 1 barriers, 20000 bytes smem, 600 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120staged_gather_kernelIfffLb1ELb0ELb1EEEvPKT_PT1_NS_12GatherParamsE' for 'sm_90a'
ptxas info    : Function properties for x
    160 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 25000 bytes smem, 600 bytes cmem[0]
"""


def test_kernel_ab_bounds_count_as_chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert kernel_ab.EASU_RCAS_OPS == chip_smoke.EASU_RCAS_OPS
    assert kernel_ab.EPI_OPS == chip_smoke.LFGA_OPS + chip_smoke.TEPD_OPS
    assert kernel_ab.ALPHA_OPS == chip_smoke.ALPHA_OPS
    assert (kernel_ab.HBM_BYTES_PER_S, kernel_ab.F32_OPS_PER_S) == (chip_smoke.HBM_BYTES_PER_S, chip_smoke.F32_OPS_PER_S)


def test_kernel_ab_k6_bound_counts_as_chip_smoke():
    """K6's bound in kernel_ab is chip_smoke's (EASU_H_OPS + RCAS_H_OPS by
    type, the halves at the half2 rate), and phase 17's record of the
    parent's SASS names only printed columns and its other instructions."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert kernel_ab.K6_F32_OPS == chip_smoke.EASU_H_OPS[0] + chip_smoke.RCAS_H_OPS[0]
    assert kernel_ab.K6_HALF_OPS == chip_smoke.EASU_H_OPS[1] + chip_smoke.RCAS_H_OPS[1]
    assert kernel_ab.HALF2_OPS_PER_S == chip_smoke.HALF2_OPS_PER_S
    assert set(chip_smoke.K6_SASS_PARENT) <= set(opmix_floor.HALF_SASS_OPS) | {"other"}
    assert sum(chip_smoke.K6_SASS_PARENT.values()) == 1680 and chip_smoke.K6_SASS_PARENT["CALL"] == 7


K6_LISTING = """\
\t\tFunction : _ZN12_GLOBAL__N_113easu_h_kernelI6__halfLb1ELb0ELb0EEEvPKT_PS1_NS_7HParamsE
        /*0000*/                   HADD2 R4, R4.H0_H0, R5.H0_H0 ;
        /*0010*/                   HMUL2 R4, R4, R5 ;
        /*0020*/                   HFMA2.MMA R4, R4, R5.H0_H0, -RZ ;
        /*0030*/                   HADD2.F32 R4, -RZ, R5.H0_H0 ;
        /*0040*/                   HFMA2.MMA R4, -RZ, RZ, 0, 0 ;
        /*0050*/              @!P0 HMNMX2 R1, |R2|.H1_H1, R3.H0_H0, PT ;
        /*0060*/                   PRMT R1, R2, 0x5410, R3 ;
\t\tFunction : _ZN12_GLOBAL__N_113easu_h_kernelI6__halfLb1ELb1ELb0EEEvPKT_PS1_NS_7HParamsE
        /*0000*/                   HADD2 R4, R4, R5 ;
"""


def test_half_lanes_count_k6s_paired_half_instructions():
    """K6's half arithmetic by lanes: one lane where every register source
    selects a half; conversions (HADD2.F32) and constant moves (no register
    source) left out; only the float16 RCAS-on, no-denoise RGB kernel."""
    lines = K6_LISTING.splitlines(True)
    assert opmix_floor.parse_half_lanes(lines) == {"K6 f16": {"one lane": 2, "two lanes": 2}}
    counts = opmix_floor.parse_sass(lines)
    assert counts == {"K6 f16": {"HADD2": 2, "HMUL2": 1, "HFMA2": 2, "HMNMX2": 1, "PRMT": 1}}
    table = opmix_floor.sass_lines(counts, opmix_floor.HALF_SASS_OPS)
    assert table[0].split()[2:7] == ["HADD2", "HMUL2", "HMNMX2", "HFMA2", "HSETP2"]
    assert table[1].split()[-1] == "7"


def test_chip_smoke_lists_k6s_sass_in_a_process_of_its_own(tmp_path, monkeypatch):
    """Phase 17's SASS of K6's whole-frame and strip-source forms, listed by
    the process ``_start_k6_sass`` starts (here a stand-in ``cuobjdump``
    on PATH printing a listing of both), read by ``_k6_sass``; a CALL
    fails it."""
    import importlib.util
    import os
    import stat
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    strip = K6_LISTING.replace("13easu_h_kernelI6__half", "19easu_h_kernel_stripI6__half")
    call = strip.replace("0x5410, R3 ;\n", "0x5410, R3 ;\n        /*0070*/                   CALL.REL.NOINC R2 ;\n")
    for listing, fails in ((K6_LISTING + strip, False), (K6_LISTING + call, True)):
        tool = tmp_path / "cuobjdump"
        tool.write_text("#!/bin/sh\ncat <<'EOF'\n" + listing + "EOF\n")
        tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
        proc = chip_smoke._start_k6_sass()
        if fails:
            with pytest.raises(AssertionError, match="K6 f16, strip calls a subroutine"):
                chip_smoke._k6_sass(proc)
        else:
            chip_smoke._k6_sass(proc)
        assert proc.returncode == 0


def test_kernel_ab_reads_ptxas_and_swaps_the_library(tmp_path):
    (tmp_path / "build.log").write_text(PTXAS_LOG)
    lines = kernel_ab.ptxas_lines(tmp_path)
    # Every K4; K2 with RCAS and no denoise (RGB or RGBA) only.
    assert len(lines) == 2
    assert "edge_pad_kernel" in lines[0] and lines[0].endswith("Used 20 registers, used 0 barriers, 400 bytes cmem[0]")
    assert "Lb1ELb0ELb1E" in lines[1] and "160 bytes stack frame" in lines[1]
    saved = _build.library
    marker = object()
    with kernel_ab.using(marker):
        assert _build.library() is marker
    assert _build.library is saved
