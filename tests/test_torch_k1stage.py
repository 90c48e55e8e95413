"""K1's staged source window and its quad path (``kernels/fused.py``: the
rule of ``csrc/fused.cu:stage`` and ``quad_axis``) on the port's own plans,
on the CPU.

K1 stages, per block of ``fused.TILE`` outputs, the source rectangle from
the 'f' of ring position y0 - 1, less one, to the 'f' of ring position
y0 + TILE, plus two (rows and columns alike), each texel at its index
clamped to the source.  Three things are held here, with the device rule
written out once more as a numpy mirror:

- every tap of every tile and ring pixel lies inside its block's window,
  and the window fits the kernel's compile-time maximum for its path
  (``fused.window``, ``fused.WINDOW_MAX``);
- the quad path is chosen exactly where the 2x structure holds (540p ->
  1080p, 1080p -> 4K, the row strips of ``parallel.spatial``, and a DRS
  offset at 2x, whose integer offset only shifts 'f'), and the generic path
  for 4x, 1x on an axis and a DRS offset at 4x; the two pixels of a quad on
  each axis share 'f' in the float32 coordinate tables, at fractions 0.25
  and 0.75;
- the fold computes what K4 + K1 computed: each pixel's 12 taps gathered
  from its block's clamped window of the unpadded source equal the taps
  that the plan's padded offsets read from ``pad.edge_pad_reference``'s
  padded source, for every phase structure, a negative lead (DRS), uint8,
  float32 under bfloat16 storage, RGBA and row strips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fsr_tpu_torch.core import easu_math
from fsr_tpu_torch.core.constants import EasuConstants
from fsr_tpu_torch.kernels import epilogue as epilogue_mod
from fsr_tpu_torch.kernels import fused, pad
from fsr_tpu_torch.ops.easu import easu_coords
from fsr_tpu_torch.parallel import spatial

TH, TW = fused.TILE
# The 12 taps' (dx, dy) offsets from 'f', in the kernels' order.
TAPS = list(easu_math.TAP_OFFSETS.values())


def _con(in_hw, out_hw, viewport=None, offset=(0, 0)):
    vp = viewport or in_hw
    return EasuConstants.create((vp[1], vp[0]), (in_hw[1], in_hw[0]), (out_hw[1], out_hw[0]),
                                (offset[1], offset[0]))


def _f(q, r, idx):
    """'f' of output positions idx (numpy floor semantics at -1)."""
    idx = np.asarray(idx)
    return idx // q + np.asarray(r)[idx % q]


def _strip_plan(in_hw, out_hw, n):
    """The plan every strip of an n-way row split shares (``parallel.spatial``):
    its halo'd source extent, output rows and shard-local constants."""
    con = _con(in_hw, out_hw)
    lcon = spatial._local_constants(con, spatial._HALO)
    hin_l = in_hw[0] // n + 2 * spatial._HALO
    hl = out_hw[0] // n
    return (hin_l, in_hw[1]), (hl, out_hw[1]), lcon


# (id, input (h, w), output (h, w), viewport, offset, path)
PLANS = [
    ("540p -> 1080p", (540, 960), (1080, 1920), None, (0, 0), "quad"),
    ("1080p -> 4K", (1080, 1920), (2160, 3840), None, (0, 0), "quad"),
    ("2x ragged", (67, 131), (134, 262), None, (0, 0), "quad"),
    ("2x, one tile and a bit", (17, 16), (34, 32), None, (0, 0), "quad"),
    ("DRS offset at 2x", (67, 131), (120, 256), (60, 128), (3, 2), "quad"),
    ("4x", (135, 240), (540, 960), None, (0, 0), "generic"),
    ("4x tiny", (5, 7), (20, 28), None, (0, 0), "generic"),
    ("2x rows, 1x columns", (64, 128), (128, 128), None, (0, 0), "generic"),
    ("1x rows, 2x columns", (64, 64), (64, 128), None, (0, 0), "generic"),
    ("4x rows, 2x columns", (30, 64), (120, 128), None, (0, 0), "generic"),
    ("DRS offset at 4x", (40, 70), (128, 240), (32, 60), (4, 5), "generic"),
]

STRIPS = [(f"{what} sp={n}", in_hw, out_hw, n)
          for what, in_hw, out_hw in (("2x", (96, 160), (192, 320)), ("1080p -> 4K", (1080, 1920), (2160, 3840)),
                                      ("4x", (48, 80), (192, 320)))
          for n in (2, 4, 8)]


def _source_plan(in_hw, out_hw, con):
    return fused.source_plan(fused.plan(in_hw, out_hw, con))


def _device_windows(sp, out_hw):
    """csrc/fused.cu:stage, block by block: (first index, extent) of the
    window per block row and per block column."""
    rows = [(_f(sp.qy, sp.ry, y0 - 1) - 1, _f(sp.qy, sp.ry, y0 + TH) + 2 - (_f(sp.qy, sp.ry, y0 - 1) - 1) + 1)
            for y0 in range(0, out_hw[0], TH)]
    cols = [(_f(sp.qx, sp.rx, x0 - 1) - 1, _f(sp.qx, sp.rx, x0 + TW) + 2 - (_f(sp.qx, sp.rx, x0 - 1) - 1) + 1)
            for x0 in range(0, out_hw[1], TW)]
    return rows, cols


def _check_windows(sp, out_hw):
    path = "quad" if fused.quad_ok(sp) else "generic"
    rows, cols = _device_windows(sp, out_hw)
    for axis, (q, r, n, t, blocks) in enumerate(((sp.qy, sp.ry, out_hw[0], TH, rows),
                                                 (sp.qx, sp.rx, out_hw[1], TW, cols))):
        lo, ext = fused.window(q, r, n, t)
        assert [(int(a), int(b)) for a, b in zip(lo, ext)] == [(int(a), int(b)) for a, b in blocks]
        assert int(ext.max()) <= fused.WINDOW_MAX[path][axis]
        for b, (w0, w) in enumerate(blocks):
            # Every ring position of the block: its taps -1..2 around 'f'.
            f = _f(q, r, np.arange(b * t - 1, b * t + t + 1))
            assert (f - 1).min() >= w0 and (f + 2).max() <= w0 + w - 1
            if path == "quad":
                # Quad k of the ring: 'f' is window index k + 1 on both of its
                # positions (csrc/fused.cu:ring_easu).
                k = np.arange(len(f)) // 2
                np.testing.assert_array_equal(f - w0, k + 1)
    return path


@pytest.mark.parametrize("case", PLANS, ids=[c[0] for c in PLANS])
def test_every_tap_inside_the_window_and_the_path(case):
    _, in_hw, out_hw, vp, off, path = case
    sp = _source_plan(in_hw, out_hw, _con(in_hw, out_hw, vp, off))
    assert _check_windows(sp, out_hw) == path
    fused._check_window(sp, out_hw, path)


@pytest.mark.parametrize("case", STRIPS, ids=[c[0] for c in STRIPS])
def test_row_strip_windows_and_path(case):
    _, in_hw, out_hw, n = case
    src_hw, strip_hw, lcon = _strip_plan(in_hw, out_hw, n)
    sp = _source_plan(src_hw, strip_hw, lcon)
    want = "quad" if out_hw[0] == 2 * in_hw[0] else "generic"
    assert _check_windows(sp, strip_hw) == want


@pytest.mark.parametrize("case", [c for c in PLANS if c[-1] == "quad"], ids=[c[0] for c in PLANS if c[-1] == "quad"])
def test_quad_pixels_share_f_at_the_constant_fractions(case):
    """From the float32 coordinate tables themselves: outputs 2j+1 and 2j+2
    share 'f' j + r[1], at fractions 0.25 and 0.75 bit for bit."""
    _, in_hw, out_hw, vp, off, _ = case
    con = _con(in_hw, out_hw, vp, off)
    sp = _source_plan(in_hw, out_hw, con)
    fx, fy, px, py = easu_coords(con, out_hw)
    for f, frac, r, n in ((fx, px, sp.rx, out_hw[1]), (fy, py, sp.ry, out_hw[0])):
        odd = np.arange(1, n - 1, 2)
        np.testing.assert_array_equal(f[odd], f[odd + 1])
        np.testing.assert_array_equal(f[odd], (odd - 1) // 2 + r[1])
        assert np.all(np.asarray(frac[odd], np.float32).view(np.uint32) == np.float32(0.25).view(np.uint32))
        assert np.all(np.asarray(frac[odd + 1], np.float32).view(np.uint32) == np.float32(0.75).view(np.uint32))


def test_quad_needs_the_exact_structure():
    sp = _source_plan((540, 960), (1080, 1920), _con((540, 960), (1080, 1920)))
    assert fused.quad_ok(sp)
    off = np.nextafter(np.float32(0.25), np.float32(1))
    for bad in (dict(py=(0.75, float(off))), dict(rx=(sp.rx[0], sp.rx[0] + 2)), dict(px=(0.25, 0.75))):
        assert not fused.quad_ok(dataclasses.replace(sp, **bad))
    assert fused._pick_path(sp, "auto") == "quad" and fused._pick_path(sp, "generic") == "generic"
    assert fused._pick_path(_source_plan((135, 240), (540, 960), _con((135, 240), (540, 960))), "auto") == "generic"
    with pytest.raises(ValueError, match="path"):
        fused._pick_path(sp, "quad")


def _window_taps(src, sp, out_hw, ring_rows=None):
    """The fold's numpy mirror: per block, the window of ``src`` (..., C, H,
    W) at clamped indices, then each tile and ring pixel's 12 taps gathered
    from it at 'f' - window origin.  Returns {(Y, X): (..., C, 12)} for the
    ring positions of every block (a position shared by blocks must agree)."""
    h, w = src.shape[-2:]
    rows, cols = _device_windows(sp, out_hw)
    out = {}
    for by, (r0, fh) in enumerate(rows):
        for bx, (c0, fw) in enumerate(cols):
            ri = np.clip(np.arange(r0, r0 + fh), 0, h - 1)
            ci = np.clip(np.arange(c0, c0 + fw), 0, w - 1)
            win = src[..., ri[:, None], ci[None, :]]
            for Y in range(by * TH - 1, min(by * TH + TH + 1, out_hw[0] + 1)):
                for X in range(bx * TW - 1, min(bx * TW + TW + 1, out_hw[1] + 1)):
                    fy, fx = int(_f(sp.qy, sp.ry, Y)), int(_f(sp.qx, sp.rx, X))
                    taps = np.stack([win[..., fy + dy - r0, fx + dx - c0] for dx, dy in TAPS], -1)
                    if (Y, X) in out:
                        np.testing.assert_array_equal(out[(Y, X)], taps)
                    out[(Y, X)] = taps
    return out


FOLD = [
    # id, input, output, viewport, offset, source kind, storage, channels
    ("2x f32", (23, 37), (46, 74), None, (0, 0), "float", torch.float32, 3),
    ("2x f32 under bf16", (23, 37), (46, 74), None, (0, 0), "float", torch.bfloat16, 3),
    ("2x u8", (23, 37), (46, 74), None, (0, 0), "u8", torch.float32, 3),
    ("2x RGBA", (23, 37), (46, 74), None, (0, 0), "float", torch.float32, 4),
    ("2x RGBA u8", (23, 37), (46, 74), None, (0, 0), "u8", torch.float32, 4),
    ("4x", (9, 11), (36, 44), None, (0, 0), "float", torch.float32, 3),
    ("2x rows 1x cols", (16, 40), (32, 40), None, (0, 0), "float", torch.float32, 3),
    ("1x rows 4x cols", (33, 10), (33, 40), None, (0, 0), "float", torch.bfloat16, 3),
    ("DRS negative lead, 2x", (40, 70), (60, 120), (30, 60), (6, 8), "float", torch.float32, 3),
    ("DRS negative lead, 4x", (40, 70), (64, 120), (16, 30), (9, 17), "u8", torch.float32, 4),
]


def _source(kind, shape, seed):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    return torch.from_numpy((x * 255).astype(np.uint8) if kind == "u8" else x)


def _check_fold(image, out_hw, con, storage, ring_rows=None):
    fplan = fused.plan(tuple(image.shape[-2:]), out_hw, con)
    sp = fused.source_plan(fplan)
    # K4 padded a byte source as bytes, a float one into the storage type.
    padded = epilogue_mod.decode(pad.edge_pad_reference(
        image, fplan.pads, torch.uint8 if image.dtype == torch.uint8 else storage))
    src = epilogue_mod.decode(image, None if image.dtype == torch.uint8 else storage)
    got = _window_taps(src.numpy(), sp, out_hw)
    pn = padded.numpy()
    ylo, yhi = ring_rows if ring_rows is not None else (0, out_hw[0] - 1)
    for (Y, X), taps in got.items():
        if not (ylo <= Y <= yhi and 0 <= X < out_hw[1]):
            continue  # the kernel computes it, RCAS never reads it
        fy, fx = int(_f(fplan.qy, fplan.ry, Y)), int(_f(fplan.qx, fplan.rx, X))
        want = np.stack([pn[..., fy + dy, fx + dx] for dx, dy in TAPS], -1)
        np.testing.assert_array_equal(taps, want, err_msg=f"pixel {(Y, X)}")


@pytest.mark.parametrize("case", FOLD, ids=[c[0] for c in FOLD])
def test_fold_reads_what_k4_padded(case):
    _, in_hw, out_hw, vp, off, kind, storage, nc = case
    con = _con(in_hw, out_hw, vp, off)
    _check_fold(_source(kind, (2, nc, *in_hw), 3), out_hw, con, storage)


@pytest.mark.parametrize("n", [2, 4])
def test_fold_on_row_strips(n):
    """Each strip of a row split: its halo'd source, shard-local constants,
    and the ring rows that RCAS reads (ylo -1 / yhi hout at a neighbour)."""
    in_hw, out_hw = (32, 40), (64, 80)
    x = _source("float", (1, 3, *in_hw), 5)
    hl, hs = out_hw[0] // n, in_hw[0] // n
    strips = spatial._exchange_halo([x[..., k * hs:(k + 1) * hs, :] for k in range(n)], spatial._HALO)
    lcon = spatial._local_constants(_con(in_hw, out_hw), spatial._HALO)
    for k, s in enumerate(strips):
        ring = fused.ring_rows(hl, k * hl, out_hw[0])
        _check_fold(s, (hl, out_hw[1]), lcon, torch.float32, ring)


def test_drs_plans_lead_negative():
    """The DRS fold cases above really take a negative lead: the image's
    first 'f' lies inside it, so K4 padded nothing there and the plan
    shifted the offsets instead."""
    for case in [c for c in FOLD if c[0].startswith("DRS")]:
        _, in_hw, out_hw, vp, off, *_ = case
        pl = fused.plan(in_hw, out_hw, _con(in_hw, out_hw, vp, off))
        sp = fused.source_plan(pl)
        assert pl.pads[0] == 0 and pl.pads[2] == 0
        assert min(sp.ry) - 2 > 0 and min(sp.rx) - 2 > 0


def test_check_window_raises_on_an_oversized_window():
    sp = _source_plan((64, 64), (64, 128), _con((64, 64), (64, 128)))
    bad = dataclasses.replace(sp, qy=1, ry=(0,), py=(0.0,))
    fused._check_window(bad, (64, 128), "generic")
    with pytest.raises(ValueError, match="window"):
        fused._check_window(bad, (64, 128), "quad")
