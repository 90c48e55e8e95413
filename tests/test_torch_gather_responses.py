"""K2's shared texel responses (``csrc/easu_gather.cu``) on the CPU: a
numpy mirror of the kernel, block by block, against K2's plain version, the
dynamic shared memory the host sizes for it, and the count of responses a
launch evaluates.

The mirror stages what a block stages: the footprint of its ``TILE`` and
RCAS ring as the kernel loads it (a byte decoded as v * float32(1/255), a
float32 source rounded to a bfloat16 storage type) and each texel's luma;
then the response (gx, gy, gl) of every quadrant centre its pixels use,
once, on a grid from the first ring pixel's 'f' centre to the last one's
'k' centre on each axis, each neighbour clamped to the footprint; each ring
pixel picks its four quadrants from that grid by its tap offsets
(``easu_gather.cu:centre``), adds them weighted in the order s,
t, u, v, makes its filter shape, accumulates its 12 taps and clamps; RCAS
runs on the block's ring.  Every operation is a float32 numpy operation,
rounded once, as the plain version's torch operations round (the kernel
may contract a product and a sum; the chip's A/B holds it to its parent's
bits).  The limit is bit equality with ``easu_gather_reference``.  Alpha is
not mirrored: the kernel computes it per pixel, as before.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.core.presets import render_resolution
from fsr_tpu_torch.kernels import easu_gather as tgather
from fsr_tpu_torch.utils import profiling

F32 = np.float32
INV255 = F32(1.0 / 255.0)
TH, TW = tgather.TILE
ROOT = Path(__file__).resolve().parents[1]
# (dx, dy) of the 12 taps around 'f', in FsrEasuF's accumulation order.
TAPS = ((0, -1), (1, -1), (-1, 1), (0, 1), (0, 0), (-1, 0), (1, 1), (2, 1), (2, 0), (1, 0), (1, 2), (0, 2))
RCAS_LIMIT4 = F32(4.0 * (0.25 - 1.0 / 16.0))


def _f(v):
    return F32(v)


def _bits(a, magic, shift=0):
    return (np.uint32(magic) - (np.asarray(a, F32).view(np.uint32) >> np.uint32(shift))).view(F32)


def _rcp_lo(a):
    return _bits(a, 0x7EF07EBB)


def _rsq_lo(a):
    return _bits(a, 0x5F347D74, 1)


def _rcp_med(a):
    b = _bits(a, 0x7EF19FFF)
    return b * (-b * a + _f(2.0))


def _luma(r, g, b):
    return b * _f(0.5) + (r * _f(0.5) + g)


def _response(la, lb, lc, ld, le):
    """fsr_pixel.cuh:texel_response: (gx, gy, gl) of the '+' around lc."""
    len_x = _rcp_lo(np.maximum(np.abs(ld - lc), np.abs(lc - lb)))
    gx = ld - lb
    len_x = np.clip(np.abs(gx) * len_x, _f(0.0), _f(1.0))
    len_y = _rcp_lo(np.maximum(np.abs(le - lc), np.abs(lc - la)))
    gy = le - la
    len_y = np.clip(np.abs(gy) * len_y, _f(0.0), _f(1.0))
    return gx, gy, len_x * len_x + len_y * len_y


def _centre(a, b, c, n):
    """easu_gather.cu:centre: the response grid's index of a quadrant centre."""
    return np.where(a != c, b + 1, np.where(b == 0, 0, n + 1))


def _easu(fp, rv, cv, g, ppx, ppy):
    """easu_gather.cu:easu_staged after its loads (fsr_pixel.cuh:
    easu_resolve_quads): the weighted adds, the filter shape, the taps and
    the dering clamp, for a block's ring; fp (3, fh, fw) its footprint, rv /
    cv its ring's tap rows / columns in it, g the four quadrants'
    responses."""
    qx, qy = _f(1.0) - ppx, _f(1.0) - ppy
    dirx = diry = length = np.zeros(np.broadcast(ppx, ppy).shape, F32)
    for (gx, gy, gl), w in zip(g, (qx * qy, ppx * qy, qx * ppy, ppx * ppy)):
        dirx = dirx + gx * w
        diry = diry + gy * w
        length = length + gl * w
    dir_r = dirx * dirx + diry * diry
    zro = dir_r < _f(1.0 / 32768.0)
    dir_r = np.where(zro, _f(1.0), _rsq_lo(dir_r)).astype(F32)
    dirx = np.where(zro, _f(1.0), dirx).astype(F32)
    dirx, diry = dirx * dir_r, diry * dir_r
    length = length * _f(0.5)
    length = length * length
    stretch = (dirx * dirx + diry * diry) * _rcp_lo(np.maximum(np.abs(dirx), np.abs(diry)))
    len2_x = _f(1.0) + (stretch - _f(1.0)) * length
    len2_y = _f(1.0) + _f(-0.5) * length
    lob = _f(0.5) + _f((1.0 / 4.0 - 0.04) - 0.5) * length
    clp = _rcp_lo(lob)
    lx2, ly2 = len2_x * len2_x, len2_y * len2_y
    xx, yy, xy = dirx * dirx, diry * diry, dirx * diry
    qa = xx * lx2 + yy * ly2
    qb = (xy + xy) * (lx2 - ly2)
    qc = yy * lx2 + xx * ly2
    oy = {d: _f(d) - ppy for d in range(-1, 3)}
    ox = {d: _f(d) - ppx for d in range(-1, 3)}
    acc = np.zeros((3, *lob.shape), F32)
    aw = np.zeros(lob.shape, F32)
    for dx, dy in TAPS:
        d2 = (ox[dx] * ox[dx]) * qa + (ox[dx] * (oy[dy] * qb) + (oy[dy] * oy[dy]) * qc)
        d2 = np.minimum(d2, clp)
        w_a = lob * d2 + _f(-1.0)
        w_a = w_a * w_a
        w = ((_f(0.25) * d2 + _f(-1.25)) * d2 + _f(1.0)) * w_a
        acc = acc + fp[:, rv[dy + 1][:, None], cv[dx + 1][None, :]] * w
        aw = aw + w
    quad = [fp[:, rv[r][:, None], cv[q][None, :]] for r, q in ((1, 1), (1, 2), (2, 1), (2, 2))]
    mn = np.minimum(np.minimum(quad[0], quad[1]), np.minimum(quad[2], quad[3]))
    mx = np.maximum(np.maximum(quad[0], quad[1]), np.maximum(quad[2], quad[3]))
    return np.minimum(mx, np.maximum(mn, acc * (_f(1.0) / aw)))


def _rcas(ring, sharp, denoise):
    """fsr_pixel.cuh:rcas_pixel on a (3, TH + 2, TW + 2) ring."""
    b, d, e = ring[:, :-2, 1:-1], ring[:, 1:-1, :-2], ring[:, 1:-1, 1:-1]
    f, h = ring[:, 1:-1, 2:], ring[:, 2:, 1:-1]
    one = _f(1.0)
    num = den = None
    for c in range(3):
        mn4 = np.minimum(np.minimum(b[c], d[c]), np.minimum(f[c], h[c]))
        mx4 = np.maximum(np.maximum(b[c], d[c]), np.maximum(f[c], h[c]))
        u, v, q = np.minimum(mn4, e[c]), one - np.maximum(mx4, e[c]), one - mn4
        pick1 = u * q < np.where(q == 0, one, v) * mx4
        n_c, d_c = np.where(pick1, u, v), np.where(pick1, mx4, q)
        if num is None:
            num, den = n_c, d_c
        else:
            sw = n_c * den < num * d_c
            num, den = np.where(sw, n_c, num), np.where(sw, d_c, den)
    lobe = np.minimum(np.maximum(num * (one / den), _f(0.0)), RCAS_LIMIT4) * (_f(sharp) * _f(-0.25))
    if denoise:
        q = _f(0.25)
        bl, dl, el, fl, hl = (_luma(*x) for x in (b, d, e, f, h))
        nz = q * bl + q * dl + q * fl + q * hl - el
        rng = np.maximum(np.maximum(np.maximum(bl, dl), np.maximum(el, fl)), hl) - \
            np.minimum(np.minimum(np.minimum(bl, dl), np.minimum(el, fl)), hl)
        nz = np.abs(nz) * _rcp_med(rng)
        nz = np.where(nz > 0, np.minimum(nz, one), _f(0.0)).astype(F32)
        lobe = lobe * (_f(-0.5) * nz + one)
    rcp_l = _rcp_med(_f(4.0) * lobe + one)
    return (lobe * ((b + d) + (h + f)) + e) * rcp_l


def _loaded(image: torch.Tensor, compute_dtype) -> np.ndarray:
    """The colour planes as K2's stage loads them, float32."""
    x = image[:3]
    if x.dtype == torch.uint8:
        return x.numpy().astype(F32) * INV255
    if x.dtype == torch.float32 and compute_dtype == torch.bfloat16:
        x = x.to(torch.bfloat16)
    return x.float().numpy()


def k2_mirror(image, out_hw, con, rcon, apply_rcas, denoise, compute_dtype=torch.float32, gplan=None):
    """K2's colour planes of one (C, H, W) frame, block by block as the
    kernel computes them, float32 (3, Hout, Wout).  A row strip: ``image``
    its halo'd rows, ``out_hw`` its (hl, Wout), ``gplan`` its row tables."""
    hin, win = image.shape[-2:]
    hout, wout = out_hw
    gplan = tgather.plan((hin, win), out_hw, con) if gplan is None else gplan
    rows, cols, py, px = gplan.rows, gplan.cols, gplan.py, gplan.px  # row tables at output row Y: [Y + 1]
    src = _loaded(image, compute_dtype)
    out = np.empty((3, hout, wout), F32)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for y0 in range(0, hout, TH):
            for x0 in range(0, wout, TW):
                r0, c0 = rows[0][y0], cols[0][max(x0 - 1, 0)]
                fh = rows[3][min(y0 + TH, hout) + 1] - r0 + 1
                fw = cols[3][min(x0 + TW, wout - 1)] - c0 + 1
                fp = src[:, r0:r0 + fh, c0:c0 + fw]
                lum = _luma(*fp)
                xs = np.clip(x0 + np.arange(TW + 2) - 1, 0, wout - 1)
                ys = np.minimum(y0 + np.arange(TH + 2) - 1, hout) + 1
                cv, rv = cols[:, xs] - c0, rows[:, ys] - r0  # (4, ring columns), (4, ring rows)
                qc = [_centre(cv[k], cv[k + 1], cv[k + 2], fw) for k in (0, 1)]
                qr = [_centre(rv[k], rv[k + 1], rv[k + 2], fh) for k in (0, 1)]
                lr, lc = qr[0][0], qc[0][0]  # the grid: the first 'f' centre to the last 'k' centre
                vr, vc = np.arange(lr, qr[1][-1] + 1)[:, None], np.arange(lc, qc[1][-1] + 1)[None, :]
                up, cr, dn = (np.clip(vr + k, 0, fh - 1) for k in (-2, -1, 0))
                lf, cc, rt = (np.clip(vc + k, 0, fw - 1) for k in (-2, -1, 0))
                resp = _response(lum[up, cc], lum[cr, lf], lum[cr, cc], lum[cr, rt], lum[dn, cc])
                g = [tuple(a[qr[j][:, None] - lr, qc[i][None, :] - lc] for a in resp)
                     for j, i in ((0, 0), (0, 1), (1, 0), (1, 1))]
                ring = _easu(fp, rv, cv, g, px[xs][None, :], py[ys][:, None])
                tile = _rcas(ring, rcon.sharpness, denoise) if apply_rcas else ring[:, 1:-1, 1:-1]
                h, w = min(TH, hout - y0), min(TW, wout - x0)
                out[:, y0:y0 + h, x0:x0 + w] = tile[:, :h, :w]
    return out


def _con(in_hw, out_hw, viewport=None, offset=(0, 0)):
    vp = viewport or in_hw
    return EasuConstants.create((vp[1], vp[0]), (in_hw[1], in_hw[0]), (out_hw[1], out_hw[0]),
                                (offset[1], offset[0]))


def _image(seed, shape, dtype):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
    return (x * 255).to(torch.uint8) if dtype == torch.uint8 else x.to(dtype)


# id, source (dtype, shape), output (h, w), viewport, offset, compute dtype, (RCAS, denoise)
CASES = [
    ("1.5x f32, partial tiles, odd width", torch.float32, (3, 37, 61), (55, 91), None, (0, 0), torch.float32,
     (True, False)),
    ("1.3x u8", torch.uint8, (3, 30, 40), (39, 52), None, (0, 0), torch.float32, (True, False)),
    ("1.7x f32, RCAS off", torch.float32, (3, 30, 40), (51, 68), None, (0, 0), torch.float32, (False, False)),
    ("native 1x f32, denoise", torch.float32, (3, 33, 47), (33, 47), None, (0, 0), torch.float32, (True, True)),
    ("DRS viewport + offset", torch.float32, (2, 3, 40, 72), (54, 96), (36, 64), (2, 4), torch.float32,
     (True, False)),
    ("DRS offset, no viewport, denoise", torch.float32, (3, 32, 48), (44, 64), None, (2, 3), torch.float32,
     (True, True)),
    ("2x odd width u8", torch.uint8, (3, 20, 31), (40, 61), None, (0, 0), torch.float32, (True, False)),
    ("4x tiny", torch.float32, (3, 5, 7), (20, 28), None, (0, 0), torch.float32, (True, False)),
    ("1.5x bf16 storage from f32", torch.float32, (3, 36, 64), (54, 96), None, (0, 0), torch.bfloat16,
     (True, False)),
    ("1.5x bf16 source", torch.bfloat16, (3, 36, 64), (54, 96), None, (0, 0), torch.float32, (True, False)),
    ("RGBA 1.5x u8", torch.uint8, (4, 36, 64), (54, 96), None, (0, 0), torch.float32, (True, False)),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_mirror_of_k2_equals_easu_gather_reference(case):
    """The kernel's shared responses, mirrored, give the plain version's
    bits (colour planes) on partial tiles, odd widths, the ratios K2
    serves, DRS, RCAS off, denoise, bytes and bfloat16."""
    _, dtype, shape, out_hw, vp, off, cdt, (rc, dn) = case
    image = _image(5, shape, dtype)
    con = _con(shape[-2:], out_hw, vp, off)
    rcon = RcasConstants(0.25)
    want = tgather.easu_gather_reference(image, out_hw, con, rcon, rc, dn, cdt)
    frames = image.reshape(-1, *shape[-3:])
    got = torch.from_numpy(np.stack([k2_mirror(f, out_hw, con, rcon, rc, dn, cdt) for f in frames])).to(cdt)
    assert torch.equal(got, want.reshape(-1, *want.shape[-3:])[:, :3])


# Row strips whose seams cut K2's 32-row tiles of the whole frame and leave
# partial tiles in the strips.
STRIP_CASES = [("1.5x, 2 strips", (48, 80), (72, 120), 2, (True, False)),
               ("1.5x, 4 strips, denoise", (96, 64), (144, 96), 4, (True, True)),
               ("1.3x, 3 strips, RCAS off", (60, 50), (78, 65), 3, (False, False))]


@pytest.mark.parametrize("case", STRIP_CASES, ids=lambda c: c[0])
def test_mirror_of_k2_strips_equals_the_whole_frame(case):
    """K2 on ``shard_plan`` row strips, mirrored block by block on each
    strip's halo'd rows, gives the whole frame's bits: a seam's rows come
    from the halo and count as interior (``centre``)."""
    from fsr_tpu_torch.kernels import halo
    from fsr_tpu_torch.parallel import spatial

    _, in_hw, out_hw, n, (rc, dn) = case
    x = _image(6, (3, *in_hw), torch.float32)
    layout = spatial._layout(in_hw, out_hw, n, None, (0, 0))
    rcon = RcasConstants(0.25)
    srcs = spatial._sources(list(x.split(in_hw[0] // n, dim=-2)), layout.halo)
    got = np.concatenate([k2_mirror(halo.halo_rows_reference(s), layout.out_hw, layout.con, rcon, rc, dn,
                                    gplan=st.rows) for s, st in zip(srcs, layout.strips)], axis=-2)
    want = tgather.easu_gather_reference(x, out_hw, layout.con, rcon, rc, dn)
    assert torch.equal(torch.from_numpy(got), want)


# --- the response grid and the stage's size -----------------------------------

QUALITY_4K = ((1440, 2560), (2160, 3840))
# (id, input, output, viewport, offset): the plans whose stage is sized.
PLANS = [(f"{name} 4K", render_resolution((2160, 3840), s), (2160, 3840), None, (0, 0))
         for name, s in (("ultra_quality", 1.3), ("quality", 1.5), ("balanced", 1.7), ("performance", 2.0),
                         ("native", 1.0))] + [
    ("DRS viewport + offset", (96, 160), (128, 256), (64, 120), (8, 16)),
    ("ragged ~1.7x", (64, 114), (108, 192), None, (0, 0)),
    ("4x tiny", (5, 7), (20, 28), None, (0, 0)),
]
# csrc/easu_gather.cu's static shared memory with RCAS, as ptxas reads it
# for sm_90a: the table slice (Tables: an int4, an int2 and a float per ring
# column and ring row, 1,904 B) and the RCAS ring (fsr_pixel.cuh:rcas_tile,
# 3 float32 planes of the ring, 13,872 B), aligned.  The H100's shared
# memory per SM, and what the system reserves per block.
STATIC_SHARED = 15792
SM_SHARED, BLOCK_RESERVED = 228 * 1024, 1024


def _blocks(gplan, out_hw):
    """csrc/easu_gather.cu:stage once more, block by block: per block row
    (fh, gh) and per block column (fw, gw), the footprint's and the response
    grid's extents, the grid from the first ring pixel's 'f' centre to the
    last one's 'k' centre."""
    out = []
    # (the axis' four tap tables, its output extent, tile, the table index of output coordinate 0, the ring's bounds)
    for table, n, tile, at, lo, hi in ((gplan.rows, out_hw[0], TH, 1, -1, out_hw[0]),
                                      (gplan.cols, out_hw[1], TW, 0, 0, out_hw[1] - 1)):
        axis = []
        for s0 in range(0, n, tile):
            first, last = max(s0 - 1, lo) + at, min(s0 + tile, hi) + at
            f0 = table[0][first]
            size = table[3][last] - f0 + 1
            c_f = _centre(0, table[1][first] - f0, table[2][first] - f0, size)
            c_k = _centre(table[1][last] - f0, table[2][last] - f0, size - 1, size)
            axis.append((int(size), int(c_k - c_f + 1)))
        out.append(axis)
    return out


@pytest.mark.parametrize("case", PLANS, ids=lambda c: c[0])
def test_every_blocks_stage_fits_the_launchs_dynamic_shared_memory(case):
    """The stage the host sizes (``Footprint.stage``) holds every block's
    footprint and response grid, RGB and RGBA, and is at most the kernel's
    largest (a FOOTPRINT_MAX footprint and a grid one centre wider on each
    side, which the kernel's dynamic shared memory is raised to); the
    responses counted are the blocks' grids."""
    _, in_hw, out_hw, vp, off = case
    gplan = tgather.plan(in_hw, out_hw, _con(in_hw, out_hw, vp, off))
    fp = tgather.footprint(gplan)
    assert fp.fits
    rows, cols = _blocks(gplan, out_hw)
    assert [(int(h), int(g)) for h, g in zip(fp.h, fp.gh)] == rows
    assert [(int(w), int(g)) for w, g in zip(fp.w, fp.gw)] == cols
    assert all(g <= h + 2 for h, g in rows + cols)
    fh, fw = tgather.FOOTPRINT_MAX
    for rgba in (False, True):
        need = [tgather.stage_bytes(h, w, gh, gw, rgba) for h, gh in rows for w, gw in cols]
        assert max(need) == fp.stage[rgba] <= tgather.stage_bytes(fh, fw, fh + 2, fw + 2, rgba)
    assert fp.responses == sum(gh * gw for _, gh in rows for _, gw in cols)


@pytest.mark.parametrize("case", PLANS[:5], ids=lambda c: c[0])
def test_four_blocks_share_an_sm_at_every_ratio_to_4k(case):
    """From native 1x to 2x at 4K (RGB), a block's shared memory lets four
    blocks of 256 threads share an H100 SM, as 64 registers a thread do."""
    _, in_hw, out_hw, vp, off = case
    fp = tgather.footprint(tgather.plan(in_hw, out_hw, _con(in_hw, out_hw, vp, off)))
    assert STATIC_SHARED >= (TW + 2 + TH + 2) * (16 + 8 + 4) + 3 * (TH + 2) * (TW + 2) * 4
    assert 4 * (STATIC_SHARED + fp.stage[False] + BLOCK_RESERVED) <= SM_SHARED


@pytest.mark.parametrize("case", PLANS, ids=lambda c: c[0])
def test_quadrant_centres_name_grid_cells_whose_neighbours_are_the_taps(case):
    """For K2's TILE, each ring pixel's quadrant centre index (``centre``)
    names a grid cell whose neighbours, clamped to the footprint, are the
    pixel's own tap rows and columns."""
    _, in_hw, out_hw, vp, off = case
    gplan = tgather.plan(in_hw, out_hw, _con(in_hw, out_hw, vp, off))
    for table, n, tile in ((gplan.rows[:, 1:-1], out_hw[0], TH), (gplan.cols, out_hw[1], TW)):
        for s in range(0, n, tile):
            taps = table[:, np.clip(np.arange(s - 1, s + tile + 1), 0, n - 1)]
            lo, size = taps.min(), taps.max() - taps.min() + 1
            for k in (0, 1):
                a, b, c = (taps[k + j] - lo for j in range(3))
                v = _centre(a, b, c, size)
                np.testing.assert_array_equal(np.clip(v - 2, 0, size - 1), a)
                np.testing.assert_array_equal(np.clip(v - 1, 0, size - 1), b)
                np.testing.assert_array_equal(np.clip(v, 0, size - 1), c)


# --- the count and its metric ---------------------------------------------------


def test_quality_plan_evaluates_056_responses_per_pixel():
    """The host's count rule at 1440p -> 4K: 0.56 responses per output pixel,
    its blocks' 24 x 24 grids of used centres (a grid one texel wider than
    the 26 x 26 footprint on each side would hold 0.76; a pixel evaluating
    its own four, 4 x 1156 / 1024 = 4.52)."""
    in_hw, out_hw = QUALITY_4K
    fp = tgather.footprint(tgather.plan(in_hw, out_hw, _con(in_hw, out_hw)))
    assert (int(fp.h.max()), int(fp.w.max()), int(fp.gh.max()), int(fp.gw.max())) == (26, 26, 24, 24)
    assert fp.responses / (out_hw[0] * out_hw[1]) == pytest.approx(0.56, abs=0.01)


def test_a_cpu_call_counts_no_responses():
    """On the CPU K2 runs its plain version: no launch, no count."""
    x = _image(7, (3, 24, 40), torch.float32)
    with profiling.recording() as rec:
        tgather.easu_gather(x, (36, 60), _con((24, 40), (36, 60)), RcasConstants(0.25), True)
    assert not rec.named("fsr.launch")
    assert rec.counts("texel_responses") == {} and rec.counts("pixels") == {}


def _metric():
    rel = "fsrbench/metrics/texel_responses_per_pixel.quality.py"
    spec = importlib.util.spec_from_file_location("responses_metric", ROOT / rel)
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _launch(call, **args):
    s = profiling.Span("fsr.launch", None, None, False)
    s.start, s.end, s.call, s.parent, s.id, s.args = 0.0, 1e-6, call, None, call, args
    return s


@pytest.mark.parametrize("spans, want", [
    ([], None),
    ([_launch(0, kernel="K1"), _launch(1, kernel="K1")], None),
    ([_launch(0, kernel="K2")], None),  # a program that counts nothing
    ([_launch(0, kernel="K1"), _launch(1, kernel="K2", texel_responses=760, pixels=1000),
      _launch(2, kernel="K2", texel_responses=1520, pixels=1000), _launch(3, kernel="K2")], 1.14),
], ids=["nothing", "K1 only", "K2 uncounted", "K2 counted"])
def test_metric_reads_k2s_responses_per_pixel(spans, want, monkeypatch):
    """``texel_responses_per_pixel.quality`` sums the counts over K2's
    launches that carry them, and reads None without one."""
    read = _metric()
    monkeypatch.setattr(profiling, "records", lambda: profiling.Records(spans))
    got = read(None)
    assert got == (None if want is None else pytest.approx(want))
