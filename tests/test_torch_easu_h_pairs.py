"""K6's arithmetic order (``csrc/easu_h.cu``, ``csrc/fsr_half.cuh``) on the
CPU: a numpy mirror of the kernel, block by block, against K6's plain
version, and the reciprocal identity the kernel's half reciprocal keeps.

The mirror stages what a block stages: the footprint of its ``TILE`` and
RCAS ring, the half luma of each texel, and every quadrant centre's
response (dir_x, len_x^2, dir_y, len_y^2) once per texel on a grid one
texel wider than the footprint on each side, each pixel's quadrants picked
from that grid by its tap offsets (``easu_h.cu:centre``).  Then per pixel
the weighted adds and the float32 filter shape, and EASU's and FsrRcasH's
half operations, each rounded to float16 (numpy's float16 operations round
each result once, as ``__hadd2_rn``/``__hmul2_rn`` round each lane).  The
limit is bit equality with ``easu_h_reference`` (the torch path's float16
ops) on ``test_torch_easu_h.CASES``: the presets, DRS, an odd output width
with partial tiles, every source type, RCAS off and denoise.  Alpha is not
mirrored: the kernel computes it as before, per pixel.
"""

import numpy as np
import pytest
import torch

import fsr_tpu_torch
from fsr_tpu_torch.core.constants import RcasConstants
from fsr_tpu_torch.kernels import easu_gather as tgather
from fsr_tpu_torch.kernels import easu_h as teasu_h
from test_torch_easu_h import CASES, _con, _source, _torch

F16, F32 = np.float16, np.float32
INV255 = F32(1.0 / 255.0)


def _f(v):
    """A float32 constant, as the kernel writes it."""
    return F32(v)


def _h(v):
    """A half constant as fsr_half.cuh's k()/k2() round it (float to half)."""
    return F32(v).astype(F16)


def _prx_lo_rcp(a):
    return (np.uint32(0x7EF07EBB) - a.astype(F32).view(np.uint32)).view(F32)


def _prx_lo_rsq(a):
    return (np.uint32(0x5F347D74) - (a.astype(F32).view(np.uint32) >> np.uint32(1))).view(F32)


def _sat_nan0(x):
    return np.where(x > 0, np.minimum(x, _f(1.0)), _f(0.0)).astype(F32)


def _rcp_h(a):
    """torch's ``1.0 / a`` on halves: the float32 reciprocal rounded to half."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return (_f(1.0) / a.astype(F32)).astype(F16)


def _prx_med_rcp_h(a):
    b = (np.uint16(0x778D) - a.view(np.uint16)).view(F16)
    return b * (-b * a + _h(2.0))


def _sat_h(x):
    return np.where(x > 0, np.where(x > _h(1.0), _h(1.0), x), _h(0.0)).astype(F16)


def _luma_h(r, g, b):
    return b * _h(0.5) + (r * _h(0.5) + g)


def _to_half(image: torch.Tensor) -> np.ndarray:
    """The source's colour planes rounded to half as ``to_half`` rounds them."""
    if image.dtype == torch.uint8:
        return (image.numpy().astype(F32) * INV255).astype(F16)
    return image.float().numpy().astype(F16)


def _quad_response(la, lb, lc, ld, le):
    """fsr_half.cuh:quad_response, in float32."""
    dc, cb = ld - lc, lc - lb
    len_x = _prx_lo_rcp(np.maximum(np.abs(dc), np.abs(cb)))
    dx = ld - lb
    len_x = _sat_nan0(np.abs(dx) * len_x)
    ec, ca = le - lc, lc - la
    len_y = _prx_lo_rcp(np.maximum(np.abs(ec), np.abs(ca)))
    dy = le - la
    len_y = _sat_nan0(np.abs(dy) * len_y)
    return dx, len_x * len_x, dy, len_y * len_y


def _easu_shape(g, ppx, ppy):
    """fsr_half.cuh:easu_shape, in float32: g is the four quadrants'
    responses, each four arrays."""
    qx, qy = _f(1.0) - ppx, _f(1.0) - ppy
    dirx = diry = length = np.zeros(np.broadcast(ppx, ppy).shape, F32)
    for (dx, lx2, dy, ly2), w in zip(g, (qx * qy, ppx * qy, qx * ppy, ppx * ppy)):
        dirx = dirx + dx * w
        length = length + lx2 * w
        diry = diry + dy * w
        length = length + ly2 * w
    dir_r = dirx * dirx + diry * diry
    zro = dir_r < _f(1.0 / 32768.0)
    dir_r = np.where(zro, _f(1.0), _prx_lo_rsq(dir_r)).astype(F32)
    dirx = np.where(zro, _f(1.0), dirx).astype(F32)
    dirx, diry = dirx * dir_r, diry * dir_r
    length = length * _f(0.5)
    length = length * length
    stretch = (dirx * dirx + diry * diry) * _prx_lo_rcp(np.maximum(np.abs(dirx), np.abs(diry)))
    lob = _f(0.5) + _f((1.0 / 4.0 - 0.04) - 0.5) * length
    return (dirx, diry, _f(1.0) + (stretch - _f(1.0)) * length, _f(1.0) + _f(-0.5) * length, lob, _prx_lo_rcp(lob))


TAPS = ((0, -1), (1, -1), (-1, 1), (0, 1), (0, 0), (-1, 0), (1, 1), (2, 1), (2, 0), (1, 0), (1, 2), (0, 2))


def _easu_half(t, shape, ppx, ppy):
    """fsr_half.cuh:easu_pair lane by lane: t[c][r][q] the tap planes."""
    hdx, hdy, l2x, l2y, lob, clp = (s.astype(F16) for s in shape)
    ndy = -hdy
    hpx, hpy = ppx.astype(F16), ppy.astype(F16)
    ox = [_h(q - 1) - hpx for q in range(4)]
    oy = [_h(r - 1) - hpy for r in range(4)]
    xdx, xndy = [o * hdx for o in ox], [o * ndy for o in ox]
    ydy, ydx = [o * hdy for o in oy], [o * hdx for o in oy]
    m1, c25, c2516, c916 = _h(-1.0), _h(2.0 / 5.0), _h(25.0 / 16.0), _h(-(25.0 / 16.0 - 1.0))
    acc = [np.zeros(hdx.shape, F16) for _ in range(3)]
    aw = np.zeros(hdx.shape, F16)
    for dx, dy in TAPS:
        q, r = dx + 1, dy + 1
        vx = (xdx[q] + ydy[r]) * l2x
        vy = (xndy[q] + ydx[r]) * l2y
        d2 = np.minimum(vx * vx + vy * vy, clp)
        w_a = lob * d2 + m1
        w_a = w_a * w_a
        w_b = c25 * d2 + m1
        w_b = w_b * w_b
        w_b = c2516 * w_b + c916
        w = w_b * w_a
        acc = [a + t[c][r][q] * w for c, a in enumerate(acc)]
        aw = aw + w
    inv_w = _rcp_h(aw)
    out = []
    for c in range(3):
        mn = np.minimum(np.minimum(t[c][1][1], t[c][1][2]), np.minimum(t[c][2][1], t[c][2][2]))
        mx = np.maximum(np.maximum(t[c][1][1], t[c][1][2]), np.maximum(t[c][2][1], t[c][2][2]))
        out.append(np.minimum(mx, np.maximum(mn, acc[c] * inv_w)))
    return np.stack(out)


def _rcas_half(ring, sharp, denoise):
    """fsr_half.cuh:rcas_pair lane by lane on a (3, TH + 2, TW + 2) ring."""
    b, d, e = ring[:, :-2, 1:-1], ring[:, 1:-1, :-2], ring[:, 1:-1, 1:-1]
    f, hh = ring[:, 1:-1, 2:], ring[:, 2:, 1:-1]
    one, four = _h(1.0), _h(4.0)
    lobe = None
    for c in range(3):
        mn4 = np.minimum(np.minimum(b[c], d[c]), np.minimum(f[c], hh[c]))
        mx4 = np.maximum(np.maximum(b[c], d[c]), np.maximum(f[c], hh[c]))
        hit_min = np.minimum(mn4, e[c]) * _rcp_h(four * mx4)
        hit_max = (one - np.maximum(mx4, e[c])) * _rcp_h(four * mn4 + _h(-4.0))
        lobe_c = np.fmax(-hit_min, hit_max)
        lobe = lobe_c if c == 0 else np.maximum(lobe, lobe_c)
    lobe = np.maximum(_h(-(0.25 - 1.0 / 16.0)), np.minimum(lobe, _h(0.0))) * sharp
    if denoise:
        q = _h(0.25)
        bl, dl, el, fl, hl = (_luma_h(*x) for x in (b, d, e, f, hh))
        nz = (((q * bl + q * dl) + q * fl) + q * hl) - el
        rng = np.maximum(np.maximum(np.maximum(bl, dl), np.maximum(el, fl)), hl) - \
            np.minimum(np.minimum(np.minimum(bl, dl), np.minimum(el, fl)), hl)
        nz = _sat_h(np.abs(nz) * _prx_med_rcp_h(rng))
        lobe = lobe * (_h(-0.5) * nz + one)
    rcp_l = _prx_med_rcp_h(four * lobe + one)
    return ((((lobe * b + lobe * d) + lobe * hh) + lobe * f) + e) * rcp_l


def _centre(a, b, c, n):
    """easu_h.cu:centre: the response grid's index of a quadrant centre."""
    return np.where(a != c, b + 1, np.where(b == 0, 0, n + 1))


def k6_mirror(image: torch.Tensor, out_hw, con, rcon, apply_rcas: bool, denoise: bool, gplan=None) -> np.ndarray:
    """K6's colour planes of one (C, H, W) frame, block by block as the
    kernel computes them; float16 (3, Hout, Wout).  A row strip: ``image``
    its halo'd rows, ``out_hw`` its (hl, Wout) and ``gplan`` its row tables
    (``easu_gather.shard_plan``), as K6's strip form runs it."""
    hin, win = image.shape[-2:]
    hout, wout = out_hw
    th, tw = teasu_h.TILE
    gplan = tgather.plan((hin, win), out_hw, con) if gplan is None else gplan
    rows, cols, py, px = gplan.rows, gplan.cols, gplan.py, gplan.px  # row tables at output row Y: [Y + 1]
    src = _to_half(image[:3])
    sharp = F32(rcon.sharpness_f16 if rcon is not None else 1.0).astype(F16)
    out = np.empty((3, hout, wout), F16)
    with np.errstate(over="ignore", invalid="ignore"):
        for y0 in range(0, hout, th):
            for x0 in range(0, wout, tw):
                r0, c0 = rows[0][y0], cols[0][max(x0 - 1, 0)]
                fh = rows[3][min(y0 + th, hout) + 1] - r0 + 1
                fw = cols[3][min(x0 + tw, wout - 1)] - c0 + 1
                assert fh <= th + 5 and fw <= tw + 5
                fp = src[:, r0:r0 + fh, c0:c0 + fw]
                lum = _luma_h(*fp).astype(F32)
                vr, vc = np.arange(fh + 2)[:, None], np.arange(fw + 2)[None, :]
                up, cr, dn = (np.clip(vr + k, 0, fh - 1) for k in (-2, -1, 0))
                lf, cc, rt = (np.clip(vc + k, 0, fw - 1) for k in (-2, -1, 0))
                resp = _quad_response(lum[up, cc], lum[cr, lf], lum[cr, cc], lum[cr, rt], lum[dn, cc])

                xs = np.clip(x0 + np.arange(tw + 2) - 1, 0, wout - 1)
                ys = np.minimum(y0 + np.arange(th + 2) - 1, hout) + 1
                cv, rv = cols[:, xs] - c0, rows[:, ys] - r0  # (4, ring columns), (4, ring rows)
                qc = [_centre(cv[k], cv[k + 1], cv[k + 2], fw)[None, :] for k in (0, 1)]
                qr = [_centre(rv[k], rv[k + 1], rv[k + 2], fh)[:, None] for k in (0, 1)]
                g = [tuple(a[qr[j], qc[i]] for a in resp) for j, i in ((0, 0), (0, 1), (1, 0), (1, 1))]
                ppx, ppy = px[xs][None, :], py[ys][:, None]
                shape = _easu_shape(g, ppx, ppy)
                t = [[[fp[c][rv[r][:, None], cv[q][None, :]] for q in range(4)] for r in range(4)] for c in range(3)]
                ring = _easu_half(t, shape, np.broadcast_to(ppx, shape[0].shape), np.broadcast_to(ppy, shape[0].shape))
                tile = _rcas_half(ring, sharp, denoise) if apply_rcas else ring[:, 1:-1, 1:-1]
                h, w = min(th, hout - y0), min(tw, wout - x0)
                out[:, y0:y0 + h, x0:x0 + w] = tile[:, :h, :w]
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_mirror_of_k6_equals_easu_h_reference(case):
    """The kernel's order of operations, mirrored, gives the plain
    version's bits on every case (colour planes)."""
    _, kind, shape, kw = case
    t = _torch(_source(10, shape, kind), kind)
    hin, win = shape[-2:]
    out_hw = tuple(fsr_tpu_torch.upscale(t[..., :1, :, :].float().expand(*t.shape[:-3], 3, hin, win),
                                         apply_rcas=False, impl="torch",
                                         **{k: v for k, v in kw.items() if k not in ("apply_rcas", "denoise")}
                                         ).shape[-2:])
    con = _con((hin, win), out_hw, kw.get("input_viewport", (hin, win)), kw.get("input_offset", (0, 0)))
    rcon = RcasConstants(kw.get("sharpness", 0.25))
    rc, dn = kw.get("apply_rcas", True), kw.get("denoise", False)
    want = teasu_h.easu_h_reference(t, out_hw, con, rcon, rc, dn)
    frames = t.reshape(-1, *t.shape[-3:])
    got = np.stack([k6_mirror(x, out_hw, con, rcon, rc, dn) for x in frames])
    np.testing.assert_array_equal(got.view(np.int16), want.reshape(-1, *want.shape[-3:])[:, :3].numpy().view(np.int16))


# Row strips whose seams cut K6's 30-row tiles of the whole frame (and
# leave partial tiles in the strips): 2x at 48 rows, 1.5x at 24 and 48.
STRIP_CASES = [("2x, 2 strips", (48, 80), (96, 160), 2, (True, False)),
               ("2x, 4 strips, denoise", (48, 80), (96, 160), 4, (True, True)),
               ("1.5x, 2 strips", (64, 96), (96, 144), 2, (True, False)),
               ("1.5x, 4 strips, RCAS off", (64, 96), (96, 144), 4, (False, False))]


@pytest.mark.parametrize("case", STRIP_CASES, ids=lambda c: c[0])
def test_mirror_of_k6_strips_equals_the_whole_frame(case):
    """K6's strip form, mirrored block by block on each strip's halo'd rows
    and row tables, gives the whole frame's bits (the plain version's),
    and each strip's plain version's: a seam's rows come from the halo and
    count as interior (``centre``), the frame's edge rows from the tables'
    clamp."""
    from fsr_tpu_torch.kernels import halo
    from fsr_tpu_torch.parallel import spatial

    _, in_hw, out_hw, n, (rc, dn) = case
    x = _torch(_source(11, (2, 3, *in_hw), "float16"), "float16")
    layout = spatial._layout(in_hw, out_hw, n, None, (0, 0))
    rcon = RcasConstants(0.25)
    srcs = spatial._sources(list(x.split(in_hw[0] // n, dim=-2)), layout.halo)
    got, plain = [], []
    for s, st in zip(srcs, layout.strips):
        rows = halo.halo_rows_reference(s)
        got.append(np.stack([k6_mirror(f, layout.out_hw, layout.con, rcon, rc, dn, st.rows) for f in rows]))
        plain.append(teasu_h.easu_h_reference(s, layout.out_hw, layout.con, rcon, rc, dn, row_plan=st.rows).numpy())
    got, plain = np.concatenate(got, axis=-2), np.concatenate(plain, axis=-2)
    want = teasu_h.easu_h_reference(x, out_hw, layout.con, rcon, rc, dn).numpy()
    np.testing.assert_array_equal(got.view(np.int16), want.view(np.int16))
    np.testing.assert_array_equal(plain.view(np.int16), want.view(np.int16))


def _all_halves():
    return np.arange(65536, dtype=np.uint32).astype(np.uint16).view(F16)


def test_reciprocal_of_every_half_is_torch_one_over_x():
    """numpy's float32 1/x rounded to half equals torch's ``1.0 / t`` in
    float16, bit for bit, over all 65,536 patterns (NaN as NaN): the
    identity the kernel's rcp keeps."""
    x = _all_halves()
    want = (1.0 / torch.from_numpy(x.copy())).numpy()
    got = _rcp_h(x)
    nan = np.isnan(want)
    assert want.dtype == F16 and np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint16), want[~nan].view(np.uint16))


def test_reciprocal_margin_lets_an_approximate_float32_reciprocal_round_alike():
    """1/x of every finite nonzero half lies more than 2 float32 ulps from
    each point halfway between two halves, so a float32 reciprocal within
    2 ulps (MUFU.RCP: 1) rounds to the same half as the exact one; 0, inf
    and the overflow to inf are the IEEE cases."""
    x = _all_halves()
    fin = np.isfinite(x) & (x != 0)
    inv = 1.0 / x[fin].astype(np.float64)  # within 2^-53 of 1/x: far below the margin
    with np.errstate(over="ignore"):
        h = inv.astype(F16)
    h64 = h.astype(np.float64)
    toward = np.where(inv > h64, np.nextafter(h, F16(np.inf)), np.nextafter(h, F16(-np.inf))).astype(np.float64)
    ok = np.isfinite(h64) & np.isfinite(toward)
    mid = (h64 + toward)[ok] / 2
    ulp = np.spacing(np.abs(inv[ok]).astype(F32)).astype(np.float64)
    assert (np.abs(inv[ok] - mid) / ulp).min() > 2.0
    # 1/x past the largest half rounds to inf: far past its midpoint too.
    big = ~np.isfinite(h64)
    assert (np.abs(inv[big]) >= 65520.0 * (1 + 2 * 2.0 ** -23)).all()


@pytest.mark.parametrize("in_hw,out_hw,vp,off", [
    ((27, 48), (54, 96), None, (0, 0)), ((36, 64), (54, 96), None, (0, 0)), ((30, 40), (51, 68), None, (0, 0)),
    ((40, 72), (54, 96), (36, 64), (2, 4)), ((27, 48), (53, 97), None, (0, 0)), ((30, 44), (30, 44), None, (0, 0)),
    ((1080, 1920), (2160, 3840), None, (0, 0)), ((1440, 2560), (2160, 3840), None, (0, 0))])
def test_k6_tile_footprint_fits_and_quadrant_centres_lie_on_the_grid(in_hw, out_hw, vp, off):
    """For K6's TILE: every block's footprint fits (TH + 5, TW + 5), and
    each pixel's quadrant centre index (``centre``) names a grid cell whose
    neighbours are the pixel's own tap columns and rows."""
    con = _con(in_hw, out_hw, vp, off)
    gplan = tgather.plan(in_hw, out_hw, con)
    th, tw = teasu_h.TILE
    for axis, table, n, tile in ((0, gplan.rows[:, 1:-1], out_hw[0], th), (1, gplan.cols, out_hw[1], tw)):
        for s in range(0, n, tile):
            ring = np.clip(np.arange(s - 1, s + tile + 1), 0, n - 1)
            taps = table[:, ring]
            lo, size = taps.min(), taps.max() - taps.min() + 1
            assert size <= tile + 5
            for k in (0, 1):
                a, b, c = (taps[k + j] - lo for j in range(3))
                v = _centre(a, b, c, size)
                # the grid's neighbours of v, clamped to the footprint, are a, b, c
                np.testing.assert_array_equal(np.clip(v - 2, 0, size - 1), a)
                np.testing.assert_array_equal(np.clip(v - 1, 0, size - 1), b)
                np.testing.assert_array_equal(np.clip(v, 0, size - 1), c)
