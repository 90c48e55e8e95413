"""Pure-NumPy scalar-semantics oracle.

Copy of ``fsr_tpu/reference/scalar.py`` (the frozen ground truth of the JAX
package), so that the port can be held against the oracle where JAX is not
installed.  It imports this package's constants; a CPU test holds every
function bit-equal to its original.

- EASU fp32 (``FsrEasuF``, ffx_fsr1.h:315-437) and the packed-fp16 variant
  (``FsrEasuH``, ffx_fsr1.h:505-593: fp16 rounding after the coordinate
  setup, the exact reciprocal in the set stage, its accumulation order),
  with the bit-trick reciprocal / rsqrt approximations (``APrx*``,
  ffx_a.h:1786-1860) in float32 and float16.
- RCAS fp32 / fp16 (``FsrRcasF``, ffx_fsr1.h:684-769; ``FsrRcasH``,
  ffx_fsr1.h:782-866), incl. denoise and alpha passthrough.
- SRTM, SRTM^-1, LFGA and TEPD (ffx_fsr1.h:990-1121).
- The bilinear fallback (FSR_Pass.hlsl:70-73).

Tap layout ((dx, dy) offsets from texel 'f'):

        b c
      e f g h
      i j k l
        n o

All tap reads clamp to the image border (the sample binds a CLAMP sampler).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants, FSR_RCAS_LIMIT

__all__ = [
    "TAPS",
    "prx_lo_rcp_f32",
    "prx_med_rcp_f32",
    "prx_lo_rsq_f32",
    "prx_lo_sqrt_f32",
    "prx_lo_rcp_f16",
    "prx_med_rcp_f16",
    "prx_lo_rsq_f16",
    "prx_lo_sqrt_f16",
    "easu_ref",
    "easu_ref_f16",
    "rcas_ref",
    "srtm_ref",
    "srtm_inv_ref",
    "lfga_ref",
    "tepd_dither_ref",
    "tepd_quantize_ref",
    "bilinear_ref",
]

F32 = np.float32
F16 = np.float16

# (name, dx, dy) relative to 'f'; order matches the FsrEasuF tap accumulation.
TAPS = (
    ("b", 0, -1),
    ("c", 1, -1),
    ("i", -1, 1),
    ("j", 0, 1),
    ("f", 0, 0),
    ("e", -1, 0),
    ("k", 1, 1),
    ("l", 2, 1),
    ("h", 2, 0),
    ("g", 1, 0),
    ("o", 1, 2),
    ("n", 0, 2),
)

# ----------------------------------------------------------------------------
# Bit-trick approximations (ffx_a.h:1786-1860), float32 and float16.
# ----------------------------------------------------------------------------


def _u32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _f32v(u: np.ndarray) -> np.ndarray:
    return np.asarray(u, dtype=np.uint32).view(np.float32)


def prx_lo_rcp_f32(a):
    return _f32v(np.uint32(0x7EF07EBB) - _u32(a))


def prx_med_rcp_f32(a):
    a = np.asarray(a, dtype=F32)
    b = _f32v(np.uint32(0x7EF19FFF) - _u32(a))
    return b * (-b * a + F32(2.0))


def prx_lo_rsq_f32(a):
    return _f32v(np.uint32(0x5F347D74) - (_u32(a) >> np.uint32(1)))


def prx_lo_sqrt_f32(a):
    return _f32v((_u32(a) >> np.uint32(1)) + np.uint32(0x1FBC4639))


def _u16(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float16).view(np.uint16)


def _f16v(u: np.ndarray) -> np.ndarray:
    return np.asarray(u, dtype=np.uint16).view(np.float16)


def prx_lo_rcp_f16(a):
    return _f16v(np.uint16(0x7784) - _u16(a))


def prx_med_rcp_f16(a):
    a = np.asarray(a, dtype=F16)
    b = _f16v(np.uint16(0x778D) - _u16(a))
    return b * (-b * a + F16(2.0))


def prx_lo_rsq_f16(a):
    return _f16v(np.uint16(0x59A3) - (_u16(a) >> np.uint16(1)))


def prx_lo_sqrt_f16(a):
    return _f16v((_u16(a) >> np.uint16(1)) + np.uint16(0x1DE2))


# ----------------------------------------------------------------------------
# EASU fp32 oracle (FsrEasuF semantics)
# ----------------------------------------------------------------------------


def _gather_taps(src: np.ndarray, row: np.ndarray, col: np.ndarray, dtype) -> Dict[str, np.ndarray]:
    """src: (3, Hin, Win); row/col: int arrays (Hout,), (Wout,) of 'f' texel."""
    hin, win = src.shape[-2:]
    taps = {}
    for name, dx, dy in TAPS:
        r = np.clip(row + dy, 0, hin - 1)
        c = np.clip(col + dx, 0, win - 1)
        taps[name] = src[:, r[:, None], c[None, :]].astype(dtype)
    return taps


def _sat(x, dt):
    """HLSL saturate semantics: clamp to [0,1] with NaN -> 0.

    The reference's ASat* is a GPU saturate; the fp16 path can produce
    0 * INF = NaN in the set stage (ARcpH2(0) = INF with dirX = 0) and
    relies on saturate flushing it to 0.
    """
    return np.where(x > dt(0.0), np.minimum(x, dt(1.0)), dt(0.0)).astype(dt)


def _easu_set_f(dirx, diry, length, w, l_a, l_b, l_c, l_d, l_e, *, f16: bool):
    """FsrEasuSetF (ffx_fsr1.h:275-313): one quadrant's dir/len contribution.

    l_a..l_e are the '+' pattern lumas:   a
                                        b c d
                                          e
    """
    if f16:
        dt = F16
        rcp = lambda x: (F16(1.0) / x.astype(F16)).astype(F16)  # ARcpH2: hw rcp
    else:
        dt = F32
        rcp = prx_lo_rcp_f32  # the F path uses APrxLoRcpF1 (ffx_fsr1.h:298)
    with np.errstate(divide="ignore", invalid="ignore"):
        dc = l_d - l_c
        cb = l_c - l_b
        len_x = np.maximum(np.abs(dc), np.abs(cb)).astype(dt)
        len_x = rcp(len_x)
        dir_x = (l_d - l_b).astype(dt)
        dirx = dirx + dir_x * w
        len_x = _sat(np.abs(dir_x) * len_x, dt)
        len_x = len_x * len_x
        length = length + len_x * w

        ec = l_e - l_c
        ca = l_c - l_a
        len_y = np.maximum(np.abs(ec), np.abs(ca)).astype(dt)
        len_y = rcp(len_y)
        dir_y = (l_e - l_a).astype(dt)
        diry = diry + dir_y * w
        len_y = _sat(np.abs(dir_y) * len_y, dt)
        len_y = len_y * len_y
        length = length + len_y * w
    return dirx, diry, length


def _easu_tap_f(ac, aw, off_x, off_y, dir_x, dir_y, len2_x, len2_y, lob, clp, color, dt):
    """FsrEasuTapF (ffx_fsr1.h:239-272): one tap's weighted contribution."""
    vx = (off_x * dir_x + off_y * dir_y).astype(dt)
    vy = (off_x * (-dir_y) + off_y * dir_x).astype(dt)
    vx = vx * len2_x
    vy = vy * len2_y
    d2 = vx * vx + vy * vy
    d2 = np.minimum(d2, clp)
    w_b = dt(2.0 / 5.0) * d2 + dt(-1.0)
    w_a = lob * d2 + dt(-1.0)
    w_b = w_b * w_b
    w_a = w_a * w_a
    w_b = dt(25.0 / 16.0) * w_b + dt(-(25.0 / 16.0 - 1.0))
    w = (w_b * w_a).astype(dt)
    return ac + color * w, aw + w


def _easu_coords(con: EasuConstants, out_size: Tuple[int, int]):
    hout, wout = out_size
    sx, sy = con.scale
    ox, oy = con.offset
    ppx = np.arange(wout, dtype=F32) * sx + ox
    ppy = np.arange(hout, dtype=F32) * sy + oy
    fx = np.floor(ppx)
    fy = np.floor(ppy)
    px = (ppx - fx).astype(F32)
    py = (ppy - fy).astype(F32)
    return fx.astype(np.int64), fy.astype(np.int64), px, py


def easu_ref(src: np.ndarray, out_size: Tuple[int, int], con: EasuConstants) -> np.ndarray:
    """EASU upscale, fp32 scalar semantics (FsrEasuF, ffx_fsr1.h:315-437).

    src: float32 (3, Hin, Win) in [0, 1].  Returns float32 (3, Hout, Wout).
    """
    src = np.asarray(src, dtype=F32)
    hout, wout = out_size
    col, row, px, py = _easu_coords(con, out_size)
    ppx = px[None, :]  # (1, Wout)
    ppy = py[:, None]  # (Hout, 1)
    t = _gather_taps(src, row, col, F32)
    lum = {k: (v[2] * F32(0.5) + (v[0] * F32(0.5) + v[1])).astype(F32) for k, v in t.items()}

    one = F32(1.0)
    w_s = ((one - ppx) * (one - ppy)).astype(F32)
    w_t = (ppx * (one - ppy)).astype(F32)
    w_u = ((one - ppx) * ppy).astype(F32)
    w_v = (ppx * ppy).astype(F32)

    shape = np.broadcast_shapes(w_s.shape, (hout, wout))
    dirx = np.zeros(shape, F32)
    diry = np.zeros(shape, F32)
    length = np.zeros(shape, F32)
    # Quadrant '+' patterns (ffx_fsr1.h:383-386).
    dirx, diry, length = _easu_set_f(dirx, diry, length, w_s, lum["b"], lum["e"], lum["f"], lum["g"], lum["j"], f16=False)
    dirx, diry, length = _easu_set_f(dirx, diry, length, w_t, lum["c"], lum["f"], lum["g"], lum["h"], lum["k"], f16=False)
    dirx, diry, length = _easu_set_f(dirx, diry, length, w_u, lum["f"], lum["i"], lum["j"], lum["k"], lum["n"], f16=False)
    dirx, diry, length = _easu_set_f(dirx, diry, length, w_v, lum["g"], lum["j"], lum["k"], lum["l"], lum["o"], f16=False)

    # Normalize direction; zero-protect (ffx_fsr1.h:388-395).
    dir_r = dirx * dirx + diry * diry
    zro = dir_r < F32(1.0 / 32768.0)
    dir_r = prx_lo_rsq_f32(dir_r)
    dir_r = np.where(zro, F32(1.0), dir_r)
    dirx = np.where(zro, F32(1.0), dirx)
    dirx = dirx * dir_r
    diry = diry * dir_r
    length = (length * F32(0.5)).astype(F32)
    length = length * length
    stretch = ((dirx * dirx + diry * diry) * prx_lo_rcp_f32(np.maximum(np.abs(dirx), np.abs(diry)))).astype(F32)
    len2_x = (F32(1.0) + (stretch - F32(1.0)) * length).astype(F32)
    len2_y = (F32(1.0) + F32(-0.5) * length).astype(F32)
    lob = (F32(0.5) + F32((1.0 / 4.0 - 0.04) - 0.5) * length).astype(F32)
    clp = prx_lo_rcp_f32(lob)

    # Dering bounds from nearest 2x2 {f,g,j,k} (ffx_fsr1.h:416-419).
    min4 = np.minimum(np.minimum(np.minimum(t["f"], t["g"]), t["j"]), t["k"])
    max4 = np.maximum(np.maximum(np.maximum(t["f"], t["g"]), t["j"]), t["k"])

    ac = np.zeros_like(t["f"])
    aw = np.zeros(shape, F32)
    for name, dx, dy in TAPS:
        off_x = (F32(dx) - ppx).astype(F32)
        off_y = (F32(dy) - ppy).astype(F32)
        ac, aw = _easu_tap_f(ac, aw, off_x, off_y, dirx, diry, len2_x, len2_y, lob, clp, t[name], F32)
    pix = ac * (F32(1.0) / aw)
    return np.minimum(max4, np.maximum(min4, pix)).astype(F32)


# ----------------------------------------------------------------------------
# EASU fp16 oracle (FsrEasuH semantics: fp16 math, fp32 coordinate setup)
# ----------------------------------------------------------------------------


def easu_ref_f16(src: np.ndarray, out_size: Tuple[int, int], con: EasuConstants) -> np.ndarray:
    """EASU upscale, packed-fp16 semantics (FsrEasuH, ffx_fsr1.h:505-593).

    The packed-pair trick is plain elementwise fp16 math once vectorized; what
    differs from the fp32 path is (a) fp16 rounding everywhere after the
    coordinate setup, (b) ARcpH2 (exact-rounded rcp here) instead of
    APrxLoRcpF1 in the set stage, (c) the H-path accumulation order
    (S,U into lane r; T,V into lane g; then r+g).
    """
    src16 = np.asarray(src).astype(F16)
    hout, wout = out_size
    col, row, px, py = _easu_coords(con, out_size)
    ppx = px.astype(F16)[None, :]
    ppy = py.astype(F16)[:, None]
    t = _gather_taps(src16, row, col, F16)
    lum = {k: (v[2] * F16(0.5) + (v[0] * F16(0.5) + v[1])).astype(F16) for k, v in t.items()}

    one = F16(1.0)
    w_s = ((one - ppx) * (one - ppy)).astype(F16)
    w_t = (ppx * (one - ppy)).astype(F16)
    w_u = ((one - ppx) * ppy).astype(F16)
    w_v = (ppx * ppy).astype(F16)

    shape = np.broadcast_shapes(ppx.shape, (hout, wout))
    z = np.zeros(shape, F16)
    # Lane r accumulates quadrants S then U; lane g accumulates T then V
    # (FsrEasuSetH calls at ffx_fsr1.h:555-556), then dir = r+g.
    dxr, dyr, lr = _easu_set_f(z, z, z, w_s, lum["b"], lum["e"], lum["f"], lum["g"], lum["j"], f16=True)
    dxr, dyr, lr = _easu_set_f(dxr, dyr, lr, w_u, lum["f"], lum["i"], lum["j"], lum["k"], lum["n"], f16=True)
    dxg, dyg, lg = _easu_set_f(z, z, z, w_t, lum["c"], lum["f"], lum["g"], lum["h"], lum["k"], f16=True)
    dxg, dyg, lg = _easu_set_f(dxg, dyg, lg, w_v, lum["g"], lum["j"], lum["k"], lum["l"], lum["o"], f16=True)
    dirx = (dxr + dxg).astype(F16)
    diry = (dyr + dyg).astype(F16)
    length = (lr + lg).astype(F16)

    dir_r = dirx * dirx + diry * diry
    zro = dir_r < F16(1.0 / 32768.0)
    dir_r = prx_lo_rsq_f16(dir_r)
    dir_r = np.where(zro, F16(1.0), dir_r)
    dirx = np.where(zro, F16(1.0), dirx)
    dirx = (dirx * dir_r).astype(F16)
    diry = (diry * dir_r).astype(F16)
    length = (length * F16(0.5)).astype(F16)
    length = length * length
    stretch = ((dirx * dirx + diry * diry) * prx_lo_rcp_f16(np.maximum(np.abs(dirx), np.abs(diry)))).astype(F16)
    len2_x = (F16(1.0) + (stretch - F16(1.0)) * length).astype(F16)
    len2_y = (F16(1.0) + F16(-0.5) * length).astype(F16)
    lob = (F16(0.5) + F16((1.0 / 4.0 - 0.04) - 0.5) * length).astype(F16)
    clp = prx_lo_rcp_f16(lob)

    min4 = np.minimum(np.minimum(np.minimum(t["f"], t["g"]), t["j"]), t["k"])
    max4 = np.maximum(np.maximum(np.maximum(t["f"], t["g"]), t["j"]), t["k"])

    ac = np.zeros_like(t["f"])
    aw = np.zeros(shape, F16)
    for name, dx, dy in TAPS:
        off_x = (F16(dx) - ppx).astype(F16)
        off_y = (F16(dy) - ppy).astype(F16)
        ac, aw = _easu_tap_f(ac, aw, off_x, off_y, dirx, diry, len2_x, len2_y, lob, clp, t[name], F16)
    pix = ac * (F16(1.0) / aw).astype(F16)
    return np.minimum(max4, np.maximum(min4, pix)).astype(F16)


# ----------------------------------------------------------------------------
# RCAS oracle (FsrRcasF, ffx_fsr1.h:684-769)
# ----------------------------------------------------------------------------


def _shift_edge(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """img (..., H, W) shifted so result[y,x] = img[clamp(y+dy), clamp(x+dx)]."""
    h, w = img.shape[-2:]
    r = np.clip(np.arange(h) + dy, 0, h - 1)
    c = np.clip(np.arange(w) + dx, 0, w - 1)
    return img[..., r[:, None], c[None, :]]


def rcas_ref(
    img: np.ndarray,
    con: RcasConstants,
    denoise: bool = False,
    dtype=F32,
) -> np.ndarray:
    """RCAS sharpening, scalar semantics.

    img: (3, H, W) or (4, H, W) (alpha passed through, FSR_RCAS_PASSTHROUGH_ALPHA).
    dtype=np.float16 gives FsrRcasH semantics (sharpness read from the packed
    half constant, ffx_fsr1.h:857).
    """
    dt = dtype
    img = np.asarray(img)
    has_alpha = img.shape[0] == 4
    rgb = img[:3].astype(dt)
    if dt == F16:
        sharp = dt(con.sharpness_f16)
        med_rcp = prx_med_rcp_f16
        rcp = lambda x: (dt(1.0) / x).astype(dt)
    else:
        sharp = dt(con.sharpness)
        med_rcp = prx_med_rcp_f32
        rcp = lambda x: (dt(1.0) / x).astype(dt)

    b = _shift_edge(rgb, -1, 0)
    d = _shift_edge(rgb, 0, -1)
    e = rgb
    f = _shift_edge(rgb, 0, 1)
    h = _shift_edge(rgb, 1, 0)

    def luma(c):
        return (c[2] * dt(0.5) + (c[0] * dt(0.5) + c[1])).astype(dt)

    b_l, d_l, e_l, f_l, h_l = luma(b), luma(d), luma(e), luma(f), luma(h)
    # Noise detection (ffx_fsr1.h:736-739).
    nz = (dt(0.25) * b_l + dt(0.25) * d_l + dt(0.25) * f_l + dt(0.25) * h_l - e_l).astype(dt)
    rng = (
        np.maximum(np.maximum(np.maximum(b_l, d_l), np.maximum(e_l, f_l)), h_l)
        - np.minimum(np.minimum(np.minimum(b_l, d_l), np.minimum(e_l, f_l)), h_l)
    ).astype(dt)
    nz = _sat(np.abs(nz) * med_rcp(rng), dt)
    nz = (dt(-0.5) * nz + dt(1.0)).astype(dt)

    mn4 = np.minimum(np.minimum(b, d), np.minimum(f, h))
    mx4 = np.maximum(np.maximum(b, d), np.maximum(f, h))
    # Limiters need high-precision rcp (comment at ffx_fsr1.h:749).  The
    # divisions can hit 0*INF = NaN (e.g. mx4 == 0 under a bright center
    # pixel); GPU max() drops the NaN operand, which we emulate explicitly —
    # this path is load-bearing: it is what lets RCAS spike isolated bright
    # pixels to the clipping point.
    with np.errstate(divide="ignore", invalid="ignore"):
        hit_min = np.minimum(mn4, e) * rcp(dt(4.0) * mx4)
        hit_max = (dt(1.0) - np.maximum(mx4, e)) * rcp(dt(4.0) * mn4 + dt(-4.0))
    neg_hit_min = -hit_min
    lobe_rgb = np.maximum(
        np.where(np.isnan(neg_hit_min), hit_max, neg_hit_min),
        np.where(np.isnan(hit_max), neg_hit_min, hit_max),
    )
    lobe = (
        np.maximum(
            dt(-FSR_RCAS_LIMIT),
            np.minimum(np.maximum(np.maximum(lobe_rgb[0], lobe_rgb[1]), lobe_rgb[2]), dt(0.0)),
        )
        * sharp
    ).astype(dt)
    if denoise:
        lobe = (lobe * nz).astype(dt)
    rcp_l = med_rcp(dt(4.0) * lobe + dt(1.0))
    out = ((lobe * b + lobe * d + lobe * h + lobe * f + e) * rcp_l).astype(dt)
    if has_alpha:
        out = np.concatenate([out, img[3:4].astype(dt)], axis=0)
    return out


# ----------------------------------------------------------------------------
# SRTM / LFGA / TEPD / bilinear (ffx_fsr1.h:990-1199)
# ----------------------------------------------------------------------------


def srtm_ref(c: np.ndarray, dtype=F32) -> np.ndarray:
    """FsrSrtmF: c *= rcp(max3(c) + 1). c: (3, H, W) HDR {0..fp16max}."""
    dt = dtype
    c = np.asarray(c).astype(dt)
    m = np.maximum(np.maximum(c[0], c[1]), c[2])
    return (c * (dt(1.0) / (m + dt(1.0)))).astype(dt)


def srtm_inv_ref(c: np.ndarray, dtype=F32) -> np.ndarray:
    """FsrSrtmInvF: c *= rcp(max(1/32768, 1 - max3(c)))."""
    dt = dtype
    c = np.asarray(c).astype(dt)
    m = np.maximum(np.maximum(c[0], c[1]), c[2])
    return (c * (dt(1.0) / np.maximum(dt(1.0 / 32768.0), dt(1.0) - m))).astype(dt)


def lfga_ref(c: np.ndarray, grain: np.ndarray, amount: float, dtype=F32) -> np.ndarray:
    """FsrLfgaF: c += (t*a) * min(1-c, c); grain in {-0.5..0.5}, 3-channel."""
    dt = dtype
    c = np.asarray(c).astype(dt)
    t = np.asarray(grain).astype(dt)
    return (c + (t * dt(amount)) * np.minimum(dt(1.0) - c, c)).astype(dt)


def tepd_dither_ref(h: int, w: int, frame: int) -> np.ndarray:
    """FsrTepdDitF (ffx_fsr1.h:1086-1094): golden-ratio ordered dither, {0..<1}."""
    x = (np.arange(w, dtype=np.uint32) + np.uint32(frame)).astype(F32)[None, :]
    y = np.arange(h, dtype=F32)[:, None]
    a = F32((1.0 + np.sqrt(np.float64(5.0))) / 2.0)
    b = F32(1.0 / 3.69)
    v = (x * a + (y * b)).astype(F32)
    return (v - np.floor(v)).astype(F32)


def tepd_quantize_ref(c: np.ndarray, dit: np.ndarray, bits: int = 10) -> np.ndarray:
    """FsrTepdC8F / C10F: energy-preserving dithered linear -> gamma-2.0 quantize."""
    steps = F32(255.0) if bits == 8 else F32(1023.0)
    inv = F32(1.0) / steps
    c = np.asarray(c, dtype=F32)
    n = np.sqrt(c).astype(F32)
    n = (np.floor(n * steps) * inv).astype(F32)
    a = n * n
    b = (n + inv).astype(F32)
    b = b * b
    r = ((c - b) * prx_med_rcp_f32(a - b)).astype(F32)
    # AGtZeroF3(x) = sat(x * +INF): 1 where x > 0, else 0.
    gt = (dit[None] - r > F32(0.0)).astype(F32)
    return np.clip(n + gt * inv, F32(0.0), F32(1.0)).astype(F32)


def bilinear_ref(src: np.ndarray, out_size: Tuple[int, int], con: EasuConstants) -> np.ndarray:
    """Bilinear fallback using the same con0 mapping (FSR_Pass.hlsl:70-73)."""
    src = np.asarray(src, dtype=F32)
    hin, win = src.shape[-2:]
    col, row, px, py = _easu_coords(con, out_size)
    c0 = np.clip(col, 0, win - 1)
    c1 = np.clip(col + 1, 0, win - 1)
    r0 = np.clip(row, 0, hin - 1)
    r1 = np.clip(row + 1, 0, hin - 1)
    px = px[None, None, :]
    py = py[None, :, None]
    tl = src[:, r0[:, None], c0[None, :]]
    tr = src[:, r0[:, None], c1[None, :]]
    bl = src[:, r1[:, None], c0[None, :]]
    br = src[:, r1[:, None], c1[None, :]]
    top = tl + (tr - tl) * px
    bot = bl + (br - bl) * px
    return (top + (bot - top) * py).astype(F32)
