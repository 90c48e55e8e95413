"""The benchmark's plain reference for FSR 1.0's EASU + RCAS with UNORM8 I/O.

A frozen copy, in plain PyTorch, of the NumPy oracle's float32 semantics
(``FsrEasuF``, ffx_fsr1.h:315-437; ``FsrRcasF``, ffx_fsr1.h:684-769;
the bit-trick approximations ``APrx*``, ffx_a.h:1786-1860): every step is
one elementwise operation rounded to ``dtype``, so on the CPU in float32 it
is bit-equal to the oracle, and on the card it is the same arithmetic.  It
imports nothing of the program: the constants (``FsrEasuCon``,
``FsrRcasCon``, ffx_fsr1.h:156-225, 662-672) and the coordinates are worked
out again here from the configuration's sizes and sharpness.

``dtype=torch.bfloat16`` computes every step after the coordinate set-up in
bfloat16 (the bit tricks on its values widened to float32): the benchmark's
lower-precision control.

Bytes decode as v * float32(1/255), the rule of the FSR package that the
port follows (``fsr_tpu/utils/image.py`` ``from_uint8``), and encode as
floor(sat(v) * 255 + 0.5), the D3D UNORM rule of the sample's RGBA8 target.
The decode has to be that rule to the bit: a correctly rounded v / 255
differs in the last bit for 126 of the 256 codes, and EASU's direction
estimate is not continuous where neighbouring lumas are equal (the
reciprocal of a zero gradient against that of a one-ulp one), so on
frames of random bytes that last bit moves some outputs by tens of codes.

Tap layout ((dx, dy) from texel 'f'; every tap clamps to the image, the
sample's CLAMP sampler):

        b c
      e f g h
      i j k l
        n o
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["easu_constants", "rcas_sharpness", "decode_unorm8", "encode_unorm8", "easu", "rcas", "upscale_frame",
           "expected"]

TAPS = (
    ("b", 0, -1), ("c", 1, -1), ("i", -1, 1), ("j", 0, 1), ("f", 0, 0), ("e", -1, 0),
    ("k", 1, 1), ("l", 2, 1), ("h", 2, 0), ("g", 1, 0), ("o", 1, 2), ("n", 0, 2),
)
RCAS_LIMIT = 0.25 - 1.0 / 16.0


def _f(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in either type)."""
    return float(np.float32(x))


def easu_constants(in_hw: Tuple[int, int], out_hw: Tuple[int, int]):
    """(scale, offset) per axis as (x, y) float32 values, as ``FsrEasuCon``
    computes them on the host: scale = in * rcp(out), offset =
    0.5 * in * rcp(out) - 0.5, each operation rounded to float32."""
    f32 = np.float32

    def axis(n_in, n_out):
        rcp = f32(f32(1.0) / f32(n_out))
        return float(f32(f32(n_in) * rcp)), float(f32(f32(f32(0.5) * f32(n_in)) * rcp) - f32(0.5))

    (sy, oy), (sx, ox) = axis(in_hw[0], out_hw[0]), axis(in_hw[1], out_hw[1])
    return (sx, sy), (ox, oy)


def rcas_sharpness(stops: float) -> float:
    """``FsrRcasCon``'s linear sharpness exp2(-stops), in float32."""
    return float(np.float32(np.exp2(np.float32(-stops))))


INV255 = float(np.float32(1.0 / 255.0))


def decode_unorm8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * INV255


def encode_unorm8(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    s = torch.where(x > 0, torch.clamp_max(x, 1.0), torch.zeros_like(x))
    return torch.floor(s * 255.0 + 0.5).to(torch.uint8)


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32).view(torch.int32)


def _float(bits: torch.Tensor, dtype) -> torch.Tensor:
    return bits.view(torch.float32).to(dtype)


# The operands are never negative, so the sign bit is 0 and int32 arithmetic
# is the oracle's uint32 arithmetic.
def prx_lo_rcp(a):
    return _float(0x7EF07EBB - _bits(a), a.dtype)


def prx_med_rcp(a):
    b = _float(0x7EF19FFF - _bits(a), a.dtype)
    return b * (-b * a + 2.0)


def prx_lo_rsq(a):
    return _float(0x5F347D74 - (_bits(a) >> 1), a.dtype)


def _sat(x):
    """HLSL saturate: clamp to [0, 1], NaN to 0."""
    return torch.where(x > 0, torch.clamp_max(x, 1.0), torch.zeros_like(x))


def _easu_set(dirx, diry, length, w, l_a, l_b, l_c, l_d, l_e):
    """``FsrEasuSetF`` (ffx_fsr1.h:275-313): one quadrant's direction and
    length; l_a..l_e the '+' pattern's lumas (a above, b c d across, e below)."""
    len_x = prx_lo_rcp(torch.maximum(torch.abs(l_d - l_c), torch.abs(l_c - l_b)))
    dir_x = l_d - l_b
    dirx = dirx + dir_x * w
    len_x = _sat(torch.abs(dir_x) * len_x)
    len_x = len_x * len_x
    length = length + len_x * w
    len_y = prx_lo_rcp(torch.maximum(torch.abs(l_e - l_c), torch.abs(l_c - l_a)))
    dir_y = l_e - l_a
    diry = diry + dir_y * w
    len_y = _sat(torch.abs(dir_y) * len_y)
    len_y = len_y * len_y
    length = length + len_y * w
    return dirx, diry, length


def easu(src: torch.Tensor, out_hw: Tuple[int, int], dtype=torch.float32) -> torch.Tensor:
    """EASU of one frame: src (3, Hin, Win) in [0, 1] -> (3, Hout, Wout) in
    ``dtype``; the coordinates in float32, then every step in ``dtype``."""
    hin, win = src.shape[-2:]
    hout, wout = out_hw
    (sx, sy), (ox, oy) = easu_constants((hin, win), out_hw)
    dev = src.device
    ppx = torch.arange(wout, dtype=torch.float32, device=dev) * sx + ox
    ppy = torch.arange(hout, dtype=torch.float32, device=dev) * sy + oy
    fx, fy = torch.floor(ppx), torch.floor(ppy)
    px = (ppx - fx).to(dtype)[None, :]
    py = (ppy - fy).to(dtype)[:, None]
    col, row = fx.to(torch.int64), fy.to(torch.int64)
    t = {}
    for name, dx, dy in TAPS:
        r = torch.clamp(row + dy, 0, hin - 1)
        c = torch.clamp(col + dx, 0, win - 1)
        t[name] = src[:, r[:, None], c[None, :]].to(dtype)
    lum = {k: v[2] * 0.5 + (v[0] * 0.5 + v[1]) for k, v in t.items()}

    w_s = (1.0 - px) * (1.0 - py)
    w_t = px * (1.0 - py)
    w_u = (1.0 - px) * py
    w_v = px * py
    z = torch.zeros((hout, wout), dtype=dtype, device=dev)
    dirx, diry, length = _easu_set(z, z, z, w_s, lum["b"], lum["e"], lum["f"], lum["g"], lum["j"])
    dirx, diry, length = _easu_set(dirx, diry, length, w_t, lum["c"], lum["f"], lum["g"], lum["h"], lum["k"])
    dirx, diry, length = _easu_set(dirx, diry, length, w_u, lum["f"], lum["i"], lum["j"], lum["k"], lum["n"])
    dirx, diry, length = _easu_set(dirx, diry, length, w_v, lum["g"], lum["j"], lum["k"], lum["l"], lum["o"])

    dir_r = dirx * dirx + diry * diry
    zro = dir_r < _f(1.0 / 32768.0)
    one = torch.ones((), dtype=dtype, device=dev)
    dir_r = torch.where(zro, one, prx_lo_rsq(dir_r))
    dirx = torch.where(zro, one, dirx)
    dirx = dirx * dir_r
    diry = diry * dir_r
    length = length * 0.5
    length = length * length
    stretch = (dirx * dirx + diry * diry) * prx_lo_rcp(torch.maximum(torch.abs(dirx), torch.abs(diry)))
    len2_x = 1.0 + (stretch - 1.0) * length
    len2_y = 1.0 + -0.5 * length
    lob = 0.5 + _f((1.0 / 4.0 - 0.04) - 0.5) * length
    clp = prx_lo_rcp(lob)

    min4 = torch.minimum(torch.minimum(torch.minimum(t["f"], t["g"]), t["j"]), t["k"])
    max4 = torch.maximum(torch.maximum(torch.maximum(t["f"], t["g"]), t["j"]), t["k"])

    ac = torch.zeros_like(t["f"])
    aw = torch.zeros((hout, wout), dtype=dtype, device=dev)
    for name, dx, dy in TAPS:
        off_x = float(dx) - px
        off_y = float(dy) - py
        vx = (off_x * dirx + off_y * diry) * len2_x
        vy = (off_x * -diry + off_y * dirx) * len2_y
        d2 = torch.minimum(vx * vx + vy * vy, clp)
        w_b = _f(2.0 / 5.0) * d2 + -1.0
        w_a = lob * d2 + -1.0
        w_b = w_b * w_b
        w_a = w_a * w_a
        w_b = _f(25.0 / 16.0) * w_b + _f(-(25.0 / 16.0 - 1.0))
        w = w_b * w_a
        ac = ac + t[name] * w
        aw = aw + w
        del t[name]
    pix = ac * (1.0 / aw)
    return torch.minimum(max4, torch.maximum(min4, pix))


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """result[y, x] = img[clamp(y + dy), clamp(x + dx)]."""
    h, w = img.shape[-2:]
    r = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    c = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[..., r[:, None], c[None, :]]


def rcas(img: torch.Tensor, sharpness: float, denoise: bool = False) -> torch.Tensor:
    """RCAS of one frame (3, H, W), in ``img``'s dtype."""
    b, d, e, f, h = _shift(img, -1, 0), _shift(img, 0, -1), img, _shift(img, 0, 1), _shift(img, 1, 0)

    def luma(c):
        return c[2] * 0.5 + (c[0] * 0.5 + c[1])

    b_l, d_l, e_l, f_l, h_l = luma(b), luma(d), luma(e), luma(f), luma(h)
    nz = 0.25 * b_l + 0.25 * d_l + 0.25 * f_l + 0.25 * h_l - e_l
    rng = (torch.maximum(torch.maximum(torch.maximum(b_l, d_l), torch.maximum(e_l, f_l)), h_l)
           - torch.minimum(torch.minimum(torch.minimum(b_l, d_l), torch.minimum(e_l, f_l)), h_l))
    nz = _sat(torch.abs(nz) * prx_med_rcp(rng))
    nz = -0.5 * nz + 1.0

    mn4 = torch.minimum(torch.minimum(b, d), torch.minimum(f, h))
    mx4 = torch.maximum(torch.maximum(b, d), torch.maximum(f, h))
    # The limiters can read 0 * inf = NaN; the GPU's max drops a NaN operand.
    hit_min = torch.minimum(mn4, e) * (1.0 / (4.0 * mx4))
    hit_max = (1.0 - torch.maximum(mx4, e)) * (1.0 / (4.0 * mn4 + -4.0))
    neg = -hit_min
    lobe_rgb = torch.maximum(torch.where(torch.isnan(neg), hit_max, neg),
                             torch.where(torch.isnan(hit_max), neg, hit_max))
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    lobe = torch.minimum(torch.maximum(torch.maximum(lobe_rgb[0], lobe_rgb[1]), lobe_rgb[2]), zero)
    lobe = torch.maximum(zero - _f(RCAS_LIMIT), lobe) * _f(sharpness)
    if denoise:
        lobe = lobe * nz
    rcp_l = prx_med_rcp(4.0 * lobe + 1.0)
    return (lobe * b + lobe * d + lobe * h + lobe * f + e) * rcp_l


def upscale_frame(src_u8: torch.Tensor, out_hw: Tuple[int, int], sharpness_stops: float, apply_rcas: bool = True,
                  denoise: bool = False, dtype=torch.float32) -> torch.Tensor:
    """One uint8 frame (3, Hin, Win) -> its uint8 (3, Hout, Wout) output:
    decode, EASU, RCAS, encode."""
    out = easu(decode_unorm8(src_u8), out_hw, dtype)
    if apply_rcas:
        out = rcas(out, rcas_sharpness(sharpness_stops), denoise)
    return encode_unorm8(out)


def expected(inputs: dict, cfg: dict, dtype=torch.float32) -> torch.Tensor:
    """The frame a configuration's call should give for ``inputs`` (its
    source frame ``src``), computed in ``dtype``."""
    return upscale_frame(inputs["src"], tuple(cfg["out_size"]), cfg["sharpness_stops"], cfg["apply_rcas"],
                         cfg["denoise"], dtype=dtype)
