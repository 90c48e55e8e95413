"""The benchmark's plain reference for FSR 1.0's float16 path with UNORM8
I/O, as the port computes it: FsrEasuH with its direction and length
estimate kept in float32 ("mixed"), then FsrRcasH.

Every step is one elementwise PyTorch operation rounded to its type, in
the order the program's plain float16 path computes it.  It imports nothing
of the program: the constants, the coordinates, the UNORM8 decode and
encode and the float32 bit tricks are ``fsrbench.reference.fsr1``'s.

- The source: each byte decoded as ``fsr1.decode_unorm8`` (v *
  float32(1/255)), then rounded to half.
- EASU (FsrEasuH, ffx_fsr1.h:505-593).  The coordinates in float32
  (``FsrEasuCon``, ffx_fsr1.h:156-225).  Each tap's luma, B * 0.5 + (R *
  0.5 + G), in half (ffx_fsr1.h:362-366), widened to float32.  The four
  quadrants' direction and length (``FsrEasuSetF``, ffx_fsr1.h:275-313,
  with ``APrxLoRcpF1``, ffx_a.h:1786-1860) and the normalisation
  (ffx_fsr1.h:388-410: ``APrxLoRsqF1``, ``APrxLoRcpF1``) in float32.  The
  filter's shape (dir, len2, lob, clp) then rounded to half, and in half:
  the twelve taps' weights in the header's form (``FsrEasuTapH``,
  ffx_fsr1.h:452-473, the constants as halves), one accumulation chain in
  ``FsrEasuF``'s order (ffx_fsr1.h:423-434), the exact reciprocal of the
  weight sum and the dering clamp (ffx_fsr1.h:416-419, 436).
- RCAS (FsrRcasH, ffx_fsr1.h:782-866) on those halves: the sharpness
  rounded to half (``FsrRcasCon``'s packed half, ffx_fsr1.h:662-672, read
  at :857), the exact reciprocal in the limiters, ``APrxMedRcpH1``
  (ffx_a.h:1814, magic 0x778D) for the lobe's reciprocal, the border
  clamped in output coordinates.
- The store: the half value widened to float32 and encoded as
  ``fsr1.encode_unorm8``.

Departures from ``FsrEasuH``, each the port's semantics that the program
is held to:

1. The direction and length estimate run in float32 with the float32 bit
   tricks, where ``FsrEasuSetH`` (ffx_fsr1.h:476-503) and the
   normalisation run in half (with the exact ``ARcpH2`` in the set stage).
   A half estimate flips direction where neighbouring lumas nearly tie and
   then applies another kernel at that pixel (``docs/FIDELITY.md``, "Why
   fp16 cannot hit 1/255"); the port keeps it in float32 (``precision=
   "mixed"``, the default).
2. The quadrants and the taps accumulate in one chain, in ``FsrEasuF``'s
   order, where ``FsrEasuH`` accumulates quadrants S, U and T, V in two
   packed lanes (ffx_fsr1.h:555-558) and the taps in two lanes
   (ffx_fsr1.h:583-590), then adds the lanes: the port's order under
   "mixed".
3. A byte is decoded in float32 and then rounded to half (two roundings),
   where the sample's texture unit hands the shader the half of the UNORM8
   value: the port's decode, the rule of ``fsr1``.

Outside the header, the RCAS border clamps as ``fsr1`` does (the sample
reads zeros outside the image).

``dtype=torch.bfloat16`` is the control (``check.control``): the same
steps with every half step in bfloat16, the constants rounded to it, and
the lobe's reciprocal the float32 ``APrxMedRcpF1`` on its values widened
(bfloat16 has no bit trick of its own), as ``fsr1``'s control computes
it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fsrbench.reference import fsr1

__all__ = ["prx_med_rcp_h", "easu", "rcas", "upscale_frame", "expected"]

# APrxMedRcpH1's magic number (ffx_a.h:1814).
MED_RCP_H = 0x778D


def _round(v: float, dtype) -> float:
    """The constant ``v`` rounded to ``dtype``, as a Python float (exact in
    float32, so an operation with a ``dtype`` tensor rounds once)."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


def prx_med_rcp_h(a: torch.Tensor) -> torch.Tensor:
    """``APrxMedRcpH1`` on halves: the 16-bit estimate, then one
    Newton-Raphson step, each operation rounded to half.  The operand is
    positive, so its bits are those of an int16 and the difference stays
    within 16 bits."""
    b = (MED_RCP_H - a.view(torch.int16).to(torch.int32)).to(torch.int16).view(torch.float16)
    return b * (-b * a + 2.0)


def _med_rcp(a: torch.Tensor) -> torch.Tensor:
    return prx_med_rcp_h(a) if a.dtype == torch.float16 else fsr1.prx_med_rcp(a)


def easu(src: torch.Tensor, out_hw: Tuple[int, int], dtype=torch.float16) -> torch.Tensor:
    """EASU "mixed" of one frame: src (3, Hin, Win) float32 in [0, 1] ->
    (3, Hout, Wout) in ``dtype``."""
    hin, win = src.shape[-2:]
    hout, wout = out_hw
    (sx, sy), (ox, oy) = fsr1.easu_constants((hin, win), out_hw)
    dev = src.device
    f32 = torch.float32
    ppx = torch.arange(wout, dtype=f32, device=dev) * sx + ox
    ppy = torch.arange(hout, dtype=f32, device=dev) * sy + oy
    fx, fy = torch.floor(ppx), torch.floor(ppy)
    px32, py32 = (ppx - fx)[None, :], (ppy - fy)[:, None]
    col, row = fx.to(torch.int64), fy.to(torch.int64)
    src = src.to(dtype)
    t = {}
    for name, dx, dy in fsr1.TAPS:
        r = torch.clamp(row + dy, 0, hin - 1)
        c = torch.clamp(col + dx, 0, win - 1)
        t[name] = src[:, r[:, None], c[None, :]]
    lum = {k: (v[2] * 0.5 + (v[0] * 0.5 + v[1])).to(f32) for k, v in t.items()}

    # The direction and length in float32, as FsrEasuF computes them.
    w_s = (1.0 - px32) * (1.0 - py32)
    w_t = px32 * (1.0 - py32)
    w_u = (1.0 - px32) * py32
    w_v = px32 * py32
    z = torch.zeros((hout, wout), dtype=f32, device=dev)
    dirx, diry, length = fsr1._easu_set(z, z, z, w_s, lum["b"], lum["e"], lum["f"], lum["g"], lum["j"])
    dirx, diry, length = fsr1._easu_set(dirx, diry, length, w_t, lum["c"], lum["f"], lum["g"], lum["h"], lum["k"])
    dirx, diry, length = fsr1._easu_set(dirx, diry, length, w_u, lum["f"], lum["i"], lum["j"], lum["k"], lum["n"])
    dirx, diry, length = fsr1._easu_set(dirx, diry, length, w_v, lum["g"], lum["j"], lum["k"], lum["l"], lum["o"])
    del lum

    dir_r = dirx * dirx + diry * diry
    zro = dir_r < fsr1._f(1.0 / 32768.0)
    one = torch.ones((), dtype=f32, device=dev)
    dir_r = torch.where(zro, one, fsr1.prx_lo_rsq(dir_r))
    dirx = torch.where(zro, one, dirx)
    dirx = dirx * dir_r
    diry = diry * dir_r
    length = length * 0.5
    length = length * length
    stretch = (dirx * dirx + diry * diry) * fsr1.prx_lo_rcp(torch.maximum(torch.abs(dirx), torch.abs(diry)))
    len2_x = 1.0 + (stretch - 1.0) * length
    len2_y = 1.0 + -0.5 * length
    lob = 0.5 + fsr1._f((1.0 / 4.0 - 0.04) - 0.5) * length
    clp = fsr1.prx_lo_rcp(lob)
    dirx, diry, len2_x, len2_y, lob, clp = (v.to(dtype) for v in (dirx, diry, len2_x, len2_y, lob, clp))

    # The taps' weights and the colour in ``dtype``.
    px, py = px32.to(dtype), py32.to(dtype)
    two_fifths = _round(2.0 / 5.0, dtype)
    min4 = torch.minimum(torch.minimum(torch.minimum(t["f"], t["g"]), t["j"]), t["k"])
    max4 = torch.maximum(torch.maximum(torch.maximum(t["f"], t["g"]), t["j"]), t["k"])
    ac = torch.zeros_like(t["f"])
    aw = torch.zeros((hout, wout), dtype=dtype, device=dev)
    for name, dx, dy in fsr1.TAPS:
        off_x = float(dx) - px
        off_y = float(dy) - py
        vx = (off_x * dirx + off_y * diry) * len2_x
        vy = (off_x * -diry + off_y * dirx) * len2_y
        d2 = torch.minimum(vx * vx + vy * vy, clp)
        w_b = two_fifths * d2 + -1.0
        w_a = lob * d2 + -1.0
        w_b = w_b * w_b
        w_a = w_a * w_a
        w_b = 1.5625 * w_b + -0.5625
        w = w_b * w_a
        ac = ac + t[name] * w
        aw = aw + w
        del t[name]
    pix = ac * (1.0 / aw)
    return torch.minimum(max4, torch.maximum(min4, pix))


def rcas(img: torch.Tensor, sharpness: float, denoise: bool = False) -> torch.Tensor:
    """FsrRcasH of one frame (3, H, W) in ``img``'s dtype; ``sharpness``
    linear, rounded to that dtype here."""
    sharp = _round(sharpness, img.dtype)
    b, d, e, f, h = (fsr1._shift(img, -1, 0), fsr1._shift(img, 0, -1), img, fsr1._shift(img, 0, 1),
                     fsr1._shift(img, 1, 0))

    def luma(c):
        return c[2] * 0.5 + (c[0] * 0.5 + c[1])

    b_l, d_l, e_l, f_l, h_l = luma(b), luma(d), luma(e), luma(f), luma(h)
    nz = 0.25 * b_l + 0.25 * d_l + 0.25 * f_l + 0.25 * h_l - e_l
    rng = (torch.maximum(torch.maximum(torch.maximum(b_l, d_l), torch.maximum(e_l, f_l)), h_l)
           - torch.minimum(torch.minimum(torch.minimum(b_l, d_l), torch.minimum(e_l, f_l)), h_l))
    nz = fsr1._sat(torch.abs(nz) * _med_rcp(rng))
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
    lobe = torch.maximum(zero - fsr1.RCAS_LIMIT, lobe) * sharp
    if denoise:
        lobe = lobe * nz
    rcp_l = _med_rcp(4.0 * lobe + 1.0)
    return (lobe * b + lobe * d + lobe * h + lobe * f + e) * rcp_l


def upscale_frame(src_u8: torch.Tensor, out_hw: Tuple[int, int], sharpness_stops: float, apply_rcas: bool = True,
                  denoise: bool = False, dtype=torch.float16) -> torch.Tensor:
    """One uint8 frame (3, Hin, Win) -> its uint8 (3, Hout, Wout) output:
    decode, EASU "mixed", FsrRcasH, encode."""
    out = easu(fsr1.decode_unorm8(src_u8), out_hw, dtype)
    if apply_rcas:
        out = rcas(out, fsr1.rcas_sharpness(sharpness_stops), denoise)
    return fsr1.encode_unorm8(out)


def expected(inputs: dict, cfg: dict, dtype=torch.float16) -> torch.Tensor:
    """The frame a configuration's call should give for ``inputs`` (its
    source frame ``src``), its half steps computed in ``dtype``."""
    return upscale_frame(inputs["src"], tuple(cfg["out_size"]), cfg["sharpness_stops"], cfg["apply_rcas"],
                         cfg["denoise"], dtype=dtype)
