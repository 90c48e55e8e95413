"""EASU/RCAS resolve math on tensors, shared by the ops path and the kernels'
plain versions.

Counterpart of ``fsr_tpu/core/easu_math.py``: the caller materialises the
12 EASU tap planes (or the 5 RCAS cross planes) and these functions run the
filter math elementwise on them.  Planes are stacked with the channel axis
at -3: ``(..., C, H, W)``.

Dtype policy:
- float32: the reference's bit-trick approximations (exact parity path).
- float16: FsrEasuH/FsrRcasH semantics (the float16 bit tricks, the exact
  reciprocal in the set stage, ffx_fsr1.h:489) and, when both the colour
  and the direction dtypes are float16, FsrEasuH's accumulation order.
- bfloat16: no reference analog; native rsqrt and exact reciprocals.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from fsr_tpu_torch.core import approx
from fsr_tpu_torch.core.constants import FSR_RCAS_LIMIT

__all__ = [
    "TAP_OFFSETS",
    "EASU_QUADS",
    "easu_texel_response",
    "easu_resolve",
    "rcas_resolve",
]

# (dx, dy) offsets from 'f' for the 12-tap footprint, in FsrEasuF
# accumulation order (ffx_fsr1.h:423-434).
TAP_OFFSETS: Dict[str, Tuple[int, int]] = {
    "b": (0, -1),
    "c": (1, -1),
    "i": (-1, 1),
    "j": (0, 1),
    "f": (0, 0),
    "e": (-1, 0),
    "k": (1, 1),
    "l": (2, 1),
    "h": (2, 0),
    "g": (1, 0),
    "o": (1, 2),
    "n": (0, 2),
}

# Quadrant '+' patterns: (bilinear-weight key, (lA, lB, lC, lD, lE)) as in the
# four FsrEasuSetF calls (ffx_fsr1.h:383-386).
EASU_QUADS = (
    ("s", ("b", "e", "f", "g", "j")),
    ("t", ("c", "f", "g", "h", "k")),
    ("u", ("f", "i", "j", "k", "n")),
    ("v", ("g", "j", "k", "l", "o")),
)


_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
# The dtypes with reference bit tricks (ffx_a.h's float and half forms).
_PRX = (torch.float32, torch.float16)


def _check_dtype(dt):
    if dt not in _DTYPES:
        raise TypeError(f"EASU/RCAS math runs in float32, float16 or bfloat16, got {dt}")


def _consts(dt, device):
    # 0-dim tensors of the working dtype: a Python float would enter bf16
    # arithmetic unrounded, where the JAX math rounds each constant to bf16.
    # Filled on the device, with no host copy (a captured graph may hold them).
    return lambda v: torch.full((), v, dtype=dt, device=device)


def _sat(x):
    """HLSL saturate: clamp to [0,1] with NaN -> 0."""
    return torch.where(x > 0, torch.clamp(x, max=1.0), torch.zeros_like(x))


def _nan_drop_max(a, b):
    """HLSL max semantics: if one operand is NaN, return the other.

    torch.maximum propagates NaN (as jnp.maximum does), so the drop is
    written out."""
    return torch.maximum(torch.where(torch.isnan(a), b, a), torch.where(torch.isnan(b), a, b))


def _set_rcp(x, dt, hi_rcp):
    if dt == torch.float32:
        return approx.prx_lo_rcp(x)
    return hi_rcp(x)


def _lo_rsq(x, dt):
    if dt in _PRX:
        return approx.prx_lo_rsq(x)
    return torch.rsqrt(x)


def _lo_rcp(x, dt, hi_rcp):
    if dt in _PRX:
        return approx.prx_lo_rcp(x)
    return hi_rcp(x)


def _luma(p, c):
    """Luma*2 (ffx_fsr1.h:362-366): B*0.5 + (R*0.5 + G); channel 0 when
    there are fewer than 3 channels."""
    if p.shape[-3] >= 3:
        return p[..., 2, :, :] * c(0.5) + (p[..., 0, :, :] * c(0.5) + p[..., 1, :, :])
    return p[..., 0, :, :]


def easu_texel_response(l_a, l_b, l_c, l_d, l_e, fast: bool = False):
    """Per-texel '+'-pattern direction/length response.

    FsrEasuSetF's quadrant contribution factors as w_q(pp) * g(texel), so
    g can be evaluated once per input texel.  Returns
    (gx, gy, glen_x, glen_y), or (gx, gy, glen_x + glen_y) when fast=True
    (the kernels' pre-summed length response, a ~1-ulp reassociation).
    """
    dt = l_c.dtype
    _check_dtype(dt)
    hi_rcp = approx.rcp_fast if fast else approx.rcp
    # f32 uses the finite bit-trick rcp, so a plain clamp is NaN-safe; the
    # exact reciprocal can give 0 * inf and needs the NaN-flushing saturate.
    sat = approx.sat if dt == torch.float32 else _sat
    dc = l_d - l_c
    cb = l_c - l_b
    len_x = _set_rcp(torch.maximum(dc.abs(), cb.abs()), dt, hi_rcp)
    gx = l_d - l_b
    len_x = sat(gx.abs() * len_x)
    len_x = len_x * len_x
    ec = l_e - l_c
    ca = l_c - l_a
    len_y = _set_rcp(torch.maximum(ec.abs(), ca.abs()), dt, hi_rcp)
    gy = l_e - l_a
    len_y = sat(gy.abs() * len_y)
    len_y = len_y * len_y
    if fast:
        return gx, gy, len_x + len_y
    return gx, gy, len_x, len_y


def easu_resolve(
    taps: Dict[str, torch.Tensor],
    ppx: torch.Tensor,
    ppy: torch.Tensor,
    dtype=None,
    dir_dtype=torch.float32,
    fast: bool = False,
    quad_g=None,
) -> torch.Tensor:
    """Run the EASU filter on pre-gathered tap planes.

    taps: tap name -> (..., C, H, W) plane stack.
    ppx/ppy: subpixel position of the output sample inside the f..k quad,
      broadcastable to (..., H, W), float32.
    dtype: tap-weighting/colour-accumulation dtype; dir_dtype: dtype of the
      direction/length estimation (float32 keeps the "mixed" mode).
    fast: the kernels' forms (quadratic-form tap distance, Horner w_b).
    quad_g: optional quad key ('s','t','u','v') -> per-texel response tuple
      from easu_texel_response, pre-sliced to the plane shape; the set
      stage is then a pure bilinear blend.

    Returns the resolved (..., C, H, W) planes.
    """
    first = taps["f"]
    dt = dtype if dtype is not None else first.dtype
    ddt = dir_dtype
    _check_dtype(dt)
    _check_dtype(ddt)
    c = _consts(dt, first.device)
    cd = _consts(ddt, first.device)
    hi_rcp = approx.rcp_fast if fast else approx.rcp

    lum = None
    if quad_g is None:
        lum = {k: _luma(v, c).to(ddt) for k, v in taps.items()}

    one = cd(1.0)
    ppx_d = ppx.to(ddt)
    ppy_d = ppy.to(ddt)
    wq = {
        "s": (one - ppx_d) * (one - ppy_d),
        "t": ppx_d * (one - ppy_d),
        "u": (one - ppx_d) * ppy_d,
        "v": ppx_d * ppy_d,
    }

    # FsrEasuH's packed accumulation order when everything is float16:
    # quadrants S,U into one partial and T,V into another, then their sum
    # (ffx_fsr1.h:555-558); taps in two lanes likewise (ffx_fsr1.h:583-590).
    # Otherwise FsrEasuF's single chains.
    h_order = ddt == torch.float16 and dt == torch.float16
    shape_hw = (lum["f"] if lum is not None else quad_g["s"][0]).shape
    quads = dict(EASU_QUADS)

    def accumulate_quads(keys):
        dirx = torch.zeros(shape_hw, dtype=ddt, device=first.device)
        diry = torch.zeros_like(dirx)
        length = torch.zeros_like(dirx)
        for wkey in keys:
            w = wq[wkey]
            if quad_g is not None:
                if len(quad_g[wkey]) == 3:  # fast: pre-summed length response
                    gx, gy, gl = quad_g[wkey]
                    dirx = dirx + gx * w
                    diry = diry + gy * w
                    length = length + gl * w
                else:
                    gx, gy, glx, gly = quad_g[wkey]
                    dirx = dirx + gx * w
                    length = length + glx * w
                    diry = diry + gy * w
                    length = length + gly * w
                continue
            l_a, l_b, l_c, l_d, l_e = (lum[n] for n in quads[wkey])
            dc = l_d - l_c
            cb = l_c - l_b
            len_x = _set_rcp(torch.maximum(dc.abs(), cb.abs()), ddt, hi_rcp)
            dir_x = l_d - l_b
            dirx = dirx + dir_x * w
            len_x = _sat(dir_x.abs() * len_x)
            length = length + len_x * len_x * w
            ec = l_e - l_c
            ca = l_c - l_a
            len_y = _set_rcp(torch.maximum(ec.abs(), ca.abs()), ddt, hi_rcp)
            dir_y = l_e - l_a
            diry = diry + dir_y * w
            len_y = _sat(dir_y.abs() * len_y)
            length = length + len_y * len_y * w
        return dirx, diry, length

    parts = [accumulate_quads(g) for g in ((("s", "u"), ("t", "v")) if h_order else ("stuv",))]
    dirx, diry, length = parts[0]
    for part in parts[1:]:
        dirx, diry, length = dirx + part[0], diry + part[1], length + part[2]

    # Direction normalisation with zero-protect (ffx_fsr1.h:388-395).
    dir_r = dirx * dirx + diry * diry
    zro = dir_r < cd(1.0 / 32768.0)
    dir_r = _lo_rsq(dir_r, ddt)
    dir_r = torch.where(zro, one, dir_r)
    dirx = torch.where(zro, one, dirx)
    dirx = dirx * dir_r
    diry = diry * dir_r
    length = length * cd(0.5)
    length = length * length
    stretch = (dirx * dirx + diry * diry) * _lo_rcp(
        torch.maximum(dirx.abs(), diry.abs()), ddt, hi_rcp
    )
    len2_x = one + (stretch - one) * length
    len2_y = one + cd(-0.5) * length
    lob = cd(0.5) + cd((1.0 / 4.0 - 0.04) - 0.5) * length
    clp = _lo_rcp(lob, ddt, hi_rcp)
    # Hand the per-pixel filter shape to the accumulation dtype.
    dirx, diry, len2_x, len2_y, lob, clp = (
        t.to(dt) for t in (dirx, diry, len2_x, len2_y, lob, clp)
    )

    # Dering bounds from the nearest 2x2 {f,g,j,k} (ffx_fsr1.h:416-419).
    min4 = torch.minimum(torch.minimum(taps["f"], taps["g"]), torch.minimum(taps["j"], taps["k"]))
    max4 = torch.maximum(torch.maximum(taps["f"], taps["g"]), torch.maximum(taps["j"], taps["k"]))

    ppx = ppx.to(dt)
    ppy = ppy.to(dt)
    if fast:
        # Tap distance as a quadratic form: with v = M @ off for the
        # rotation/anisotropy matrix M, d2 = qa*ox^2 + qb*ox*oy + qc*oy^2,
        # factored per tap row/column group (~1-2 ulp reassociation).
        lx2 = len2_x * len2_x
        ly2 = len2_y * len2_y
        xx = dirx * dirx
        yy = diry * diry
        xy = dirx * diry
        qa = xx * lx2 + yy * ly2
        qb = (xy + xy) * (lx2 - ly2)
        qc = yy * lx2 + xx * ly2
        off_ys = {dy: c(float(dy)) - ppy for dy in sorted({d for _, d in TAP_OFFSETS.values()})}
        off_xs = {dx: c(float(dx)) - ppx for dx in sorted({d for d, _ in TAP_OFFSETS.values()})}
        a_dy = {dy: oy * qb for dy, oy in off_ys.items()}
        b_dy = {dy: (oy * oy) * qc for dy, oy in off_ys.items()}
        c_dx = {dx: (ox * ox) * qa for dx, ox in off_xs.items()}

    def accumulate_taps(names):
        ac = torch.zeros_like(first, dtype=dt)
        aw = torch.zeros_like(dirx)
        for name in names:
            dx, dy = TAP_OFFSETS[name]
            off_x = c(float(dx)) - ppx
            off_y = c(float(dy)) - ppy
            if fast:
                d2 = c_dx[dx] + (off_x * a_dy[dy] + b_dy[dy])
            else:
                vx = (off_x * dirx + off_y * diry) * len2_x
                vy = (off_x * (-diry) + off_y * dirx) * len2_y
                d2 = vx * vx + vy * vy
            d2 = torch.minimum(d2, clp)
            w_a = lob * d2 + c(-1.0)
            w_a = w_a * w_a
            if fast:
                # Horner form of 25/16*(2/5*d2-1)^2 - 9/16 (one op fewer).  The
                # product w_b * w_a stays factored: a single Horner quartic was
                # measured to cost fidelity against the oracle.
                w_b = (c(0.25) * d2 + c(-1.25)) * d2 + c(1.0)
            else:
                w_b = c(2.0 / 5.0) * d2 + c(-1.0)
                w_b = w_b * w_b
                w_b = c(25.0 / 16.0) * w_b + c(-(25.0 / 16.0 - 1.0))
            w = w_b * w_a
            ac = ac + taps[name].to(dt) * w.unsqueeze(-3)
            aw = aw + w
        return ac, aw

    lanes = (("b", "i", "f", "k", "h", "o"), ("c", "j", "e", "l", "g", "n")) if h_order else (tuple(TAP_OFFSETS),)
    ac, aw = accumulate_taps(lanes[0])
    for names in lanes[1:]:
        ac2, aw2 = accumulate_taps(names)
        ac, aw = ac + ac2, aw + aw2

    inv_w = hi_rcp(aw)
    return torch.minimum(max4, torch.maximum(min4, ac * inv_w.unsqueeze(-3)))


def rcas_resolve(
    taps_b: torch.Tensor,
    taps_d: torch.Tensor,
    taps_e: torch.Tensor,
    taps_f: torch.Tensor,
    taps_h: torch.Tensor,
    sharpness,
    denoise: bool = False,
    fast: bool = False,
) -> torch.Tensor:
    """Run the RCAS 5-tap cross on pre-gathered (..., 3, H, W) planes
    (FsrRcasF semantics): b above, d left, e centre, f right, h below.

    sharpness: linear sharpness (exp2(-stops), RcasConstants.sharpness; its
      ``sharpness_f16`` for FsrRcasH).
    fast: the kernels' division-light limiter (one reciprocal, selects)
      and the factored cross sum.
    """
    dt = taps_e.dtype
    _check_dtype(dt)
    hi_rcp = approx.rcp_fast if fast else approx.rcp
    c = _consts(dt, taps_e.device)
    sharp = c(float(sharpness))
    med_rcp = approx.prx_med_rcp if dt in _PRX else hi_rcp

    def ch(t, i):
        return t[..., i, :, :]

    nz = None
    if denoise:
        b_l, d_l, e_l, f_l, h_l = (_luma(p, c) for p in (taps_b, taps_d, taps_e, taps_f, taps_h))
        nz = c(0.25) * b_l + c(0.25) * d_l + c(0.25) * f_l + c(0.25) * h_l - e_l
        rng = torch.maximum(
            torch.maximum(torch.maximum(b_l, d_l), torch.maximum(e_l, f_l)), h_l
        ) - torch.minimum(torch.minimum(torch.minimum(b_l, d_l), torch.minimum(e_l, f_l)), h_l)
        nz = _sat(nz.abs() * med_rcp(rng))
        nz = c(-0.5) * nz + c(1.0)

    lobe = None
    if fast:
        # Division-light limiter: with u = min(mn4, e), v = 1 - max(mx4, e),
        # q = 1 - mn4, the reference's lobe is -(1/4) min_ch min(u/mx4, v/q);
        # the ratios are compared cross-multiplied and one reciprocal is
        # taken.  The selects reproduce the reference's NaN-drop branch at
        # mx4 == 0 (isolated bright pixels) without ever forming a NaN.
        num = den = None
        one = c(1.0)
        for i in range(3):
            b, d, e, f, h = (ch(t, i) for t in (taps_b, taps_d, taps_e, taps_f, taps_h))
            mn4 = torch.minimum(torch.minimum(b, d), torch.minimum(f, h))
            mx4 = torch.maximum(torch.maximum(b, d), torch.maximum(f, h))
            u = torch.minimum(mn4, e)
            v = one - torch.maximum(mx4, e)
            q = one - mn4
            v_s = torch.where(q == 0, one, v)
            pick1 = u * q < v_s * mx4
            n_c = torch.where(pick1, u, v)
            d_c = torch.where(pick1, mx4, q)
            if num is None:
                num, den = n_c, d_c
            else:
                sw = n_c * den < num * d_c
                num = torch.where(sw, n_c, num)
                den = torch.where(sw, d_c, den)
        r = torch.minimum(torch.maximum(num * hi_rcp(den), c(0.0)), c(4.0 * FSR_RCAS_LIMIT))
        lobe = r * (sharp * c(-0.25))
    else:
        for i in range(3):
            b, d, e, f, h = (ch(t, i) for t in (taps_b, taps_d, taps_e, taps_f, taps_h))
            mn4 = torch.minimum(torch.minimum(b, d), torch.minimum(f, h))
            mx4 = torch.maximum(torch.maximum(b, d), torch.maximum(f, h))
            # Limiters need high-precision rcp (ffx_fsr1.h:749).  0 * inf =
            # NaN here (mx4 == 0 under a bright centre pixel) is dropped by
            # the HLSL max, which is what lets RCAS spike isolated pixels.
            hit_min = torch.minimum(mn4, e) * hi_rcp(c(4.0) * mx4)
            hit_max = (c(1.0) - torch.maximum(mx4, e)) * hi_rcp(c(4.0) * mn4 + c(-4.0))
            lobe_ch = _nan_drop_max(-hit_min, hit_max)
            lobe = lobe_ch if lobe is None else torch.maximum(lobe, lobe_ch)
        lobe = torch.maximum(c(-FSR_RCAS_LIMIT), torch.minimum(lobe, c(0.0))) * sharp

    if denoise:
        lobe = lobe * nz
    rcp_l = med_rcp(c(4.0) * lobe + c(1.0))
    if fast:
        out = [
            (lobe * ((ch(taps_b, i) + ch(taps_d, i)) + (ch(taps_h, i) + ch(taps_f, i))) + ch(taps_e, i))
            * rcp_l
            for i in range(3)
        ]
    else:
        out = [
            (
                lobe * ch(taps_b, i)
                + lobe * ch(taps_d, i)
                + lobe * ch(taps_h, i)
                + lobe * ch(taps_f, i)
                + ch(taps_e, i)
            )
            * rcp_l
            for i in range(3)
        ]
    return torch.stack(out, dim=-3)
