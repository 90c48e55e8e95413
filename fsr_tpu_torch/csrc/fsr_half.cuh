// Device math of K6 (easu_h.cu): the float16 upscale's per-pixel EASU in
// "mixed" precision and FsrRcasH, as the port's torch path computes them
// (ops.easu with compute_dtype=float16, precision="mixed", then ops.rcas in
// float16; core/easu_math.easu_resolve / rcas_resolve with fast=False),
// for two output pixels at once: every half operation is the paired form
// on a __half2 whose low lane is the first pixel's and high lane the
// second's.
//
// Each torch float16 operation rounds its result to a half, and each
// float32 one to a float, with no contraction between two operations.  So
// every operation here is one on its own: __hadd2_rn/__hsub2_rn/__hmul2_rn
// on pairs of halves (IEEE half arithmetic lane by lane, round to nearest
// even, never fused into an HFMA2), __fadd_rn/__fsub_rn/__fmul_rn on floats
// (never fused into an FFMA).  A half operation rounds once, as torch's
// float operation then its rounding to half does: float has 24 bits, more
// than 2 * 11 + 2, so the double rounding gives the correctly rounded half.
// torch.minimum/maximum propagate NaN (__hmin2_nan/__hmax2_nan, and selects
// on floats); the reference's NaN-dropping max (_nan_drop_max) is __hmax2.
//
// A reciprocal is torch's `1.0 / a` on a half: the float32 reciprocal of
// the widened half, rounded to half.  h2rcp gives the same half for every
// one of the 65,536 patterns: MUFU.RCP is within 1 float32 ulp of 1/a, and
// 1/a of a finite nonzero half lies more than 2 float32 ulps from every
// point halfway between two halves, so both round alike; 1/+-0 = +-inf,
// 1/+-inf = +-0 and NaN stay as torch gives them (the RCAS limiters form
// min(...) * rcp(0) on purpose).  tests/test_torch_easu_h_pairs.py checks
// the margin and the identity on the CPU; chip_smoke.py phase 17 runs every
// pattern through rcp on the card against torch's `1.0 / x`
// (fsr_easu_h_rcp_check).
//
// K1, K2 and K3 do not include this header: their code stays as it was.

#pragma once

#include <cuda_fp16.h>

#include "fsr_pixel.cuh"

namespace fsr {
namespace h16 {

using h = __half;
using h2 = __half2;

// Scalar forms: the staging's luma of one texel.
__device__ __forceinline__ h add(h a, h b) { return __hadd_rn(a, b); }
__device__ __forceinline__ h mul(h a, h b) { return __hmul_rn(a, b); }
// A constant as easu_math._consts holds it (torch.full of a half).
__device__ __forceinline__ h k(float v) { return __float2half_rn(v); }

// Paired forms.
__device__ __forceinline__ h2 add(h2 a, h2 b) { return __hadd2_rn(a, b); }
__device__ __forceinline__ h2 sub(h2 a, h2 b) { return __hsub2_rn(a, b); }
__device__ __forceinline__ h2 mul(h2 a, h2 b) { return __hmul2_rn(a, b); }
// torch.minimum / torch.maximum: NaN in, NaN out.
__device__ __forceinline__ h2 tmin(h2 a, h2 b) { return __hmin2_nan(a, b); }
__device__ __forceinline__ h2 tmax(h2 a, h2 b) { return __hmax2_nan(a, b); }
// approx.rcp on a half: reciprocal(a) * 1.0 (see the note above).
__device__ __forceinline__ h2 rcp(h2 a) { return h2rcp(a); }
__device__ __forceinline__ h2 k2(float v) { return __float2half2_rn(v); }
__device__ __forceinline__ h2 pair(float a, float b) { return __floats2half2_rn(a, b); }
__device__ __forceinline__ h2 as_h2(unsigned int v) { return *reinterpret_cast<const h2*>(&v); }
__device__ __forceinline__ unsigned int bits(h2 v) { return *reinterpret_cast<const unsigned int*>(&v); }

// torch.maximum on floats (NaN in, NaN out).
__device__ __forceinline__ float tmaxf(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }

// A lane mask of a paired compare's 1.0 / 0.0 results (0xFFFF where true).
__device__ __forceinline__ unsigned int mask(h2 cmp) { return __vcmpne2(bits(cmp), 0u); }

// easu_math._sat on halves: where(x > 0, clamp(x, max=1), 0), a NaN to +0.
__device__ __forceinline__ h2 sat(h2 x) {
  const unsigned int pos = mask(__hgt2(x, k2(0.0f)));
  const unsigned int big = mask(__hgt2(x, k2(1.0f)));
  return as_h2(((bits(x) & ~big) | (bits(k2(1.0f)) & big)) & pos);
}

// APrxMedRcp with the FsrRcasH magic number (approx._MAGIC[float16]): an
// integer operation on each lane's 16-bit pattern (no borrow between the
// lanes), then one Newton step whose every operation rounds to half.
__device__ __forceinline__ h2 prx_med_rcp(h2 a) {
  const h2 b = as_h2(__vsub2(0x778D778Du, bits(a)));
  return mul(b, add(mul(__hneg2(b), a), k2(2.0f)));
}

// Luma*2 on halves (easu_math._luma): B * 0.5 + (R * 0.5 + G).
__device__ __forceinline__ h luma(h r, h g, h b) {
  const h half_ = k(0.5f);
  return add(mul(b, half_), add(mul(r, half_), g));
}
__device__ __forceinline__ h2 luma(h2 r, h2 g, h2 b) {
  const h2 half_ = k2(0.5f);
  return add(mul(b, half_), add(mul(r, half_), g));
}

// A source element rounded to half as `src.to(torch.float16)` rounds it; a
// byte first decodes as epilogue.decode does (v * float32(1/255)).
__device__ __forceinline__ h to_half(const __half* p) { return *p; }
__device__ __forceinline__ h to_half(const float* p) { return __float2half_rn(*p); }
__device__ __forceinline__ h to_half(const __nv_bfloat16* p) { return __float2half_rn(__bfloat162float(*p)); }
__device__ __forceinline__ h to_half(const uint8_t* p) { return __float2half_rn(__fmul_rn((float)*p, INV255)); }
// The same through the read-only data cache (__ldg), for the strip-source
// form's parts, which no __restrict__ kernel parameter names.
template <typename S>
__device__ __forceinline__ h to_half_nc(const S* p) {
  const S v = __ldg(p);
  return to_half(&v);
}

// A texel of the frame tail's forms (easu_h.cu): its three channels (plane
// stride `plane`) as to_half rounds them, after the SRTM prologue when srtm
// is set: ops.extras.srtm, c * (1 / (max3(c) + 1)), on the source as the
// torch path holds it, so a float16 or bfloat16 source computes in its own
// type, each operation's float32 result rounded to it (a torch elementwise
// operation on that dtype computes in float32 and rounds once), and a
// float32 source or a decoded byte in float32 (as fsr_pixel.cuh:
// srtm_texel, with torch.maximum's NaN rule).  NC: loads through the
// read-only data cache.
template <bool NC, typename S>
__device__ __forceinline__ void srtm_to_half(const S* at, int64_t plane, int srtm, h& r, h& g, h& b) {
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if constexpr (NC)
      c[k] = ldg(at + k * plane);
    else
      c[k] = ld(at + k * plane);
  }
  if (srtm) {
    const float d = as_storage<S>(__fadd_rn(tmaxf(tmaxf(c[0], c[1]), c[2]), 1.0f));
    const float rc = as_storage<S>(__frcp_rn(d));
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = as_storage<S>(__fmul_rn(c[k], rc));
  }
  r = __float2half_rn(c[0]);
  g = __float2half_rn(c[1]);
  b = __float2half_rn(c[2]);
}

// A difference of two source elements (given widened) in the source's own
// type, as ops.easu.bilinear's `tr - tl` runs on the alpha plane: rounded to
// half or bfloat16; float32 and decoded bytes stay float32.
template <typename S>
__device__ __forceinline__ float diff_as(float a, float b) {
  const float d = __fsub_rn(a, b);
  if constexpr (std::is_same<S, __half>::value) return __half2float(__float2half_rn(d));
  if constexpr (std::is_same<S, __nv_bfloat16>::value) return __bfloat162float(__float2bfloat16_rn(d));
  return d;
}

// ops.easu.bilinear of the alpha plane (float32 math after the source-type
// difference), from the texels at 'f', right of it, below it and below
// right, at (px, py).
template <typename S>
__device__ __forceinline__ float bilinear_alpha(float tl, float tr, float bl, float br, float px, float py) {
  const float top = __fadd_rn(tl, __fmul_rn(diff_as<S>(tr, tl), px));
  const float bot = __fadd_rn(bl, __fmul_rn(diff_as<S>(br, bl), px));
  return __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), py));
}

// A texel's share of one quadrant of the direction and length estimate
// (easu_resolve's accumulate_quads, one FsrEasuSetF call, up to its * w
// products): from the '+' pattern a (above), b (left), c (centre), d
// (right), e (below) of float32 lumas, (dir_x, len_x^2, dir_y, len_y^2).
// It depends on the centre texel and its four neighbours only, so a block
// computes it once per texel (easu_h.cu:stage).
__device__ __forceinline__ float4 quad_response(float la, float lb, float lc, float ld, float le) {
  const float dc = __fsub_rn(ld, lc);
  const float cb = __fsub_rn(lc, lb);
  float len_x = prx_lo_rcp(tmaxf(fabsf(dc), fabsf(cb)));
  const float dx = __fsub_rn(ld, lb);
  len_x = sat_nan0(__fmul_rn(fabsf(dx), len_x));
  const float ec = __fsub_rn(le, lc);
  const float ca = __fsub_rn(lc, la);
  float len_y = prx_lo_rcp(tmaxf(fabsf(ec), fabsf(ca)));
  const float dy = __fsub_rn(le, la);
  len_y = sat_nan0(__fmul_rn(fabsf(dy), len_y));
  return make_float4(dx, __fmul_rn(len_x, len_x), dy, __fmul_rn(len_y, len_y));
}

// The rest of that FsrEasuSetF call: the response g weighted by w, added to
// dir_x, len, dir_y, len in the reference's order.
__device__ __forceinline__ void add_quad(float4 g, float w, float& dirx, float& diry, float& len) {
  dirx = __fadd_rn(dirx, __fmul_rn(g.x, w));
  len = __fadd_rn(len, __fmul_rn(g.y, w));
  diry = __fadd_rn(diry, __fmul_rn(g.z, w));
  len = __fadd_rn(len, __fmul_rn(g.w, w));
}

// One pixel's filter shape in float32, from the responses of its quadrants
// s, t, u, v (centres f, g, j, k) at subpixel position (ppx, ppy): the
// direction and length with the APrx bit tricks (ffx_fsr1.h:388-410).
// shape: dir_x, dir_y, len2_x, len2_y, lob, clp, still in float32.
__device__ __forceinline__ void easu_shape(const float4 (&g)[4], float ppx, float ppy, float (&shape)[6]) {
  const float qx = __fsub_rn(1.0f, ppx);
  const float qy = __fsub_rn(1.0f, ppy);
  float dirx = 0.0f, diry = 0.0f, len = 0.0f;
  add_quad(g[0], __fmul_rn(qx, qy), dirx, diry, len);    // s
  add_quad(g[1], __fmul_rn(ppx, qy), dirx, diry, len);   // t
  add_quad(g[2], __fmul_rn(qx, ppy), dirx, diry, len);   // u
  add_quad(g[3], __fmul_rn(ppx, ppy), dirx, diry, len);  // v

  // Direction normalisation with zero-protect (ffx_fsr1.h:388-395).
  float dir_r = __fadd_rn(__fmul_rn(dirx, dirx), __fmul_rn(diry, diry));
  const bool zro = dir_r < (1.0f / 32768.0f);
  dir_r = prx_lo_rsq(dir_r);
  if (zro) {
    dir_r = 1.0f;
    dirx = 1.0f;
  }
  dirx = __fmul_rn(dirx, dir_r);
  diry = __fmul_rn(diry, dir_r);
  len = __fmul_rn(len, 0.5f);
  len = __fmul_rn(len, len);
  const float stretch = __fmul_rn(__fadd_rn(__fmul_rn(dirx, dirx), __fmul_rn(diry, diry)),
                                  prx_lo_rcp(tmaxf(fabsf(dirx), fabsf(diry))));
  const float lob = __fadd_rn(0.5f, __fmul_rn((float)((1.0 / 4.0 - 0.04) - 0.5), len));
  shape[0] = dirx;
  shape[1] = diry;
  shape[2] = __fadd_rn(1.0f, __fmul_rn(__fsub_rn(stretch, 1.0f), len));
  shape[3] = __fadd_rn(1.0f, __fmul_rn(-0.5f, len));
  shape[4] = lob;
  shape[5] = prx_lo_rcp(lob);
}

// One tap of two pixels: its three channels, each a pair.
struct Tap2 {
  h2 c[3];
};

// EASU "mixed" of two pixels from their tap windows (tap(r, q): rows
// fy-1..fy+2, columns fx-1..fx+2 around 'f' = tap(1, 1); the corners are
// not read; each tap read where the accumulation takes it), their float32
// shapes sa, sb (easu_shape) and subpixel columns pxa, pxb, on one row at
// ppy: the filter shape handed to half once per pixel and packed, then the
// taps' weights, FsrEasuF's single accumulation chain, the reciprocal of
// the weight sum and the dering clamp, all in paired half.
template <typename TapFn>
__device__ __forceinline__ void easu_pair(TapFn tap, const float (&sa)[6], const float (&sb)[6], float pxa,
                                          float pxb, float ppy, h2 out[3]) {
  // The filter shape handed to half (easu_math.py:261-263).
  const h2 hdx = pair(sa[0], sb[0]), hdy = pair(sa[1], sb[1]), ndy = __hneg2(hdy);
  const h2 l2x = pair(sa[2], sb[2]), l2y = pair(sa[3], sb[3]);
  const h2 lob = pair(sa[4], sb[4]), clp = pair(sa[5], sb[5]);
  const h2 hpx = pair(pxa, pxb), hpy = k2(ppy);
  // The tap offsets' products with the shape: each tap's rotated offset
  // reads one per column q and one per row r (the same operations on the
  // same values, so the same halves, as computing them per tap).
  h2 xdx[4], xndy[4], ydy[4], ydx[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const h2 ox = sub(k2((float)(q - 1)), hpx);
    const h2 oy = sub(k2((float)(q - 1)), hpy);
    xdx[q] = mul(ox, hdx);
    xndy[q] = mul(ox, ndy);
    ydy[q] = mul(oy, hdy);
    ydx[q] = mul(oy, hdx);
  }

  // Taps in FsrEasuF accumulation order (b c i j f e k l h g o n;
  // ffx_fsr1.h:423-434), each with the rotated, anisotropic distance and
  // the non-fast weight (2/5 d2 - 1)^2 25/16 - 9/16 times (lob d2 - 1)^2.
  constexpr int kTapDx[12] = {0, 1, -1, 0, 0, -1, 1, 2, 2, 1, 1, 0};
  constexpr int kTapDy[12] = {-1, -1, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2};
  const h2 m1 = k2(-1.0f), c25 = k2(2.0f / 5.0f), c2516 = k2(25.0f / 16.0f), c916 = k2(-(25.0f / 16.0f - 1.0f));
  h2 ac0 = k2(0.0f), ac1 = k2(0.0f), ac2 = k2(0.0f), aw = k2(0.0f);
  Tap2 tf, tg, tj, tk;  // the nearest 2x2, for the dering clamp
#pragma unroll
  for (int n = 0; n < 12; ++n) {
    const int q = kTapDx[n] + 1;
    const int r = kTapDy[n] + 1;
    const Tap2 t = tap(r, q);
    if (r == 1 && q == 1) tf = t;
    if (r == 1 && q == 2) tg = t;
    if (r == 2 && q == 1) tj = t;
    if (r == 2 && q == 2) tk = t;
    const h2 vx = mul(add(xdx[q], ydy[r]), l2x);
    const h2 vy = mul(add(xndy[q], ydx[r]), l2y);
    const h2 d2 = tmin(add(mul(vx, vx), mul(vy, vy)), clp);
    h2 w_a = add(mul(lob, d2), m1);
    w_a = mul(w_a, w_a);
    h2 w_b = add(mul(c25, d2), m1);
    w_b = mul(w_b, w_b);
    w_b = add(mul(c2516, w_b), c916);
    const h2 w = mul(w_b, w_a);
    ac0 = add(ac0, mul(t.c[0], w));
    ac1 = add(ac1, mul(t.c[1], w));
    ac2 = add(ac2, mul(t.c[2], w));
    aw = add(aw, w);
  }
  const h2 inv_w = rcp(aw);
  const h2 acc[3] = {ac0, ac1, ac2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // Dering clamp to the nearest 2x2 {f, g, j, k} (ffx_fsr1.h:416-419).
    const h2 mn = tmin(tmin(tf.c[c], tg.c[c]), tmin(tj.c[c], tk.c[c]));
    const h2 mx = tmax(tmax(tf.c[c], tg.c[c]), tmax(tj.c[c], tk.c[c]));
    out[c] = tmin(mx, tmax(mn, mul(acc[c], inv_w)));
  }
}

// FsrRcasH (rcas_resolve(fast=False) in float16) of two pixels on their
// crosses b (above), d (left), e (centre), f (right), h (below), three
// channels each, as pairs: the limiters with the exact reciprocal and the
// NaN-dropping max, the optional denoise, APrxMedRcp on halves.  sharp:
// sharpness_f16 in both lanes.
template <bool DENOISE>
__device__ __forceinline__ void rcas_pair(const h2 b[3], const h2 d[3], const h2 e[3], const h2 f[3], const h2 hh[3],
                                          h2 sharp, h2 out[3]) {
  const h2 one = k2(1.0f), four = k2(4.0f);
  h2 lobe = k2(0.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const h2 mn4 = tmin(tmin(b[c], d[c]), tmin(f[c], hh[c]));
    const h2 mx4 = tmax(tmax(b[c], d[c]), tmax(f[c], hh[c]));
    // 0 * inf = NaN under a bright centre (mx4 == 0) is dropped by the
    // HLSL max (ffx_fsr1.h:749), as _nan_drop_max drops it.
    const h2 hit_min = mul(tmin(mn4, e[c]), rcp(mul(four, mx4)));
    const h2 hit_max = mul(sub(one, tmax(mx4, e[c])), rcp(add(mul(four, mn4), k2(-4.0f))));
    const h2 lobe_c = __hmax2(__hneg2(hit_min), hit_max);
    lobe = c == 0 ? lobe_c : tmax(lobe, lobe_c);
  }
  lobe = mul(tmax(k2(-(0.25f - 1.0f / 16.0f)), tmin(lobe, k2(0.0f))), sharp);
  if (DENOISE) {
    const h2 q = k2(0.25f);
    const h2 bl = luma(b[0], b[1], b[2]), dl = luma(d[0], d[1], d[2]), el = luma(e[0], e[1], e[2]);
    const h2 fl = luma(f[0], f[1], f[2]), hl = luma(hh[0], hh[1], hh[2]);
    h2 nz = sub(add(add(add(mul(q, bl), mul(q, dl)), mul(q, fl)), mul(q, hl)), el);
    const h2 rng = sub(tmax(tmax(tmax(bl, dl), tmax(el, fl)), hl), tmin(tmin(tmin(bl, dl), tmin(el, fl)), hl));
    nz = sat(mul(__habs2(nz), prx_med_rcp(rng)));
    nz = add(mul(k2(-0.5f), nz), one);
    lobe = mul(lobe, nz);
  }
  const h2 rcp_l = prx_med_rcp(add(mul(four, lobe), one));
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = mul(add(add(add(add(mul(lobe, b[c]), mul(lobe, d[c])), mul(lobe, hh[c])), mul(lobe, f[c])), e[c]),
                 rcp_l);
}

}  // namespace h16
}  // namespace fsr
