// Device math of K6 (easu_h.cu): the float16 upscale's per-pixel EASU in
// "mixed" precision and FsrRcasH, as the port's torch path computes them
// (ops.easu with compute_dtype=float16, precision="mixed", then ops.rcas in
// float16; core/easu_math.easu_resolve / rcas_resolve with fast=False).
//
// Each torch float16 operation rounds its result to a half, and each
// float32 one to a float, with no contraction between two operations.  So
// every operation here is one on its own: __hadd_rn/__hsub_rn/__hmul_rn on
// halves (IEEE half arithmetic, round to nearest even, never fused into an
// HFMA), __fadd_rn/__fsub_rn/__fmul_rn on floats (never fused into an
// FFMA).  A half operation rounds once, as torch's float operation then
// its rounding to half does: float has 24 bits, more than 2 * 11 + 2, so
// the double rounding gives the correctly rounded half.  A reciprocal is
// torch's `1.0 / a`: an IEEE float32 division of the widened half, rounded
// to half (no __hdiv, whose approximate reciprocal may round otherwise).
// torch.minimum/maximum propagate NaN (__hmin_nan/__hmax_nan, and selects
// on floats); the reference's NaN-dropping max (_nan_drop_max) is __hmax.
//
// K1, K2 and K3 do not include this header: their code stays as it was.

#pragma once

#include <cuda_fp16.h>

#include "fsr_pixel.cuh"

namespace fsr {
namespace h16 {

using h = __half;

__device__ __forceinline__ h add(h a, h b) { return __hadd_rn(a, b); }
__device__ __forceinline__ h sub(h a, h b) { return __hsub_rn(a, b); }
__device__ __forceinline__ h mul(h a, h b) { return __hmul_rn(a, b); }
// torch.minimum / torch.maximum: NaN in, NaN out.
__device__ __forceinline__ h tmin(h a, h b) { return __hmin_nan(a, b); }
__device__ __forceinline__ h tmax(h a, h b) { return __hmax_nan(a, b); }
// approx.rcp on a half: reciprocal(a) * 1.0, the reciprocal a float32
// division rounded to half.
__device__ __forceinline__ h rcp(h a) { return __float2half_rn(__fdiv_rn(1.0f, __half2float(a))); }
// A constant as easu_math._consts holds it (torch.full of a half).
__device__ __forceinline__ h k(float v) { return __float2half_rn(v); }

// torch.maximum on floats (NaN in, NaN out).
__device__ __forceinline__ float tmaxf(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }

// easu_math._sat on halves: where(x > 0, clamp(x, max=1), 0).
__device__ __forceinline__ h sat(h x) {
  const h one = k(1.0f);
  return __hgt(x, k(0.0f)) ? (__hgt(x, one) ? one : x) : k(0.0f);
}

// APrxMedRcp with the FsrRcasH magic number (approx._MAGIC[float16]): an
// integer operation on the 16-bit pattern, then one Newton step whose every
// operation rounds to half.
__device__ __forceinline__ h prx_med_rcp(h a) {
  const h b = __ushort_as_half((unsigned short)(0x778Du - __half_as_ushort(a)));
  return mul(b, add(mul(__hneg(b), a), k(2.0f)));
}

// Luma*2 on halves (easu_math._luma): B * 0.5 + (R * 0.5 + G).
__device__ __forceinline__ h luma(h r, h g, h b) {
  const h half_ = k(0.5f);
  return add(mul(b, half_), add(mul(r, half_), g));
}

// A source element rounded to half as `src.to(torch.float16)` rounds it; a
// byte first decodes as epilogue.decode does (v * float32(1/255)).
__device__ __forceinline__ h to_half(const __half* p) { return *p; }
__device__ __forceinline__ h to_half(const float* p) { return __float2half_rn(*p); }
__device__ __forceinline__ h to_half(const __nv_bfloat16* p) { return __float2half_rn(__bfloat162float(*p)); }
__device__ __forceinline__ h to_half(const uint8_t* p) { return __float2half_rn(__fmul_rn((float)*p, INV255)); }

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

// One quadrant of the direction and length estimate, in float32
// (easu_resolve's accumulate_quads, one FsrEasuSetF call): the '+' pattern
// a (above), b (left), c (centre), d (right), e (below) of float32 lumas,
// weighted by w, added to dir_x, dir_y and len in the reference's order.
__device__ __forceinline__ void set_quad(float la, float lb, float lc, float ld, float le, float w, float& dirx,
                                         float& diry, float& len) {
  const float dc = __fsub_rn(ld, lc);
  const float cb = __fsub_rn(lc, lb);
  float len_x = prx_lo_rcp(tmaxf(fabsf(dc), fabsf(cb)));
  const float dx = __fsub_rn(ld, lb);
  dirx = __fadd_rn(dirx, __fmul_rn(dx, w));
  len_x = sat_nan0(__fmul_rn(fabsf(dx), len_x));
  len = __fadd_rn(len, __fmul_rn(__fmul_rn(len_x, len_x), w));
  const float ec = __fsub_rn(le, lc);
  const float ca = __fsub_rn(lc, la);
  float len_y = prx_lo_rcp(tmaxf(fabsf(ec), fabsf(ca)));
  const float dy = __fsub_rn(le, la);
  diry = __fadd_rn(diry, __fmul_rn(dy, w));
  len_y = sat_nan0(__fmul_rn(fabsf(dy), len_y));
  len = __fadd_rn(len, __fmul_rn(__fmul_rn(len_y, len_y), w));
}

// EASU "mixed" from the tap window t[c][r][q] of halves (rows fy-1..fy+2,
// columns fx-1..fx+2 around 'f' = t[c][1][1]; the corners are not read),
// the float32 lumas L[r][q] of those texels (each the half luma, widened),
// at subpixel position (ppx, ppy) (float32): the direction and length in
// float32 with the APrx bit tricks, the filter shape rounded to half once,
// then the taps' weights, FsrEasuF's single accumulation chain, the exact
// reciprocal of the weight sum and the dering clamp, all in half.
__device__ __forceinline__ void easu_mixed(const h (&t)[3][4][4], const float (&L)[4][4], float ppx, float ppy,
                                           h out[3]) {
  const float qx = __fsub_rn(1.0f, ppx);
  const float qy = __fsub_rn(1.0f, ppy);
  float dirx = 0.0f, diry = 0.0f, len = 0.0f;
  set_quad(L[0][1], L[1][0], L[1][1], L[1][2], L[2][1], __fmul_rn(qx, qy), dirx, diry, len);    // s
  set_quad(L[0][2], L[1][1], L[1][2], L[1][3], L[2][2], __fmul_rn(ppx, qy), dirx, diry, len);   // t
  set_quad(L[1][1], L[2][0], L[2][1], L[2][2], L[3][1], __fmul_rn(qx, ppy), dirx, diry, len);   // u
  set_quad(L[1][2], L[2][1], L[2][2], L[2][3], L[3][2], __fmul_rn(ppx, ppy), dirx, diry, len);  // v

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
  const float len2_x = __fadd_rn(1.0f, __fmul_rn(__fsub_rn(stretch, 1.0f), len));
  const float len2_y = __fadd_rn(1.0f, __fmul_rn(-0.5f, len));
  const float lob_f = __fadd_rn(0.5f, __fmul_rn((float)((1.0 / 4.0 - 0.04) - 0.5), len));
  const float clp_f = prx_lo_rcp(lob_f);

  // The filter shape handed to half (easu_math.py:261-263).
  const h hdx = __float2half_rn(dirx), hdy = __float2half_rn(diry), ndy = __hneg(hdy);
  const h l2x = __float2half_rn(len2_x), l2y = __float2half_rn(len2_y);
  const h lob = __float2half_rn(lob_f), clp = __float2half_rn(clp_f);
  const h hpx = __float2half_rn(ppx), hpy = __float2half_rn(ppy);
  h off_x[4], off_y[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    off_x[q] = sub(k((float)(q - 1)), hpx);
    off_y[q] = sub(k((float)(q - 1)), hpy);
  }

  // Taps in FsrEasuF accumulation order (b c i j f e k l h g o n;
  // ffx_fsr1.h:423-434), each with the rotated, anisotropic distance and
  // the non-fast weight (2/5 d2 - 1)^2 25/16 - 9/16 times (lob d2 - 1)^2.
  constexpr int kTapDx[12] = {0, 1, -1, 0, 0, -1, 1, 2, 2, 1, 1, 0};
  constexpr int kTapDy[12] = {-1, -1, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2};
  const h m1 = k(-1.0f), c25 = k(2.0f / 5.0f), c2516 = k(25.0f / 16.0f), c916 = k(-(25.0f / 16.0f - 1.0f));
  h ac0 = k(0.0f), ac1 = k(0.0f), ac2 = k(0.0f), aw = k(0.0f);
#pragma unroll
  for (int n = 0; n < 12; ++n) {
    const int q = kTapDx[n] + 1;
    const int r = kTapDy[n] + 1;
    const h ox = off_x[q], oy = off_y[r];
    const h vx = mul(add(mul(ox, hdx), mul(oy, hdy)), l2x);
    const h vy = mul(add(mul(ox, ndy), mul(oy, hdx)), l2y);
    const h d2 = tmin(add(mul(vx, vx), mul(vy, vy)), clp);
    h w_a = add(mul(lob, d2), m1);
    w_a = mul(w_a, w_a);
    h w_b = add(mul(c25, d2), m1);
    w_b = mul(w_b, w_b);
    w_b = add(mul(c2516, w_b), c916);
    const h w = mul(w_b, w_a);
    ac0 = add(ac0, mul(t[0][r][q], w));
    ac1 = add(ac1, mul(t[1][r][q], w));
    ac2 = add(ac2, mul(t[2][r][q], w));
    aw = add(aw, w);
  }
  const h inv_w = rcp(aw);
  const h acc[3] = {ac0, ac1, ac2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // Dering clamp to the nearest 2x2 {f, g, j, k} (ffx_fsr1.h:416-419).
    const h mn = tmin(tmin(t[c][1][1], t[c][1][2]), tmin(t[c][2][1], t[c][2][2]));
    const h mx = tmax(tmax(t[c][1][1], t[c][1][2]), tmax(t[c][2][1], t[c][2][2]));
    out[c] = tmin(mx, tmax(mn, mul(acc[c], inv_w)));
  }
}

// FsrRcasH (rcas_resolve(fast=False) in float16) on the cross b (above),
// d (left), e (centre), f (right), h (below), three channels each: the
// limiters with the exact reciprocal and the NaN-dropping max, the optional
// denoise, APrxMedRcp on halves.  sharp: sharpness_f16.
template <bool DENOISE>
__device__ __forceinline__ void rcas_h(const h b[3], const h d[3], const h e[3], const h f[3], const h hh[3],
                                       h sharp, h out[3]) {
  const h one = k(1.0f), four = k(4.0f);
  h lobe = k(0.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const h mn4 = tmin(tmin(b[c], d[c]), tmin(f[c], hh[c]));
    const h mx4 = tmax(tmax(b[c], d[c]), tmax(f[c], hh[c]));
    // 0 * inf = NaN under a bright centre (mx4 == 0) is dropped by the
    // HLSL max (ffx_fsr1.h:749), as _nan_drop_max drops it.
    const h hit_min = mul(tmin(mn4, e[c]), rcp(mul(four, mx4)));
    const h hit_max = mul(sub(one, tmax(mx4, e[c])), rcp(add(mul(four, mn4), k(-4.0f))));
    const h lobe_c = __hmax(__hneg(hit_min), hit_max);
    lobe = c == 0 ? lobe_c : tmax(lobe, lobe_c);
  }
  lobe = mul(tmax(k(-(0.25f - 1.0f / 16.0f)), tmin(lobe, k(0.0f))), sharp);
  if (DENOISE) {
    const h q = k(0.25f);
    const h bl = luma(b[0], b[1], b[2]), dl = luma(d[0], d[1], d[2]), el = luma(e[0], e[1], e[2]);
    const h fl = luma(f[0], f[1], f[2]), hl = luma(hh[0], hh[1], hh[2]);
    h nz = sub(add(add(add(mul(q, bl), mul(q, dl)), mul(q, fl)), mul(q, hl)), el);
    const h rng = sub(tmax(tmax(tmax(bl, dl), tmax(el, fl)), hl), tmin(tmin(tmin(bl, dl), tmin(el, fl)), hl));
    nz = sat(mul(__habs(nz), prx_med_rcp(rng)));
    nz = add(mul(k(-0.5f), nz), one);
    lobe = mul(lobe, nz);
  }
  const h rcp_l = prx_med_rcp(add(mul(four, lobe), one));
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = mul(add(add(add(add(mul(lobe, b[c]), mul(lobe, d[c])), mul(lobe, hh[c])), mul(lobe, f[c])), e[c]),
                 rcp_l);
}

}  // namespace h16
}  // namespace fsr
