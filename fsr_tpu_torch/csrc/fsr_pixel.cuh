// Device math shared by K1 (fused.cu), K2 (easu_gather.cu) and K3 (rcas.cu).
//
// Per-pixel EASU and RCAS in float32, as the kernels' plain versions compute
// them (easu_math.easu_resolve / rcas_resolve with fast=True): the APrx bit
// tricks, the per-texel quad responses with a pre-summed length, the
// quadratic-form tap distance, and the division-light RCAS limiter written
// with selects.  These functions take values: where a pixel's tap window
// lies, and the frame's border rule, are each kernel's own business.
//
// Also the tile loop all three kernels share: one block of NTHREADS per
// TILE_H (K2: its own height) x TILE_W output tile, with a one-pixel ring of
// float32 planes in shared memory for RCAS, and the host-side launch loop
// over frames.  RGBA's alpha never enters the ring: K1 and K2 resolve it
// bilinearly at the store (bilinear_alpha), as RCAS passes alpha through.
//
// And the storage rules with byte I/O, the SRTM prologue at load and the
// K5 epilogue before the store (kernels/epilogue.py), written with
// __fmul_rn/__fadd_rn wherever nvcc would otherwise contract a product and
// a sum into an FMA: these must round each operation as the kernels' plain
// torch versions do, because the TEPD dither and the UNORM encode have
// knife edges (a one-ulp difference flips a code).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fsr {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int RING_W = TILE_W + 2;
constexpr int NTHREADS = 256;
constexpr float RCAS_LIMIT4 = 4.0f * (0.25f - 1.0f / 16.0f);

// Stage knockouts, for the ablation tools only (tools_torch/ablation/
// fused_stage_ablation.py, gather_ablation.py): each FSR_ABL_* macro, passed
// with -D to a tool's own build, replaces one stage of K1 or K2 with a cheap
// stand-in that depends on the data, so that nvcc cannot drop the stages
// upstream of it.  The output is wrong by design.  Every knockout sits under
// #if defined(...), so a build without the macros compiles the production
// kernels token for token.  fsr_ablation_mask() (fused.cu) returns this
// mask: one bit per macro the library was built with, in the order of
// kernels/_build.py:ABLATION_MACROS; the tools check it (a misspelt -D
// would build the production kernel), and chip_smoke.py holds the
// production library's to 0.
constexpr int ABLATION_MASK = 0
#if defined(FSR_ABL_K1_SET)
                              | 1 << 0
#endif
#if defined(FSR_ABL_K1_NORM)
                              | 1 << 1
#endif
#if defined(FSR_ABL_K1_WEIGHTS)
                              | 1 << 2
#endif
#if defined(FSR_ABL_K1_POLY)
                              | 1 << 3
#endif
#if defined(FSR_ABL_K1_DERING)
                              | 1 << 4
#endif
#if defined(FSR_ABL_RCASLIMIT)
                              | 1 << 5
#endif
#if defined(FSR_ABL_K2_NOG)
                              | 1 << 6
#endif
#if defined(FSR_ABL_K2_WEIGHTS)
                              | 1 << 7
#endif
#if defined(FSR_ABL_K2_STAGEONLY)
                              | 1 << 8
#endif
    ;

// Float32 constants, bit-exact to the plain versions' (ops/extras.py).
constexpr float INV255 = 0x1.010102p-8f;    // float32(1/255)
constexpr float INV1023 = 0x1.00401p-10f;   // float32(1/1023)
constexpr float DIT_A = 0x1.9e377ap+0f;     // float32((1 + sqrt(5)) / 2)
constexpr float DIT_B = 0x1.1581bcp-2f;     // float32(1 / 3.69)

// dtype codes of the C interfaces: the source's and the output's.
enum DType { F32 = 0, BF16 = 1, U8 = 2, U16 = 3, F16 = 4 };

// D3D UNORM code floor(sat(v) * max_code + 0.5); NaN encodes as 0, as
// utils.image.to_uint8 (its nan_to_num) does.
__device__ __forceinline__ float unorm(float v, float max_code) {
  const float s = v > 0.0f ? fminf(v, 1.0f) : 0.0f;
  return floorf(__fadd_rn(__fmul_rn(s, max_code), 0.5f));
}

// Storage helpers: the math is float32, bfloat16 and float16 are storage
// only (a load widens exactly, a store rounds once to nearest even); a byte
// decodes as v * float32(1/255) and the integer outputs store UNORM codes
// of the float32 value (8-bit in uint8, 10-bit in uint16).
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ld(const __half* p) { return __half2float(*p); }
__device__ __forceinline__ float ld(const uint8_t* p) { return __fmul_rn((float)*p, INV255); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void st(__half* p, float v) { *p = __float2half_rn(v); }
__device__ __forceinline__ void st(uint8_t* p, float v) { *p = (uint8_t)unorm(v, 255.0f); }
__device__ __forceinline__ void st(uint16_t* p, float v) { *p = (uint16_t)unorm(v, 1023.0f); }

// A value as storage type T holds it: bfloat16 and float16 round to nearest
// even, as a dtype convert of the source would.
template <typename T>
__device__ __forceinline__ float as_storage(float v) { return v; }
template <>
__device__ __forceinline__ float as_storage<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ float as_storage<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

// The same loads through the read-only data cache (__ldg), for a source the
// compiler cannot see is read-only (the strip-source form's parts, which no
// __restrict__ kernel parameter names).
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float ldg(const __half* p) { return __half2float(__ldg(p)); }
__device__ __forceinline__ float ldg(const uint8_t* p) { return __fmul_rn((float)__ldg(p), INV255); }

// Load a source element of type S, rounded to storage type T, widened (NC:
// through the read-only data cache).  A decoded byte is never rounded to
// the storage type.
template <typename T, bool NC = false, typename S>
__device__ __forceinline__ float ld_as(const S* p) {
  float v;
  if constexpr (NC)
    v = ldg(p);
  else
    v = ld(p);
  if constexpr (std::is_same<S, uint8_t>::value) {
    return v;
  } else {
    return as_storage<T>(v);
  }
}

// APrx* bit tricks (ffx_a.h:1786-1860), float32.
__device__ __forceinline__ float prx_lo_rcp(float a) {
  return __uint_as_float(0x7EF07EBBu - __float_as_uint(a));
}
// APrxMedRcp with every operation rounded, as the plain version's separate
// torch ops round them (RCAS's resolve and TEPD's threshold).
__device__ __forceinline__ float prx_med_rcp(float a) {
  const float b = __uint_as_float(0x7EF19FFFu - __float_as_uint(a));
  return __fmul_rn(b, __fadd_rn(__fmul_rn(-b, a), 2.0f));
}
__device__ __forceinline__ float prx_lo_rsq(float a) {
  return __uint_as_float(0x5F347D74u - (__float_as_uint(a) >> 1));
}

// Plain clamp: the texel response's input cannot be NaN (the bit-trick
// reciprocal is finite at 0).
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
// HLSL saturate: NaN -> 0.
__device__ __forceinline__ float sat_nan0(float x) { return x > 0.0f ? fminf(x, 1.0f) : 0.0f; }

// torch.clamp(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clip01(float x) { return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x); }

// Bilinear alpha (ops.easu.bilinear, fsr_tpu/ops/easu.py:134-136) from the
// texels at 'f', right of it, below it and below right, at subpixel position
// (px, py): each operation rounded on its own (nvcc would contract each lerp
// into an FMA), so the float32 alpha is bit-equal to the plain version's.
__device__ __forceinline__ float bilinear_alpha(float tl, float tr, float bl, float br, float px,
                                                float py) {
  const float top = __fadd_rn(tl, __fmul_rn(__fsub_rn(tr, tl), px));
  const float bot = __fadd_rn(bl, __fmul_rn(__fsub_rn(br, bl), px));
  return __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), py));
}

__device__ __forceinline__ float luma2(float r, float g, float b) {
  return b * 0.5f + (r * 0.5f + g);
}

// easu_texel_response(fast=True): '+'-pattern response around texel c.
__device__ __forceinline__ void texel_response(float la, float lb, float lc, float ld_,
                                               float le, float& gx, float& gy, float& gl) {
  const float dc = ld_ - lc;
  const float cb = lc - lb;
  float len_x = prx_lo_rcp(fmaxf(fabsf(dc), fabsf(cb)));
  gx = ld_ - lb;
  len_x = clamp01(fabsf(gx) * len_x);
  len_x = len_x * len_x;
  const float ec = le - lc;
  const float ca = lc - la;
  float len_y = prx_lo_rcp(fmaxf(fabsf(ec), fabsf(ca)));
  gy = le - la;
  len_y = clamp01(fabsf(gy) * len_y);
  len_y = len_y * len_y;
  gl = len_x + len_y;
}

// The SRTM prologue (FsrSrtmF, ffx_fsr1.h:1043) on one texel, in float32
// on the source as stored: c *= 1 / (max3(c) + 1) with the correctly
// rounded reciprocal (ops.extras.srtm).
__device__ __forceinline__ void srtm_texel(float& r, float& g, float& b) {
  const float rc = __frcp_rn(__fadd_rn(fmaxf(fmaxf(r, g), b), 1.0f));
  r = __fmul_rn(r, rc);
  g = __fmul_rn(g, rc);
  b = __fmul_rn(b, rc);
}

// The SRTM prologue on each texel of a loaded tap window.
__device__ __forceinline__ void srtm_window(float (&t)[3][4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((r == 0 || r == 3) && (q == 0 || q == 3)) continue;
      srtm_texel(t[0][r][q], t[1][r][q], t[2][r][q]);
    }
  }
}

// EASU resolve (easu_resolve(fast=True) with per-texel quad responses) from
// the tap window t[c][r][q]: rows fy-1..fy+2 and columns fx-1..fx+2 around
// 'f' = t[c][1][1] (the four corners are not read), and the responses
// (texel_response's gx, gy, gl) of the quadrant centres f (1,1) as s, g
// (1,2) as t, j (2,1) as u and k (2,2) as v, at subpixel position (ppx,
// ppy) inside the f..k quad.  K1 computes the responses per pixel
// (easu_resolve_luma), K2 once per texel of its block (easu_gather.cu).
__device__ __forceinline__ void easu_resolve_quads(const float (&t)[3][4][4], float gxs, float gys, float gls,
                                                   float gxt, float gyt, float glt, float gxu, float gyu, float glu,
                                                   float gxv, float gyv, float glv, float ppx, float ppy,
                                                   float out[3]) {
  const float ws = (1.0f - ppx) * (1.0f - ppy);
  const float wt = ppx * (1.0f - ppy);
  const float wu = (1.0f - ppx) * ppy;
  const float wv = ppx * ppy;
  float dirx = gxs * ws;
  float diry = gys * ws;
  float len = gls * ws;
  dirx = dirx + gxt * wt;
  diry = diry + gyt * wt;
  len = len + glt * wt;
  dirx = dirx + gxu * wu;
  diry = diry + gyu * wu;
  len = len + glu * wu;
  dirx = dirx + gxv * wv;
  diry = diry + gyv * wv;
  len = len + glv * wv;

  // Direction normalisation with zero-protect (ffx_fsr1.h:388-395).
  float dir_r = dirx * dirx + diry * diry;
  const bool zro = dir_r < (1.0f / 32768.0f);
  dir_r = prx_lo_rsq(dir_r);
  if (zro) {
    dir_r = 1.0f;
    dirx = 1.0f;
  }
  dirx = dirx * dir_r;
  diry = diry * dir_r;
  len = len * 0.5f;
  len = len * len;
  const float stretch = (dirx * dirx + diry * diry) * prx_lo_rcp(fmaxf(fabsf(dirx), fabsf(diry)));
  const float len2_x = 1.0f + (stretch - 1.0f) * len;
  const float len2_y = 1.0f + (-0.5f) * len;
  const float lob = 0.5f + (float)((1.0 / 4.0 - 0.04) - 0.5) * len;
  const float clp = prx_lo_rcp(lob);

  // Tap distance as a quadratic form, factored per tap row/column.
  const float lx2 = len2_x * len2_x;
  const float ly2 = len2_y * len2_y;
  const float xx = dirx * dirx;
  const float yy = diry * diry;
  const float xy = dirx * diry;
  const float qa = xx * lx2 + yy * ly2;
  const float qb = (xy + xy) * (lx2 - ly2);
  const float qc = yy * lx2 + xx * ly2;
  float off_x[4], c_dx[4], a_dy[4], b_dy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    off_x[k] = (float)(k - 1) - ppx;
    const float oy = (float)(k - 1) - ppy;
    a_dy[k] = oy * qb;
    b_dy[k] = (oy * oy) * qc;
    c_dx[k] = (off_x[k] * off_x[k]) * qa;
  }

  // Tap (dx, dy) offsets from 'f' in FsrEasuF accumulation order
  // (b c i j f e k l h g o n; ffx_fsr1.h:423-434).  The loop unrolls, so
  // every index below is a compile-time constant and t stays in registers.
  constexpr int kTapDx[12] = {0, 1, -1, 0, 0, -1, 1, 2, 2, 1, 1, 0};
  constexpr int kTapDy[12] = {-1, -1, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2};
  float ac0 = 0.0f, ac1 = 0.0f, ac2 = 0.0f, aw = 0.0f;
#pragma unroll
  for (int n = 0; n < 12; ++n) {
    const int dx = kTapDx[n] + 1;
    const int dy = kTapDy[n] + 1;
#if defined(FSR_ABL_K2_WEIGHTS)
    // Knockout (gather_ablation.py "weights"): the tap distance and weight
    // stubbed by the lobe or the clip, alternating; the accumulation stays.
    const float w = (dx + dy) % 2 == 0 ? lob : clp;
#else
    float d2 = c_dx[dx] + (off_x[dx] * a_dy[dy] + b_dy[dy]);
    d2 = fminf(d2, clp);
    float w_a = lob * d2 - 1.0f;
    w_a = w_a * w_a;
    // Horner form of 25/16*(2/5*d2-1)^2 - 9/16; the product with w_a stays
    // factored (a single quartic loses fidelity near the clip point).
    const float w_b = (0.25f * d2 - 1.25f) * d2 + 1.0f;
    const float w = w_b * w_a;
#endif
    ac0 = ac0 + t[0][dy][dx] * w;
    ac1 = ac1 + t[1][dy][dx] * w;
    ac2 = ac2 + t[2][dy][dx] * w;
    aw = aw + w;
  }
  const float inv_w = __frcp_rn(aw);
  const float acc[3] = {ac0, ac1, ac2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // Dering clamp to the nearest 2x2 {f, g, j, k}; selects keep a NaN as
    // jnp.minimum/maximum would.
    const float mn = fminf(fminf(t[c][1][1], t[c][1][2]), fminf(t[c][2][1], t[c][2][2]));
    const float mx = fmaxf(fmaxf(t[c][1][1], t[c][1][2]), fmaxf(t[c][2][1], t[c][2][2]));
    float v = acc[c] * inv_w;
    v = (v < mn) ? mn : v;
    v = (v > mx) ? mx : v;
    out[c] = v;
  }
}

// EASU resolve from the tap window t and its lumas L[r][q] (luma2 of each
// texel): the four quadrant responses, then easu_resolve_quads.
__device__ __forceinline__ void easu_resolve_luma(const float (&t)[3][4][4], const float (&L)[4][4],
                                                  float ppx, float ppy, float out[3]) {
  float gxs, gys, gls, gxt, gyt, glt, gxu, gyu, glu, gxv, gyv, glv;
  texel_response(L[0][1], L[1][0], L[1][1], L[1][2], L[2][1], gxs, gys, gls);
  texel_response(L[0][2], L[1][1], L[1][2], L[1][3], L[2][2], gxt, gyt, glt);
  texel_response(L[1][1], L[2][0], L[2][1], L[2][2], L[3][1], gxu, gyu, glu);
  texel_response(L[1][2], L[2][1], L[2][2], L[2][3], L[3][2], gxv, gyv, glv);
  easu_resolve_quads(t, gxs, gys, gls, gxt, gyt, glt, gxu, gyu, glu, gxv, gyv, glv, ppx, ppy, out);
}

// EASU resolve from the tap window alone: its lumas first.
__device__ __forceinline__ void easu_resolve(const float (&t)[3][4][4], float ppx, float ppy,
                                             float out[3]) {
  float L[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((r == 0 || r == 3) && (q == 0 || q == 3)) continue;
      L[r][q] = luma2(t[0][r][q], t[1][r][q], t[2][r][q]);
    }
  }
  easu_resolve_luma(t, L, ppx, ppy, out);
}

// rcas_resolve(fast=True) on the cross b (above), d (left), e (centre),
// f (right), h (below), three channels each.  Every product that meets a
// sum or a comparison is rounded on its own, as in the plain version (the
// multiplications by 0.5 and 0.25 are exact, so those may contract): RCAS
// here is bit-equal to its plain version, and so are K3's byte codes.
template <bool DENOISE>
__device__ __forceinline__ void rcas_pixel(const float b[3], const float d[3], const float e[3],
                                           const float f[3], const float h[3], float sharp,
                                           float out[3]) {
  // Division-light limiter: the reference's lobe is
  // -(1/4) min_ch min(u/mx4, v/q) with u = min(mn4, e), v = 1 - max(mx4, e),
  // q = 1 - mn4; ratios compare cross-multiplied, then one reciprocal.  The
  // selects reproduce the reference's NaN-drop branch (mx4 == 0 under an
  // isolated bright pixel) without forming a NaN; no fmaxf NaN-dropping is
  // relied on.
#if defined(FSR_ABL_RCASLIMIT)
  // Knockout (fused_stage_ablation.py "rcaslimit"): the limiter replaced by
  // a lobe from the centre's red, as the JAX tool's stand-in
  // (easu_math.rcas_resolve); the resolve below stays.
  (void)sharp;
  float lobe = __fmul_rn(e[0], -0.01f);
#else
  float num = 0.0f, den = 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mn4 = fminf(fminf(b[c], d[c]), fminf(f[c], h[c]));
    const float mx4 = fmaxf(fmaxf(b[c], d[c]), fmaxf(f[c], h[c]));
    const float u = fminf(mn4, e[c]);
    const float v = 1.0f - fmaxf(mx4, e[c]);
    const float q = 1.0f - mn4;
    const float v_s = (q == 0.0f) ? 1.0f : v;
    const bool pick1 = __fmul_rn(u, q) < __fmul_rn(v_s, mx4);
    const float n_c = pick1 ? u : v;
    const float d_c = pick1 ? mx4 : q;
    if (c == 0) {
      num = n_c;
      den = d_c;
    } else if (__fmul_rn(n_c, den) < __fmul_rn(num, d_c)) {
      num = n_c;
      den = d_c;
    }
  }
  float r = num * __frcp_rn(den);
  r = (r < 0.0f) ? 0.0f : r;
  r = (r > RCAS_LIMIT4) ? RCAS_LIMIT4 : r;
  float lobe = r * (sharp * -0.25f);
#endif
  if (DENOISE) {
    const float bl = luma2(b[0], b[1], b[2]);
    const float dl = luma2(d[0], d[1], d[2]);
    const float el = luma2(e[0], e[1], e[2]);
    const float fl = luma2(f[0], f[1], f[2]);
    const float hl = luma2(h[0], h[1], h[2]);
    float nz = 0.25f * bl + 0.25f * dl + 0.25f * fl + 0.25f * hl - el;
    const float rng = fmaxf(fmaxf(fmaxf(bl, dl), fmaxf(el, fl)), hl) -
                      fminf(fminf(fminf(bl, dl), fminf(el, fl)), hl);
    nz = sat_nan0(fabsf(nz) * prx_med_rcp(rng));
    nz = -0.5f * nz + 1.0f;
    lobe = lobe * nz;
  }
  const float rcp_l = prx_med_rcp(4.0f * lobe + 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = __fmul_rn(__fadd_rn(__fmul_rn(lobe, (b[c] + d[c]) + (h[c] + f[c])), e[c]), rcp_l);
}

// K5's parameters (kernels/epilogue.py:EpilogueArgs.struct), the same for
// every thread: the branches on them are uniform.
// frame_dev comes last, so that the fields before it keep their offsets: a
// library built before it reads a struct from this one's wrappers as its own
// (tools_torch/ablation/kernel_ab.py drives both).
struct EpilogueParams {
  const float* grain;  // [3][h][w] float32 LFGA grain, or null (no grain)
  const float* page;   // [page_h][page_w] float32 dither positions, or null (hash)
  float grain_amount;
  int transform;    // 0 none, 1 srtm_inv, 2 gamma2
  int dither_bits;  // 0 (no TEPD), 8 or 10
  unsigned frame;   // the TEPD hash's frame index from the host
  int page_h, page_w;
  int row0;  // global output row of the frame's row 0 (a row strip's offset; 0 for a whole frame)
  const int* frame_dev;  // the TEPD hash's frame index on the device (int32), or null: `frame`
};

// The TEPD hash's frame index as uint32 (JAX's jnp.uint32(frame)): the
// device operand where there is one (a frame traced on the card, read at
// each launch, so a captured graph takes each replay's), else the host's.
// Each thread reads it once, before its pixel loop.
__device__ __forceinline__ unsigned epilogue_frame(const EpilogueParams& e) {
  return e.frame_dev != nullptr ? (unsigned)__ldg(e.frame_dev) : e.frame;
}

// The K5 epilogue on output pixel (Y, X)'s float32 channels v, before the
// store (epilogue.apply: the ops.extras chain): SRTM^-1 or gamma2, LFGA
// grain, TEPD dithered quantize (the hash's frame: epilogue_frame(e)).  The
// grain shares the output frame's layout (plane stride oplane, offset at);
// the TEPD hash and the dither page take the global row Y + row0, so a row
// strip dithers as its rows of the whole frame do.  For finite values every
// operation rounds as the plain version's does.
__device__ __forceinline__ void epilogue(const EpilogueParams& e, unsigned frame, int64_t oplane,
                                         int64_t at, int Y, int X, float v[3]) {
  if (e.transform == 1) {
    const float m = fmaxf(fmaxf(v[0], v[1]), v[2]);
    const float rc = __frcp_rn(fmaxf(__fsub_rn(1.0f, m), 1.0f / 32768.0f));
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __fmul_rn(v[c], rc);
  } else if (e.transform == 2) {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __fmul_rn(v[c], v[c]);
  }
  if (e.grain != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g = __fmul_rn(__ldg(e.grain + c * oplane + at), e.grain_amount);
      const float u = __fsub_rn(1.0f, v[c]);
      v[c] = __fadd_rn(v[c], __fmul_rn(g, u < v[c] ? u : v[c]));
    }
  }
  if (e.dither_bits != 0) {
    float dit;
    const int gy = Y + e.row0;
    if (e.page != nullptr) {
      dit = __ldg(e.page + (gy % e.page_h) * e.page_w + (X % e.page_w));
    } else {
      // FsrTepdDitF: fract(phi * (x + frame) + y / 3.69), coordinates as uint32.
      const float x = __uint2float_rn((unsigned)X + frame);
      const float hv = __fadd_rn(__fmul_rn(x, DIT_A), __fmul_rn(__int2float_rn(gy), DIT_B));
      dit = __fsub_rn(hv, floorf(hv));
    }
    const float steps = e.dither_bits == 8 ? 255.0f : 1023.0f;
    const float inv = e.dither_bits == 8 ? INV255 : INV1023;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // FsrTepdC8F/C10F: the linear-nearest of the two gamma-2.0 steps.
      float n = __fsqrt_rn(v[c]);
      n = __fmul_rn(floorf(__fmul_rn(n, steps)), inv);
      const float a = __fmul_rn(n, n);
      float b = __fadd_rn(n, inv);
      b = __fmul_rn(b, b);
      const float r = __fmul_rn(__fsub_rn(v[c], b), prx_med_rcp(__fsub_rn(a, b)));
      v[c] = clip01(__fadd_rn(n, __fsub_rn(dit, r) > 0.0f ? inv : 0.0f));
    }
  }
}

// Store one pixel's three channels at plane offset `at`.
template <typename T>
__device__ __forceinline__ void st3(T* o, int64_t oplane, int64_t at, const float v[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) st(o + c * oplane + at, v[c]);
}

// An RGBA pixel's store: the three channels after the epilogue, and alpha
// (plane 3) by the same storage rule (bfloat16/float16 rounding, UNORM8,
// UNORM10); the epilogue never touches alpha.
template <typename T>
__device__ __forceinline__ void st4(T* o, int64_t oplane, int64_t at, const float v[3], float a) {
  st3(o, oplane, at, v);
  st(o + 3 * oplane + at, a);
}

// One block's TH x TILE_W tile of an h x w output frame, RCAS off:
// pixel(Y, X, v) gives each pixel's three channels, store(Y, X, v) finishes
// and stores them (K1 and K2 run the epilogue and resolve alpha there).
template <int TH = TILE_H, typename Pixel, typename Store>
__device__ __forceinline__ void store_tile(Pixel pixel, Store store, int h, int w) {
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TH;
  for (int k = threadIdx.x; k < TILE_W * TH; k += NTHREADS) {
    const int Y = y0 + k / TILE_W;
    const int X = x0 + k % TILE_W;
    if (Y >= h || X >= w) continue;
    float v[3];
    pixel(Y, X, v);
    store(Y, X, v);
  }
}

// One block's tile with RCAS: ring(Y, X, v) fills the float32 planes of the
// tile and its one-pixel ring in shared memory (sm), for (Y, X) from one
// before the tile to one past it (possibly outside the frame: the caller
// applies its border rule); after a barrier each pixel of the tile runs the
// RCAS cross on them, then store(Y, X, v), once.
template <bool DENOISE, int TH = TILE_H, typename Ring, typename Store>
__device__ __forceinline__ void rcas_tile(Ring ring, Store store, int h, int w, float sharp,
                                          float (&sm)[3][TH + 2][RING_W]) {
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TH;
  for (int k = threadIdx.x; k < (TH + 2) * RING_W; k += NTHREADS) {
    const int ly = k / RING_W;
    const int lx = k % RING_W;
    float v[3];
    ring(y0 + ly - 1, x0 + lx - 1, v);
#pragma unroll
    for (int c = 0; c < 3; ++c) sm[c][ly][lx] = v[c];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < TILE_W * TH; k += NTHREADS) {
    const int ly = k / TILE_W;
    const int lx = k % TILE_W;
    const int Y = y0 + ly;
    const int X = x0 + lx;
    if (Y >= h || X >= w) continue;
    float b[3], d[3], e[3], f[3], hh[3], v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = sm[c][ly][lx + 1];
      d[c] = sm[c][ly + 1][lx];
      e[c] = sm[c][ly + 1][lx + 1];
      f[c] = sm[c][ly + 1][lx + 2];
      hh[c] = sm[c][ly + 2][lx + 1];
    }
    rcas_pixel<DENOISE>(b, d, e, f, hh, sharp, v);
    store(Y, X, v);
  }
}

// The same with the ring's planes in a static shared array of its own.
template <bool DENOISE, int TH = TILE_H, typename Ring, typename Store>
__device__ __forceinline__ void rcas_tile(Ring ring, Store store, int h, int w, float sharp) {
  __shared__ float sm[3][TH + 2][RING_W];
  rcas_tile<DENOISE, TH>(ring, store, h, w, sharp, sm);
}

// The strip-source form of K1 and K2 (kernels/halo.py:StripSource): a row
// strip of a row-sharded frame read in place from three parts, as the host
// passes them.  Each part is (..., C, rows, win) with rows of win contiguous
// elements, its planes and frames at its own strides (a view of a larger
// tensor, or a buffer on a neighbour's card read by peer access).  The
// kernels index the virtual halo'd strip of h + 2 * halo rows as they index
// a whole source; only the load's address comes from here:
//   row r < halo           up's row rows_up - halo + r (no up: own row 0);
//   halo <= r < halo + h   own's row r - halo;
//   r >= halo + h          down's row r - halo - h (no down: own row h - 1).
// These are the rows parallel/spatial.py:_exchange_halo's torch.cat gives.
struct StripParts {
  const void* ptr[3];  // up (or null), own, down (or null)
  long long plane[3];  // each part's plane stride, in elements
  long long frame[3];  // its frame stride, in elements
  int rows[3];
  int halo;
};

template <typename S>
struct StripSrc {
  const S* up;
  const S* own;
  const S* down;
  int64_t up_plane, own_plane, down_plane;
  int64_t up_frame, own_frame, down_frame;
  int up_row0;  // up's row of virtual row 0: its rows less halo
  int halo, h;
};

// A pack of one strip source (the strip-source form's trailing kernel
// argument), as itself.
template <typename S>
__device__ __forceinline__ const StripSrc<S>& only(const StripSrc<S>& s) {
  return s;
}

// The strip-source form's staging of frame n: a block's window rows
// 0 .. fh - 1 hold the virtual rows clamp(r0 + r, 0, hin - 1), which are
// non-decreasing in r, so they fall into three runs by part: [0, a) from
// up, [a, b) from own, [b, fh) from down (a = 0 without up and b = fh
// without down, own's edge row repeated).  run(rb, re, base, plane, row)
// loads window rows rb .. re - 1 from base + row(r) * win at the part's
// plane stride: within a run the base and the plane are uniform, so its
// loads take the whole-frame form's address arithmetic (a select of the
// part per texel, ahead of every load, slowed K1's quad path).
template <typename S, typename Run>
__device__ __forceinline__ void stage_strip(const StripSrc<S>& s, int64_t n, int r0, int fh, int hin, Run run) {
  const int a = s.up != nullptr ? min(max(s.halo - r0, 0), fh) : 0;
  const int b = s.down != nullptr ? min(max(s.halo + s.h - r0, 0), fh) : fh;
  if (a > 0) run(0, a, s.up + n * s.up_frame, s.up_plane, [&](int r) { return s.up_row0 + max(r0 + r, 0); });
  run(a, b, s.own + n * s.own_frame, s.own_plane, [&](int r) { return min(max(r0 + r - s.halo, 0), s.h - 1); });
  if (b < fh)
    run(b, fh, s.down + n * s.down_frame, s.down_plane,
        [&](int r) { return min(r0 + r, hin - 1) - s.halo - s.h; });
}

// The parts of frames n0 on, for a launch of K1 or K2 over a chunk of
// frames (launch_frames).
template <typename S>
StripSrc<S> strip_src(const StripParts& sp, int64_t n0) {
  auto at = [&](int i) {
    return sp.ptr[i] == nullptr ? nullptr : static_cast<const S*>(sp.ptr[i]) + n0 * sp.frame[i];
  };
  return StripSrc<S>{at(0), at(1), at(2), sp.plane[0], sp.plane[1], sp.plane[2], sp.frame[0], sp.frame[1],
                     sp.frame[2], sp.rows[0] - sp.halo, sp.halo, sp.rows[1]};
}

// The host's checks of a strip source for an hin-row virtual strip.
inline bool strip_ok(const StripParts* sp, int hin) {
  if (sp == nullptr || sp->ptr[1] == nullptr || sp->halo < 1 || sp->rows[1] < 1) return false;
  if (hin != sp->rows[1] + 2 * sp->halo) return false;
  return (sp->ptr[0] == nullptr || sp->rows[0] >= sp->halo) && (sp->ptr[2] == nullptr || sp->rows[2] >= sp->halo);
}

// Host side: launch(grid, n0) once per chunk of at most 65535 frames (the
// grid's z limit) starting at frame n0, one block per TH x TW tile of an
// h x w output; returns the first launch error.
template <int TH = TILE_H, int TW = TILE_W, typename Launch>
int launch_frames(int nb, int h, int w, Launch launch) {
  const int max_z = 65535;
  for (int n0 = 0; n0 < nb; n0 += max_z) {
    const int nz = nb - n0 < max_z ? nb - n0 : max_z;
    launch(dim3((w + TW - 1) / TW, (h + TH - 1) / TH, nz), n0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace fsr
