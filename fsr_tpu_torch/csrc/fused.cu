// K1: fused EASU + RCAS for integer per-axis ratios qy, qx in {1, 2, 4}.
//
// Replaces the TPU kernel fsr_tpu/kernels/fused.py:upscale_fused
// (pallas_call at fused.py:1298).  It computes what fused.py:884-928 (EASU,
// fast kernel form) and fused.py:1100-1192 (RCAS with the border clamp in
// global output coordinates) compute; the TPU's phase-planar riffles,
// row packing and one-tile software pipeline have no counterpart here.
//
// Design: one block per TILE_H x TILE_W output tile.
//   Phase 1: EASU in f32 for the tile and a one-pixel ring into shared
//     memory.  Ring positions outside the image are clamped to the nearest
//     edge pixel, so the ring slot holds exactly the centre pixel's value:
//     RCAS then sees e in place of the missing neighbour at global row 0,
//     the last row, column 0 and the last column.
//   Barrier.
//   Phase 2: RCAS (division-light limiter, optional denoise) on the
//     unrounded f32 EASU values, then one store rounded to the storage type.
// With apply_rcas off the kernel stores EASU directly.
//
// Each output pixel (Y, X) lies in phase (a, b) = (Y % qy, X % qx) with
// 'f' texel (Y / qy + ry[a], X / qx + rx[b]) in the padded source and
// constant subpixel fractions (py[a], px[b]).  The host derives all four
// from the float32 coordinate tables (fused.py:_phase_structure); the device
// never recomputes x*sx+ox or floor(), which an FMA contraction would flip
// at integer positions.  The source is pre-padded by K4 far enough that no
// load needs bounds logic.
//
// Bound: f32 arithmetic.  Per output pixel it reads 12 taps x 3 channels
// (mostly from L1/L2: a 2x2 quad of outputs shares its taps) and runs a
// few hundred flops; device-memory traffic is one read of the source and
// one write of the output.  This first version recomputes the per-texel
// direction response and the ring (about 1.2x the tile's EASU work) instead
// of sharing them; per-texel reuse and TMA loads are later work.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int RING_W = TILE_W + 2;
constexpr int RING_H = TILE_H + 2;
constexpr int NTHREADS = 256;
constexpr float RCAS_LIMIT4 = 4.0f * (0.25f - 1.0f / 16.0f);

struct Params {
  int qy, qx;
  int ry[4], rx[4];  // padded-frame row/col of phase a/b's 'f' texel at plane index 0
  float py[4], px[4];
  int hp, wp;  // padded source extent
  int hout, wout;
  float sharp;  // linear RCAS sharpness
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// APrx* bit tricks (ffx_a.h:1786-1860), float32.
__device__ __forceinline__ float prx_lo_rcp(float a) {
  return __uint_as_float(0x7EF07EBBu - __float_as_uint(a));
}
__device__ __forceinline__ float prx_med_rcp(float a) {
  const float b = __uint_as_float(0x7EF19FFFu - __float_as_uint(a));
  return b * (-b * a + 2.0f);
}
__device__ __forceinline__ float prx_lo_rsq(float a) {
  return __uint_as_float(0x5F347D74u - (__float_as_uint(a) >> 1));
}

// Plain clamp: the texel response's input cannot be NaN (the bit-trick
// reciprocal is finite at 0).
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
// HLSL saturate: NaN -> 0.
__device__ __forceinline__ float sat_nan0(float x) { return x > 0.0f ? fminf(x, 1.0f) : 0.0f; }

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

// EASU (easu_resolve(fast=True) with per-texel quad responses) for output
// pixel (Y, X) of one frame.
template <typename T>
__device__ __forceinline__ void easu_pixel(const T* __restrict__ src, const Params& p, int Y,
                                           int X, float out[3]) {
  const int a = Y % p.qy;
  const int b = X % p.qx;
  const int fy = Y / p.qy + p.ry[a];
  const int fx = X / p.qx + p.rx[b];
  const int64_t plane = (int64_t)p.hp * p.wp;
  const T* base = src + (int64_t)(fy - 1) * p.wp + (fx - 1);

  // 4x4 window rows fy-1..fy+2, cols fx-1..fx+2; the corners are unused.
  float t[3][4][4];
  float L[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((r == 0 || r == 3) && (q == 0 || q == 3)) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) t[c][r][q] = ld(base + c * plane + (int64_t)r * p.wp + q);
      L[r][q] = luma2(t[0][r][q], t[1][r][q], t[2][r][q]);
    }
  }

  // Quadrant responses at the quad's texels f (1,1), g (1,2), j (2,1), k (2,2).
  float gxs, gys, gls, gxt, gyt, glt, gxu, gyu, glu, gxv, gyv, glv;
  texel_response(L[0][1], L[1][0], L[1][1], L[1][2], L[2][1], gxs, gys, gls);
  texel_response(L[0][2], L[1][1], L[1][2], L[1][3], L[2][2], gxt, gyt, glt);
  texel_response(L[1][1], L[2][0], L[2][1], L[2][2], L[3][1], gxu, gyu, glu);
  texel_response(L[1][2], L[2][1], L[2][2], L[2][3], L[3][2], gxv, gyv, glv);

  const float ppx = p.px[b];
  const float ppy = p.py[a];
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
    float d2 = c_dx[dx] + (off_x[dx] * a_dy[dy] + b_dy[dy]);
    d2 = fminf(d2, clp);
    float w_a = lob * d2 - 1.0f;
    w_a = w_a * w_a;
    // Horner form of 25/16*(2/5*d2-1)^2 - 9/16; the product with w_a stays
    // factored (a single quartic loses fidelity near the clip point).
    const float w_b = (0.25f * d2 - 1.25f) * d2 + 1.0f;
    const float w = w_b * w_a;
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

// rcas_resolve(fast=True) on the shared-memory EASU planes around (cy, cx).
template <bool DENOISE>
__device__ __forceinline__ void rcas_pixel(float (*sm)[RING_H][RING_W], int cy, int cx,
                                           float sharp, float out[3]) {
  float b[3], d[3], e[3], f[3], h[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b[c] = sm[c][cy - 1][cx];
    d[c] = sm[c][cy][cx - 1];
    e[c] = sm[c][cy][cx];
    f[c] = sm[c][cy][cx + 1];
    h[c] = sm[c][cy + 1][cx];
  }
  // Division-light limiter: the reference's lobe is
  // -(1/4) min_ch min(u/mx4, v/q) with u = min(mn4, e), v = 1 - max(mx4, e),
  // q = 1 - mn4; ratios compare cross-multiplied, then one reciprocal.  The
  // selects reproduce the reference's NaN-drop branch (mx4 == 0 under an
  // isolated bright pixel) without forming a NaN; no fmaxf NaN-dropping is
  // relied on.
  float num = 0.0f, den = 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mn4 = fminf(fminf(b[c], d[c]), fminf(f[c], h[c]));
    const float mx4 = fmaxf(fmaxf(b[c], d[c]), fmaxf(f[c], h[c]));
    const float u = fminf(mn4, e[c]);
    const float v = 1.0f - fmaxf(mx4, e[c]);
    const float q = 1.0f - mn4;
    const float v_s = (q == 0.0f) ? 1.0f : v;
    const bool pick1 = u * q < v_s * mx4;
    const float n_c = pick1 ? u : v;
    const float d_c = pick1 ? mx4 : q;
    if (c == 0) {
      num = n_c;
      den = d_c;
    } else if (n_c * den < num * d_c) {
      num = n_c;
      den = d_c;
    }
  }
  float r = num * __frcp_rn(den);
  r = (r < 0.0f) ? 0.0f : r;
  r = (r > RCAS_LIMIT4) ? RCAS_LIMIT4 : r;
  float lobe = r * (sharp * -0.25f);
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
  for (int c = 0; c < 3; ++c) out[c] = (lobe * ((b[c] + d[c]) + (h[c] + f[c])) + e[c]) * rcp_l;
}

template <typename T, bool RCAS, bool DENOISE>
__global__ void __launch_bounds__(NTHREADS)
    fused_kernel(const T* __restrict__ src, T* __restrict__ dst, Params p) {
  const int64_t n = blockIdx.z;
  const T* s = src + n * 3 * (int64_t)p.hp * p.wp;
  const int64_t oplane = (int64_t)p.hout * p.wout;
  T* o = dst + n * 3 * oplane;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;

  if (!RCAS) {
    for (int k = threadIdx.x; k < TILE_W * TILE_H; k += NTHREADS) {
      const int Y = y0 + k / TILE_W;
      const int X = x0 + k % TILE_W;
      if (Y >= p.hout || X >= p.wout) continue;
      float v[3];
      easu_pixel(s, p, Y, X, v);
      const int64_t at = (int64_t)Y * p.wout + X;
#pragma unroll
      for (int c = 0; c < 3; ++c) st(o + c * oplane + at, v[c]);
    }
    return;
  }

  __shared__ float sm[3][RING_H][RING_W];
  for (int k = threadIdx.x; k < RING_H * RING_W; k += NTHREADS) {
    const int ly = k / RING_W;
    const int lx = k % RING_W;
    const int Y = min(max(y0 + ly - 1, 0), p.hout - 1);
    const int X = min(max(x0 + lx - 1, 0), p.wout - 1);
    float v[3];
    easu_pixel(s, p, Y, X, v);
#pragma unroll
    for (int c = 0; c < 3; ++c) sm[c][ly][lx] = v[c];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < TILE_W * TILE_H; k += NTHREADS) {
    const int ly = k / TILE_W;
    const int lx = k % TILE_W;
    const int Y = y0 + ly;
    const int X = x0 + lx;
    if (Y >= p.hout || X >= p.wout) continue;
    float v[3];
    rcas_pixel<DENOISE>(sm, ly + 1, lx + 1, p.sharp, v);
    const int64_t at = (int64_t)Y * p.wout + X;
#pragma unroll
    for (int c = 0; c < 3; ++c) st(o + c * oplane + at, v[c]);
  }
}

template <typename T>
int launch(const void* src, void* dst, int nb, const Params& p, bool rcas, bool denoise,
           cudaStream_t stream) {
  const int64_t in_frame = 3 * (int64_t)p.hp * p.wp;
  const int64_t out_frame = 3 * (int64_t)p.hout * p.wout;
  const int max_z = 65535;
  for (int n0 = 0; n0 < nb; n0 += max_z) {
    const int nz = nb - n0 < max_z ? nb - n0 : max_z;
    const dim3 grid((p.wout + TILE_W - 1) / TILE_W, (p.hout + TILE_H - 1) / TILE_H, nz);
    const T* s = static_cast<const T*>(src) + n0 * in_frame;
    T* d = static_cast<T*>(dst) + n0 * out_frame;
    if (!rcas)
      fused_kernel<T, false, false><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else if (denoise)
      fused_kernel<T, true, true><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else
      fused_kernel<T, true, false><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (storage of both source and output).
extern "C" int fsr_upscale_fused(const void* src, void* dst, int dtype, int nb, int hp, int wp,
                                 int hout, int wout, int qy, int qx, const int* ry,
                                 const int* rx, const float* py, const float* px, float sharp,
                                 int apply_rcas, int denoise, void* stream) {
  if (qy < 1 || qy > 4 || qx < 1 || qx > 4) return (int)cudaErrorInvalidValue;
  Params p;
  p.qy = qy;
  p.qx = qx;
  for (int k = 0; k < 4; ++k) {
    p.ry[k] = k < qy ? ry[k] : 0;
    p.py[k] = k < qy ? py[k] : 0.0f;
    p.rx[k] = k < qx ? rx[k] : 0;
    p.px[k] = k < qx ? px[k] : 0.0f;
  }
  p.hp = hp;
  p.wp = wp;
  p.hout = hout;
  p.wout = wout;
  p.sharp = sharp;
  if (nb == 0 || hout == 0 || wout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(src, dst, nb, p, apply_rcas != 0, denoise != 0, s);
  if (dtype == 1) return launch<__nv_bfloat16>(src, dst, nb, p, apply_rcas != 0, denoise != 0, s);
  return (int)cudaErrorInvalidValue;
}
