// K1: fused EASU + RCAS for integer per-axis ratios qy, qx in {1, 2, 4}.
//
// Replaces the TPU kernel fsr_tpu/kernels/fused.py:upscale_fused
// (pallas_call at fused.py:1298).  It computes what fused.py:884-928 (EASU,
// fast kernel form) and fused.py:1100-1192 (RCAS with the border clamp in
// global output coordinates) compute; the TPU's phase-planar riffles,
// row packing and one-tile software pipeline have no counterpart here.
//
// Phases: each output pixel (Y, X) lies in phase (a, b) = (Y mod qy, X mod
// qx) with 'f' texel (floor(Y / qy) + ry[a], floor(X / qx) + rx[b]) in the
// source and constant subpixel fractions (py[a], px[b]).  qy and qx are 1, 2
// or 4, so the device takes their logarithms and shifts and masks, which
// floor at negative positions as the phase arithmetic needs.  The host
// derives ry, rx, py, px from the float32 coordinate tables
// (fused.py:_phase_structure); the device never recomputes x*sx+ox or
// floor(), which an FMA contraction would flip at integer positions.
//
// The source is the image itself (or a strip of it with its halo rows, or
// a frame K4 already padded: then the clamp below never fires).  Every
// texel index is clamped to the source, row min(max(r, 0), hin - 1) and
// column likewise: that is the edge pad of K4 (the CLAMP sampler of the
// reference, FSR_Filter.cpp:49-50) folded into the load, so no pad pass
// runs in front of K1.
//
// Design: one block of NTHREADS per TH x TW output tile (30 x 30), in three
// steps.
//   Stage: the source texels that the tile and its one-pixel RCAS ring read
//     form one rectangle, the window: from the 'f' row of ring row -1, minus
//     one, to the 'f' row of ring row TH, plus two, and columns likewise
//     ('f' is non-decreasing in the output coordinate).  The block loads it
//     once, coalesced, into shared memory, each texel at its clamped index,
//     converted by the load rule below, tonemapped by the SRTM prologue when
//     it is on, and its luma taken, as one float4 (r, g, b, luma); RGBA's
//     alpha plane beside it.  With it, per ring row and ring column, the
//     window index of its 'f' texel and its fraction.  The host checks that
//     every block's window fits (fused.py:_check_window); the kernel traps
//     if one does not.
//   Barrier.  EASU in float32 for the tile and its ring (RH x RW positions,
//     RH = TH + 2) into shared memory, at the positions as they are: ring
//     positions outside the frame take their clamped source texels and are
//     never read (below).  Two paths:
//     - quad, the 2x Performance structure (qy = qx = 2, fractions 0.75 and
//       0.25 bit for bit, ry[1] = ry[0] + 1, rx likewise): output rows 2j+1
//       and 2j+2 share 'f' row j + ry[1], at fractions 0.25 and 0.75, and
//       columns likewise.  So one thread per 2x2 quad reads its 12 taps
//       once, computes the four texel responses once, and resolves its four
//       pixels at constant fractions.  The ring of a 30 x 30 tile is 16 x 16
//       quads, one per thread, over a 19 x 19 window.
//     - generic, every other phase structure (1x or 4x on an axis, DRS
//       offsets): one evaluation per ring position, its 12 taps from the
//       window at its row's and column's 'f' index, the resolve at its
//       fractions.  The window is at most (TH + 5) x (TW + 5).
//     Both run the same resolve on the same values in the same order, so a
//     pixel's bits do not depend on the path (chip_smoke.py phase 4 holds
//     them bit-equal; a row strip may take the other path than the whole
//     frame).
//   Barrier.  RCAS (limiter, optional denoise) per tile pixel, with its
//     cross read from the ring at row indices clamped to [ylo, yhi] and
//     column indices clamped to the frame: where a neighbour lies outside,
//     RCAS sees e in place of it, as the plain version's clamped shift does.
//     Then the K5 epilogue and one store; consecutive threads store
//     consecutive pixels of a tile row.
// With apply_rcas off the store pass takes the ring's centre.
//
// Storage: the source is float32, bfloat16 or uint8; the output float32,
// bfloat16, or uint8/uint16 UNORM codes.  A float32 source under bfloat16
// storage is rounded (RNE) at its load before widening, which is what K4's
// convert gave; a byte decodes v * float32(1/255) at its load and is never
// rounded to the storage type.  Source, load-rounding and output types are
// template parameters; the prologue, epilogue and apply_rcas flags are
// uniform runtime branches.
//
// RGBA (fused.py:929-943, :1052-1056, :1120-1122): alpha in plane 3 of the
// source and the output, staged beside the colour (loaded as the colour is,
// never tonemapped); the store pass resolves it bilinearly from the window's
// 'f' texel and its right, lower and lower-right neighbours (the clamp is
// the CLAMP of ops.easu.bilinear), never touched by the epilogue, and stores
// it by the colour's rule.  The channel count is a template parameter, so
// the RGB kernels carry no alpha code.
//
// Row strips (fused.py:412-437, :1174-1184; parallel/spatial.py): the
// output may be rows row0 .. row0 + hout - 1 of a frame of global_rows rows,
// computed from the strip's rows with a halo around them.  The ring's rows
// clamp to [ylo, yhi]: [0, hout - 1] for a whole frame, and -1 or hout where
// the strip has a neighbour row, which the ring computes from the halo as
// the whole frame's EASU would; only global row 0 and global_rows - 1
// clamp.  The epilogue's dither takes the global row (EpilogueParams.row0).
// A strip's source is either its halo'd rows as one tensor, or, in the
// strip-source form (fused_kernel_strip, fsr_upscale_fused_strip), three
// parts read in place: the strip above's rows, its own and the strip
// below's (fsr_pixel.cuh:StripSrc).  That form indexes the same virtual
// halo'd strip and changes only the staging load's address, so a strip's
// bits are those of the halo'd tensor; the halo rows are H1's, which no
// launch of its own copies any more.  It is compiled in its own
// translation unit (fused_strip.cu), and the whole-frame kernels' code is
// the same as without it.
//
// Bound: f32 arithmetic (~489 ops per output pixel for the function; the
// kernel runs the ring recompute on top, 1.138x at 30 x 30) and the
// instruction stream around it.  Device-memory traffic is one read of the
// source and one write of the output (plus 12 bytes of grain per pixel with
// LFGA).  The staging takes out of the per-pixel stream what the design
// before it (one thread per pixel, 36 global loads behind a K4 pass)
// repeated at every tap: the loads, their conversions, the SRTM prologue,
// the lumas and a 64-bit base per evaluation; the quad path also shares
// each window's taps and texel responses among its four pixels.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fsr_pixel.cuh"

using namespace fsr;

namespace {

// The tile (kernels/fused.py:TILE mirrors it).  Even, so that a block's
// ring starts at an odd row and column: a whole number of quads.
#ifndef FSR_K1_TILE_H
#define FSR_K1_TILE_H 30
#endif
#ifndef FSR_K1_TILE_W
#define FSR_K1_TILE_W 30
#endif
// Blocks per SM the register allocation must allow (__launch_bounds__) on
// the generic and the quad path: 4 (64 registers) and 3 (80), the fastest
// without spills in turn with 1 (71 and 94 registers) and the quad path at 4
// (which spills), tools_torch/ablation/kernel_ab.py --define ....
#ifndef FSR_K1_MIN_BLOCKS
#define FSR_K1_MIN_BLOCKS 4
#endif
#ifndef FSR_K1_QUAD_MIN_BLOCKS
#define FSR_K1_QUAD_MIN_BLOCKS 3
#endif
constexpr int TH = FSR_K1_TILE_H;
constexpr int TW = FSR_K1_TILE_W;
static_assert(TH % 2 == 0 && TW % 2 == 0, "K1's tile is a whole number of quads");
constexpr int RH = TH + 2;  // the RCAS ring's rows
constexpr int RW = TW + 2;  // and columns
constexpr int QH = RH / 2;  // the ring's quads
constexpr int QW = RW / 2;

// The window's extent at most: QUAD, exactly (QH + 3) x (QW + 3); else
// ring positions and taps -1..2 at one 'f' per position.
template <bool QUAD>
struct Win {
  static constexpr int H = QUAD ? QH + 3 : RH + 3;
  static constexpr int W = QUAD ? QW + 3 : RW + 3;
};

struct Params {
  int ly, lx;        // log2 of the phase counts qy, qx
  int ry[4], rx[4];  // source row/col of phase a/b's 'f' texel at plane index 0
  float py[4], px[4];
  int hin, win;  // source extent (the clamp)
  int hout, wout;
  int ylo, yhi;  // the RCAS ring's row clamp (row strips: -1 / hout at a neighbour)
  float sharp;   // linear RCAS sharpness
  int rcas;      // apply RCAS
  int srtm;      // SRTM prologue on each staged texel
  EpilogueParams epi;
};

// v[a] for a = 0..3 by selects: a per-thread index into the parameters
// would copy them to the stack or serialise a warp on the constant bank.
template <typename V>
__device__ __forceinline__ V pick(const V (&v)[4], int a) {
  return a == 0 ? v[0] : a == 1 ? v[1] : a == 2 ? v[2] : v[3];
}

// 'f' of output row (column) y: floor(y / q) + r[y mod q].
__device__ __forceinline__ int f_of(int y, int lq, const int (&r)[4]) {
  return (y >> lq) + pick(r, y & ((1 << lq) - 1));
}

// One block's window of one frame's source, its tables, and the ring.
template <bool QUAD, bool RGBA>
struct Stage {
  static constexpr int WH = Win<QUAD>::H;
  static constexpr int WW = Win<QUAD>::W;
  float4 tex[WH * WW];              // (r, g, b, luma2), rows of stride WW
  float alpha[RGBA ? WH * WW : 1];  // RGBA: the alpha plane, as tex
  int fr[RH];                       // window index of ring row i's 'f' row (times WW)
  float py[RH];
  int fc[RW];  // window column of ring column j's 'f'
  float px[RW];
  float ring[3][RH][RW];  // EASU of the tile and its ring
};

// Load the block's window and tables (see the source note), then a barrier.
// T is the storage type a float source rounds to, S the source's; strip:
// empty for a whole source, else its strip source (the loads' addresses).
template <typename T, typename S, bool QUAD, bool RGBA, typename... Strip>
__device__ __forceinline__ void stage(Stage<QUAD, RGBA>& st, const S* __restrict__ src, const Params& p,
                                      int y0, int x0, const Strip&... strip) {
  constexpr int WW = Stage<QUAD, RGBA>::WW;
  const int r0 = f_of(y0 - 1, p.ly, p.ry) - 1;
  const int c0 = f_of(x0 - 1, p.lx, p.rx) - 1;
  int fh, fw;
  if constexpr (QUAD) {
    fh = Win<true>::H;
    fw = Win<true>::W;
  } else {
    fh = f_of(y0 + TH, p.ly, p.ry) + 2 - r0 + 1;
    fw = f_of(x0 + TW, p.lx, p.rx) + 2 - c0 + 1;
    if (fh > Win<false>::H || fw > Win<false>::W) __trap();  // the host's window check failed to hold
  }
  if constexpr (sizeof...(Strip) > 0) {
    // A strip's parts, run by run, loaded through the read-only cache.
    auto run = [&](int rb, int re, const S* base, int64_t pl, auto row) {
      for (int k = rb * fw + threadIdx.x; k < re * fw; k += NTHREADS) {
        const int r = k / fw;
        const int c = k - r * fw;
        const S* at = base + (int64_t)row(r) * p.win + min(max(c0 + c, 0), p.win - 1);
        float cr = ld_as<T, true>(at), cg = ld_as<T, true>(at + pl), cb = ld_as<T, true>(at + 2 * pl);
        if (p.srtm) srtm_texel(cr, cg, cb);
        st.tex[r * WW + c] = make_float4(cr, cg, cb, luma2(cr, cg, cb));
        if constexpr (RGBA) st.alpha[r * WW + c] = ld_as<T, true>(at + 3 * pl);
      }
    };
    stage_strip(only(strip...), blockIdx.z, r0, fh, p.hin, run);
  } else {
    const int64_t plane = (int64_t)p.hin * p.win;
    for (int k = threadIdx.x; k < fh * fw; k += NTHREADS) {
      const int r = k / fw;
      const int c = k - r * fw;
      const int sr = min(max(r0 + r, 0), p.hin - 1);
      const int sc = min(max(c0 + c, 0), p.win - 1);
      const S* at = src + (int64_t)sr * p.win + sc;
      float cr = ld_as<T>(at), cg = ld_as<T>(at + plane), cb = ld_as<T>(at + 2 * plane);
      if (p.srtm) srtm_texel(cr, cg, cb);
      st.tex[r * WW + c] = make_float4(cr, cg, cb, luma2(cr, cg, cb));
      if constexpr (RGBA) st.alpha[r * WW + c] = ld_as<T>(at + 3 * plane);
    }
  }
  for (int i = threadIdx.x; i < RH + RW; i += NTHREADS) {
    if (i < RH) {
      const int Y = y0 - 1 + i;
      st.fr[i] = (f_of(Y, p.ly, p.ry) - r0) * WW;
      st.py[i] = pick(p.py, Y & ((1 << p.ly) - 1));
    } else {
      const int X = x0 - 1 + (i - RH);
      st.fc[i - RH] = f_of(X, p.lx, p.rx) - c0;
      st.px[i - RH] = pick(p.px, X & ((1 << p.lx) - 1));
    }
  }
  __syncthreads();
}

// K1's EASU arithmetic, the same function as fsr_pixel.cuh's
// easu_resolve_luma on the same values in the same order, split into the
// four texel responses (shared by a quad's pixels) and the resolve at one
// subpixel position, with every product that meets a sum written as
// __fmaf_rn, __fmul_rn or __fadd_rn: nvcc's choice of which product of a sum of two to contract
// depends on the code around it, and the quad path's constant fractions
// change that code.  Pinned, the quad and generic paths give the same bits
// (chip_smoke.py phase 4), so a row strip that takes the other path than the
// whole frame stays bit-equal to it.
__device__ __forceinline__ void k1_response(float la, float lb, float lc, float ld_, float le, float (&g)[3]) {
  const float dc = __fsub_rn(ld_, lc);
  const float cb = __fsub_rn(lc, lb);
  float len_x = prx_lo_rcp(fmaxf(fabsf(dc), fabsf(cb)));
  const float gx = __fsub_rn(ld_, lb);
  len_x = clamp01(__fmul_rn(fabsf(gx), len_x));
  const float ec = __fsub_rn(le, lc);
  const float ca = __fsub_rn(lc, la);
  float len_y = prx_lo_rcp(fmaxf(fabsf(ec), fabsf(ca)));
  const float gy = __fsub_rn(le, la);
  len_y = clamp01(__fmul_rn(fabsf(gy), len_y));
  g[0] = gx;
  g[1] = gy;
  g[2] = __fmaf_rn(len_x, len_x, __fmul_rn(len_y, len_y));
}

__device__ __forceinline__ void k1_responses(const float (&L)[4][4], float (&g)[4][3]) {
#if defined(FSR_ABL_K1_SET)
  // Knockout (fused_stage_ablation.py "set"; fsr_pixel.cuh:ABLATION_MASK):
  // the four texel responses replaced by their lumas, as the JAX tool's
  // stand-in (dir (l, l / 2), length sat(l)).
  const float l4[4] = {L[1][1], L[1][2], L[2][1], L[2][2]};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    g[k][0] = l4[k];
    g[k][1] = __fmul_rn(l4[k], 0.5f);
    g[k][2] = clamp01(l4[k]);
  }
#else
  k1_response(L[0][1], L[1][0], L[1][1], L[1][2], L[2][1], g[0]);
  k1_response(L[0][2], L[1][1], L[1][2], L[1][3], L[2][2], g[1]);
  k1_response(L[1][1], L[2][0], L[2][1], L[2][2], L[3][1], g[2]);
  k1_response(L[1][2], L[2][1], L[2][2], L[2][3], L[3][2], g[3]);
#endif
}

__device__ __forceinline__ void k1_resolve(const float (&t)[3][4][4], const float (&g)[4][3], float ppx,
                                           float ppy, float out[3]) {
  const float ax = __fsub_rn(1.0f, ppx);
  const float ay = __fsub_rn(1.0f, ppy);
  const float w4[4] = {__fmul_rn(ax, ay), __fmul_rn(ppx, ay), __fmul_rn(ax, ppy), __fmul_rn(ppx, ppy)};
  float dirx = __fmul_rn(g[0][0], w4[0]);
  float diry = __fmul_rn(g[0][1], w4[0]);
  float len = __fmul_rn(g[0][2], w4[0]);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    dirx = __fmaf_rn(g[k][0], w4[k], dirx);
    diry = __fmaf_rn(g[k][1], w4[k], diry);
    len = __fmaf_rn(g[k][2], w4[k], len);
  }
#if defined(FSR_ABL_K1_NORM)
  // Knockout ("norm"): no normalisation, stretch or lobe chain; the blended
  // direction and length stand in, as in the JAX tool.
  const float len2_x = dirx, len2_y = diry, lob = len, clp = dirx;
#else
  // Direction normalisation with zero-protect (ffx_fsr1.h:388-395).
  float dir_r = __fmaf_rn(dirx, dirx, __fmul_rn(diry, diry));
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
  const float stretch = __fmul_rn(__fmaf_rn(dirx, dirx, __fmul_rn(diry, diry)),
                                  prx_lo_rcp(fmaxf(fabsf(dirx), fabsf(diry))));
  const float len2_x = __fmaf_rn(__fsub_rn(stretch, 1.0f), len, 1.0f);
  const float len2_y = __fmaf_rn(-0.5f, len, 1.0f);
  const float lob = __fmaf_rn((float)((1.0 / 4.0 - 0.04) - 0.5), len, 0.5f);
  const float clp = prx_lo_rcp(lob);
#endif
  // Tap distance as a quadratic form, factored per tap row/column.
  const float lx2 = __fmul_rn(len2_x, len2_x);
  const float ly2 = __fmul_rn(len2_y, len2_y);
  const float xx = __fmul_rn(dirx, dirx);
  const float yy = __fmul_rn(diry, diry);
  const float xy = __fmul_rn(dirx, diry);
  const float qa = __fmaf_rn(xx, lx2, __fmul_rn(yy, ly2));
  const float qb = __fmul_rn(__fadd_rn(xy, xy), __fsub_rn(lx2, ly2));
  const float qc = __fmaf_rn(yy, lx2, __fmul_rn(xx, ly2));
  float off_x[4], c_dx[4], a_dy[4], b_dy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    off_x[k] = __fsub_rn((float)(k - 1), ppx);
    const float oy = __fsub_rn((float)(k - 1), ppy);
    a_dy[k] = __fmul_rn(oy, qb);
    b_dy[k] = __fmul_rn(__fmul_rn(oy, oy), qc);
    c_dx[k] = __fmul_rn(__fmul_rn(off_x[k], off_x[k]), qa);
  }
  // Taps in FsrEasuF accumulation order (fsr_pixel.cuh:easu_resolve_luma).
  constexpr int kTapDx[12] = {0, 1, -1, 0, 0, -1, 1, 2, 2, 1, 1, 0};
  constexpr int kTapDy[12] = {-1, -1, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2};
  float ac0 = 0.0f, ac1 = 0.0f, ac2 = 0.0f, aw = 0.0f;
#pragma unroll
  for (int n = 0; n < 12; ++n) {
    const int dx = kTapDx[n] + 1;
    const int dy = kTapDy[n] + 1;
#if defined(FSR_ABL_K1_WEIGHTS)
    // Knockout ("weights"): no tap distance and no weight polynomial, the
    // lobe or the clip in their place, alternating; the accumulation stays.
    const float w = (dx + dy) % 2 == 0 ? lob : clp;
#elif defined(FSR_ABL_K1_POLY)
    // Knockout ("poly"): the tap distance as the weight, no polynomial.
    const float w = __fadd_rn(c_dx[dx], __fmaf_rn(off_x[dx], a_dy[dy], b_dy[dy]));
#else
    float d2 = __fadd_rn(c_dx[dx], __fmaf_rn(off_x[dx], a_dy[dy], b_dy[dy]));
    d2 = fminf(d2, clp);
    float w_a = __fmaf_rn(lob, d2, -1.0f);
    w_a = __fmul_rn(w_a, w_a);
    const float w_b = __fmaf_rn(__fmaf_rn(0.25f, d2, -1.25f), d2, 1.0f);
    const float w = __fmul_rn(w_b, w_a);
#endif
    ac0 = __fmaf_rn(t[0][dy][dx], w, ac0);
    ac1 = __fmaf_rn(t[1][dy][dx], w, ac1);
    ac2 = __fmaf_rn(t[2][dy][dx], w, ac2);
    aw = __fadd_rn(aw, w);
  }
  const float inv_w = __frcp_rn(aw);
  const float acc[3] = {ac0, ac1, ac2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#if defined(FSR_ABL_K1_DERING)
    // Knockout ("dering"): no min/max clamp.
    out[c] = __fmul_rn(acc[c], inv_w);
#else
    // Dering clamp to the nearest 2x2 {f, g, j, k}; selects keep a NaN.
    const float mn = fminf(fminf(t[c][1][1], t[c][1][2]), fminf(t[c][2][1], t[c][2][2]));
    const float mx = fmaxf(fmaxf(t[c][1][1], t[c][1][2]), fmaxf(t[c][2][1], t[c][2][2]));
    float v = __fmul_rn(acc[c], inv_w);
    v = (v < mn) ? mn : v;
    v = (v > mx) ? mx : v;
    out[c] = v;
#endif
  }
}

// The 12 taps and their lumas of the window around window index w ('f').
template <int WW>
__device__ __forceinline__ void taps(const float4* tex, int w, float (&t)[3][4][4], float (&L)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((r == 0 || r == 3) && (q == 0 || q == 3)) continue;
      const float4 v = tex[w + (r - 1) * WW + (q - 1)];
      t[0][r][q] = v.x;
      t[1][r][q] = v.y;
      t[2][r][q] = v.z;
      L[r][q] = v.w;
    }
  }
}

// EASU of the block's ring into st.ring, then a barrier.
template <bool QUAD, bool RGBA>
__device__ __forceinline__ void ring_easu(Stage<QUAD, RGBA>& st) {
  constexpr int WW = Stage<QUAD, RGBA>::WW;
  float t[3][4][4], L[4][4], v[3];
  if constexpr (QUAD) {
    // Quad (qi, qj): ring rows 2qi (fraction 0.25) and 2qi + 1 (0.75), ring
    // columns likewise; its 'f' is window texel (qi + 1, qj + 1).
    for (int k = threadIdx.x; k < QH * QW; k += NTHREADS) {
      const int qi = k / QW;
      const int qj = k - qi * QW;
      taps<WW>(st.tex, (qi + 1) * WW + qj + 1, t, L);
      float g[4][3];
      k1_responses(L, g);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          k1_resolve(t, g, dx ? 0.75f : 0.25f, dy ? 0.75f : 0.25f, v);
#pragma unroll
          for (int c = 0; c < 3; ++c) st.ring[c][2 * qi + dy][2 * qj + dx] = v[c];
        }
      }
    }
  } else {
    for (int k = threadIdx.x; k < RH * RW; k += NTHREADS) {
      const int i = k / RW;
      const int j = k - i * RW;
      taps<WW>(st.tex, st.fr[i] + st.fc[j], t, L);
      float g[4][3];
      k1_responses(L, g);
      k1_resolve(t, g, st.px[j], st.py[i], v);
#pragma unroll
      for (int c = 0; c < 3; ++c) st.ring[c][i][j] = v[c];
    }
  }
  __syncthreads();
}

// One block's tile: the kernels' body, for a whole source (src) or a strip
// source (strip).
template <typename S, typename T, typename O, bool QUAD, bool DENOISE, bool RGBA, typename... Strip>
__device__ __forceinline__ void fused_tile(const S* __restrict__ src, O* __restrict__ dst, const Params& p,
                                           const Strip&... strip) {
  constexpr int C = RGBA ? 4 : 3;
  constexpr int WW = Stage<QUAD, RGBA>::WW;
  __shared__ Stage<QUAD, RGBA> st;
  const int64_t n = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  stage<T>(st, src + n * C * (int64_t)p.hin * p.win, p, y0, x0, strip...);
  ring_easu(st);
  O* o = dst + n * C * (int64_t)p.hout * p.wout;
  const int64_t oplane = (int64_t)p.hout * p.wout;
  const unsigned frame = epilogue_frame(p.epi);
  for (int k = threadIdx.x; k < TH * TW; k += NTHREADS) {
    const int ly = k / TW;
    const int lx = k - ly * TW;
    const int Y = y0 + ly;
    const int X = x0 + lx;
    if (Y >= p.hout || X >= p.wout) continue;
    // Ring indices: ring row i is output row y0 - 1 + i.
    const int i = ly + 1;
    const int j = lx + 1;
    float v[3];
    if (p.rcas) {
      const int iu = min(max(Y - 1, p.ylo), p.yhi) - y0 + 1;
      const int id = min(max(Y + 1, p.ylo), p.yhi) - y0 + 1;
      const int jl = max(X - 1, 0) - x0 + 1;
      const int jr = min(X + 1, p.wout - 1) - x0 + 1;
      float b[3], d[3], e[3], f[3], h[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        b[c] = st.ring[c][iu][j];
        d[c] = st.ring[c][i][jl];
        e[c] = st.ring[c][i][j];
        f[c] = st.ring[c][i][jr];
        h[c] = st.ring[c][id][j];
      }
      rcas_pixel<DENOISE>(b, d, e, f, h, p.sharp, v);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = st.ring[c][i][j];
    }
    const int64_t at = (int64_t)Y * p.wout + X;
    epilogue(p.epi, frame, oplane, at, Y, X, v);
    if constexpr (RGBA) {
      const float* a = st.alpha + st.fr[i] + st.fc[j];
      st4(o, oplane, at, v, bilinear_alpha(a[0], a[1], a[WW], a[WW + 1], st.px[j], st.py[i]));
    } else {
      st3(o, oplane, at, v);
    }
  }
}

template <typename S, typename T, typename O, bool QUAD, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NTHREADS, QUAD ? FSR_K1_QUAD_MIN_BLOCKS : FSR_K1_MIN_BLOCKS)
    fused_kernel(const S* __restrict__ src, O* __restrict__ dst, Params p) {
  fused_tile<S, T, O, QUAD, DENOISE, RGBA>(src, dst, p);
}

// The strip-source form (fsr_pixel.cuh:StripSrc): the same tile, each texel
// loaded from the part that holds its row of the virtual halo'd strip.
template <typename S, typename T, typename O, bool QUAD, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NTHREADS, QUAD ? FSR_K1_QUAD_MIN_BLOCKS : FSR_K1_MIN_BLOCKS)
    fused_kernel_strip(StripSrc<S> strip, O* __restrict__ dst, Params p) {
  fused_tile<S, T, O, QUAD, DENOISE, RGBA>(static_cast<const S*>(nullptr), dst, p, strip);
}

// STRIP: launch the strip-source form on sp, else the whole-frame form on
// src.  Each form is compiled in its own translation unit (fused_strip.cu).
template <bool STRIP, typename S, typename T, typename O, bool QUAD, bool RGBA>
int launch_planes(const void* src, const StripParts* sp, void* dst, int nb, const Params& p, bool denoise,
                  cudaStream_t stream) {
  constexpr int C = RGBA ? 4 : 3;
  const int64_t in_frame = C * (int64_t)p.hin * p.win;
  const int64_t out_frame = C * (int64_t)p.hout * p.wout;
  return launch_frames<TH, TW>(nb, p.hout, p.wout, [&](dim3 grid, int n0) {
    O* d = static_cast<O*>(dst) + n0 * out_frame;
    if constexpr (STRIP) {
      const StripSrc<S> s = strip_src<S>(*sp, n0);
      if (denoise)
        fused_kernel_strip<S, T, O, QUAD, true, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
      else
        fused_kernel_strip<S, T, O, QUAD, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    } else {
      const S* s = static_cast<const S*>(src) + n0 * in_frame;
      if (denoise)
        fused_kernel<S, T, O, QUAD, true, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
      else
        fused_kernel<S, T, O, QUAD, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    }
  });
}

// The path and the channel count are template parameters, so the RGB
// kernels carry no alpha code and the quad kernels no table reads per tap.
template <bool STRIP, typename S, typename T, typename O>
int launch(const void* src, const StripParts* sp, void* dst, int nb, int channels, bool quad, const Params& p,
           bool denoise, cudaStream_t stream) {
  if (quad)
    return channels == 4 ? launch_planes<STRIP, S, T, O, true, true>(src, sp, dst, nb, p, denoise, stream)
                         : launch_planes<STRIP, S, T, O, true, false>(src, sp, dst, nb, p, denoise, stream);
  return channels == 4 ? launch_planes<STRIP, S, T, O, false, true>(src, sp, dst, nb, p, denoise, stream)
                       : launch_planes<STRIP, S, T, O, false, false>(src, sp, dst, nb, p, denoise, stream);
}

// The quad path's structure on one axis (see the source note).
bool quad_axis(int q, const int* r, const float* f) {
  return q == 2 && r[1] == r[0] + 1 && f[0] == 0.75f && f[1] == 0.25f;
}

// The C entry points' body: the checks, the parameters and the dispatch on
// the types, for the whole-frame form (STRIP false: src) or the strip-source
// form (sp).
template <bool STRIP>
int upscale_fused(const void* src, const StripParts* sp, void* dst, int src_dtype, int dtype, int out_dtype,
                  int nb, int channels, int hin, int win, int hout, int wout, int qy, int qx, const int* ry,
                  const int* rx, const float* py, const float* px, float sharp, int apply_rcas, int denoise,
                  int srtm, int ylo, int yhi, int quad, const EpilogueParams* epi, void* stream) {
  if ((qy != 1 && qy != 2 && qy != 4) || (qx != 1 && qx != 2 && qx != 4))
    return (int)cudaErrorInvalidValue;
  if (channels != 3 && channels != 4) return (int)cudaErrorInvalidValue;
  if (ylo < -1 || ylo > 0 || yhi < hout - 1 || yhi > hout) return (int)cudaErrorInvalidValue;
  if (quad && !(quad_axis(qy, ry, py) && quad_axis(qx, rx, px))) return (int)cudaErrorInvalidValue;
  if (hin < 1 || win < 1) return (int)cudaErrorInvalidValue;
  if (STRIP && !strip_ok(sp, hin)) return (int)cudaErrorInvalidValue;
  Params p;
  p.ly = qy / 2;  // log2 of 1, 2, 4
  p.lx = qx / 2;
  for (int k = 0; k < 4; ++k) {
    p.ry[k] = k < qy ? ry[k] : 0;
    p.py[k] = k < qy ? py[k] : 0.0f;
    p.rx[k] = k < qx ? rx[k] : 0;
    p.px[k] = k < qx ? px[k] : 0.0f;
  }
  p.hin = hin;
  p.win = win;
  p.hout = hout;
  p.wout = wout;
  p.ylo = ylo;
  p.yhi = yhi;
  p.sharp = sharp;
  p.rcas = apply_rcas != 0;
  p.srtm = srtm;
  p.epi = epi != nullptr ? *epi : EpilogueParams{};
  if (nb == 0 || hout == 0 || wout == 0) return 0;
  if ((dtype != F32 && dtype != BF16) || (src_dtype != U8 && out_dtype != dtype && out_dtype != U8 &&
                                          out_dtype != U16))
    return (int)cudaErrorInvalidValue;
  const bool q = quad != 0;
  const bool dn = denoise != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  // Only a float32 (or float16, below) source rounds to a bfloat16 storage
  // type at load; a bfloat16 source widens exactly and a byte decodes,
  // whatever the storage.
  if (src_dtype == F32 && dtype == BF16) {
    if (out_dtype == BF16) return launch<STRIP, float, bf16, bf16>(src, sp, dst, nb, channels, q, p, dn, s);
    if (out_dtype == U8) return launch<STRIP, float, bf16, uint8_t>(src, sp, dst, nb, channels, q, p, dn, s);
    return launch<STRIP, float, bf16, uint16_t>(src, sp, dst, nb, channels, q, p, dn, s);
  }
  if (src_dtype == F32) {
    if (out_dtype == F32) return launch<STRIP, float, float, float>(src, sp, dst, nb, channels, q, p, dn, s);
    if (out_dtype == U8) return launch<STRIP, float, float, uint8_t>(src, sp, dst, nb, channels, q, p, dn, s);
    return launch<STRIP, float, float, uint16_t>(src, sp, dst, nb, channels, q, p, dn, s);
  }
  if (src_dtype == BF16) {
    if (out_dtype == F32) return launch<STRIP, bf16, float, float>(src, sp, dst, nb, channels, q, p, dn, s);
    if (out_dtype == BF16) return launch<STRIP, bf16, float, bf16>(src, sp, dst, nb, channels, q, p, dn, s);
    if (out_dtype == U8) return launch<STRIP, bf16, float, uint8_t>(src, sp, dst, nb, channels, q, p, dn, s);
    return launch<STRIP, bf16, float, uint16_t>(src, sp, dst, nb, channels, q, p, dn, s);
  }
  // A float16 source widens exactly, and rounds to a bfloat16 storage type
  // at load as a float32 source does.
  if (src_dtype == F16 && dtype == BF16) {
    if (out_dtype == BF16) return launch<STRIP, __half, bf16, bf16>(src, sp, dst, nb, channels, q, p, dn, s);
    if (out_dtype == U8) return launch<STRIP, __half, bf16, uint8_t>(src, sp, dst, nb, channels, q, p, dn, s);
    return launch<STRIP, __half, bf16, uint16_t>(src, sp, dst, nb, channels, q, p, dn, s);
  }
  if (src_dtype == F16) {
    if (out_dtype == F32) return launch<STRIP, __half, float, float>(src, sp, dst, nb, channels, q, p, dn, s);
    if (out_dtype == U8) return launch<STRIP, __half, float, uint8_t>(src, sp, dst, nb, channels, q, p, dn, s);
    return launch<STRIP, __half, float, uint16_t>(src, sp, dst, nb, channels, q, p, dn, s);
  }
  if (src_dtype == U8) {
    if (out_dtype == F32) return launch<STRIP, uint8_t, float, float>(src, sp, dst, nb, channels, q, p, dn, s);
    if (out_dtype == BF16) return launch<STRIP, uint8_t, float, bf16>(src, sp, dst, nb, channels, q, p, dn, s);
    if (out_dtype == U8) return launch<STRIP, uint8_t, float, uint8_t>(src, sp, dst, nb, channels, q, p, dn, s);
    return launch<STRIP, uint8_t, float, uint16_t>(src, sp, dst, nb, channels, q, p, dn, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#ifndef FSR_STRIP_TU
// The FSR_ABL_* knockouts this library was built with, one bit each
// (fsr_pixel.cuh:ABLATION_MASK); 0 for the production build.
extern "C" int fsr_ablation_mask(void) { return ABLATION_MASK; }

// dtype codes (fsr_pixel.cuh DType): src_dtype is the source's (float32,
// bfloat16, float16 or uint8), dtype the storage type (float32 or bfloat16;
// a float32 or float16 source rounds to it at load), out_dtype the output's:
// the storage type, or uint8/uint16 codes; a uint8 source may also store
// float32 or bfloat16.  channels: 3, or 4 with alpha in plane 3 of the
// source and the output.  hin, win: the source's extent, which every texel
// index is clamped to.  qy, qx: 1, 2 or 4; ry, rx: the source row/column of each
// phase's 'f' texel at plane index 0 (may lie outside the source).  quad: 1
// takes the quad path, which the phase structure must allow; 0 the generic
// path.  srtm: 1 runs the SRTM prologue; ylo, yhi: the ring's row clamp;
// epi: the K5 epilogue (host struct, device pointers inside).
extern "C" int fsr_upscale_fused(const void* src, void* dst, int src_dtype, int dtype, int out_dtype, int nb,
                                 int channels, int hin, int win, int hout, int wout, int qy, int qx,
                                 const int* ry, const int* rx, const float* py, const float* px, float sharp,
                                 int apply_rcas, int denoise, int srtm, int ylo, int yhi, int quad,
                                 const EpilogueParams* epi, void* stream) {
  return upscale_fused<false>(src, nullptr, dst, src_dtype, dtype, out_dtype, nb, channels, hin, win, hout, wout,
                              qy, qx, ry, rx, py, px, sharp, apply_rcas, denoise, srtm, ylo, yhi, quad, epi,
                              stream);
}
#else
// K1 on a row strip read in place from its three parts (sp: fsr_pixel.cuh's
// StripParts); hin is the virtual halo'd strip's rows, own's rows plus
// 2 * halo.  The other arguments are fsr_upscale_fused's.
extern "C" int fsr_upscale_fused_strip(const StripParts* sp, void* dst, int src_dtype, int dtype, int out_dtype,
                                       int nb, int channels, int hin, int win, int hout, int wout, int qy, int qx,
                                       const int* ry, const int* rx, const float* py, const float* px,
                                       float sharp, int apply_rcas, int denoise, int srtm, int ylo, int yhi,
                                       int quad, const EpilogueParams* epi, void* stream) {
  return upscale_fused<true>(nullptr, sp, dst, src_dtype, dtype, out_dtype, nb, channels, hin, win, hout, wout,
                             qy, qx, ry, rx, py, px, sharp, apply_rcas, denoise, srtm, ylo, yhi, quad, epi,
                             stream);
}
#endif
