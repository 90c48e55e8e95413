// K2: EASU (+ fused RCAS) at any upscale ratio from 1x to 4x area, with
// Dynamic Resolution Scaling offsets.
//
// Replaces the TPU kernel fsr_tpu/kernels/easu_gather.py:easu_gather
// (pallas_call at easu_gather.py:1451).  It computes what that kernel
// computes for RGB float32/bfloat16 storage: EASU in float32 with per-texel
// quad responses, RCAS on the unrounded EASU values with the border clamped
// in output coordinates, and one rounding to the storage type at the store.
// The TPU's hybrid X-phase, one-hot MXU row selectors, dynamic-roll column
// gathers and one-tile software pipeline existed because a TPU has no
// vector gather; a Hopper block stages its source footprint in shared
// memory and each thread reads its taps there.
//
// Coordinates: the host builds per-axis tables from the float32 coordinate
// mapping (kernels/easu_gather.py:plan) -- for each output column X the four
// source columns clip(fx + dx, 0, win - 1), dx = -1..2, and the subpixel
// fraction px; the same for rows, for output rows -1 .. hout (the RCAS
// ring's) with each row first clipped to the frame.  The clip is the CLAMP
// sampler of the reference (FSR_Filter.cpp:49-50), so the kernel reads the
// unpadded source and no pad pass runs in front of it.  The device never
// computes x*sx+ox or floor(): nvcc contracts the former into an FMA, which
// flips floor() at integer positions (every third column of the 1.5x
// Quality preset).
//
// Row strips (easu_gather.py:216-311, :364-381; parallel/spatial.py): the
// row tables of a strip of a row-sharded frame come from the GLOBAL mapping
// (easu_gather.py:shard_plan), cover the strip's rows and one row on each
// side, clipped to the frame (the global RCAS border), and index the strip's
// source with its halo rows; the epilogue's dither takes the global row
// (EpilogueParams.row0).  The kernel is the same for a whole frame and a
// strip: only the tables differ.  A strip's source is either its halo'd
// rows as one tensor, or, in the strip-source form
// (staged_gather_kernel_strip, fsr_easu_gather_strip, compiled in
// easu_gather_strip.cu), three parts read in place (fsr_pixel.cuh:
// StripSrc): only the staging load's address changes, so a strip's bits
// are those of the halo'd tensor.
//
// Design: one block per TH x TILE_W output tile (TH = FSR_K2_TILE_H), in
// four steps.
//   Stage: the tables are non-decreasing in the output coordinate and in
//     the tap offset (floors of an increasing map, clipped), so the source
//     texels that the block's tile and its one-pixel RCAS ring read form one
//     rectangle, from the first ring pixel's dx = -1 tap to the last one's
//     dx = +2 tap: at most (TH + 5) x (TILE_W + 5) texels for an upscale
//     (easu_gather.py:footprint mirrors the rule; the host checks the fit
//     before the launch).  The block loads it once, coalesced, into shared
//     memory: each texel converted by the load rule below, tonemapped by the
//     SRTM prologue when it is on, as one float4 (r, g, b, unused), and its
//     luma into a float array of the footprint's shape (Scratch, which the
//     RCAS ring reuses later).  Beside it, the block's slice of the tables
//     as byte offsets into the stage: per ring column the four tap columns,
//     its two quadrant centres' response columns and px, per ring row the
//     same for rows and py.  Ring columns are clamped to the image, ring rows
//     to the tables' -1 .. hout, whose rows outside the frame repeat its
//     edge rows: a ring slot outside the image holds exactly the edge
//     pixel's value, so RCAS sees e in place of the missing neighbour with
//     no per-pixel border tests.
//   Barrier.  Responses: every quadrant centre's texel response (gx, gy,
//     gl) once, from the staged lumas, as K6 does (easu_h.cu), on a grid of
//     the centres the block's pixels use: from the first ring pixel's 'f'
//     centre to the last one's 'k' centre on each axis, two fewer than the
//     footprint's texels inside the image, up to one more than them at its
//     edge (a tap window clamped there puts its centre beside the
//     footprint: left, centre and right are then one texel, centre()).  At
//     1.5x a block evaluates 0.56 per output pixel where each pixel
//     evaluated its own four (4 x 1156 / 1024 = 4.52).
//   Barrier.  EASU in float32 for the tile and its ring into shared memory:
//     per pixel its table entries, four 16-byte shared loads of its
//     quadrants' responses and 12 of its taps, at the sums of their row and
//     column offsets, then the shared resolve (fsr_pixel.cuh:
//     easu_resolve_quads: the weighted adds in the order s, t, u, v).
//   Barrier.  RCAS (limiter, optional denoise) and one store.
// With apply_rcas off the kernel stores EASU directly.  The footprint and
// the response grid are dynamic shared memory, sized by the host from its
// plan's largest block (stage_bytes: 20.0 KB at 1.5x, 41.5 KB at 1x), beside
// 15.8 KB of static tables and RCAS ring; the kernels may pass the default
// 48 KB in all (allow_stage, once per device).  From 1x to 4x four RGB
// blocks of 256 threads share an SM, as 64 registers a thread allow (a grid
// one texel wider than the footprint on each side, K6's, left three at
// 1x).
//
// Storage: the source is float32, bfloat16 or uint8; the output float32,
// bfloat16, or uint8/uint16 UNORM codes.  A float32 source under bfloat16
// storage is rounded (RNE) at its load before widening, which is what
// converting the source first would give; a byte decodes v * float32(1/255)
// at its load and is never rounded to the storage type.
//
// Options, as easu_gather.py:919-930 and :748-784 run them: the SRTM
// prologue on each staged texel, and the K5 epilogue on the float32 RCAS
// result at the pixel's output coordinates before the one store
// (fsr_pixel.cuh:epilogue); the grain is plain output-space (3, Hout, Wout).
// Source, load-rounding and output types are template parameters; the
// prologue and epilogue flags are uniform runtime branches.
//
// RGBA (easu_gather.py:400-403, :757-761, :1372-1375): alpha in plane 3 of
// the source and the output.  The block stages the alpha plane of its
// footprint beside the colour, loaded as the colour is (rounded to the
// storage type, or a decoded byte), never tonemapped; the store pass
// resolves it bilinearly from the tables' rows[1..2], cols[1..2] (the
// clipped 'f' and next texels, the CLAMP of ops.easu.bilinear) at (px, py),
// never touched by the epilogue, and stores it by the colour's rule; RGB is
// as for three channels, and alpha never enters the RCAS ring.  The channel
// count is a template parameter (RGBA), so the RGB kernels carry no alpha
// code.
//
// Bound: f32 arithmetic, as K1 (the function needs ~489 ops per output
// pixel; with the ring recompute the kernel runs 1.129x that at 32 x 32,
// where a 32 x 16 tile ran 1.195x with 156 of 768 thread slots of its ring
// loop idle) and the instruction stream around it.  The staging takes out
// of the per-pixel stream what the old design (one thread per pixel loading
// its own taps) repeated at every tap: 10 global table loads and four
// 64-bit row offsets per evaluation, and 36 global loads, each with its own
// conversion, SRTM and a third of a luma, where a footprint texel serves
// about 17 taps at 1.5x; the response pass takes out the four texel
// responses each pixel evaluated.  Device-memory traffic stays one read of
// the source and one write of the output (plus the grain's 12 bytes per
// pixel with LFGA).  Left: the ring recompute, the tap weights, and the
// staging's latency, which one buffer does not overlap with the math.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "fsr_pixel.cuh"

using namespace fsr;

namespace {

// The tile's height: 32 (measured against 16 and 28 in turn,
// tools_torch/ablation/kernel_ab.py --define FSR_K2_TILE_H=...).
#ifndef FSR_K2_TILE_H
#define FSR_K2_TILE_H 32
#endif
constexpr int TH = FSR_K2_TILE_H;  // the tile's rows (its columns: TILE_W)
constexpr int RH = TH + 2;         // the RCAS ring's rows
constexpr int FP_H = RH + 3;       // the footprint's rows at most: ring rows and taps -1..2
constexpr int FP_W = RING_W + 3;   // its columns at most

// The float4s of a footprint of n texels and, with RGBA, of its alpha
// plane after it (rounded up to a float4, so that the grid after them
// stays aligned).
__host__ __device__ constexpr int texel_slots(int n, bool rgba) { return n + (rgba ? (n + 3) / 4 : 0); }
// The dynamic shared memory of a block whose footprint is fh x fw texels
// and whose response grid is gh x gw centres: the footprint as float4 (r,
// g, b, unused), with RGBA its alpha plane, then the grid as float4 (gx,
// gy, gl, unused) (kernels/easu_gather.py:stage_bytes computes the same).
__host__ __device__ constexpr int stage_bytes(int fh, int fw, int gh, int gw, bool rgba) {
  return 16 * (texel_slots(fh * fw, rgba) + gh * gw);
}
// The most a block takes: the largest footprint and a grid one centre wider
// on each side (the largest plan's stage is native 1x RGBA's, 46,992 B: a
// 37 x 37 footprint and a 35 x 35 grid).  With the static tables and ring
// it passes the 48 KB a kernel takes by default.
__host__ __device__ constexpr int max_stage_bytes(bool rgba) {
  return stage_bytes(FP_H, FP_W, FP_H + 2, FP_W + 2, rgba);
}

struct GatherParams {
  const int* rows;   // rows[k * rstride + Y]: source row of tap dy = k - 1 of output row Y = -1..hout
  const int* cols;   // [4][wout]: clip(fx + dx, 0, win - 1) for dx = -1..2
  const float* py;   // py[Y]: subpixel row fraction of output row Y = -1..hout
  const float* px;   // [wout] subpixel column fraction
  int hin, win;
  int hout, wout;
  int rstride;  // hout + 2: the length of a row table
  float sharp;  // linear RCAS sharpness
  int srtm;     // SRTM prologue on each loaded texel
  EpilogueParams epi;
};

// The block's stage, in the dynamic shared memory: its footprint (fh x fw
// float4 texels), with RGBA the footprint's alpha plane, then its response
// grid (gh x gw float4).
extern __shared__ float4 stage_mem[];

// One block's slice of the tables, in static shared memory, as byte
// offsets into stage_mem: a tap of ring row ly and ring column lx, at
// offsets dy, dx = -1..2, is at row[ly][dy + 1] + col[lx][dx + 1]; its
// quadrants s, t, u, v' responses at quad_row[ly].x + quad_col[lx].x,
// .x + .y, .y + .x and .y + .y.
struct Tables {
  int4 col[RING_W];
  int2 quad_col[RING_W];
  float px[RING_W];
  int4 row[RH];
  int2 quad_row[RH];
  float py[RH];
};

// Static shared memory that the block uses twice: first for its
// footprint's lumas (luma2), rows of fw, which the response pass reads at
// consecutive addresses (in the staged float4s they would lie 16 bytes
// apart, four lanes to a bank), then for the RCAS ring's float32 planes
// (fsr_pixel.cuh:rcas_tile), written only after the response pass's
// barrier.
union Scratch {
  float lum[FP_H * FP_W];
  float ring[3][RH][RING_W];
};

// A quadrant centre's index on one axis, from the pixel's tap offsets a, b,
// c (centre b) into a footprint of n texels: b + 1 for a window inside the
// image (a, c = b -+ 1, clamped to the image, which the footprint then
// holds), else 0 or n + 1, where left, centre and right are one edge texel
// (the window clamped at the image's edge); K6's rule (easu_h.cu:centre).
// Index v is the centre at footprint texel v - 1, its neighbours at v - 2
// and v, each clamped to the footprint.  It is non-decreasing along the
// ring, so a block's grid holds the indices from its first ring pixel's 'f'
// centre to its last one's 'k' centre.
__device__ __forceinline__ int centre(int a, int b, int c, int n) { return a != c ? b + 1 : (b == 0 ? 0 : n + 1); }

// The dynamic shared memory of this launch, in bytes.
__device__ __forceinline__ unsigned dynamic_smem_size() {
  unsigned n;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}

// Load the block's footprint of one frame's source and its table slice
// (see the source note), a barrier, then the response of every quadrant
// centre, and a barrier.  T is the storage type a float source rounds to,
// S the source's; strip: empty for a whole source, else its strip source
// (the loads' addresses).  Returns the stage's alpha plane (RGBA).
template <typename T, typename S, bool RGBA, typename... Strip>
__device__ __forceinline__ float* stage(Tables& st, float* __restrict__ lum, const S* __restrict__ src,
                                      const GatherParams& p, const Strip&... strip) {
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TH;
  const int r0 = __ldg(p.rows + y0 - 1);
  const int c0 = __ldg(p.cols + max(x0 - 1, 0));
  const int fh = __ldg(p.rows + 3 * p.rstride + min(y0 + TH, p.hout)) - r0 + 1;
  const int fw = __ldg(p.cols + 3 * p.wout + min(x0 + TILE_W, p.wout - 1)) - c0 + 1;
  // The host sized the launch's stage from its plan's largest block: the
  // footprint here, the grid below.
  if (stage_bytes(fh, fw, 0, 0, RGBA) > (int)dynamic_smem_size()) __trap();
  float4* tex = stage_mem;
  float* alpha = reinterpret_cast<float*>(tex + fh * fw);
  if constexpr (sizeof...(Strip) > 0) {
    // A strip's parts, run by run, loaded through the read-only cache; the
    // tables keep every row inside the virtual strip.
    auto run = [&](int rb, int re, const S* base, int64_t pl, auto row) {
      for (int k = rb * fw + threadIdx.x; k < re * fw; k += NTHREADS) {
        const int r = k / fw;
        const S* at = base + (int64_t)row(r) * p.win + c0 + (k - r * fw);
        float cr = ld_as<T, true>(at), cg = ld_as<T, true>(at + pl), cb = ld_as<T, true>(at + 2 * pl);
        if (p.srtm) srtm_texel(cr, cg, cb);
        tex[k] = make_float4(cr, cg, cb, 0.0f);
        lum[k] = luma2(cr, cg, cb);
        if constexpr (RGBA) alpha[k] = ld_as<T, true>(at + 3 * pl);
      }
    };
    stage_strip(only(strip...), blockIdx.z, r0, fh, p.hin, run);
  } else {
    const int64_t plane = (int64_t)p.hin * p.win;
    const S* base = src + (int64_t)r0 * p.win + c0;
    for (int k = threadIdx.x; k < fh * fw; k += NTHREADS) {
      const int r = k / fw;
      const S* at = base + (int64_t)r * p.win + (k - r * fw);
      float cr = ld_as<T>(at), cg = ld_as<T>(at + plane), cb = ld_as<T>(at + 2 * plane);
      if (p.srtm) srtm_texel(cr, cg, cb);
      tex[k] = make_float4(cr, cg, cb, 0.0f);
      lum[k] = luma2(cr, cg, cb);
      if constexpr (RGBA) alpha[k] = ld_as<T>(at + 3 * plane);
    }
  }
  // The grid's first index (lr, lc) and extent (gh, gw) on each axis,
  // found after the staging loops, which need none of them.
  const int Yl = min(y0 + TH, p.hout), Xf = max(x0 - 1, 0), Xl = min(x0 + TILE_W, p.wout - 1);
  auto row_at = [&](int k, int Y) { return __ldg(p.rows + k * p.rstride + Y) - r0; };
  auto col_at = [&](int k, int X) { return __ldg(p.cols + k * p.wout + X) - c0; };
  const int lr = centre(0, row_at(1, y0 - 1), row_at(2, y0 - 1), fh);
  const int gh = centre(row_at(1, Yl), row_at(2, Yl), fh - 1, fh) - lr + 1;
  const int lc = centre(0, col_at(1, Xf), col_at(2, Xf), fw);
  const int gw = centre(col_at(1, Xl), col_at(2, Xl), fw - 1, fw) - lc + 1;
  if (stage_bytes(fh, fw, gh, gw, RGBA) > (int)dynamic_smem_size()) __trap();
  const int rb = 16 * texel_slots(fh * fw, RGBA);  // the response grid's byte offset
  float4* resp = stage_mem + texel_slots(fh * fw, RGBA);
  for (int i = threadIdx.x; i < RING_W + RH; i += NTHREADS) {
    if (i < RING_W) {
      const int* c = p.cols + min(max(x0 + i - 1, 0), p.wout - 1);
      const int w = p.wout;
      const int4 cv = make_int4(__ldg(c) - c0, __ldg(c + w) - c0, __ldg(c + 2 * w) - c0, __ldg(c + 3 * w) - c0);
      st.col[i] = make_int4(16 * cv.x, 16 * cv.y, 16 * cv.z, 16 * cv.w);
      st.quad_col[i] = make_int2(16 * (centre(cv.x, cv.y, cv.z, fw) - lc), 16 * (centre(cv.y, cv.z, cv.w, fw) - lc));
      st.px[i] = __ldg(p.px + (c - p.cols));
    } else {
      const int ly = i - RING_W;
      const int Y = min(y0 + ly - 1, p.hout);
      const int* r = p.rows + Y;
      const int rs = p.rstride;
      const int4 rv = make_int4(__ldg(r) - r0, __ldg(r + rs) - r0, __ldg(r + 2 * rs) - r0, __ldg(r + 3 * rs) - r0);
      const int b = 16 * fw;
      st.row[ly] = make_int4(b * rv.x, b * rv.y, b * rv.z, b * rv.w);
      st.quad_row[ly] = make_int2(rb + 16 * gw * (centre(rv.x, rv.y, rv.z, fh) - lr),
                                  rb + 16 * gw * (centre(rv.y, rv.z, rv.w, fh) - lr));
      st.py[ly] = __ldg(p.py + Y);
    }
  }
  __syncthreads();
#if !defined(FSR_ABL_K2_STAGEONLY)
  // Cell (vr, vc) is index (vr + lr, vc + lc): the centre at footprint
  // texel (vr + lr - 1, vc + lc - 1) with its neighbours one texel either
  // way, every index clamped to the footprint: at the margin the centre and
  // a neighbour are one texel.  A thread takes grid column t % gw and the
  // rows of chunk t / gw, top to bottom: a cell's centre and the texel below
  // it are the next cell's above and centre (threads past the last chunk
  // idle).
  const int per = (gh + NTHREADS / gw - 1) / (NTHREADS / gw);  // rows a chunk (gw <= FP_W + 2 < NTHREADS)
  const int vc = threadIdx.x % gw, v0 = threadIdx.x / gw * per, v1 = min(v0 + per, gh);
  const int ic = vc + lc;
  const int lf = min(max(ic - 2, 0), fw - 1), cc = min(max(ic - 1, 0), fw - 1), rt = min(ic, fw - 1);
  auto row = [&](int i) { return fw * min(max(i, 0), fh - 1); };  // footprint row i, clamped, as an offset
  if (v0 < v1) {
    float la = lum[row(v0 + lr - 2) + cc], lm = lum[row(v0 + lr - 1) + cc];
    for (int vr = v0; vr < v1; ++vr) {
      const int cr = row(vr + lr - 1);
      const float le = lum[row(vr + lr) + cc];
      float gx, gy, gl;
#if defined(FSR_ABL_K2_NOG)
      // Knockout (gather_ablation.py "nog"; fsr_pixel.cuh:ABLATION_MASK):
      // the centre's luma as its response, as the JAX tool's
      // FSR_GATHER_ABL=nog.
      gx = gy = gl = lm;
#else
      texel_response(la, lum[cr + lf], lm, lum[cr + rt], le, gx, gy, gl);
#endif
      resp[vr * gw + vc] = make_float4(gx, gy, gl, 0.0f);
      la = lm;
      lm = le;
    }
  }
  __syncthreads();
#endif
  return alpha;
}

// EASU for ring pixel (ly, lx) of the block (output pixel y0 - 1 + ly,
// x0 - 1 + lx) from the stage: its four quadrants' responses and 12 taps,
// then the shared resolve.
__device__ __forceinline__ void easu_staged(const Tables& st, int ly, int lx, float out[3]) {
  const int4 cv = st.col[lx];
  const int4 rv = st.row[ly];
  const int co[4] = {cv.x, cv.y, cv.z, cv.w};
  const int ro[4] = {rv.x, rv.y, rv.z, rv.w};
  const char* s = reinterpret_cast<const char*>(stage_mem);
#if defined(FSR_ABL_K2_STAGEONLY)
  // Knockout (gather_ablation.py "stageonly"; fsr_pixel.cuh:ABLATION_MASK):
  // the staged 'f' texel in place of EASU, so the kernel keeps its staging,
  // its table slice and its store.
  const float4 f = *reinterpret_cast<const float4*>(s + ro[1] + co[1]);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
#else
  const int2 qr = st.quad_row[ly], qc = st.quad_col[lx];
  const float4 gs = *reinterpret_cast<const float4*>(s + qr.x + qc.x);
  const float4 gt = *reinterpret_cast<const float4*>(s + qr.x + qc.y);
  const float4 gu = *reinterpret_cast<const float4*>(s + qr.y + qc.x);
  const float4 gv = *reinterpret_cast<const float4*>(s + qr.y + qc.y);
  // The corners of the 4x4 window are unused.
  float t[3][4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((r == 0 || r == 3) && (q == 0 || q == 3)) continue;
      const float4 v = *reinterpret_cast<const float4*>(s + ro[r] + co[q]);
      t[0][r][q] = v.x;
      t[1][r][q] = v.y;
      t[2][r][q] = v.z;
    }
  }
  easu_resolve_quads(t, gs.x, gs.y, gs.z, gt.x, gt.y, gt.z, gu.x, gu.y, gu.z, gv.x, gv.y, gv.z, st.px[lx],
                     st.py[ly], out);
#endif
}

// Bilinear alpha of ring pixel (ly, lx) from the staged alpha plane a, at
// the tables' 'f' and next rows and columns.
__device__ __forceinline__ float alpha_staged(const Tables& st, const float* a, int ly, int lx) {
  const int4 cv = st.col[lx];
  const int4 rv = st.row[ly];
  return bilinear_alpha(a[(rv.y + cv.y) >> 4], a[(rv.y + cv.z) >> 4], a[(rv.z + cv.y) >> 4],
                        a[(rv.z + cv.z) >> 4], st.px[lx], st.py[ly]);
}

// One block's tile: the kernels' body, for a whole source (src) or a strip
// source (strip).
template <typename S, typename T, typename O, bool RCAS, bool DENOISE, bool RGBA, typename... Strip>
__device__ __forceinline__ void gather_tile(const S* __restrict__ src, O* __restrict__ dst, const GatherParams& p,
                                            const Strip&... strip) {
  constexpr int C = RGBA ? 4 : 3;
  __shared__ Tables st;
  __shared__ Scratch sc;
  const int64_t n = blockIdx.z;
  const float* alpha = stage<T, S, RGBA>(st, sc.lum, src + n * C * (int64_t)p.hin * p.win, p, strip...);
  O* o = dst + n * C * (int64_t)p.hout * p.wout;
  const int64_t oplane = (int64_t)p.hout * p.wout;
  const EpilogueParams e = p.epi;
  const unsigned frame = epilogue_frame(e);
  const int wout = p.wout;
  // The ring's origin: output pixel (y0, x0) is ring pixel (0, 0).
  const int y0 = blockIdx.y * TH - 1;
  const int x0 = blockIdx.x * TILE_W - 1;
  auto store = [&](int Y, int X, float v[3]) {
    const int64_t at = (int64_t)Y * wout + X;
    epilogue(e, frame, oplane, at, Y, X, v);
    if constexpr (RGBA)
      st4(o, oplane, at, v, alpha_staged(st, alpha, Y - y0, X - x0));
    else
      st3(o, oplane, at, v);
  };
  auto pixel = [&](int Y, int X, float v[3]) { easu_staged(st, Y - y0, X - x0, v); };
  if constexpr (RCAS)
    rcas_tile<DENOISE, TH>(pixel, store, p.hout, p.wout, p.sharp, sc.ring);
  else
    store_tile<TH>(pixel, store, p.hout, p.wout);
}

// Blocks a SM that the register budget keeps: 64 registers a thread for RGB,
// 85 for RGBA, whose alpha path needs more.  Given both bounds, ptxas stays
// within the budget without spilling to reach another occupancy step (with
// the first alone it spilled a few bytes in some instantiations to reach 48
// or 64 registers).
template <bool RGBA>
constexpr int MIN_BLOCKS = RGBA ? 3 : 4;

template <typename S, typename T, typename O, bool RCAS, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS<RGBA>)
    staged_gather_kernel(const S* __restrict__ src, O* __restrict__ dst, GatherParams p) {
  gather_tile<S, T, O, RCAS, DENOISE, RGBA>(src, dst, p);
}

// The strip-source form (fsr_pixel.cuh:StripSrc): the same tile, each texel
// loaded from the part that holds its row of the virtual halo'd strip.
template <typename S, typename T, typename O, bool RCAS, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS<RGBA>)
    staged_gather_kernel_strip(StripSrc<S> strip, O* __restrict__ dst, GatherParams p) {
  gather_tile<S, T, O, RCAS, DENOISE, RGBA>(static_cast<const S*>(nullptr), dst, p, strip);
}

// Allow kernel K the largest stage (max_stage_bytes) once per device, the
// first time it is launched there: a kernel's attribute is set once per
// instantiation, not per launch.
template <auto K, bool RGBA>
int allow_stage() {
  static std::atomic<unsigned long long> done{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_relaxed) & bit) != 0) return 0;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, max_stage_bytes(RGBA));
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit, std::memory_order_relaxed);
  return 0;
}

// STRIP: launch the strip-source form on sp, else the whole-frame form on
// src, with `stage` bytes of dynamic shared memory a block.  Each form is
// compiled in its own translation unit (easu_gather_strip.cu).
template <bool STRIP, typename S, typename T, typename O, bool RCAS, bool DENOISE, bool RGBA>
int launch_one(const void* src, const StripParts* sp, void* dst, int nb, const GatherParams& p, int stage,
               cudaStream_t stream) {
  constexpr int C = RGBA ? 4 : 3;
  const int64_t in_frame = C * (int64_t)p.hin * p.win;
  const int64_t out_frame = C * (int64_t)p.hout * p.wout;
  if constexpr (STRIP) {
    const int err = allow_stage<&staged_gather_kernel_strip<S, T, O, RCAS, DENOISE, RGBA>, RGBA>();
    if (err != 0) return err;
  } else {
    const int err = allow_stage<&staged_gather_kernel<S, T, O, RCAS, DENOISE, RGBA>, RGBA>();
    if (err != 0) return err;
  }
  return launch_frames<TH>(nb, p.hout, p.wout, [&](dim3 grid, int n0) {
    O* d = static_cast<O*>(dst) + n0 * out_frame;
    if constexpr (STRIP)
      staged_gather_kernel_strip<S, T, O, RCAS, DENOISE, RGBA><<<grid, NTHREADS, stage, stream>>>(
          strip_src<S>(*sp, n0), d, p);
    else
      staged_gather_kernel<S, T, O, RCAS, DENOISE, RGBA><<<grid, NTHREADS, stage, stream>>>(
          static_cast<const S*>(src) + n0 * in_frame, d, p);
  });
}

// The channel count is a template parameter, as in K1 (fused.cu), and so
// are RCAS and denoise.
template <bool STRIP, typename S, typename T, typename O>
int launch(const void* src, const StripParts* sp, void* dst, int nb, int channels, const GatherParams& p,
           bool rcas, bool denoise, int stage, cudaStream_t stream) {
  if (stage <= 0 || stage > max_stage_bytes(channels == 4)) return (int)cudaErrorInvalidValue;
  auto planes = [&](auto rgba) {
    constexpr bool RGBA = decltype(rgba)::value;
    if (!rcas) return launch_one<STRIP, S, T, O, false, false, RGBA>(src, sp, dst, nb, p, stage, stream);
    if (denoise) return launch_one<STRIP, S, T, O, true, true, RGBA>(src, sp, dst, nb, p, stage, stream);
    return launch_one<STRIP, S, T, O, true, false, RGBA>(src, sp, dst, nb, p, stage, stream);
  };
  return channels == 4 ? planes(std::true_type{}) : planes(std::false_type{});
}

// The C entry points' body: the parameters, the checks and the dispatch on
// the types, for the whole-frame form (STRIP false: src) or the strip-source
// form (sp).
template <bool STRIP>
int easu_gather(const void* src, const StripParts* sp, void* dst, int src_dtype, int dtype, int out_dtype, int nb,
                int channels, int hin, int win, int hout, int wout, const void* rows, const void* cols,
                const void* py, const void* px, float sharp, int apply_rcas, int denoise, int srtm,
                const EpilogueParams* epi, void* stream, int stage) {
  if (STRIP && !strip_ok(sp, hin)) return (int)cudaErrorInvalidValue;
  GatherParams p;
  // The row tables start at output row -1: their bases move one entry on,
  // so the device indexes them by the output row itself.
  p.rows = static_cast<const int*>(rows) + 1;
  p.cols = static_cast<const int*>(cols);
  p.py = static_cast<const float*>(py) + 1;
  p.px = static_cast<const float*>(px);
  p.hin = hin;
  p.win = win;
  p.hout = hout;
  p.wout = wout;
  p.rstride = hout + 2;
  p.sharp = sharp;
  p.srtm = srtm;
  p.epi = epi != nullptr ? *epi : EpilogueParams{};
  if (nb == 0 || hout == 0 || wout == 0) return 0;
  if ((dtype != F32 && dtype != BF16) || (out_dtype != dtype && out_dtype != U8 && out_dtype != U16))
    return (int)cudaErrorInvalidValue;
  if (channels != 3 && channels != 4) return (int)cudaErrorInvalidValue;
  const bool r = apply_rcas != 0;
  const bool dn = denoise != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  // Only a float32 (or float16, below) source rounds to a bfloat16 storage
  // type at load; a bfloat16 source widens exactly and a byte decodes,
  // whatever the storage.
  if (src_dtype == F32 && dtype == BF16) {
    if (out_dtype == BF16) return launch<STRIP, float, bf16, bf16>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    if (out_dtype == U8) return launch<STRIP, float, bf16, uint8_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    return launch<STRIP, float, bf16, uint16_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
  }
  if (src_dtype == F32) {
    if (out_dtype == F32) return launch<STRIP, float, float, float>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    if (out_dtype == U8) return launch<STRIP, float, float, uint8_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    return launch<STRIP, float, float, uint16_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
  }
  if (src_dtype == BF16) {
    if (out_dtype == F32) return launch<STRIP, bf16, float, float>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    if (out_dtype == BF16) return launch<STRIP, bf16, float, bf16>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    if (out_dtype == U8) return launch<STRIP, bf16, float, uint8_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    return launch<STRIP, bf16, float, uint16_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
  }
  // A float16 source widens exactly, and rounds to a bfloat16 storage type
  // at load as a float32 source does.
  if (src_dtype == F16 && dtype == BF16) {
    if (out_dtype == BF16) return launch<STRIP, __half, bf16, bf16>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    if (out_dtype == U8) return launch<STRIP, __half, bf16, uint8_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    return launch<STRIP, __half, bf16, uint16_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
  }
  if (src_dtype == F16) {
    if (out_dtype == F32) return launch<STRIP, __half, float, float>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    if (out_dtype == U8) return launch<STRIP, __half, float, uint8_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    return launch<STRIP, __half, float, uint16_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
  }
  if (src_dtype == U8) {
    if (out_dtype == F32) return launch<STRIP, uint8_t, float, float>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    if (out_dtype == BF16) return launch<STRIP, uint8_t, float, bf16>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    if (out_dtype == U8) return launch<STRIP, uint8_t, float, uint8_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
    return launch<STRIP, uint8_t, float, uint16_t>(src, sp, dst, nb, channels, p, r, dn, stage, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#ifndef FSR_STRIP_TU
// dtype codes (fsr_pixel.cuh DType): src_dtype is the source's (float32,
// bfloat16, float16 or uint8), dtype the storage type (float32 or bfloat16),
// out_dtype the output's: the storage type, or uint8/uint16 codes.
// channels: 3, or 4 with alpha in plane 3 of the source and the output.
// rows/cols (int32 [4][hout + 2], [4][wout]) and py/px (float32 [hout + 2],
// [wout]) are device pointers; the row tables cover output rows -1..hout.
// srtm: 1 runs the SRTM prologue; epi: the K5 epilogue (host struct, device
// pointers inside).  stage: a block's dynamic shared memory in bytes, the
// plan's largest block's stage_bytes (kernels/easu_gather.py:
// Footprint.stage), at most max_stage_bytes.
extern "C" int fsr_easu_gather(const void* src, void* dst, int src_dtype, int dtype,
                               int out_dtype, int nb, int channels, int hin, int win, int hout,
                               int wout, const void* rows, const void* cols, const void* py,
                               const void* px, float sharp, int apply_rcas, int denoise,
                               int srtm, const EpilogueParams* epi, void* stream, int stage) {
  return easu_gather<false>(src, nullptr, dst, src_dtype, dtype, out_dtype, nb, channels, hin, win, hout, wout,
                            rows, cols, py, px, sharp, apply_rcas, denoise, srtm, epi, stream, stage);
}
#else
// K2 on a row strip read in place from its three parts (sp: fsr_pixel.cuh's
// StripParts); hin is the virtual halo'd strip's rows, own's rows plus
// 2 * halo, which the row tables index.  The other arguments are
// fsr_easu_gather's.
extern "C" int fsr_easu_gather_strip(const StripParts* sp, void* dst, int src_dtype, int dtype, int out_dtype,
                                     int nb, int channels, int hin, int win, int hout, int wout, const void* rows,
                                     const void* cols, const void* py, const void* px, float sharp,
                                     int apply_rcas, int denoise, int srtm, const EpilogueParams* epi,
                                     void* stream, int stage) {
  return easu_gather<true>(nullptr, sp, dst, src_dtype, dtype, out_dtype, nb, channels, hin, win, hout, wout,
                           rows, cols, py, px, sharp, apply_rcas, denoise, srtm, epi, stream, stage);
}
#endif
