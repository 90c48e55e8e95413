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
// three steps.
//   Stage: the tables are non-decreasing in the output coordinate and in
//     the tap offset (floors of an increasing map, clipped), so the source
//     texels that the block's tile and its one-pixel RCAS ring read form one
//     rectangle, from the first ring pixel's dx = -1 tap to the last one's
//     dx = +2 tap: at most (TH + 5) x (TILE_W + 5) texels for an upscale
//     (easu_gather.py:footprint mirrors the rule; the host checks the fit
//     before the launch).  The block loads it once, coalesced, into shared
//     memory: each texel converted by the load rule below, tonemapped by the
//     SRTM prologue when it is on, and its luma taken, as one float4 (r, g,
//     b, luma).  Beside it, the block's slice of the tables as byte offsets
//     into the footprint: per ring column the four tap columns and px, per
//     ring row the four tap rows and py.  Ring columns are clamped to the
//     image, ring rows to the tables' -1 .. hout, whose rows outside the
//     frame repeat its edge rows: a ring slot outside the image holds
//     exactly the edge pixel's value, so RCAS sees e in place of the missing
//     neighbour with no per-pixel border tests.
//   Barrier.  EASU in float32 for the tile and its ring into shared memory:
//     per pixel two table entries and 12 taps, each one 16-byte shared load
//     at the sum of its row and column offsets, then the shared resolve on
//     the staged lumas.
//   Barrier.  RCAS (limiter, optional denoise) and one store.
// With apply_rcas off the kernel stores EASU directly.
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
// loop idle) and the instruction stream around it.  The staging takes out of the per-pixel
// stream what the old design (one thread per pixel loading its own taps)
// repeated at every tap: 10 global table loads and four 64-bit row offsets
// per evaluation, and 36 global loads, each with its own conversion, SRTM
// and a third of a luma, where a footprint texel serves about 17 taps at
// 1.5x.  Device-memory traffic stays one read of the source and one write
// of the output (plus the grain's 12 bytes per pixel with LFGA).  Left: the
// ring recompute, the texel responses per pixel (sharing them per block
// cost K1's replay as much as it saved, PERF.md), and the staging's latency,
// which one buffer does not overlap with the math.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// One block's source footprint and its slice of the tables, in shared
// memory.  Offsets are in bytes into tex: a tap of ring row ly and ring
// column lx, at offsets dy, dx = -1..2, is at row[ly][dy + 1] + col[lx][dx + 1].
template <bool RGBA>
struct Stage {
  float4 tex[FP_H * FP_W];                // (r, g, b, luma2), rows of the footprint's width
  float alpha[RGBA ? FP_H * FP_W : 1];    // RGBA: the alpha plane, as tex
  int4 col[RING_W];
  float px[RING_W];
  int4 row[RH];
  float py[RH];
};

// Load the block's footprint of one frame's source and its table slice
// (see the source note), then a barrier.  T is the storage type a float
// source rounds to, S the source's; strip: empty for a whole source, else
// its strip source (the loads' addresses).
template <typename T, typename S, bool RGBA, typename... Strip>
__device__ __forceinline__ void stage(Stage<RGBA>& st, const S* __restrict__ src, const GatherParams& p,
                                      const Strip&... strip) {
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TH;
  const int r0 = __ldg(p.rows + y0 - 1);
  const int c0 = __ldg(p.cols + max(x0 - 1, 0));
  const int fh = __ldg(p.rows + 3 * p.rstride + min(y0 + TH, p.hout)) - r0 + 1;
  const int fw = __ldg(p.cols + 3 * p.wout + min(x0 + TILE_W, p.wout - 1)) - c0 + 1;
  if (fh > FP_H || fw > FP_W) __trap();  // the host's footprint check failed to hold
  if constexpr (sizeof...(Strip) > 0) {
    // A strip's parts, run by run, loaded through the read-only cache; the
    // tables keep every row inside the virtual strip.
    auto run = [&](int rb, int re, const S* base, int64_t pl, auto row) {
      for (int k = rb * fw + threadIdx.x; k < re * fw; k += NTHREADS) {
        const int r = k / fw;
        const S* at = base + (int64_t)row(r) * p.win + c0 + (k - r * fw);
        float cr = ld_as<T, true>(at), cg = ld_as<T, true>(at + pl), cb = ld_as<T, true>(at + 2 * pl);
        if (p.srtm) srtm_texel(cr, cg, cb);
        st.tex[k] = make_float4(cr, cg, cb, luma2(cr, cg, cb));
        if constexpr (RGBA) st.alpha[k] = ld_as<T, true>(at + 3 * pl);
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
      st.tex[k] = make_float4(cr, cg, cb, luma2(cr, cg, cb));
      if constexpr (RGBA) st.alpha[k] = ld_as<T>(at + 3 * plane);
    }
  }
  for (int i = threadIdx.x; i < RING_W + RH; i += NTHREADS) {
    if (i < RING_W) {
      const int* c = p.cols + min(max(x0 + i - 1, 0), p.wout - 1);
      const int w = p.wout;
      st.col[i] = make_int4(16 * (__ldg(c) - c0), 16 * (__ldg(c + w) - c0), 16 * (__ldg(c + 2 * w) - c0),
                            16 * (__ldg(c + 3 * w) - c0));
      st.px[i] = __ldg(p.px + (c - p.cols));
    } else {
      const int ly = i - RING_W;
      const int Y = min(y0 + ly - 1, p.hout);
      const int* r = p.rows + Y;
      const int rs = p.rstride;
      const int b = 16 * fw;
      st.row[ly] = make_int4(b * (__ldg(r) - r0), b * (__ldg(r + rs) - r0), b * (__ldg(r + 2 * rs) - r0),
                             b * (__ldg(r + 3 * rs) - r0));
      st.py[ly] = __ldg(p.py + Y);
    }
  }
  __syncthreads();
}

// EASU for ring pixel (ly, lx) of the block (output pixel y0 - 1 + ly,
// x0 - 1 + lx) from the staged footprint: 12 taps and their lumas, then the
// shared resolve.
template <bool RGBA>
__device__ __forceinline__ void easu_staged(const Stage<RGBA>& st, int ly, int lx, float out[3]) {
  const int4 cv = st.col[lx];
  const int4 rv = st.row[ly];
  const int co[4] = {cv.x, cv.y, cv.z, cv.w};
  const int ro[4] = {rv.x, rv.y, rv.z, rv.w};
  const char* tex = reinterpret_cast<const char*>(st.tex);
#if defined(FSR_ABL_K2_STAGEONLY)
  // Knockout (gather_ablation.py "stageonly"; fsr_pixel.cuh:ABLATION_MASK):
  // the staged 'f' texel in place of EASU, so the kernel keeps its staging,
  // its table slice and its store.
  const float4 f = *reinterpret_cast<const float4*>(tex + ro[1] + co[1]);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
#else
  // The corners of the 4x4 window are unused.
  float t[3][4][4], L[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((r == 0 || r == 3) && (q == 0 || q == 3)) continue;
      const float4 v = *reinterpret_cast<const float4*>(tex + ro[r] + co[q]);
      t[0][r][q] = v.x;
      t[1][r][q] = v.y;
      t[2][r][q] = v.z;
      L[r][q] = v.w;
    }
  }
  easu_resolve_luma(t, L, st.px[lx], st.py[ly], out);
#endif
}

// Bilinear alpha of ring pixel (ly, lx) from the staged alpha plane, at the
// tables' 'f' and next rows and columns.
template <bool RGBA>
__device__ __forceinline__ float alpha_staged(const Stage<RGBA>& st, int ly, int lx) {
  const int4 cv = st.col[lx];
  const int4 rv = st.row[ly];
  const float* a = st.alpha;
  return bilinear_alpha(a[(rv.y + cv.y) >> 4], a[(rv.y + cv.z) >> 4], a[(rv.z + cv.y) >> 4],
                        a[(rv.z + cv.z) >> 4], st.px[lx], st.py[ly]);
}

// One block's tile: the kernels' body, for a whole source (src) or a strip
// source (strip).
template <typename S, typename T, typename O, bool RCAS, bool DENOISE, bool RGBA, typename... Strip>
__device__ __forceinline__ void gather_tile(const S* __restrict__ src, O* __restrict__ dst, const GatherParams& p,
                                            const Strip&... strip) {
  constexpr int C = RGBA ? 4 : 3;
  __shared__ Stage<RGBA> st;
  const int64_t n = blockIdx.z;
  stage<T>(st, src + n * C * (int64_t)p.hin * p.win, p, strip...);
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
      st4(o, oplane, at, v, alpha_staged(st, Y - y0, X - x0));
    else
      st3(o, oplane, at, v);
  };
  auto pixel = [&](int Y, int X, float v[3]) { easu_staged(st, Y - y0, X - x0, v); };
  if constexpr (RCAS)
    rcas_tile<DENOISE, TH>(pixel, store, p.hout, p.wout, p.sharp);
  else
    store_tile<TH>(pixel, store, p.hout, p.wout);
}

template <typename S, typename T, typename O, bool RCAS, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NTHREADS)
    staged_gather_kernel(const S* __restrict__ src, O* __restrict__ dst, GatherParams p) {
  gather_tile<S, T, O, RCAS, DENOISE, RGBA>(src, dst, p);
}

// The strip-source form (fsr_pixel.cuh:StripSrc): the same tile, each texel
// loaded from the part that holds its row of the virtual halo'd strip.
template <typename S, typename T, typename O, bool RCAS, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NTHREADS)
    staged_gather_kernel_strip(StripSrc<S> strip, O* __restrict__ dst, GatherParams p) {
  gather_tile<S, T, O, RCAS, DENOISE, RGBA>(static_cast<const S*>(nullptr), dst, p, strip);
}

// STRIP: launch the strip-source form on sp, else the whole-frame form on
// src.  Each form is compiled in its own translation unit
// (easu_gather_strip.cu).
template <bool STRIP, typename S, typename T, typename O, bool RGBA>
int launch_planes(const void* src, const StripParts* sp, void* dst, int nb, const GatherParams& p, bool rcas,
                  bool denoise, cudaStream_t stream) {
  constexpr int C = RGBA ? 4 : 3;
  const int64_t in_frame = C * (int64_t)p.hin * p.win;
  const int64_t out_frame = C * (int64_t)p.hout * p.wout;
  return launch_frames<TH>(nb, p.hout, p.wout, [&](dim3 grid, int n0) {
    O* d = static_cast<O*>(dst) + n0 * out_frame;
    if constexpr (STRIP) {
      const StripSrc<S> s = strip_src<S>(*sp, n0);
      if (!rcas)
        staged_gather_kernel_strip<S, T, O, false, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
      else if (denoise)
        staged_gather_kernel_strip<S, T, O, true, true, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
      else
        staged_gather_kernel_strip<S, T, O, true, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    } else {
      const S* s = static_cast<const S*>(src) + n0 * in_frame;
      if (!rcas)
        staged_gather_kernel<S, T, O, false, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
      else if (denoise)
        staged_gather_kernel<S, T, O, true, true, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
      else
        staged_gather_kernel<S, T, O, true, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    }
  });
}

// The channel count is a template parameter, as in K1 (fused.cu).
template <bool STRIP, typename S, typename T, typename O>
int launch(const void* src, const StripParts* sp, void* dst, int nb, int channels, const GatherParams& p,
           bool rcas, bool denoise, cudaStream_t stream) {
  return channels == 4 ? launch_planes<STRIP, S, T, O, true>(src, sp, dst, nb, p, rcas, denoise, stream)
                       : launch_planes<STRIP, S, T, O, false>(src, sp, dst, nb, p, rcas, denoise, stream);
}

// The C entry points' body: the parameters, the checks and the dispatch on
// the types, for the whole-frame form (STRIP false: src) or the strip-source
// form (sp).
template <bool STRIP>
int easu_gather(const void* src, const StripParts* sp, void* dst, int src_dtype, int dtype, int out_dtype, int nb,
                int channels, int hin, int win, int hout, int wout, const void* rows, const void* cols,
                const void* py, const void* px, float sharp, int apply_rcas, int denoise, int srtm,
                const EpilogueParams* epi, void* stream) {
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
    if (out_dtype == BF16) return launch<STRIP, float, bf16, bf16>(src, sp, dst, nb, channels, p, r, dn, s);
    if (out_dtype == U8) return launch<STRIP, float, bf16, uint8_t>(src, sp, dst, nb, channels, p, r, dn, s);
    return launch<STRIP, float, bf16, uint16_t>(src, sp, dst, nb, channels, p, r, dn, s);
  }
  if (src_dtype == F32) {
    if (out_dtype == F32) return launch<STRIP, float, float, float>(src, sp, dst, nb, channels, p, r, dn, s);
    if (out_dtype == U8) return launch<STRIP, float, float, uint8_t>(src, sp, dst, nb, channels, p, r, dn, s);
    return launch<STRIP, float, float, uint16_t>(src, sp, dst, nb, channels, p, r, dn, s);
  }
  if (src_dtype == BF16) {
    if (out_dtype == F32) return launch<STRIP, bf16, float, float>(src, sp, dst, nb, channels, p, r, dn, s);
    if (out_dtype == BF16) return launch<STRIP, bf16, float, bf16>(src, sp, dst, nb, channels, p, r, dn, s);
    if (out_dtype == U8) return launch<STRIP, bf16, float, uint8_t>(src, sp, dst, nb, channels, p, r, dn, s);
    return launch<STRIP, bf16, float, uint16_t>(src, sp, dst, nb, channels, p, r, dn, s);
  }
  // A float16 source widens exactly, and rounds to a bfloat16 storage type
  // at load as a float32 source does.
  if (src_dtype == F16 && dtype == BF16) {
    if (out_dtype == BF16) return launch<STRIP, __half, bf16, bf16>(src, sp, dst, nb, channels, p, r, dn, s);
    if (out_dtype == U8) return launch<STRIP, __half, bf16, uint8_t>(src, sp, dst, nb, channels, p, r, dn, s);
    return launch<STRIP, __half, bf16, uint16_t>(src, sp, dst, nb, channels, p, r, dn, s);
  }
  if (src_dtype == F16) {
    if (out_dtype == F32) return launch<STRIP, __half, float, float>(src, sp, dst, nb, channels, p, r, dn, s);
    if (out_dtype == U8) return launch<STRIP, __half, float, uint8_t>(src, sp, dst, nb, channels, p, r, dn, s);
    return launch<STRIP, __half, float, uint16_t>(src, sp, dst, nb, channels, p, r, dn, s);
  }
  if (src_dtype == U8) {
    if (out_dtype == F32) return launch<STRIP, uint8_t, float, float>(src, sp, dst, nb, channels, p, r, dn, s);
    if (out_dtype == BF16) return launch<STRIP, uint8_t, float, bf16>(src, sp, dst, nb, channels, p, r, dn, s);
    if (out_dtype == U8) return launch<STRIP, uint8_t, float, uint8_t>(src, sp, dst, nb, channels, p, r, dn, s);
    return launch<STRIP, uint8_t, float, uint16_t>(src, sp, dst, nb, channels, p, r, dn, s);
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
// pointers inside).
extern "C" int fsr_easu_gather(const void* src, void* dst, int src_dtype, int dtype,
                               int out_dtype, int nb, int channels, int hin, int win, int hout,
                               int wout, const void* rows, const void* cols, const void* py,
                               const void* px, float sharp, int apply_rcas, int denoise,
                               int srtm, const EpilogueParams* epi, void* stream) {
  return easu_gather<false>(src, nullptr, dst, src_dtype, dtype, out_dtype, nb, channels, hin, win, hout, wout,
                            rows, cols, py, px, sharp, apply_rcas, denoise, srtm, epi, stream);
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
                                     void* stream) {
  return easu_gather<true>(nullptr, sp, dst, src_dtype, dtype, out_dtype, nb, channels, hin, win, hout, wout,
                           rows, cols, py, px, sharp, apply_rcas, denoise, srtm, epi, stream);
}
#endif
