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
// vector gather; a Hopper thread simply loads its taps.
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
// strip: only the tables differ.
//
// Design, as K1 (fused.cu): one block per TILE_H x TILE_W output tile.
//   Phase 1: EASU in f32 for the tile and a one-pixel ring into shared
//     memory.  Ring columns are clamped to the image, ring rows to the
//     tables' -1 .. hout, whose rows outside the frame repeat its edge rows:
//     a ring slot outside the image holds exactly the edge pixel's value, so
//     RCAS sees e in place of the missing neighbour with no per-pixel border
//     tests.
//   Barrier.
//   Phase 2: RCAS (limiter, optional denoise) and one store.
// With apply_rcas off the kernel stores EASU directly.
//
// Storage: the source is float32, bfloat16 or uint8; the output float32,
// bfloat16, or uint8/uint16 UNORM codes.  A float32 source under bfloat16
// storage is rounded (RNE) at each load before widening, which is what
// converting the source first would give; a byte decodes v * float32(1/255)
// at each load and is never rounded to the storage type.
//
// Options, as easu_gather.py:919-930 and :748-784 run them: the SRTM
// prologue on each loaded texel (srtm_window), and the K5 epilogue on the
// float32 RCAS result at the pixel's output coordinates before the one
// store (fsr_pixel.cuh:epilogue); the grain is plain output-space (3, Hout,
// Wout).  Source, load-rounding and output types are template parameters;
// the prologue and epilogue flags are uniform runtime branches.
//
// RGBA (easu_gather.py:400-403, :757-761, :1372-1375): alpha in plane 3 of
// the source and the output.  The store pass resolves it bilinearly from the
// plan's rows[1..2], cols[1..2] (the clipped 'f' and next texels, the CLAMP
// of ops.easu.bilinear) at (px, py), loaded as the colour is (rounded to the
// storage type, or a decoded byte), never tonemapped nor touched by the
// epilogue, and stores it by the colour's rule; RGB is as for three
// channels, and alpha never enters the RCAS ring.  The channel count is a
// template parameter (RGBA), so the RGB kernels carry no alpha code.
//
// Bound: f32 arithmetic, as K1 (the function needs ~565 flops per output
// pixel; with the ring recompute the kernel runs ~660); the
// table loads (10 per pixel, L1-resident) replace K1's phase arithmetic.
// Device-memory traffic is one read of the source and one write of the
// output (plus the grain's 12 bytes per pixel with LFGA; the epilogue and
// prologue cost as in K1).  Sharing tap loads and texel responses between
// neighbouring pixels is later work.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fsr_pixel.cuh"

using namespace fsr;

namespace {

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

// EASU for output pixel (Y, X) of one frame: the tables give the 4x4 tap
// window's rows and columns in the unpadded source, then the shared resolve
// runs.  T is the storage type a float source rounds to, S the source's.
template <typename T, typename S>
__device__ __forceinline__ void easu_at(const S* __restrict__ src, const GatherParams& p, int Y,
                                        int X, float out[3]) {
  int64_t row[4];
  int col[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    row[k] = (int64_t)__ldg(p.rows + k * p.rstride + Y) * p.win;
    col[k] = __ldg(p.cols + k * p.wout + X);
  }
  const int64_t plane = (int64_t)p.hin * p.win;

  // The corners of the 4x4 window are unused.
  float t[3][4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((r == 0 || r == 3) && (q == 0 || q == 3)) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) t[c][r][q] = ld_as<T>(src + c * plane + row[r] + col[q]);
    }
  }
  if (p.srtm) srtm_window(t);
  easu_resolve(t, __ldg(p.px + X), __ldg(p.py + Y), out);
}

// Bilinear alpha for output pixel (Y, X) of one frame, from the tables' 'f'
// and next rows and columns of the alpha plane.
template <typename T, typename S>
__device__ __forceinline__ float alpha_at(const S* __restrict__ src, const GatherParams& p, int Y,
                                          int X) {
  const S* a = src + 3 * (int64_t)p.hin * p.win;
  const int64_t r0 = (int64_t)__ldg(p.rows + p.rstride + Y) * p.win;
  const int64_t r1 = (int64_t)__ldg(p.rows + 2 * p.rstride + Y) * p.win;
  const int c0 = __ldg(p.cols + p.wout + X);
  const int c1 = __ldg(p.cols + 2 * p.wout + X);
  return bilinear_alpha(ld_as<T>(a + r0 + c0), ld_as<T>(a + r0 + c1), ld_as<T>(a + r1 + c0),
                        ld_as<T>(a + r1 + c1), __ldg(p.px + X), __ldg(p.py + Y));
}

template <typename S, typename T, typename O, bool RCAS, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NTHREADS)
    gather_kernel(const S* __restrict__ src, O* __restrict__ dst, GatherParams p) {
  constexpr int C = RGBA ? 4 : 3;
  const int64_t n = blockIdx.z;
  const S* s = src + n * C * (int64_t)p.hin * p.win;
  O* o = dst + n * C * (int64_t)p.hout * p.wout;
  const int64_t oplane = (int64_t)p.hout * p.wout;
  const EpilogueParams e = p.epi;
  const int wout = p.wout;
  auto store = [=](int Y, int X, float v[3]) {
    const int64_t at = (int64_t)Y * wout + X;
    epilogue(e, oplane, at, Y, X, v);
    if constexpr (RGBA)
      st4(o, oplane, at, v, alpha_at<T>(s, p, Y, X));
    else
      st3(o, oplane, at, v);
  };
  if constexpr (RCAS) {
    // Ring columns clamp to the image, ring rows to the tables' -1..hout
    // (a ragged last tile's ring reaches past hout), before the lookup.
    auto ring = [=](int Y, int X, float v[3]) {
      easu_at<T>(s, p, min(max(Y, -1), p.hout), min(max(X, 0), p.wout - 1), v);
    };
    rcas_tile<DENOISE>(ring, store, p.hout, p.wout, p.sharp);
  } else {
    store_tile([=](int Y, int X, float v[3]) { easu_at<T>(s, p, Y, X, v); }, store, p.hout,
               p.wout);
  }
}

template <typename S, typename T, typename O, bool RGBA>
int launch_planes(const void* src, void* dst, int nb, const GatherParams& p, bool rcas,
                  bool denoise, cudaStream_t stream) {
  constexpr int C = RGBA ? 4 : 3;
  const int64_t in_frame = C * (int64_t)p.hin * p.win;
  const int64_t out_frame = C * (int64_t)p.hout * p.wout;
  return launch_frames(nb, p.hout, p.wout, [&](dim3 grid, int n0) {
    const S* s = static_cast<const S*>(src) + n0 * in_frame;
    O* d = static_cast<O*>(dst) + n0 * out_frame;
    if (!rcas)
      gather_kernel<S, T, O, false, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else if (denoise)
      gather_kernel<S, T, O, true, true, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else
      gather_kernel<S, T, O, true, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
  });
}

// The channel count is a template parameter, as in K1 (fused.cu).
template <typename S, typename T, typename O>
int launch(const void* src, void* dst, int nb, int channels, const GatherParams& p, bool rcas,
           bool denoise, cudaStream_t stream) {
  return channels == 4 ? launch_planes<S, T, O, true>(src, dst, nb, p, rcas, denoise, stream)
                       : launch_planes<S, T, O, false>(src, dst, nb, p, rcas, denoise, stream);
}

}  // namespace

// dtype codes (fsr_pixel.cuh DType): src_dtype is the source's (float32,
// bfloat16 or uint8), dtype the storage type (float32 or bfloat16),
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
  // Only a float32 source rounds to a bfloat16 storage type at load; a
  // bfloat16 source widens exactly and a byte decodes, whatever the storage.
  if (src_dtype == F32 && dtype == BF16) {
    if (out_dtype == BF16) return launch<float, bf16, bf16>(src, dst, nb, channels, p, r, dn, s);
    if (out_dtype == U8) return launch<float, bf16, uint8_t>(src, dst, nb, channels, p, r, dn, s);
    return launch<float, bf16, uint16_t>(src, dst, nb, channels, p, r, dn, s);
  }
  if (src_dtype == F32) {
    if (out_dtype == F32) return launch<float, float, float>(src, dst, nb, channels, p, r, dn, s);
    if (out_dtype == U8) return launch<float, float, uint8_t>(src, dst, nb, channels, p, r, dn, s);
    return launch<float, float, uint16_t>(src, dst, nb, channels, p, r, dn, s);
  }
  if (src_dtype == BF16) {
    if (out_dtype == F32) return launch<bf16, float, float>(src, dst, nb, channels, p, r, dn, s);
    if (out_dtype == BF16) return launch<bf16, float, bf16>(src, dst, nb, channels, p, r, dn, s);
    if (out_dtype == U8) return launch<bf16, float, uint8_t>(src, dst, nb, channels, p, r, dn, s);
    return launch<bf16, float, uint16_t>(src, dst, nb, channels, p, r, dn, s);
  }
  if (src_dtype == U8) {
    if (out_dtype == F32) return launch<uint8_t, float, float>(src, dst, nb, channels, p, r, dn, s);
    if (out_dtype == BF16) return launch<uint8_t, float, bf16>(src, dst, nb, channels, p, r, dn, s);
    if (out_dtype == U8)
      return launch<uint8_t, float, uint8_t>(src, dst, nb, channels, p, r, dn, s);
    return launch<uint8_t, float, uint16_t>(src, dst, nb, channels, p, r, dn, s);
  }
  return (int)cudaErrorInvalidValue;
}
