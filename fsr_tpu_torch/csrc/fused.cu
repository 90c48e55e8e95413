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
// The per-pixel EASU resolve and RCAS and the tile loop live in
// fsr_pixel.cuh, shared with K2 (easu_gather.cu) and K3 (rcas.cu); this file
// holds the phase arithmetic that locates each pixel's tap window.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fsr_pixel.cuh"

namespace {

using namespace fsr;

struct Params {
  int qy, qx;
  int ry[4], rx[4];  // padded-frame row/col of phase a/b's 'f' texel at plane index 0
  float py[4], px[4];
  int hp, wp;  // padded source extent
  int hout, wout;
  float sharp;  // linear RCAS sharpness
};

// EASU for output pixel (Y, X) of one frame: the phase arithmetic locates
// the 4x4 tap window in the padded source, then the shared resolve runs.
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
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((r == 0 || r == 3) && (q == 0 || q == 3)) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) t[c][r][q] = ld(base + c * plane + (int64_t)r * p.wp + q);
    }
  }
  easu_resolve(t, p.px[b], p.py[a], out);
}

template <typename T, bool RCAS, bool DENOISE>
__global__ void __launch_bounds__(NTHREADS)
    fused_kernel(const T* __restrict__ src, T* __restrict__ dst, Params p) {
  const int64_t n = blockIdx.z;
  const T* s = src + n * 3 * (int64_t)p.hp * p.wp;
  T* o = dst + n * 3 * (int64_t)p.hout * p.wout;
  if constexpr (RCAS) {
    // Ring positions outside the image clamp to the edge pixel.
    auto ring = [=](int Y, int X, float v[3]) {
      easu_pixel(s, p, min(max(Y, 0), p.hout - 1), min(max(X, 0), p.wout - 1), v);
    };
    rcas_tile<DENOISE>(ring, o, p.hout, p.wout, p.sharp);
  } else {
    store_tile([=](int Y, int X, float v[3]) { easu_pixel(s, p, Y, X, v); }, o, p.hout, p.wout);
  }
}

template <typename T>
int launch(const void* src, void* dst, int nb, const Params& p, bool rcas, bool denoise,
           cudaStream_t stream) {
  const int64_t in_frame = 3 * (int64_t)p.hp * p.wp;
  const int64_t out_frame = 3 * (int64_t)p.hout * p.wout;
  return launch_frames(nb, p.hout, p.wout, [&](dim3 grid, int n0) {
    const T* s = static_cast<const T*>(src) + n0 * in_frame;
    T* d = static_cast<T*>(dst) + n0 * out_frame;
    if (!rcas)
      fused_kernel<T, false, false><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else if (denoise)
      fused_kernel<T, true, true><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else
      fused_kernel<T, true, false><<<grid, NTHREADS, 0, stream>>>(s, d, p);
  });
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
