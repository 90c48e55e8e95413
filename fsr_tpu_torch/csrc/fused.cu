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
// Options, as fused.py:871-884 and :1012-1051 run them: a uint8 source
// (K4 pads it as bytes) decodes v * float32(1/255) at each tap load; the
// SRTM prologue tonemaps each loaded texel (srtm_window); the K5 epilogue
// (SRTM^-1 or gamma2, LFGA grain, TEPD dither; fsr_pixel.cuh:epilogue)
// runs on the float32 RCAS result at the pixel's global output
// coordinates; the store rounds once to float32/bfloat16, or encodes
// UNORM8/UNORM10 codes into uint8/uint16.  Source type S and output type O
// are template parameters; the prologue and epilogue flags are uniform
// runtime branches.
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
// one write of the output, plus 12 bytes of grain per pixel when LFGA is on.
// The epilogue adds about 60 flops per pixel (TEPD), the SRTM prologue
// about 10 per tap load.  This first version recomputes the per-texel
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

using namespace fsr;

namespace {

struct Params {
  int qy, qx;
  int ry[4], rx[4];  // padded-frame row/col of phase a/b's 'f' texel at plane index 0
  float py[4], px[4];
  int hp, wp;  // padded source extent
  int hout, wout;
  float sharp;  // linear RCAS sharpness
  int srtm;     // SRTM prologue on each loaded texel
  EpilogueParams epi;
};

// EASU for output pixel (Y, X) of one frame: the phase arithmetic locates
// the 4x4 tap window in the padded source, then the shared resolve runs.
template <typename S>
__device__ __forceinline__ void easu_pixel(const S* __restrict__ src, const Params& p, int Y,
                                           int X, float out[3]) {
  const int a = Y % p.qy;
  const int b = X % p.qx;
  const int fy = Y / p.qy + p.ry[a];
  const int fx = X / p.qx + p.rx[b];
  const int64_t plane = (int64_t)p.hp * p.wp;
  const S* base = src + (int64_t)(fy - 1) * p.wp + (fx - 1);

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
  if (p.srtm) srtm_window(t);
  easu_resolve(t, p.px[b], p.py[a], out);
}

template <typename S, typename O, bool RCAS, bool DENOISE>
__global__ void __launch_bounds__(NTHREADS)
    fused_kernel(const S* __restrict__ src, O* __restrict__ dst, Params p) {
  const int64_t n = blockIdx.z;
  const S* s = src + n * 3 * (int64_t)p.hp * p.wp;
  O* o = dst + n * 3 * (int64_t)p.hout * p.wout;
  const int64_t oplane = (int64_t)p.hout * p.wout;
  const EpilogueParams e = p.epi;
  const int wout = p.wout;
  auto finish = [=](int Y, int X, float v[3]) {
    epilogue(e, oplane, (int64_t)Y * wout + X, Y, X, v);
  };
  if constexpr (RCAS) {
    // Ring positions outside the image clamp to the edge pixel.
    auto ring = [=](int Y, int X, float v[3]) {
      easu_pixel(s, p, min(max(Y, 0), p.hout - 1), min(max(X, 0), p.wout - 1), v);
    };
    rcas_tile<DENOISE>(ring, finish, o, p.hout, p.wout, p.sharp);
  } else {
    store_tile([=](int Y, int X, float v[3]) { easu_pixel(s, p, Y, X, v); }, finish, o, p.hout,
               p.wout);
  }
}

template <typename S, typename O>
int launch(const void* src, void* dst, int nb, const Params& p, bool rcas, bool denoise,
           cudaStream_t stream) {
  const int64_t in_frame = 3 * (int64_t)p.hp * p.wp;
  const int64_t out_frame = 3 * (int64_t)p.hout * p.wout;
  return launch_frames(nb, p.hout, p.wout, [&](dim3 grid, int n0) {
    const S* s = static_cast<const S*>(src) + n0 * in_frame;
    O* d = static_cast<O*>(dst) + n0 * out_frame;
    if (!rcas)
      fused_kernel<S, O, false, false><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else if (denoise)
      fused_kernel<S, O, true, true><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else
      fused_kernel<S, O, true, false><<<grid, NTHREADS, 0, stream>>>(s, d, p);
  });
}

}  // namespace

// dtype codes (fsr_pixel.cuh DType): src_dtype is the padded source's
// storage (float32, bfloat16 or uint8), out_dtype the output's: the
// source's float type, or uint8/uint16 codes; a uint8 source may also store
// float32 or bfloat16.  srtm: 1 runs the SRTM prologue; epi: the K5
// epilogue (host struct, device pointers inside).
extern "C" int fsr_upscale_fused(const void* src, void* dst, int src_dtype, int out_dtype, int nb,
                                 int hp, int wp, int hout, int wout, int qy, int qx,
                                 const int* ry, const int* rx, const float* py, const float* px,
                                 float sharp, int apply_rcas, int denoise, int srtm,
                                 const EpilogueParams* epi, void* stream) {
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
  p.srtm = srtm;
  p.epi = epi != nullptr ? *epi : EpilogueParams{};
  if (nb == 0 || hout == 0 || wout == 0) return 0;
  const bool r = apply_rcas != 0;
  const bool dn = denoise != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (src_dtype * 4 + out_dtype) {
    case F32 * 4 + F32: return launch<float, float>(src, dst, nb, p, r, dn, s);
    case F32 * 4 + U8: return launch<float, uint8_t>(src, dst, nb, p, r, dn, s);
    case F32 * 4 + U16: return launch<float, uint16_t>(src, dst, nb, p, r, dn, s);
    case BF16 * 4 + BF16: return launch<bf16, bf16>(src, dst, nb, p, r, dn, s);
    case BF16 * 4 + U8: return launch<bf16, uint8_t>(src, dst, nb, p, r, dn, s);
    case BF16 * 4 + U16: return launch<bf16, uint16_t>(src, dst, nb, p, r, dn, s);
    case U8 * 4 + F32: return launch<uint8_t, float>(src, dst, nb, p, r, dn, s);
    case U8 * 4 + BF16: return launch<uint8_t, bf16>(src, dst, nb, p, r, dn, s);
    case U8 * 4 + U8: return launch<uint8_t, uint8_t>(src, dst, nb, p, r, dn, s);
    case U8 * 4 + U16: return launch<uint8_t, uint16_t>(src, dst, nb, p, r, dn, s);
  }
  return (int)cudaErrorInvalidValue;
}
