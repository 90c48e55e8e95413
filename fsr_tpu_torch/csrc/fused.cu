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
// RGBA (fused.py:929-943, :1052-1056, :1120-1122): a fourth plane rides in
// the padded source and the output.  RGB is computed as for three
// channels.  Alpha never enters the RCAS ring (RCAS passes it through): the
// store pass resolves it per output pixel, bilinearly from four loads at
// the phase's 'f' texel and its right, lower and lower-right neighbours
// (the K4 edge pad is the CLAMP of ops.easu.bilinear), decoded as the
// colour is, never tonemapped by the prologue nor touched by the epilogue,
// and stores it by the colour's rule.  The channel count is a template
// parameter (RGBA), so the RGB kernels carry no alpha code.
//
// Row strips (fused.py:412-437, :1174-1184; parallel/spatial.py): the
// output may be rows row0 .. row0 + hout - 1 of a frame of global_rows rows,
// computed from the strip's rows with a halo around them.  The ring's rows
// clamp to [ylo, yhi]: [0, hout - 1] for a whole frame, and -1 or hout where
// the strip has a neighbour row, which the ring then computes from the halo
// as the whole frame's EASU would; only global row 0 and global_rows - 1
// clamp.  The epilogue's dither takes the global row (EpilogueParams.row0),
// the grain stays the strip's own.  The kernel stores the strip's own rows.
//
// Each output pixel (Y, X) lies in phase (a, b) = (Y mod qy, X mod qx) with
// 'f' texel (floor(Y / qy) + ry[a], floor(X / qx) + rx[b]) in the padded
// source and constant subpixel fractions (py[a], px[b]).  qy and qx are 1, 2
// or 4, so the kernel takes their logarithms and shifts and masks, which
// floor as the phase arithmetic needs at the ring's row -1 (C's / and %
// truncate toward zero there).  The host derives ry, rx, py, px from the
// float32 coordinate tables (fused.py:_phase_structure); the device never
// recomputes x*sx+ox or floor(), which an FMA contraction would flip at
// integer positions.  The source is pre-padded by K4 far enough that no load
// needs bounds logic.
//
// Bound: f32 arithmetic.  Per output pixel it reads 12 taps x 3 channels
// (mostly from L1/L2: a 2x2 quad of outputs shares its taps) and runs a
// few hundred flops; device-memory traffic is one read of the source and
// one write of the output, plus 12 bytes of grain per pixel when LFGA is on;
// RGBA adds its alpha plane to both, four loads (from L1) and 8 flops per
// output pixel.
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
  int ly, lx;  // log2 of the phase counts qy, qx
  int ry[4], rx[4];  // padded-frame row/col of phase a/b's 'f' texel at plane index 0
  float py[4], px[4];
  int hp, wp;  // padded source extent
  int hout, wout;
  int ylo, yhi;  // the RCAS ring's row clamp (row strips: -1 / hout at a neighbour)
  float sharp;  // linear RCAS sharpness
  int srtm;     // SRTM prologue on each loaded texel
  EpilogueParams epi;
};

// EASU for output pixel (Y, X) of one frame: the phase arithmetic locates
// the 4x4 tap window in the padded source, then the shared resolve runs.
template <typename S>
__device__ __forceinline__ void easu_pixel(const S* __restrict__ src, const Params& p, int Y,
                                           int X, float out[3]) {
  const int a = Y & ((1 << p.ly) - 1);
  const int b = X & ((1 << p.lx) - 1);
  const int fy = (Y >> p.ly) + p.ry[a];
  const int fx = (X >> p.lx) + p.rx[b];
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

// Bilinear alpha for output pixel (Y, X) of one frame: the texels from the
// phase's 'f' to its lower-right neighbour in the padded alpha plane.
template <typename S>
__device__ __forceinline__ float alpha_pixel(const S* __restrict__ src, const Params& p, int Y,
                                             int X) {
  const int a = Y & ((1 << p.ly) - 1);
  const int b = X & ((1 << p.lx) - 1);
  const int64_t plane = (int64_t)p.hp * p.wp;
  const S* q = src + 3 * plane + (int64_t)((Y >> p.ly) + p.ry[a]) * p.wp + ((X >> p.lx) + p.rx[b]);
  return bilinear_alpha(ld(q), ld(q + 1), ld(q + p.wp), ld(q + p.wp + 1), p.px[b], p.py[a]);
}

// RGBA's view of one frame: the source and a per-thread copy of the
// parameters, which both passes index per pixel (the phase tables).  One
// copy, on the stack, shared by the EASU pass and the store pass's alpha: a
// copy captured by each pass doubled the stack to 368 bytes and K1's time
// with it on the H100, and reading the tables from the parameter bank with
// per-thread indices serialises a warp (PERF.md).
template <typename S>
struct Frame {
  const S* s;
  Params p;
  __device__ __forceinline__ void easu(int Y, int X, float v[3]) const {
    easu_pixel(s, p, Y, X, v);
  }
  __device__ __forceinline__ float alpha(int Y, int X) const { return alpha_pixel(s, p, Y, X); }
};

template <typename S, typename O, bool RCAS, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NTHREADS)
    fused_kernel(const S* __restrict__ src, O* __restrict__ dst, Params p) {
  constexpr int C = RGBA ? 4 : 3;
  const int64_t n = blockIdx.z;
  const S* s = src + n * C * (int64_t)p.hp * p.wp;
  O* o = dst + n * C * (int64_t)p.hout * p.wout;
  const int64_t oplane = (int64_t)p.hout * p.wout;
  const EpilogueParams e = p.epi;
  const int wout = p.wout;
  if constexpr (RGBA) {
    const Frame<S> f{s, p};
    auto store = [&f, o, oplane, e, wout](int Y, int X, float v[3]) {
      const int64_t at = (int64_t)Y * wout + X;
      epilogue(e, oplane, at, Y, X, v);
      st4(o, oplane, at, v, f.alpha(Y, X));
    };
    if constexpr (RCAS) {
      // Ring positions outside the image clamp to the edge pixel.
      const int ylo = p.ylo, yhi = p.yhi;
      auto ring = [&f, ylo, yhi, wout](int Y, int X, float v[3]) {
        f.easu(min(max(Y, ylo), yhi), min(max(X, 0), wout - 1), v);
      };
      rcas_tile<DENOISE>(ring, store, p.hout, p.wout, p.sharp);
    } else {
      store_tile([&f](int Y, int X, float v[3]) { f.easu(Y, X, v); }, store, p.hout, p.wout);
    }
  } else {
    // RGB keeps its own form: each pass captures what it uses.  Sharing the
    // Frame here cost the RGB kernels 7 registers and up to 13% of their time
    // on the prologue path (PERF.md).
    auto store = [=](int Y, int X, float v[3]) {
      const int64_t at = (int64_t)Y * wout + X;
      epilogue(e, oplane, at, Y, X, v);
      st3(o, oplane, at, v);
    };
    if constexpr (RCAS) {
      // Ring positions outside the image clamp to the edge pixel.
      auto ring = [=](int Y, int X, float v[3]) {
        easu_pixel(s, p, min(max(Y, p.ylo), p.yhi), min(max(X, 0), p.wout - 1), v);
      };
      rcas_tile<DENOISE>(ring, store, p.hout, p.wout, p.sharp);
    } else {
      store_tile([=](int Y, int X, float v[3]) { easu_pixel(s, p, Y, X, v); }, store, p.hout,
                 p.wout);
    }
  }
}

template <typename S, typename O, bool RGBA>
int launch_planes(const void* src, void* dst, int nb, const Params& p, bool rcas, bool denoise,
                  cudaStream_t stream) {
  constexpr int C = RGBA ? 4 : 3;
  const int64_t in_frame = C * (int64_t)p.hp * p.wp;
  const int64_t out_frame = C * (int64_t)p.hout * p.wout;
  return launch_frames(nb, p.hout, p.wout, [&](dim3 grid, int n0) {
    const S* s = static_cast<const S*>(src) + n0 * in_frame;
    O* d = static_cast<O*>(dst) + n0 * out_frame;
    if (!rcas)
      fused_kernel<S, O, false, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else if (denoise)
      fused_kernel<S, O, true, true, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else
      fused_kernel<S, O, true, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
  });
}

// The channel count is a template parameter, so the RGB kernels carry no
// alpha code.
template <typename S, typename O>
int launch(const void* src, void* dst, int nb, int channels, const Params& p, bool rcas,
           bool denoise, cudaStream_t stream) {
  return channels == 4 ? launch_planes<S, O, true>(src, dst, nb, p, rcas, denoise, stream)
                       : launch_planes<S, O, false>(src, dst, nb, p, rcas, denoise, stream);
}

// One case label per (source, output) dtype pair; every DType code is < 8.
constexpr int pair(int src_dtype, int out_dtype) { return src_dtype * 8 + out_dtype; }

}  // namespace

// dtype codes (fsr_pixel.cuh DType): src_dtype is the padded source's
// storage (float32, bfloat16 or uint8), out_dtype the output's: the
// source's float type, or uint8/uint16 codes; a uint8 source may also store
// float32 or bfloat16.  channels: 3, or 4 with alpha in plane 3 of the
// source and the output.  qy, qx: 1, 2 or 4.  srtm: 1 runs the SRTM
// prologue; ylo, yhi: the ring's row clamp; epi: the K5 epilogue (host
// struct, device pointers inside).
extern "C" int fsr_upscale_fused(const void* src, void* dst, int src_dtype, int out_dtype, int nb,
                                 int channels, int hp, int wp, int hout, int wout, int qy, int qx,
                                 const int* ry, const int* rx, const float* py, const float* px,
                                 float sharp, int apply_rcas, int denoise, int srtm, int ylo,
                                 int yhi, const EpilogueParams* epi, void* stream) {
  if ((qy != 1 && qy != 2 && qy != 4) || (qx != 1 && qx != 2 && qx != 4))
    return (int)cudaErrorInvalidValue;
  if (channels != 3 && channels != 4) return (int)cudaErrorInvalidValue;
  if (ylo < -1 || ylo > 0 || yhi < hout - 1 || yhi > hout) return (int)cudaErrorInvalidValue;
  Params p;
  p.ly = qy / 2;  // log2 of 1, 2, 4
  p.lx = qx / 2;
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
  p.ylo = ylo;
  p.yhi = yhi;
  p.sharp = sharp;
  p.srtm = srtm;
  p.epi = epi != nullptr ? *epi : EpilogueParams{};
  if (nb == 0 || hout == 0 || wout == 0) return 0;
  const bool r = apply_rcas != 0;
  const bool dn = denoise != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (pair(src_dtype, out_dtype)) {
    case pair(F32, F32): return launch<float, float>(src, dst, nb, channels, p, r, dn, s);
    case pair(F32, U8): return launch<float, uint8_t>(src, dst, nb, channels, p, r, dn, s);
    case pair(F32, U16): return launch<float, uint16_t>(src, dst, nb, channels, p, r, dn, s);
    case pair(BF16, BF16): return launch<bf16, bf16>(src, dst, nb, channels, p, r, dn, s);
    case pair(BF16, U8): return launch<bf16, uint8_t>(src, dst, nb, channels, p, r, dn, s);
    case pair(BF16, U16): return launch<bf16, uint16_t>(src, dst, nb, channels, p, r, dn, s);
    case pair(U8, F32): return launch<uint8_t, float>(src, dst, nb, channels, p, r, dn, s);
    case pair(U8, BF16): return launch<uint8_t, bf16>(src, dst, nb, channels, p, r, dn, s);
    case pair(U8, U8): return launch<uint8_t, uint8_t>(src, dst, nb, channels, p, r, dn, s);
    case pair(U8, U16): return launch<uint8_t, uint16_t>(src, dst, nb, channels, p, r, dn, s);
  }
  return (int)cudaErrorInvalidValue;
}
