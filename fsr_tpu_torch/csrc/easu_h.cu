// K6: the float16 upscale, EASU in "mixed" precision (+ FsrRcasH), at any
// upscale ratio from 1x to 4x area, with Dynamic Resolution Scaling offsets.
//
// Replaces no pallas_call: the JAX package runs a float16 upscale as two
// jitted XLA programs, fsr_tpu/ops/easu.py:47 (easu, compute_dtype float16,
// precision "mixed") and fsr_tpu/ops/rcas.py:42 (rcas, float16), because
// Mosaic has no float16 vector type on its TPU (fsr_tpu/kernels/fused.py:
// 116-120).  That is the TPU's limit, not the function's: this kernel
// computes what the port's torch path computes for a float16 frame
// (api._upscale with compute_dtype float16), in one launch, bit for bit:
//   - the source rounded to half at its load (a byte decoded first);
//   - EASU "mixed" (fsr_half.cuh:easu_mixed): the direction and length in
//     float32 with the APrx bit tricks, the taps' weights, the single
//     accumulation chain, the reciprocal and the dering clamp in half;
//   - with RCAS, FsrRcasH (fsr_half.cuh:rcas_h) on the half-rounded EASU
//     values, the border clamped in output coordinates;
//   - RGBA: alpha as ops.easu.bilinear computes it on the source's alpha
//     plane (float32 after the source-type difference), stored as half,
//     never sharpened.
// The output is float16.  The SRTM prologue, the K5 epilogue and byte
// outputs stay torch passes around this kernel (api._upscale), as JAX runs
// them as passes of their own.
//
// Design: K2's (easu_gather.cu), from the same host tables
// (kernels/easu_gather.py:plan, footprint): one block per TH x TILE_W output
// tile; the block's source footprint staged once in shared memory, each
// texel as three halves and the float32 of its half luma (and alpha beside
// it); the block's slice of the tables as offsets into the footprint;
// barrier; EASU for the tile and its one-pixel RCAS ring into a ring of
// halves; barrier; RCAS and one store per pixel.  Ring slots outside the
// frame hold the edge pixel's value (the tables repeat the edge row; ring
// columns clamp to the image), so RCAS sees e in place of a missing
// neighbour.
//
// Bound: per output pixel ~100 float32 operations for the direction and
// ~390 half operations in all (EASU_OPS + RCAS_OPS of chip_smoke.py, 488.75),
// issued one lane at a time (no half2 packing yet) plus the ring's
// recompute (1.129x at 32 x 32); device memory moves one read of the
// source and one write of the half output.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fsr_half.cuh"
#include "fsr_pixel.cuh"

using namespace fsr;

namespace {

constexpr int TH = 32;            // the tile's rows (its columns: TILE_W)
constexpr int RH = TH + 2;        // the RCAS ring's rows
constexpr int FP_H = RH + 3;      // the footprint's rows at most: ring rows and taps -1..2
constexpr int FP_W = RING_W + 3;  // its columns at most

struct HParams {
  const int* rows;   // rows[k * rstride + Y]: source row of tap dy = k - 1 of output row Y = -1..hout
  const int* cols;   // [4][wout]: clip(fx + dx, 0, win - 1) for dx = -1..2
  const float* py;   // py[Y]: subpixel row fraction of output row Y = -1..hout
  const float* px;   // [wout] subpixel column fraction
  int hin, win;
  int hout, wout;
  int rstride;  // hout + 2: the length of a row table
  float sharp;  // RCAS sharpness as a half (sharpness_f16)
};

// One block's footprint, table slice and ring.  A tap of ring row ly and
// ring column lx, at offsets dy, dx = -1..2, is texel row[ly][dy + 1] +
// col[lx][dx + 1] of the footprint.
template <bool RGBA>
struct StageH {
  uint2 rgb[FP_H * FP_W];               // r | g << 16, b: the texel's halves
  float lum[FP_H * FP_W];               // its half luma, widened
  float alpha[RGBA ? FP_H * FP_W : 1];  // RGBA: the source's alpha as loaded (a byte decoded)
  int4 col[RING_W];
  float px[RING_W];
  int4 row[RH];
  float py[RH];
  __half ring[3][RH][RING_W];  // EASU of the tile and its ring, in half
};

// Load the block's footprint of one frame's source and its table slice,
// then a barrier: K2's rule (easu_gather.cu:stage).
template <typename S, bool RGBA>
__device__ __forceinline__ void stage(StageH<RGBA>& st, const S* __restrict__ src, const HParams& p) {
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TH;
  const int r0 = __ldg(p.rows + y0 - 1);
  const int c0 = __ldg(p.cols + max(x0 - 1, 0));
  const int fh = __ldg(p.rows + 3 * p.rstride + min(y0 + TH, p.hout)) - r0 + 1;
  const int fw = __ldg(p.cols + 3 * p.wout + min(x0 + TILE_W, p.wout - 1)) - c0 + 1;
  if (fh > FP_H || fw > FP_W) __trap();  // the host's footprint check failed to hold
  const int64_t plane = (int64_t)p.hin * p.win;
  const S* base = src + (int64_t)r0 * p.win + c0;
  for (int k = threadIdx.x; k < fh * fw; k += NTHREADS) {
    const int r = k / fw;
    const S* at = base + (int64_t)r * p.win + (k - r * fw);
    const __half cr = h16::to_half(at), cg = h16::to_half(at + plane), cb = h16::to_half(at + 2 * plane);
    st.rgb[k] = make_uint2(__half_as_ushort(cr) | (unsigned)__half_as_ushort(cg) << 16, __half_as_ushort(cb));
    st.lum[k] = __half2float(h16::luma(cr, cg, cb));
    if constexpr (RGBA) st.alpha[k] = ld(at + 3 * plane);  // widened exactly, a byte decoded
  }
  for (int i = threadIdx.x; i < RING_W + RH; i += NTHREADS) {
    if (i < RING_W) {
      const int* c = p.cols + min(max(x0 + i - 1, 0), p.wout - 1);
      const int w = p.wout;
      st.col[i] = make_int4(__ldg(c) - c0, __ldg(c + w) - c0, __ldg(c + 2 * w) - c0, __ldg(c + 3 * w) - c0);
      st.px[i] = __ldg(p.px + (c - p.cols));
    } else {
      const int ly = i - RING_W;
      const int Y = min(y0 + ly - 1, p.hout);
      const int* r = p.rows + Y;
      const int rs = p.rstride;
      st.row[ly] = make_int4(fw * (__ldg(r) - r0), fw * (__ldg(r + rs) - r0), fw * (__ldg(r + 2 * rs) - r0),
                             fw * (__ldg(r + 3 * rs) - r0));
      st.py[ly] = __ldg(p.py + Y);
    }
  }
  __syncthreads();
}

// EASU of ring pixel (ly, lx) from the staged footprint.
template <bool RGBA>
__device__ __forceinline__ void easu_staged(const StageH<RGBA>& st, int ly, int lx, __half out[3]) {
  const int4 cv = st.col[lx];
  const int4 rv = st.row[ly];
  const int co[4] = {cv.x, cv.y, cv.z, cv.w};
  const int ro[4] = {rv.x, rv.y, rv.z, rv.w};
  __half t[3][4][4];
  float L[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((r == 0 || r == 3) && (q == 0 || q == 3)) continue;  // the corners are unused
      const int i = ro[r] + co[q];
      const uint2 v = st.rgb[i];
      t[0][r][q] = __ushort_as_half((unsigned short)(v.x & 0xFFFFu));
      t[1][r][q] = __ushort_as_half((unsigned short)(v.x >> 16));
      t[2][r][q] = __ushort_as_half((unsigned short)v.y);
      L[r][q] = st.lum[i];
    }
  }
  h16::easu_mixed(t, L, st.px[lx], st.py[ly], out);
}

template <typename S, bool RCAS, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NTHREADS)
    easu_h_kernel(const S* __restrict__ src, __half* __restrict__ dst, HParams p) {
  constexpr int C = RGBA ? 4 : 3;
  __shared__ StageH<RGBA> st;
  const int64_t n = blockIdx.z;
  stage<S>(st, src + n * C * (int64_t)p.hin * p.win, p);
  __half* o = dst + n * C * (int64_t)p.hout * p.wout;
  const int64_t oplane = (int64_t)p.hout * p.wout;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TH;
  auto store = [&](int ly, int lx, const __half v[3]) {
    // (ly, lx): the pixel's ring coordinates, one past its tile's.
    const int64_t at = (int64_t)(y0 + ly - 1) * p.wout + (x0 + lx - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c * oplane + at] = v[c];
    if constexpr (RGBA) {
      const int4 cv = st.col[lx];
      const int4 rv = st.row[ly];
      const float* a = st.alpha;
      o[3 * oplane + at] = __float2half_rn(h16::bilinear_alpha<S>(
          a[rv.y + cv.y], a[rv.y + cv.z], a[rv.z + cv.y], a[rv.z + cv.z], st.px[lx], st.py[ly]));
    }
  };
  if constexpr (RCAS) {
    for (int k = threadIdx.x; k < RH * RING_W; k += NTHREADS) {
      const int ly = k / RING_W;
      const int lx = k % RING_W;
      __half v[3];
      easu_staged(st, ly, lx, v);
#pragma unroll
      for (int c = 0; c < 3; ++c) st.ring[c][ly][lx] = v[c];
    }
    __syncthreads();
    const __half sharp = __float2half_rn(p.sharp);
    for (int k = threadIdx.x; k < TILE_W * TH; k += NTHREADS) {
      const int ly = k / TILE_W;
      const int lx = k % TILE_W;
      if (y0 + ly >= p.hout || x0 + lx >= p.wout) continue;
      __half b[3], d[3], e[3], f[3], hh[3], v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        b[c] = st.ring[c][ly][lx + 1];
        d[c] = st.ring[c][ly + 1][lx];
        e[c] = st.ring[c][ly + 1][lx + 1];
        f[c] = st.ring[c][ly + 1][lx + 2];
        hh[c] = st.ring[c][ly + 2][lx + 1];
      }
      h16::rcas_h<DENOISE>(b, d, e, f, hh, sharp, v);
      store(ly + 1, lx + 1, v);
    }
  } else {
    for (int k = threadIdx.x; k < TILE_W * TH; k += NTHREADS) {
      const int ly = k / TILE_W;
      const int lx = k % TILE_W;
      if (y0 + ly >= p.hout || x0 + lx >= p.wout) continue;
      __half v[3];
      easu_staged(st, ly + 1, lx + 1, v);
      store(ly + 1, lx + 1, v);
    }
  }
}

template <typename S, bool RGBA>
int launch_planes(const void* src, void* dst, int nb, const HParams& p, bool rcas, bool denoise,
                  cudaStream_t stream) {
  constexpr int C = RGBA ? 4 : 3;
  const int64_t in_frame = C * (int64_t)p.hin * p.win;
  const int64_t out_frame = C * (int64_t)p.hout * p.wout;
  return launch_frames<TH>(nb, p.hout, p.wout, [&](dim3 grid, int n0) {
    const S* s = static_cast<const S*>(src) + n0 * in_frame;
    __half* d = static_cast<__half*>(dst) + n0 * out_frame;
    if (!rcas)
      easu_h_kernel<S, false, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else if (denoise)
      easu_h_kernel<S, true, true, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
    else
      easu_h_kernel<S, true, false, RGBA><<<grid, NTHREADS, 0, stream>>>(s, d, p);
  });
}

template <typename S>
int launch(const void* src, void* dst, int nb, int channels, const HParams& p, bool rcas, bool denoise,
           cudaStream_t stream) {
  return channels == 4 ? launch_planes<S, true>(src, dst, nb, p, rcas, denoise, stream)
                       : launch_planes<S, false>(src, dst, nb, p, rcas, denoise, stream);
}

}  // namespace

// src_dtype: the source's dtype code (fsr_pixel.cuh DType: float16,
// float32, bfloat16 or uint8); the output is float16.  channels: 3, or 4
// with alpha in plane 3 of the source and the output.  rows/cols (int32
// [4][hout + 2], [4][wout]) and py/px (float32 [hout + 2], [wout]) are
// device pointers, K2's tables; the row tables cover output rows -1..hout.
// sharp: sharpness_f16.
extern "C" int fsr_easu_h(const void* src, void* dst, int src_dtype, int nb, int channels, int hin, int win,
                          int hout, int wout, const void* rows, const void* cols, const void* py, const void* px,
                          float sharp, int apply_rcas, int denoise, void* stream) {
  HParams p;
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
  if (nb == 0 || hout == 0 || wout == 0) return 0;
  if (channels != 3 && channels != 4) return (int)cudaErrorInvalidValue;
  const bool r = apply_rcas != 0;
  const bool dn = denoise != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (src_dtype) {
    case F16:
      return launch<__half>(src, dst, nb, channels, p, r, dn, s);
    case F32:
      return launch<float>(src, dst, nb, channels, p, r, dn, s);
    case BF16:
      return launch<__nv_bfloat16>(src, dst, nb, channels, p, r, dn, s);
    case U8:
      return launch<uint8_t>(src, dst, nb, channels, p, r, dn, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
