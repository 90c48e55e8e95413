// K3: standalone RCAS sharpening (no scaling), border "clamp" or "zero".
//
// Replaces the TPU kernel fsr_tpu/kernels/rcas_pallas.py:rcas_fused
// (pallas_call at rcas_pallas.py:138), which DMAs a tile with a one-pixel
// halo and builds the 5-tap cross with rolls and global-coordinate masks.
//
// Design: a 16-byte vector tile.  One block per TILE3_H x TILE3_W (16 x 128)
// tile of one frame, in two steps.
//   Stage: the tile and its one-pixel halo, three planes, into shared memory
//     as float32, each element converted once by the load rule below.  Rows
//     are read as aligned 16-byte vectors of the source type (4 float32, 8
//     bfloat16 or float16, 16 uint8 elements), one per thread and item;
//     where a vector leaves the image or its address is not 16-byte aligned
//     (a ragged width, an unaligned row start), element by element.  The
//     border rule applies only there and in the halo bands: outside the
//     image an element takes the clamped index (edge replication, so the
//     missing neighbour is e itself) or 0 (the sample's imageLoad).  Each
//     staged row keeps the tile's columns at 16-byte-aligned offsets, in
//     chunks of one RCAS thread's pixels with a 16-byte gap between chunks
//     for the small types (Row: the RCAS pass's float4 loads then meet no
//     bank conflict), the left halo just before and the right halo just
//     after.
//   Barrier.  Each thread takes V consecutive pixels of one tile row, V the
//     output's elements per 16-byte vector (4 float32, 8 bfloat16 or
//     float16, 16 uint8), four at a time: per plane the row above, the row
//     and the row below as float4 shared loads plus the two elements beside
//     them, then the shared RCAS pixel (fsr_pixel.cuh: rcas_resolve(fast=
//     True)) per pixel on those values, unchanged, and one 16-byte store per
//     plane, rounded to the storage type (element by element where the
//     vector leaves the image or is unaligned).
//
// Storage: the source is float32, bfloat16 or float16, the output any of
// the three; a source wider than the storage type is rounded (RNE) at its
// load, as converting the source first would.  float16 is storage only, as
// the TPU kernel has it (rcas_pallas.py:66-67: f32 math on the widened
// half); the output stays float16 (that kernel returns float32).  A uint8
// image sharpens byte in, byte out (rcas_pallas.py:64-73, :111, :133-134):
// decoded v * float32(1/255) at load, UNORM8 codes of the float32 result at
// the store.  The math is float32.
//
// Bound: device-memory bytes (one read and one write of the image, about
// 96 flops per pixel).  The halo re-reads (18/16 rows, 130/128 columns) are
// served by L2.  The design before this one (one thread per pixel on 32 x 16
// tiles: three scalar loads with their clamps and 64-bit addresses per ring
// slot, three scalar stores per pixel) was bound by its instruction stream:
// its uint8 pass took 75% of its float32 one for a quarter of the bytes.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fsr_pixel.cuh"

using namespace fsr;

namespace {

constexpr int TILE3_H = 16;
constexpr int TILE3_W = 128;
constexpr int VEC = 16;                 // bytes of one vector
constexpr int LEAD = 8;                 // the tile's first column in a staged row
constexpr int SRH = TILE3_H + 2;        // staged rows: the tile's and the halo's

// Threads per SM the register allocation must allow (__launch_bounds__;
// 0: no bound).  1024 caps every instantiation at 64 registers: the fastest
// of 0 (78-109 registers), 768 and 1024 for float32, bfloat16 and float16,
// in turn (tools_torch/ablation/kernel_ab.py --define ...); the bfloat16,
// float16 and uint8 kernels then spill under 50 bytes.
#ifndef FSR_K3_MIN_THREADS
#define FSR_K3_MIN_THREADS 1024
#endif

// Threads of a block whose output type is T: one per V-element vector of
// each tile row, at most 256 (float32 takes two passes over the rows); and
// the blocks per SM that FSR_K3_MIN_THREADS asks for.
template <typename T>
struct Threads {
  static constexpr int per_tile = TILE3_W / (VEC / (int)sizeof(T)) * TILE3_H;
  static constexpr int n = per_tile < 256 ? per_tile : 256;
  static constexpr int min_blocks = FSR_K3_MIN_THREADS / n > 1 ? FSR_K3_MIN_THREADS / n : 1;
};

// A staged row of a block whose output type is T: the tile's columns in
// chunks of V = 16 / sizeof(T), one chunk per thread of the RCAS pass, each
// chunk followed by PAD unused floats when V > 4.  A thread's float4 loads
// then lie 4 + V floats (12 or 20 words) apart across a warp, which maps
// eight lanes onto all 32 banks; at V = 8 or 16 without the gap they would
// fall on 8 or 4 banks and conflict.  Column x of the tile (-1 and TILE3_W
// the halo's) is float at(x) of the row.
template <typename T>
struct Row {
  static constexpr int V = VEC / (int)sizeof(T);
  static constexpr int PAD = V == 4 ? 0 : 4;
  static constexpr int n = LEAD + TILE3_W + PAD * (TILE3_W / V) + 4;
  static __device__ __forceinline__ int at(int x) { return LEAD + x + PAD * (x >= 0 ? x / V : -1); }
};

// 16 bytes as elements of type S.
template <typename S>
union Vec {
  uint4 u;
  S e[VEC / sizeof(S)];
};

template <typename T, typename S, bool ZERO, bool DENOISE>
__global__ void __launch_bounds__(Threads<T>::n, Threads<T>::min_blocks)
    rcas_kernel(const S* __restrict__ src, T* __restrict__ dst, int h, int w, float sharp) {
  constexpr int NT = Threads<T>::n;
  constexpr int VS = VEC / sizeof(S);  // source elements per vector
  constexpr int V = VEC / sizeof(T);   // output elements per vector
  using R = Row<T>;
  __shared__ __align__(16) float sm[3][SRH][R::n];
  const int64_t plane = (int64_t)h * w;
  const int64_t n = blockIdx.z;
  const S* s = src + n * 3 * plane;
  T* o = dst + n * 3 * plane;
  const int y0 = blockIdx.y * TILE3_H;
  const int x0 = blockIdx.x * TILE3_W;

  // Element (Y, X) of plane c by the border rule.
  auto at = [&](int c, int Y, int X) {
    const int Yc = min(max(Y, 0), h - 1);
    const int Xc = min(max(X, 0), w - 1);
    if (ZERO && (Y != Yc || X != Xc)) return 0.0f;
    return ld_as<T>(s + c * plane + (int64_t)Yc * w + Xc);
  };

  // Stage: the tile's columns as source vectors, then the halo columns.
  constexpr int ROW_VECS = TILE3_W / VS;
  for (int k = threadIdx.x; k < SRH * ROW_VECS; k += NT) {
    const int r = k / ROW_VECS;
    const int lx = (k - r * ROW_VECS) * VS;
    const int Y = y0 - 1 + r;
    const int X = x0 + lx;
    const int64_t off = (int64_t)Y * w + X;
    const bool vec = Y >= 0 && Y < h && X + VS <= w && ((uintptr_t)(s + off) & (VEC - 1)) == 0 &&
                     (plane * sizeof(S)) % VEC == 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float e[VS];
      if (vec) {
        Vec<S> v;
        v.u = __ldg(reinterpret_cast<const uint4*>(s + c * plane + off));
#pragma unroll
        for (int i = 0; i < VS; ++i) e[i] = ld_as<T>(&v.e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < VS; ++i) e[i] = at(c, Y, X + i);
      }
#pragma unroll
      for (int i = 0; i < VS; i += 4)
        *reinterpret_cast<float4*>(&sm[c][r][R::at(lx + i)]) = make_float4(e[i], e[i + 1], e[i + 2], e[i + 3]);
    }
  }
  for (int k = threadIdx.x; k < 2 * SRH; k += NT) {
    const int r = k >> 1;
    const int side = k & 1;
    const int Y = y0 - 1 + r;
    const int X = side ? x0 + TILE3_W : x0 - 1;
#pragma unroll
    for (int c = 0; c < 3; ++c) sm[c][r][R::at(side ? TILE3_W : -1)] = at(c, Y, X);
  }
  __syncthreads();

  // RCAS: V consecutive pixels of one tile row per thread and pass.
  constexpr int PER_ROW = TILE3_W / V;
  for (int k = threadIdx.x; k < TILE3_H * PER_ROW; k += NT) {
    const int ly = k / PER_ROW;
    const int lx = (k - ly * PER_ROW) * V;
    const int Y = y0 + ly;
    const int X = x0 + lx;
    if (Y >= h || X >= w) continue;
    // The chunk's first float; the columns before and after it lie PAD
    // floats further out.
    const int base = R::at(lx);
    Vec<T> out[3];
#pragma unroll
    for (int g = 0; g < V; g += 4) {
      float4 up[3], mid[3], dn[3];
      float lf[3], rt[3];
      const int i = base + g;
      const int il = g == 0 ? base - 1 - R::PAD : i - 1;
      const int ir = g + 4 == V ? base + V + R::PAD : i + 4;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        up[c] = *reinterpret_cast<const float4*>(&sm[c][ly][i]);
        mid[c] = *reinterpret_cast<const float4*>(&sm[c][ly + 1][i]);
        dn[c] = *reinterpret_cast<const float4*>(&sm[c][ly + 2][i]);
        lf[c] = sm[c][ly + 1][il];
        rt[c] = sm[c][ly + 1][ir];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[3], d[3], e[3], f[3], hh[3], v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float m[6] = {lf[c], mid[c].x, mid[c].y, mid[c].z, mid[c].w, rt[c]};
          const float u[4] = {up[c].x, up[c].y, up[c].z, up[c].w};
          const float l[4] = {dn[c].x, dn[c].y, dn[c].z, dn[c].w};
          b[c] = u[q];
          d[c] = m[q];
          e[c] = m[q + 1];
          f[c] = m[q + 2];
          hh[c] = l[q];
        }
        rcas_pixel<DENOISE>(b, d, e, f, hh, sharp, v);
#pragma unroll
        for (int c = 0; c < 3; ++c) st(&out[c].e[g + q], v[c]);
      }
    }
    const int64_t off = (int64_t)Y * w + X;
    const bool vec = X + V <= w && ((uintptr_t)(o + off) & (VEC - 1)) == 0 && (plane * sizeof(T)) % VEC == 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T* d = o + c * plane + off;
      if (vec) {
        *reinterpret_cast<uint4*>(d) = out[c].u;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (X + i < w) d[i] = out[c].e[i];
      }
    }
  }
}

template <typename T, typename S>
int launch(const void* src, void* dst, int nb, int h, int w, float sharp, bool zero,
           bool denoise, cudaStream_t stream) {
  constexpr int NT = Threads<T>::n;
  const int64_t frame = 3 * (int64_t)h * w;
  return launch_frames<TILE3_H, TILE3_W>(nb, h, w, [&](dim3 grid, int n0) {
    const S* s = static_cast<const S*>(src) + n0 * frame;
    T* d = static_cast<T*>(dst) + n0 * frame;
    if (zero && denoise)
      rcas_kernel<T, S, true, true><<<grid, NT, 0, stream>>>(s, d, h, w, sharp);
    else if (zero)
      rcas_kernel<T, S, true, false><<<grid, NT, 0, stream>>>(s, d, h, w, sharp);
    else if (denoise)
      rcas_kernel<T, S, false, true><<<grid, NT, 0, stream>>>(s, d, h, w, sharp);
    else
      rcas_kernel<T, S, false, false><<<grid, NT, 0, stream>>>(s, d, h, w, sharp);
  });
}

// Storage type T from a float source of any of the three float types.
template <typename T>
int launch_from(const void* src, void* dst, int src_dtype, int nb, int h, int w, float sharp,
                bool zero, bool denoise, cudaStream_t stream) {
  switch (src_dtype) {
    case F32: return launch<T, float>(src, dst, nb, h, w, sharp, zero, denoise, stream);
    case BF16: return launch<T, __nv_bfloat16>(src, dst, nb, h, w, sharp, zero, denoise, stream);
    case F16: return launch<T, __half>(src, dst, nb, h, w, sharp, zero, denoise, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes (fsr_pixel.cuh DType): src_dtype is the source's, dtype the
// output's: float32/bfloat16/float16 from any of them, or uint8 from uint8.
// border_zero: 0 = clamp, 1 = zero.
extern "C" int fsr_rcas(const void* src, void* dst, int src_dtype, int dtype, int nb, int h,
                        int w, float sharp, int border_zero, int denoise, void* stream) {
  if (nb == 0 || h == 0 || w == 0) return 0;
  const bool z = border_zero != 0;
  const bool dn = denoise != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch_from<float>(src, dst, src_dtype, nb, h, w, sharp, z, dn, s);
    case BF16: return launch_from<__nv_bfloat16>(src, dst, src_dtype, nb, h, w, sharp, z, dn, s);
    case F16: return launch_from<__half>(src, dst, src_dtype, nb, h, w, sharp, z, dn, s);
    case U8:
      if (src_dtype == U8) return launch<uint8_t, uint8_t>(src, dst, nb, h, w, sharp, z, dn, s);
  }
  return (int)cudaErrorInvalidValue;
}
