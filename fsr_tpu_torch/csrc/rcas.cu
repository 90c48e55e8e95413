// K3: standalone RCAS sharpening (no scaling), border "clamp" or "zero".
//
// Replaces the TPU kernel fsr_tpu/kernels/rcas_pallas.py:rcas_fused
// (pallas_call at rcas_pallas.py:138), which DMAs a tile with a one-pixel
// halo and builds the 5-tap cross with rolls and global-coordinate masks.
// On Hopper one block per TILE_H x TILE_W tile loads the tile and its
// one-pixel halo into shared memory as float32, filling the halo by the
// border rule: the clamped index (edge replication, so the missing
// neighbour is e itself) or 0 outside the image (the sample's imageLoad).
// After one barrier each thread runs the shared RCAS pixel
// (fsr_pixel.cuh: rcas_resolve(fast=True)) and stores once, rounded to the
// storage type.
//
// Storage: the source is float32, bfloat16 or float16, the output any of
// the three; a source wider than the storage type is rounded (RNE) at each
// load, as converting the source first would.  float16 is storage only, as
// the TPU kernel has it (rcas_pallas.py:66-67: f32 math on the widened
// half); the output stays float16 (that kernel returns float32).  A uint8
// image sharpens byte in, byte out (rcas_pallas.py:64-73, :111, :133-134):
// decoded v * float32(1/255) at load, UNORM8 codes of the float32 result at
// the store.  The math is float32.
//
// Bound: device-memory bytes (one read and one write of the image, about
// 85 flops per pixel).  The halo re-reads (1.2x of a 32x16 tile) are served
// by L2.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fsr_pixel.cuh"

using namespace fsr;

namespace {

template <typename T, typename S, bool ZERO, bool DENOISE>
__global__ void __launch_bounds__(NTHREADS)
    rcas_kernel(const S* __restrict__ src, T* __restrict__ dst, int h, int w, float sharp) {
  const int64_t plane = (int64_t)h * w;
  const int64_t n = blockIdx.z;
  const S* s = src + n * 3 * plane;
  T* o = dst + n * 3 * plane;
  // The halo outside the image: the clamped index (the edge pixel), or 0.
  auto ring = [=](int Y, int X, float v[3]) {
    const int Yc = min(max(Y, 0), h - 1);
    const int Xc = min(max(X, 0), w - 1);
    const bool outside = ZERO && (Y != Yc || X != Xc);
    const int64_t at = (int64_t)Yc * w + Xc;
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = outside ? 0.0f : ld_as<T>(s + c * plane + at);
  };
  auto store = [=](int Y, int X, float v[3]) { st3(o, plane, (int64_t)Y * w + X, v); };
  rcas_tile<DENOISE>(ring, store, h, w, sharp);
}

template <typename T, typename S>
int launch(const void* src, void* dst, int nb, int h, int w, float sharp, bool zero,
           bool denoise, cudaStream_t stream) {
  const int64_t frame = 3 * (int64_t)h * w;
  return launch_frames(nb, h, w, [&](dim3 grid, int n0) {
    const S* s = static_cast<const S*>(src) + n0 * frame;
    T* d = static_cast<T*>(dst) + n0 * frame;
    if (zero && denoise)
      rcas_kernel<T, S, true, true><<<grid, NTHREADS, 0, stream>>>(s, d, h, w, sharp);
    else if (zero)
      rcas_kernel<T, S, true, false><<<grid, NTHREADS, 0, stream>>>(s, d, h, w, sharp);
    else if (denoise)
      rcas_kernel<T, S, false, true><<<grid, NTHREADS, 0, stream>>>(s, d, h, w, sharp);
    else
      rcas_kernel<T, S, false, false><<<grid, NTHREADS, 0, stream>>>(s, d, h, w, sharp);
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
