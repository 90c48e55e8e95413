// K4: edge-replicating pad of the last two axes plus a dtype convert, in
// one pass.
//
// Replaces the TPU kernel fsr_tpu/kernels/pad.py:edge_pad (pallas_call at
// pad.py:132), which DMAs clamped row windows and realigns them with rolls.
// On Hopper the same result is one thread per output element reading the
// source at clamped indices: neighbouring threads read neighbouring
// addresses, so the loads coalesce and the L1/L2 caches serve the replicated
// border rows.
//
// Bound: device-memory bytes (one read of the source, one write of the
// padded copy; no arithmetic to speak of).  The design keeps it to that
// single pass; folding the pad into K1's loads removes it altogether and is
// later work.
//
// Bit-equal to the plain version (a clamped-index gather followed by a
// round-to-nearest-even convert): f32->bf16 uses __float2bfloat16_rn,
// bf16->f32 is exact, and a same-type pad copies bits.  A uint8 source pads
// as bytes (fused.py:583-592): K1 decodes them at its loads.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename Tin, typename Tout>
__global__ void edge_pad_kernel(const Tin* __restrict__ src, Tout* __restrict__ dst,
                                int64_t total, int h, int w, int hout, int wout,
                                int pt, int pl) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int x = (int)(i % wout);
    const int64_t t = i / wout;
    const int y = (int)(t % hout);
    const int64_t plane = t / hout;
    const int sy = min(max(y - pt, 0), h - 1);
    const int sx = min(max(x - pl, 0), w - 1);
    const Tin v = src[(plane * h + sy) * w + sx];
    if constexpr (std::is_same<Tin, Tout>::value) {
      dst[i] = v;
    } else {
      dst[i] = from_f32<Tout>(to_f32(v));
    }
  }
}

template <typename Tin, typename Tout>
int launch(const void* src, void* dst, int64_t planes, int h, int w, int pt, int pb,
           int pl, int pr, cudaStream_t stream) {
  const int hout = h + pt + pb;
  const int wout = w + pl + pr;
  const int64_t total = planes * hout * wout;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  edge_pad_kernel<Tin, Tout><<<blocks, threads, 0, stream>>>(
      static_cast<const Tin*>(src), static_cast<Tout*>(dst), total, h, w, hout, wout, pt, pl);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (either way), 2 = uint8 (to uint8).
extern "C" int fsr_edge_pad(const void* src, void* dst, int in_dtype, int out_dtype,
                            long long planes, int h, int w, int pt, int pb, int pl, int pr,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(src, dst, planes, h, w, pt, pb, pl, pr, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(src, dst, planes, h, w, pt, pb, pl, pr, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(src, dst, planes, h, w, pt, pb, pl, pr, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(src, dst, planes, h, w, pt, pb, pl, pr, s);
  if (in_dtype == 2 && out_dtype == 2)
    return launch<uint8_t, uint8_t>(src, dst, planes, h, w, pt, pb, pl, pr, s);
  return (int)cudaErrorInvalidValue;
}
