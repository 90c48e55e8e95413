// K4: edge-replicating pad of the last two axes plus a dtype convert, in
// one pass.
//
// Replaces the TPU kernel fsr_tpu/kernels/pad.py:edge_pad (pallas_call at
// pad.py:132), which DMAs clamped row windows and realigns them with rolls.
//
// Design: an aligned row copy.  One block row (blockIdx.y) per output row,
// plane * hout + y, launched in chunks of at most 65535 rows (the grid's y
// limit); blockIdx.x cuts the row into chunks of THREADS vectors.  The
// source row min(max(y - pt, 0), h - 1) and the row's 64-bit base are
// computed once per block; every index inside a row is 32-bit, and no
// thread divides.  Each thread stores one aligned 16-byte vector of the
// output row (4 float32, 8 bfloat16 or 16 uint8); the elements before the
// row's first 16-byte boundary (the head: a row of wout * sizeof elements
// need not start aligned) and after its last (the tail) are stored one by
// one by two more threads.  A vector inside the source row's columns reads
// its elements as they lie: for a same-type pad, as the one or two aligned
// 16-byte source vectors that hold them, realigned with funnel shifts (the
// shift is the same for every vector of a row, since source and output
// advance by 16 bytes together); for a convert, one coalesced scalar load
// per element.  A vector that reaches into the left or right pad band reads
// each element at its clamped column: src[row][0] and src[row][w - 1]
// replicate.
//
// Bound: device-memory bytes (one read of the source, one write of the
// padded copy).  The old design (one element per thread, two 64-bit
// divisions and remainders per element) was bound by its instruction
// stream: its uint8 pad took as long as its float32 one.  K4 still costs a
// pass over the source in front of every K1; folding it into K1's loads
// waits for K1's redesign, whose staging would take the clamps.
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

constexpr int THREADS = 128;
constexpr int VEC = 16;  // bytes of one store
constexpr int MAX_GRID_Y = 65535;

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
__device__ __forceinline__ Tout convert(Tin v) {
  if constexpr (std::is_same<Tin, Tout>::value) {
    return v;
  } else {
    return from_f32<Tout>(to_f32(v));
  }
}

// An element's bits, widened to 32.
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits(uint8_t v) { return v; }

// V = 16 / sizeof(T) elements as one 16-byte vector, little-endian.
template <typename T, int V>
__device__ __forceinline__ uint4 pack(const T (&e)[V]) {
  constexpr int per = V / 4;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = 0;
#pragma unroll
    for (int i = 0; i < per; ++i) w[j] |= bits(e[j * per + i]) << (i * 8 * (int)sizeof(T));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 16 bytes at byte offset k (0..15) of the 32 bytes a, b.
__device__ __forceinline__ uint4 realign(uint4 a, uint4 b, int k) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = k >> 2;
  const int s = (k & 3) * 8;
  uint32_t u[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    u[j] = q == 0 ? w[j] : q == 1 ? w[j + 1] : q == 2 ? w[j + 2] : w[j + 3];
  return make_uint4(__funnelshift_r(u[0], u[1], s), __funnelshift_r(u[1], u[2], s),
                    __funnelshift_r(u[2], u[3], s), __funnelshift_r(u[3], u[4], s));
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS)
    edge_pad_kernel(const Tin* __restrict__ src, Tout* __restrict__ dst, int64_t row0, int h, int w,
                    int hout, int wout, int pt, int pl) {
  constexpr int V = VEC / sizeof(Tout);
  const int64_t row = row0 + blockIdx.y;
  const int64_t plane = row / hout;
  const int y = (int)(row - plane * hout);
  const Tin* s = src + (plane * h + min(max(y - pt, 0), h - 1)) * w;
  Tout* d = dst + row * wout;
  const int head = min((int)((-(uintptr_t)d & (VEC - 1)) / sizeof(Tout)), wout);
  const int nvec = (wout - head) / V;
  const int item = blockIdx.x * THREADS + threadIdx.x;
  auto at = [&](int x) { return convert<Tin, Tout>(s[min(max(x - pl, 0), w - 1)]); };

  if (item < nvec) {
    const int x = head + item * V;
    const int sx = x - pl;
    uint4* out = reinterpret_cast<uint4*>(d + x);
    const bool inside = sx >= 0 && sx + V <= w;
    if constexpr (std::is_same<Tin, Tout>::value) {
      if (inside) {
        const uintptr_t p = (uintptr_t)(s + sx);
        const uint4* a = reinterpret_cast<const uint4*>(p & ~(uintptr_t)(VEC - 1));
        const int k = (int)(p & (VEC - 1));
        // k is the same for every vector of the row: a uniform branch.
        *out = k == 0 ? __ldg(a) : realign(__ldg(a), __ldg(a + 1), k);
        return;
      }
    }
    Tout e[V];
    if (inside) {
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = convert<Tin, Tout>(s[sx + i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = at(x + i);
    }
    *out = pack(e);
  } else if (item == nvec) {
    for (int x = 0; x < head; ++x) d[x] = at(x);
  } else if (item == nvec + 1) {
    for (int x = head + nvec * V; x < wout; ++x) d[x] = at(x);
  }
}

template <typename Tin, typename Tout>
int launch(const void* src, void* dst, int64_t planes, int h, int w, int pt, int pb, int pl, int pr,
           cudaStream_t stream) {
  const int hout = h + pt + pb;
  const int wout = w + pl + pr;
  const int64_t rows = planes * hout;
  if (rows == 0 || wout == 0) return 0;
  constexpr int V = VEC / sizeof(Tout);
  // Vectors of the row at most, plus the head's and the tail's threads.
  const int items = wout / V + 2;
  const int gx = (items + THREADS - 1) / THREADS;
  for (int64_t r0 = 0; r0 < rows; r0 += MAX_GRID_Y) {
    const int ny = (int)(rows - r0 < MAX_GRID_Y ? rows - r0 : MAX_GRID_Y);
    edge_pad_kernel<Tin, Tout><<<dim3(gx, ny), THREADS, 0, stream>>>(
        static_cast<const Tin*>(src), static_cast<Tout*>(dst), r0, h, w, hout, wout, pt, pl);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
