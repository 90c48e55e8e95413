// H1: the halo rows of one row strip's static buffer, read from its
// neighbours' buffers, card to card by peer access.
//
// Counterpart of fsr_tpu/parallel/spatial.py:_exchange_halo (:104-119),
// which is no pallas_call: inside each shard's body of the jitted
// shard_map, two lax.ppermute's bring the neighbours' edge rows, two
// jnp.where's replicate the frame's first and last rows at its ends, and a
// concatenate builds the halo'd strip.  In the port a row-sharded call
// captured once per card (parallel/spatial.py:CapturedSpatial) keeps one
// static buffer per strip, (..., C, h + 2 * halo, W), all allocated before
// any card's graph is captured; the host writes each strip's own rows
// (rows halo .. halo + h - 1), and this kernel, the first node of each
// strip's part of its card's graph, fills the rest:
//   rows 0 .. halo - 1          <- strip k - 1's rows h .. h + halo - 1
//                                  (its last own rows), or the own row
//                                  halo repeated at the frame's top;
//   rows halo + h .. h + 2 halo - 1 <- strip k + 1's rows halo .. 2 halo - 1
//                                  (its first own rows), or the own row
//                                  halo + h - 1 repeated at the bottom.
// The neighbours' buffers may lie on other cards: the kernel reads them
// through their device pointers, which the card may dereference once peer
// access is enabled (fsr_enable_peer; the wrapper refuses a pair without
// it).  Optionally one thread also copies a 0-d int32 (the frame index)
// from the source card's static into this card's.
//
// The rows are moved as bytes in the widest unit that divides the row's
// bytes and every buffer address (16, 8, 4, 2 or 1 bytes), so every dtype,
// channel count, batch and frame group goes through one body.
//
// Bound: bytes.  A strip reads and writes 2 * halo rows per plane (at the
// Performance 4K frame, batch 4, float32: 4 * 3 * 8 rows of 7,680 bytes,
// 0.74 MB each way, 0.44 us at 3.35 TB/s; over NVLink at 450 GB/s each way
// 1.6 us); at that size the launch itself dominates.  Design: a simple
// grid-stride copy, one unit per thread per step; nothing is staged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename U>
__global__ void halo_kernel(U* buf, const U* up, const U* down, long long plane, long long row, int h,
                            int halo, long long total, const int* frame_src, int* frame_dst) {
  if (frame_src != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *frame_dst = *frame_src;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += step) {
    const long long r = t / row;  // halo row over all planes: 2 * halo per plane
    const long long u = t - r * row;
    const long long p = r / (2 * halo);
    const int i = (int)(r - p * 2 * halo);
    const long long base = p * plane;
    const U* src;
    long long dst_row;
    if (i < halo) {
      dst_row = i;
      src = up != nullptr ? up + base + (long long)(h + i) * row : buf + base + (long long)halo * row;
    } else {
      const int j = i - halo;
      dst_row = halo + h + j;
      src = down != nullptr ? down + base + (long long)(halo + j) * row
                            : buf + base + (long long)(halo + h - 1) * row;
    }
    buf[base + dst_row * row + u] = src[u];
  }
}

template <typename U>
int launch(void* buf, const void* up, const void* down, long long planes, int h, int halo, long long row_bytes,
           const void* frame_src, void* frame_dst, cudaStream_t stream) {
  const long long row = row_bytes / (long long)sizeof(U);
  const long long plane = (long long)(h + 2 * halo) * row;
  const long long total = planes * 2 * halo * row;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  halo_kernel<U><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<U*>(buf), static_cast<const U*>(up), static_cast<const U*>(down), plane, row, h, halo, total,
      static_cast<const int*>(frame_src), static_cast<int*>(frame_dst));
  return (int)cudaGetLastError();
}

}  // namespace

// buf: strip k's buffer, planes x (h + 2 * halo) rows of row_bytes; up /
// down: strip k - 1's / k + 1's buffer of the same shape (NULL at the
// frame's top / bottom: replicate the edge row); frame_src, frame_dst: a
// 0-d int32 to copy (both NULL: none).  Returns a cudaError code.
extern "C" int fsr_halo_rows(void* buf, const void* up, const void* down, long long planes, int h, int halo,
                             long long row_bytes, const void* frame_src, void* frame_dst, void* stream) {
  if (h < 1 || halo < 1 || planes < 0 || row_bytes < 0) return (int)cudaErrorInvalidValue;
  if ((planes == 0 || row_bytes == 0) && frame_src == nullptr) return 0;
  uintptr_t bits = (uintptr_t)row_bytes | (uintptr_t)buf | (uintptr_t)up | (uintptr_t)down;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits % 16 == 0) return launch<uint4>(buf, up, down, planes, h, halo, row_bytes, frame_src, frame_dst, s);
  if (bits % 8 == 0) return launch<uint2>(buf, up, down, planes, h, halo, row_bytes, frame_src, frame_dst, s);
  if (bits % 4 == 0) return launch<uint32_t>(buf, up, down, planes, h, halo, row_bytes, frame_src, frame_dst, s);
  if (bits % 2 == 0) return launch<uint16_t>(buf, up, down, planes, h, halo, row_bytes, frame_src, frame_dst, s);
  return launch<uint8_t>(buf, up, down, planes, h, halo, row_bytes, frame_src, frame_dst, s);
}

// Let kernels on `device` dereference `peer`'s memory
// (cudaDeviceEnablePeerAccess; already enabled is fine).  The current
// device is restored.  Returns a cudaError code.
extern "C" int fsr_enable_peer(int device, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear it, or the next launch's check reports it
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : back);
}
