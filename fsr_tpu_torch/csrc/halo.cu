// Peer access between cards, for the strip-source form of K1 and K2.
//
// H1, the halo rows of a row strip (the counterpart of
// fsr_tpu/parallel/spatial.py:_exchange_halo, :104-119, which is no
// pallas_call: two lax.ppermute's, jnp.where's and a concatenate inside each
// shard's body of the jitted shard_map), is folded into K1 and K2: each
// strip's kernel reads its halo rows in place from its neighbours' rows
// (fsr_pixel.cuh:StripSrc), and no launch of its own copies them.  A
// row-sharded call captured once per card (parallel/spatial.py:
// CapturedSpatial) points a strip's up and down parts at its neighbours'
// static buffers, which may lie on other cards: a kernel there reads them
// through their device pointers, which its card may dereference once peer
// access is enabled from it (fsr_enable_peer; kernels/halo.py:enable_peers
// refuses a pair without it).

#include <cuda_runtime.h>

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
