// P1-P4: the measurement probes, the counterparts of the JAX package's probe
// tools (tools/ablation/opmix_floor.py, fused_roofline.py, fp16_probe.py).
// Each measures on the H100 what its TPU tool measures; none copies what the
// TPU made the tool do (VMEM-resident operand blocks, rotated tap planes).
//
// P1 opmix_replay (replaces opmix_floor.replay_ms, pallas_call at
// opmix_floor.py:156): K1 with its memory path taken out.  The operand is
// the K4-padded source of one K1 tile (a tiny frame), passed once.  Each
// block copies it into shared memory, then runs K1's own code over it: the
// phase arithmetic of fused.cu:easu_pixel (copied here, over a shared-memory
// pointer), easu_resolve, and rcas_tile/rcas_pixel with the ring clamped as
// K1 clamps it.  It launches on K1's grid at the headline shape, so it
// issues K1's per-pixel math stream (the 1.195x ring recompute included)
// with no global tap loads.  Every block computes the same tile.  Block
// (0, 0, 0) stores it into the one (3, TILE_H, TILE_W) output; every other
// block stores a pixel only if one of its channels equals NEVER, a value no
// output takes.  So every result stays live (nvcc may neither delete the
// math nor sink it under the store's branch: the compare needs all three
// channels), no frame is written, and the blocks do not queue at the same
// L2 lines.  Bound: float32 issue of that stream.
//
// P2 opmix_replay_shared (replaces opmix_floor.replay_shared_ms,
// pallas_call at opmix_floor.py:255): the shared-dataflow floor, on the same
// operand, grid and output.  Per block, the luma and the '+' texel response
// (texel_response) are computed once per texel of the block's source window
// into shared memory; each pixel, ring included, then reads its 12 taps and
// its four quad responses from shared memory and resolves as
// easu_math.easu_resolve(quad_g=) does; RCAS follows as in P1.  Bound: float32
// issue of the shared stream, the fewest operations K1's math needs (whether it
// also runs fastest is what P2 <= P1 tests).
//
// P3 fma_rate (replaces fused_roofline.vpu_rate_teops, pallas_call at
// fused_roofline.py:134): independent FMA chains, float (fmaf) or __half2
// (__hfma2), CHAINS of 64 each per element with the JAX probe's recurrence
// acc = acc * m + a from acc = a * s[c].  The multiplier and the chains'
// start scales are kernel arguments, so nothing folds.  blockIdx.y repeats
// the work (every repeat stores the same values, as every grid step of the
// JAX probe does), so the grid fills the 132 SMs for milliseconds.  Bound:
// FMA issue: 67 TFLOP/s float32, twice that in half2.
//
// P4 fp16_probe (replaces fp16_probe.main, pallas_calls at fp16_probe.py:71,
// :77, :83): the three float16 kernels of the TPU probe: mode 0 loads f16
// and stores f32 x 2, mode 1 runs an 8-step __hfma chain acc * v + 0.125 and
// stores f32, mode 2 stores f16(f32 x 0.5).  Bound: bytes (a launch at the
// probe's (256, 256) size).
//
// Plain C interface for ctypes; each returns cudaGetLastError() after its
// launch.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fsr_pixel.cuh"

using namespace fsr;

namespace {

// K1's parameters (fused.cu:Params), so that the replay's per-thread copy
// has K1's layout.
struct Params {
  int ly, lx;  // log2 of the phase counts qy, qx
  int ry[4], rx[4];  // padded-frame row/col of phase a/b's 'f' texel at plane index 0
  float py[4], px[4];
  int hp, wp;  // padded source extent
  int hout, wout;
  int ylo, yhi;  // the RCAS ring's row clamp
  float sharp;  // linear RCAS sharpness
  int srtm;     // SRTM prologue on each loaded texel
  EpilogueParams epi;
};

// fused.cu:easu_pixel, copied: the phase arithmetic locates the 4x4 tap
// window in the padded source (here in shared memory), then the shared
// resolve runs.
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

// easu_resolve after its four texel_response calls (fsr_pixel.cuh:191-280):
// the resolve from the quad responses g[k] = (gx, gy, gl) of f, g, j, k, as
// easu_math.easu_resolve(quad_g=) computes it.
__device__ __forceinline__ void easu_resolve_quads(const float (&t)[3][4][4], const float (&g)[4][3],
                                                   float ppx, float ppy, float out[3]) {
  const float ws = (1.0f - ppx) * (1.0f - ppy);
  const float wt = ppx * (1.0f - ppy);
  const float wu = (1.0f - ppx) * ppy;
  const float wv = ppx * ppy;
  float dirx = g[0][0] * ws;
  float diry = g[0][1] * ws;
  float len = g[0][2] * ws;
  dirx = dirx + g[1][0] * wt;
  diry = diry + g[1][1] * wt;
  len = len + g[1][2] * wt;
  dirx = dirx + g[2][0] * wu;
  diry = diry + g[2][1] * wu;
  len = len + g[2][2] * wu;
  dirx = dirx + g[3][0] * wv;
  diry = diry + g[3][1] * wv;
  len = len + g[3][2] * wv;

  float dir_r = dirx * dirx + diry * diry;
  const bool zro = dir_r < (1.0f / 32768.0f);
  dir_r = prx_lo_rsq(dir_r);
  if (zro) {
    dir_r = 1.0f;
    dirx = 1.0f;
  }
  dirx = dirx * dir_r;
  diry = diry * dir_r;
  len = len * 0.5f;
  len = len * len;
  const float stretch = (dirx * dirx + diry * diry) * prx_lo_rcp(fmaxf(fabsf(dirx), fabsf(diry)));
  const float len2_x = 1.0f + (stretch - 1.0f) * len;
  const float len2_y = 1.0f + (-0.5f) * len;
  const float lob = 0.5f + (float)((1.0 / 4.0 - 0.04) - 0.5) * len;
  const float clp = prx_lo_rcp(lob);

  const float lx2 = len2_x * len2_x;
  const float ly2 = len2_y * len2_y;
  const float xx = dirx * dirx;
  const float yy = diry * diry;
  const float xy = dirx * diry;
  const float qa = xx * lx2 + yy * ly2;
  const float qb = (xy + xy) * (lx2 - ly2);
  const float qc = yy * lx2 + xx * ly2;
  float off_x[4], c_dx[4], a_dy[4], b_dy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    off_x[k] = (float)(k - 1) - ppx;
    const float oy = (float)(k - 1) - ppy;
    a_dy[k] = oy * qb;
    b_dy[k] = (oy * oy) * qc;
    c_dx[k] = (off_x[k] * off_x[k]) * qa;
  }

  constexpr int kTapDx[12] = {0, 1, -1, 0, 0, -1, 1, 2, 2, 1, 1, 0};
  constexpr int kTapDy[12] = {-1, -1, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2};
  float ac0 = 0.0f, ac1 = 0.0f, ac2 = 0.0f, aw = 0.0f;
#pragma unroll
  for (int n = 0; n < 12; ++n) {
    const int dx = kTapDx[n] + 1;
    const int dy = kTapDy[n] + 1;
    float d2 = c_dx[dx] + (off_x[dx] * a_dy[dy] + b_dy[dy]);
    d2 = fminf(d2, clp);
    float w_a = lob * d2 - 1.0f;
    w_a = w_a * w_a;
    const float w_b = (0.25f * d2 - 1.25f) * d2 + 1.0f;
    const float w = w_b * w_a;
    ac0 = ac0 + t[0][dy][dx] * w;
    ac1 = ac1 + t[1][dy][dx] * w;
    ac2 = ac2 + t[2][dy][dx] * w;
    aw = aw + w;
  }
  const float inv_w = __frcp_rn(aw);
  const float acc[3] = {ac0, ac1, ac2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mn = fminf(fminf(t[c][1][1], t[c][1][2]), fminf(t[c][2][1], t[c][2][2]));
    const float mx = fmaxf(fmaxf(t[c][1][1], t[c][1][2]), fmaxf(t[c][2][1], t[c][2][2]));
    float v = acc[c] * inv_w;
    v = (v < mn) ? mn : v;
    v = (v > mx) ? mx : v;
    out[c] = v;
  }
}

// P2's shared-memory source window: luma on rows r0 .. r0 + rows - 1 and
// columns c0 .. c0 + cols - 1 of the padded operand (the taps' reach), the
// quad responses on its inner rows and columns (the 'f' to 'k' texels).
struct Window {
  int r0, c0, rows, cols;
};

// P2's EASU for pixel (Y, X) of the tile: taps from the operand planes, the
// four quad responses from the response planes (gc columns, origin at
// window texel (r0 + 1, c0 + 1)).
__device__ __forceinline__ void easu_pixel_shared(const float* __restrict__ op,
                                                  const float* __restrict__ g, const Params& p,
                                                  const Window& w, int Y, int X, float out[3]) {
  const int a = Y & ((1 << p.ly) - 1);
  const int b = X & ((1 << p.lx) - 1);
  const int fy = (Y >> p.ly) + p.ry[a];
  const int fx = (X >> p.lx) + p.rx[b];
  const int plane = p.hp * p.wp;
  const float* base = op + (fy - 1) * p.wp + (fx - 1);
  float t[3][4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((r == 0 || r == 3) && (q == 0 || q == 3)) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) t[c][r][q] = base[c * plane + r * p.wp + q];
    }
  }
  const int gc = w.cols - 2;
  const int gplane = (w.rows - 2) * gc;
  const int at = (fy - w.r0 - 1) * gc + (fx - w.c0 - 1);
  const int quad[4] = {at, at + 1, at + gc, at + gc + 1};  // f, g, j, k
  float gq[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) gq[k][c] = g[c * gplane + quad[k]];
  }
  easu_resolve_quads(t, gq, p.px[b], p.py[a], out);
}

// P1/P2's store test: block (0, 0, 0) always stores, every other block only
// a pixel with a channel equal to `never` (a kernel argument, so nvcc cannot
// prove the test false and must compute all three channels).
__device__ __forceinline__ bool keep(const float v[3], float never) {
  return (blockIdx.x | blockIdx.y | blockIdx.z) == 0 || v[0] == never || v[1] == never ||
         v[2] == never;
}

// Copy the padded operand (3 planes of hp x wp) into shared memory.
__device__ __forceinline__ void load_operand(const float* __restrict__ src, float* op, int n) {
  for (int k = threadIdx.x; k < n; k += NTHREADS) op[k] = src[k];
  __syncthreads();
}

// P1: each block runs K1's tile of the one-tile frame: the ring clamps to
// the tiny frame as K1's ring clamps to a frame's edges.
template <bool RCAS>
__global__ void __launch_bounds__(NTHREADS)
    replay_kernel(const float* __restrict__ src, float* __restrict__ dst, Params p, float never) {
  extern __shared__ float op[];
  load_operand(src, op, 3 * p.hp * p.wp);
  const float* s = op;
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const int64_t oplane = (int64_t)p.hout * p.wout;
  const EpilogueParams e = p.epi;
  const int wout = p.wout;
  auto store = [=](int Y, int X, float v[3]) {
    const int64_t at = (int64_t)(Y - y0) * wout + (X - x0);
    epilogue(e, e.frame, oplane, at, Y, X, v);  // the replays run no epilogue (p.epi is zero)
    if (keep(v, never)) st3(dst, oplane, at, v);
  };
  const int h = gridDim.y * TILE_H;
  const int w = gridDim.x * TILE_W;
  if constexpr (RCAS) {
    auto ring = [=](int Y, int X, float v[3]) {
      easu_pixel(s, p, min(max(Y - y0, p.ylo), p.yhi), min(max(X - x0, 0), p.wout - 1), v);
    };
    rcas_tile<false>(ring, store, h, w, p.sharp);
  } else {
    store_tile([=](int Y, int X, float v[3]) { easu_pixel(s, p, Y - y0, X - x0, v); }, store, h, w);
  }
}

// P2: the operand, then the window's luma, then its quad responses, once per
// texel, in shared memory; then P1's tile loop over shared taps and responses.
__global__ void __launch_bounds__(NTHREADS)
    replay_shared_kernel(const float* __restrict__ src, float* __restrict__ dst, Params p,
                         Window win, float never) {
  extern __shared__ float op[];
  const int plane = p.hp * p.wp;
  float* lum = op + 3 * plane;
  float* g = lum + win.rows * win.cols;
  load_operand(src, op, 3 * plane);
  for (int k = threadIdx.x; k < win.rows * win.cols; k += NTHREADS) {
    const int r = k / win.cols;
    const int c = k - r * win.cols;
    const int at = (win.r0 + r) * p.wp + win.c0 + c;
    lum[k] = luma2(op[at], op[plane + at], op[2 * plane + at]);
  }
  __syncthreads();
  const int gr = win.rows - 2;
  const int gc = win.cols - 2;
  for (int k = threadIdx.x; k < gr * gc; k += NTHREADS) {
    const int r = k / gc + 1;
    const int c = k - (r - 1) * gc + 1;
    const float* l = lum + r * win.cols + c;
    texel_response(l[-win.cols], l[-1], l[0], l[1], l[win.cols], g[k], g[gr * gc + k],
                   g[2 * gr * gc + k]);
  }
  __syncthreads();
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const int64_t oplane = (int64_t)p.hout * p.wout;
  const EpilogueParams e = p.epi;
  const int wout = p.wout;
  auto store = [=](int Y, int X, float v[3]) {
    const int64_t at = (int64_t)(Y - y0) * wout + (X - x0);
    epilogue(e, e.frame, oplane, at, Y, X, v);  // the replays run no epilogue (p.epi is zero)
    if (keep(v, never)) st3(dst, oplane, at, v);
  };
  const float* s = op;
  const float* gs = g;
  auto ring = [=](int Y, int X, float v[3]) {
    easu_pixel_shared(s, gs, p, win, min(max(Y - y0, p.ylo), p.yhi), min(max(X - x0, 0), p.wout - 1),
                      v);
  };
  rcas_tile<false>(ring, store, gridDim.y * TILE_H, gridDim.x * TILE_W, p.sharp);
}

// P3's arithmetic in float or __half2.
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ __half2 fma_(__half2 a, __half2 b, __half2 c) { return __hfma2(a, b, c); }
__device__ __forceinline__ float mul_(float a, float b) { return a * b; }
__device__ __forceinline__ __half2 mul_(__half2 a, __half2 b) { return __hmul2(a, b); }
__device__ __forceinline__ float add_(float a, float b) { return a + b; }
__device__ __forceinline__ __half2 add_(__half2 a, __half2 b) { return __hadd2(a, b); }

constexpr int CHAIN = 64;

template <typename T>
struct FmaArgs {
  T m;     // the recurrence's multiplier, 1 + 1e-7 as T holds it
  T s[8];  // chain c starts at a * s[c], 1 + 1e-7 c as T holds it
};

template <typename T, int CHAINS>
__global__ void __launch_bounds__(NTHREADS)
    fma_kernel(const T* __restrict__ x, T* __restrict__ out, int n, FmaArgs<T> f) {
  const int i = blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n) return;
  const T a = x[i];
  T acc[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c] = mul_(a, f.s[c]);
#pragma unroll
  for (int k = 1; k < CHAIN; ++k) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) acc[c] = fma_(acc[c], f.m, a);
  }
  T o = acc[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) o = add_(o, acc[c]);
  out[i] = o;
}

template <typename T>
int launch_fma(const void* x, void* out, int n, int chains, int reps, const FmaArgs<T>& f,
               cudaStream_t stream) {
  const dim3 grid((n + NTHREADS - 1) / NTHREADS, reps);
  const T* xs = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (chains == 4)
    fma_kernel<T, 4><<<grid, NTHREADS, 0, stream>>>(xs, o, n, f);
  else if (chains == 8)
    fma_kernel<T, 8><<<grid, NTHREADS, 0, stream>>>(xs, o, n, f);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
    fp16_kernel(const __half* __restrict__ x, void* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (i >= n) return;
  if constexpr (MODE == 0) {
    static_cast<float*>(out)[i] = __half2float(x[i]) * 2.0f;
  } else if constexpr (MODE == 1) {
    const __half v = x[i];
    const __half c = __float2half_rn(0.125f);
    __half acc = v;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = __hfma(acc, v, c);
    static_cast<float*>(out)[i] = __half2float(acc);
  } else {
    static_cast<__half*>(out)[i] = __float2half_rn(__half2float(x[i]) * 0.5f);
  }
}

// P1/P2's parameters from the host plan.
int make_params(Params& p, int hp, int wp, int hout, int wout, int qy, int qx, const int* ry,
                const int* rx, const float* py, const float* px, float sharp) {
  if ((qy != 1 && qy != 2 && qy != 4) || (qx != 1 && qx != 2 && qx != 4))
    return (int)cudaErrorInvalidValue;
  if (hout != TILE_H || wout != TILE_W) return (int)cudaErrorInvalidValue;
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
  p.ylo = 0;
  p.yhi = hout - 1;
  p.sharp = sharp;
  p.srtm = 0;
  p.epi = EpilogueParams{};
  return 0;
}

// Dynamic shared memory a block may take beside rcas_tile's static ring
// without an opt-in attribute (48 KB in all).
constexpr size_t MAX_DYNAMIC_SMEM = 32 * 1024;

// P1/P2's `never`: no output of a frame in [0, 1] takes it (EASU clamps to
// its four nearest texels, RCAS to its cross).  A pixel that did would only
// make its block store the bits block (0, 0, 0) stores.
constexpr float NEVER = -1.0f;

}  // namespace

// P1: src the padded float32 operand (3, hp, wp), dst a float32 (3, TILE_H,
// TILE_W) tile; hout, wout must be TILE_H, TILE_W; qy, qx, ry, rx, py, px
// the K1 plan; grid (gx, gy, gz) blocks.
extern "C" int fsr_opmix_replay(const float* src, float* dst, int hp, int wp, int hout, int wout,
                                int qy, int qx, const int* ry, const int* rx, const float* py,
                                const float* px, float sharp, int apply_rcas, int gx, int gy,
                                int gz, void* stream) {
  Params p;
  const int bad = make_params(p, hp, wp, hout, wout, qy, qx, ry, rx, py, px, sharp);
  if (bad) return bad;
  const size_t smem = 3 * (size_t)hp * wp * sizeof(float);
  if (smem > MAX_DYNAMIC_SMEM || gx < 1 || gy < 1 || gz < 1 || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (apply_rcas)
    replay_kernel<true><<<grid, NTHREADS, smem, s>>>(src, dst, p, NEVER);
  else
    replay_kernel<false><<<grid, NTHREADS, smem, s>>>(src, dst, p, NEVER);
  return (int)cudaGetLastError();
}

// P2: as P1 (RCAS always on), with the source window win = (r0, c0, rows,
// cols) of the padded operand that the tile and its ring read.
extern "C" int fsr_opmix_replay_shared(const float* src, float* dst, int hp, int wp, int hout,
                                       int wout, int qy, int qx, const int* ry, const int* rx,
                                       const float* py, const float* px, float sharp,
                                       const int* win, int gx, int gy, int gz, void* stream) {
  Params p;
  const int bad = make_params(p, hp, wp, hout, wout, qy, qx, ry, rx, py, px, sharp);
  if (bad) return bad;
  const Window w{win[0], win[1], win[2], win[3]};
  if (w.r0 < 0 || w.c0 < 0 || w.rows < 3 || w.cols < 3 || w.r0 + w.rows > hp || w.c0 + w.cols > wp)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (3 * (size_t)hp * wp + (size_t)w.rows * w.cols + 3 * (size_t)(w.rows - 2) * (w.cols - 2)) *
      sizeof(float);
  if (smem > MAX_DYNAMIC_SMEM || gx < 1 || gy < 1 || gz < 1 || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidValue;
  replay_shared_kernel<<<dim3(gx, gy, gz), NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      src, dst, p, w, NEVER);
  return (int)cudaGetLastError();
}

// P3: dtype F32 (n floats) or F16 (n __half2 pairs); chains 4 or 8; reps
// repeats of the grid (blockIdx.y); m the multiplier and s[0..7] the chains'
// start scales, as float32 (rounded to half for F16).
extern "C" int fsr_fma_rate(const void* x, void* out, int dtype, int n, int chains, int reps,
                            float m, const float* s, void* stream) {
  if (n < 1 || reps < 1 || reps > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32) {
    FmaArgs<float> f;
    f.m = m;
    for (int c = 0; c < 8; ++c) f.s[c] = s[c];
    return launch_fma<float>(x, out, n, chains, reps, f, st);
  }
  if (dtype == F16) {
    FmaArgs<__half2> f;
    f.m = __float2half2_rn(m);
    for (int c = 0; c < 8; ++c) f.s[c] = __float2half2_rn(s[c]);
    return launch_fma<__half2>(x, out, n, chains, reps, f, st);
  }
  return (int)cudaErrorInvalidValue;
}

// P4: x n float16 values; out n float32 values (modes 0, 1) or float16
// (mode 2).
extern "C" int fsr_fp16_probe(const void* x, void* out, long long n, int mode, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + NTHREADS - 1) / NTHREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __half* xs = static_cast<const __half*>(x);
  if (mode == 0)
    fp16_kernel<0><<<blocks, NTHREADS, 0, s>>>(xs, out, n);
  else if (mode == 1)
    fp16_kernel<1><<<blocks, NTHREADS, 0, s>>>(xs, out, n);
  else if (mode == 2)
    fp16_kernel<2><<<blocks, NTHREADS, 0, s>>>(xs, out, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
