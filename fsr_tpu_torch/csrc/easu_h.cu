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
//   - EASU "mixed" (fsr_half.cuh:quad_response, easu_shape, easu_pair): the
//     direction and length in float32 with the APrx bit tricks, the taps'
//     weights, the single accumulation chain, the reciprocal and the
//     dering clamp in half;
//   - with RCAS, FsrRcasH (fsr_half.cuh:rcas_pair) on the half-rounded EASU
//     values, the border clamped in output coordinates;
//   - RGBA: alpha as ops.easu.bilinear computes it on the source's alpha
//     plane (float32 after the source-type difference), stored as half,
//     never sharpened.
// The output is float16.
//
// The frame tail (the tail forms, easu_h_kernel_tail and its strip-source
// form easu_h_kernel_strip_tail, compiled in easu_h_tail.cu and
// easu_h_tail_strip.cu): the rest of the torch path's float16 chain around
// that function, in the same launch, as K1 and K2 run it around theirs:
//   - the SRTM prologue on each texel as it is staged, before its rounding
//     to half (fsr_half.cuh:srtm_to_half): on a float16 or bfloat16 source
//     in that type, each operation rounded to it as a torch elementwise op
//     on that dtype rounds; on a float32 source or a decoded byte in
//     float32; alpha never; the luma and the responses after it;
//   - at the store, each pixel's halves widened to float32, the K5
//     epilogue (fsr_pixel.cuh:epilogue, the strip's global rows for the
//     dither), rounded back to half as the torch path rounds it, then
//     stored as the output type: float16 as it is, uint8 or 10-bit UNORM
//     codes of that half (fsr_pixel.cuh:st); alpha from its float32
//     bilinear by the same storage rule.
// The output type is a template parameter O (__half, uint8_t, uint16_t),
// the prologue flag and the epilogue's fields uniform runtime values.  The
// bare kernels (easu_h_kernel, easu_h_kernel_strip) take no tail: their
// code is the same with or without the tail forms beside them.
//
// Row strips (parallel/spatial.py): a strip of a row-sharded frame runs on
// K2's per-strip row tables (kernels/easu_gather.py:shard_plan), built from
// the GLOBAL mapping for its output rows -1 .. hl and clipped to the frame,
// so the RCAS ring's rows -1 and hl are the neighbours' rows, read through
// the strip's halo, and only the frame's first and last rows repeat.  The
// strip-source form (easu_h_kernel_strip, fsr_easu_h_strip, compiled in
// easu_h_strip.cu) reads the strip in place from its three parts
// (fsr_pixel.cuh:StripSrc): only the staging load's address changes, so a
// strip's bits are those of the halo'd strip as one tensor, and those of
// the whole frame's rows.  A tap window is inside the image wherever its
// rows differ (centre): a seam's rows come from the halo and are interior.
//
// Design: K2's structure (easu_gather.cu) on K2's host tables
// (kernels/easu_gather.py:plan), with each block's work cut for the half2
// unit.  One block of NT threads per TH x TW output tile:
//   - stage: the block's source footprint (its tile's and its one-pixel
//     RCAS ring's taps) into shared memory, each texel as three halves, and
//     the block's slice of the tables as offsets into the footprint;
//     barrier; then every quadrant centre's response (quad_response: dir_x,
//     len_x^2, dir_y, len_y^2 as a float4) once per texel, on a grid one
//     texel wider than the footprint on each side (a tap window clamped at
//     the image's edge puts its centre there: left, centre and right are
//     then one texel); barrier;
//   - the ring pass: two ring pixels per thread, adjacent in a row; each
//     reads its four quadrants' responses (four float4 loads, four
//     weighted adds), makes its float32 filter shape alone, and the pair
//     runs EASU's half arithmetic in the paired forms
//     (fsr_half.cuh:easu_pair) into a ring of halves; barrier;
//   - the tile pass: two tile pixels per thread read their RCAS crosses
//     from the ring as pairs, run FsrRcasH paired and store.
// TH = TW = 30 makes the 32 x 32 ring 512 pairs, two rounds of 256 threads,
// and divides a 4K frame into whole tiles; 64 registers a thread keep four
// blocks (32 warps) on an SM, and the taps are read where the accumulation
// takes them, so none spills.  Ring slots outside the frame hold the edge
// pixel's value (the tables repeat the edge row; ring columns clamp to the
// image), so RCAS sees e in place of a missing neighbour; the second pixel
// of a pair past the frame's right edge is computed from the clamped tables
// and not stored.
//
// Bound (tools_torch/ablation/fused_roofline.easu_rcas_h_ops, per output
// pixel at 2x): 74.75 float32 and 541 float16 operations (convention 2),
// 0.0427 ms per 4K frame at the H100's float32 and half2 rates; device
// memory moves one read of the source and one write of the half output
// (0.0186 ms per 4K frame from float16).  So the kernel is bound by
// instruction issue: the half arithmetic issues two lanes per instruction,
// the texel responses are shared by the pixels of a block, the reciprocals
// are one MUFU.RCP a lane, and the ring's recompute is (32 * 32) / (30 *
// 30) = 1.138x of the EASU work.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fsr_half.cuh"
#include "fsr_pixel.cuh"

using namespace fsr;
using fsr::h16::h2;

namespace {

constexpr int TH = 30;            // the tile's rows
constexpr int TW = 30;            // its columns
constexpr int RH = TH + 2;        // the RCAS ring's rows
constexpr int RW = TW + 2;        // its columns
constexpr int PW = RW / 2;        // pairs per ring row
constexpr int FP_H = RH + 3;      // the footprint's rows at most: ring rows and taps -1..2
constexpr int FP_W = RW + 3;      // its columns at most
constexpr int NT = 256;           // threads per block
constexpr int MIN_BLOCKS = 4;     // blocks per SM: 64 registers a thread, no spills

// The frame tail's parameters (the tail forms only): the SRTM prologue's
// flag and the K5 epilogue's parameters, as K1 and K2 take them, with the
// grain's plane stride (a row strip reads its rows of the whole frame's
// grain in place: its planes lie the frame's plane apart).
struct TailParams {
  EpilogueParams e;
  int64_t gplane;
  int srtm;
};
// The bare kernels' tail: none.
struct NoTail {};

template <typename Tail>
constexpr bool has_tail = std::is_same<Tail, TailParams>::value;

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

// One block's footprint, responses, table slice and ring.  A tap of ring
// row ly and ring column lx, at offsets dy, dx = -1..2, is texel row[ly][dy
// + 1] + col[lx][dx + 1] of the footprint.  Its quadrants s, t, u, v read
// resp[quad_row[ly].x + quad_col[lx].x], [.x + .y], [.y + .x], [.y + .y].
template <bool RGBA>
struct StageH {
  uint2 rgb[FP_H * FP_W];                    // r | g << 16, b: the texel's halves
  float4 resp[(FP_H + 2) * (FP_W + 2)];      // quad_response per centre, one texel of margin around
  union {
    float lum[FP_H * FP_W];                  // stage: the texel's half luma, widened
    unsigned int ring[3][RH][PW + 1];        // then: EASU of ring column c in half c + 1 of its row
  };
  float alpha[RGBA ? FP_H * FP_W : 1];       // RGBA: the source's alpha as loaded (a byte decoded)
  int4 col[RW];
  int2 quad_col[RW];
  float px[RW];
  int4 row[RH];
  int2 quad_row[RH];
  float py[RH];
};

// The response grid's index of a quadrant centre on one axis, from the
// pixel's tap offsets a, b, c (centre b) into a footprint of n texels: b + 1
// for a window inside the image (a, c = b -+ 1, clamped to the image, which
// the footprint then holds), else 0 or n + 1, where left, centre and right
// are one edge texel (the window clamped at the image's edge).
__device__ __forceinline__ int centre(int a, int b, int c, int n) { return a != c ? b + 1 : (b == 0 ? 0 : n + 1); }

// Load the block's footprint of one frame's source and its table slice
// (K2's rule, easu_gather.cu:stage), then the responses of every centre;
// a barrier after each.  strip: empty for a whole source, else its strip
// source (the loads' addresses).  TAIL: a tail form's staging, which runs
// the SRTM prologue on each texel when srtm is set.
template <typename S, bool RGBA, bool TAIL, typename... Strip>
__device__ __forceinline__ void stage(StageH<RGBA>& st, const S* __restrict__ src, const HParams& p, int srtm,
                                      const Strip&... strip) {
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int r0 = __ldg(p.rows + y0 - 1);
  const int c0 = __ldg(p.cols + max(x0 - 1, 0));
  const int fh = __ldg(p.rows + 3 * p.rstride + min(y0 + TH, p.hout)) - r0 + 1;
  const int fw = __ldg(p.cols + 3 * p.wout + min(x0 + TW, p.wout - 1)) - c0 + 1;
  if (fh > FP_H || fw > FP_W) __trap();  // the host's footprint check failed to hold
  const int gw = fw + 2;                 // the response grid's row length
  const int64_t plane = (int64_t)p.hin * p.win;
  const S* base = src + (int64_t)r0 * p.win + c0;
  // k / n for k < 40 * 40, n <= 40 as (k + 0.5) * (1 / n) in float32 (1 / n
  // within 2 ulps): its error is far below the 0.5 / n that (k + 0.5) / n
  // keeps from an integer.
  const float inv_fw = __fdividef(1.0f, (float)fw), inv_gw = __fdividef(1.0f, (float)gw);
  if constexpr (sizeof...(Strip) > 0) {
    // A strip's parts, run by run, loaded through the read-only cache; the
    // tables keep every row inside the virtual strip.
    auto run = [&](int rb, int re, const S* part, int64_t pl, auto row) {
      for (int k = rb * fw + threadIdx.x; k < re * fw; k += NT) {
        const int r = (int)(__fadd_rn((float)k, 0.5f) * inv_fw);
        const S* at = part + (int64_t)row(r) * p.win + c0 + (k - r * fw);
        __half cr, cg, cb;
        if constexpr (TAIL) {
          h16::srtm_to_half<true>(at, pl, srtm, cr, cg, cb);
        } else {
          cr = h16::to_half_nc(at), cg = h16::to_half_nc(at + pl), cb = h16::to_half_nc(at + 2 * pl);
        }
        st.rgb[k] = make_uint2(__half_as_ushort(cr) | (unsigned)__half_as_ushort(cg) << 16, __half_as_ushort(cb));
        st.lum[k] = __half2float(h16::luma(cr, cg, cb));
        if constexpr (RGBA) st.alpha[k] = ldg(at + 3 * pl);  // widened exactly, a byte decoded
      }
    };
    stage_strip(only(strip...), blockIdx.z, r0, fh, p.hin, run);
  } else {
    for (int k = threadIdx.x; k < fh * fw; k += NT) {
      const int r = (int)(__fadd_rn((float)k, 0.5f) * inv_fw);
      const S* at = base + (int64_t)r * p.win + (k - r * fw);
      __half cr, cg, cb;
      if constexpr (TAIL) {
        h16::srtm_to_half<false>(at, plane, srtm, cr, cg, cb);
      } else {
        cr = h16::to_half(at), cg = h16::to_half(at + plane), cb = h16::to_half(at + 2 * plane);
      }
      st.rgb[k] = make_uint2(__half_as_ushort(cr) | (unsigned)__half_as_ushort(cg) << 16, __half_as_ushort(cb));
      st.lum[k] = __half2float(h16::luma(cr, cg, cb));
      if constexpr (RGBA) st.alpha[k] = ld(at + 3 * plane);  // widened exactly, a byte decoded
    }
  }
  for (int i = threadIdx.x; i < RW + RH; i += NT) {
    if (i < RW) {
      const int* c = p.cols + min(max(x0 + i - 1, 0), p.wout - 1);
      const int w = p.wout;
      const int4 cv = make_int4(__ldg(c) - c0, __ldg(c + w) - c0, __ldg(c + 2 * w) - c0, __ldg(c + 3 * w) - c0);
      st.col[i] = cv;
      st.quad_col[i] = make_int2(centre(cv.x, cv.y, cv.z, fw), centre(cv.y, cv.z, cv.w, fw));
      st.px[i] = __ldg(p.px + (c - p.cols));
    } else {
      const int ly = i - RW;
      const int Y = min(y0 + ly - 1, p.hout);
      const int* r = p.rows + Y;
      const int rs = p.rstride;
      const int4 rv = make_int4(__ldg(r) - r0, __ldg(r + rs) - r0, __ldg(r + 2 * rs) - r0, __ldg(r + 3 * rs) - r0);
      st.row[ly] = make_int4(fw * rv.x, fw * rv.y, fw * rv.z, fw * rv.w);
      st.quad_row[ly] = make_int2(gw * centre(rv.x, rv.y, rv.z, fh), gw * centre(rv.y, rv.z, rv.w, fh));
      st.py[ly] = __ldg(p.py + Y);
    }
  }
  __syncthreads();
  // Response (vr, vc) is the centre at footprint texel (vr - 1, vc - 1)
  // with its neighbours one texel either way, every index clamped to the
  // footprint: at the margin the centre and a neighbour are one texel.
  for (int k = threadIdx.x; k < (fh + 2) * gw; k += NT) {
    const int vr = (int)(__fadd_rn((float)k, 0.5f) * inv_gw);
    const int vc = k - vr * gw;
    const int up = fw * min(max(vr - 2, 0), fh - 1), cr = fw * min(max(vr - 1, 0), fh - 1);
    const int dn = fw * min(vr, fh - 1);
    const int lf = min(max(vc - 2, 0), fw - 1), cc = min(max(vc - 1, 0), fw - 1), rt = min(vc, fw - 1);
    st.resp[k] = h16::quad_response(st.lum[up + cc], st.lum[cr + lf], st.lum[cr + cc], st.lum[cr + rt],
                                    st.lum[dn + cc]);
  }
  __syncthreads();
}

// EASU of ring pixels (ly, la) and (ly, lb) from the staged footprint, as
// a pair.
template <bool RGBA>
__device__ __forceinline__ void easu_staged(const StageH<RGBA>& st, int ly, int la, int lb, h2 out[3]) {
  const int2 qr = st.quad_row[ly], qa = st.quad_col[la], qb = st.quad_col[lb];
  const float4 ga[4] = {st.resp[qr.x + qa.x], st.resp[qr.x + qa.y], st.resp[qr.y + qa.x], st.resp[qr.y + qa.y]};
  const float4 gb[4] = {st.resp[qr.x + qb.x], st.resp[qr.x + qb.y], st.resp[qr.y + qb.x], st.resp[qr.y + qb.y]};
  const float py = st.py[ly];
  float sa[6], sb[6];
  h16::easu_shape(ga, st.px[la], py, sa);
  h16::easu_shape(gb, st.px[lb], py, sb);
  const int4 ca = st.col[la], cb = st.col[lb];
  const int4 rv = st.row[ly];
  const int coa[4] = {ca.x, ca.y, ca.z, ca.w};
  const int cob[4] = {cb.x, cb.y, cb.z, cb.w};
  const int ro[4] = {rv.x, rv.y, rv.z, rv.w};
  // Tap (r, q) of both pixels: r | g << 16 and b of each, packed by channel.
  auto tap = [&](int r, int q) {
    const uint2 a = st.rgb[ro[r] + coa[q]];
    const uint2 b = st.rgb[ro[r] + cob[q]];
    return h16::Tap2{{h16::as_h2(__byte_perm(a.x, b.x, 0x5410)), h16::as_h2(__byte_perm(a.x, b.x, 0x7632)),
                      h16::as_h2(__byte_perm(a.y, b.y, 0x5410))}};
  };
  h16::easu_pair(tap, sa, sb, st.px[la], st.px[lb], py, out);
}

// The frame tail's store of a pixel pair's colour (columns X and X + 1 at
// offset at of each plane, the grain's at t.gplane; the second when
// `both`): each lane widened, the epilogue, rounded back to half, stored as
// O; a 4-byte-aligned pair (`paired`: an even row length) in one store per
// plane.
template <typename O>
__device__ __forceinline__ void store_tail(O* o, int64_t oplane, int64_t at, int Y, int X, bool both, bool paired,
                                           const TailParams& t, unsigned frame, const h2 v[3]) {
  float a[3], b[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = __low2float(v[c]);
    b[c] = __high2float(v[c]);
  }
  epilogue(t.e, frame, t.gplane, at, Y, X, a);
  if (both) epilogue(t.e, frame, t.gplane, at + 1, Y, X + 1, b);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    O* q = o + c * oplane + at;
    const float ha = as_storage<__half>(a[c]), hb = as_storage<__half>(b[c]);
    if (paired) {
      if constexpr (std::is_same<O, __half>::value) {
        *reinterpret_cast<h2*>(q) = __floats2half2_rn(ha, hb);
      } else if constexpr (std::is_same<O, uint8_t>::value) {
        *reinterpret_cast<uint16_t*>(q) = (uint16_t)((unsigned)unorm(ha, 255.0f) | (unsigned)unorm(hb, 255.0f) << 8);
      } else {
        *reinterpret_cast<uint32_t*>(q) = (unsigned)unorm(ha, 1023.0f) | (unsigned)unorm(hb, 1023.0f) << 16;
      }
    } else {
      fsr::st(q, ha);
      if (both) fsr::st(q + 1, hb);
    }
  }
}

// The TEPD hash's frame index of a tail form (0 for the bare kernels).
template <typename Tail>
__device__ __forceinline__ unsigned tail_frame(const Tail& tail) {
  if constexpr (has_tail<Tail>) {
    return epilogue_frame(tail.e);
  } else {
    return 0u;
  }
}

// One block's tile: the kernels' body, for a whole source (src) or a strip
// source (strip), into an output of type O, with the frame tail (tail: a
// TailParams) or without (a NoTail).  It takes the parameters by value, as
// the kernels do: a reference to the kernel's parameter moved a few
// instructions of the whole-frame form's SASS.
template <typename S, bool RCAS, bool DENOISE, bool RGBA, typename O, typename Tail, typename... Strip>
__device__ __forceinline__ void easu_h_tile(const S* __restrict__ src, O* __restrict__ dst, HParams p, Tail tail,
                                            const Strip&... strip) {
  constexpr int C = RGBA ? 4 : 3;
  constexpr bool TAIL = has_tail<Tail>;
  __shared__ StageH<RGBA> st;
  const int64_t n = blockIdx.z;
  int srtm = 0;
  if constexpr (TAIL) srtm = tail.srtm;
  stage<S, RGBA, TAIL>(st, src + n * C * (int64_t)p.hin * p.win, p, srtm, strip...);
  O* o = dst + n * C * (int64_t)p.hout * p.wout;
  const unsigned frame = tail_frame(tail);
  const int64_t oplane = (int64_t)p.hout * p.wout;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  // Tile pixel pair m of tile row ly: ring row ly + 1, ring columns 2m + 1
  // and 2m + 2, output columns X and X + 1 (the second stored when inside
  // the frame).  Pairs per tile row: TW / 2.
  auto store = [&](int ly, int m, const h2 v[3]) {
    const int Y = y0 + ly, X = x0 + 2 * m;
    const int64_t at = (int64_t)Y * p.wout + X;
    const bool both = X + 1 < p.wout;
    if constexpr (TAIL) {
      store_tail(o, oplane, at, Y, X, both, both && (p.wout & 1) == 0, tail, frame, v);
    } else if (both && (p.wout & 1) == 0) {  // an even row length: the pair is 4-byte aligned
#pragma unroll
      for (int c = 0; c < 3; ++c) *reinterpret_cast<h2*>(o + c * oplane + at) = v[c];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c * oplane + at] = __low2half(v[c]);
        if (both) o[c * oplane + at + 1] = __high2half(v[c]);
      }
    }
    if constexpr (RGBA) {
      const float* a = st.alpha;
      const int4 rv = st.row[ly + 1];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !both) break;
        const int lx = 2 * m + 1 + j;
        const int4 cv = st.col[lx];
        fsr::st(o + 3 * oplane + at + j, h16::bilinear_alpha<S>(a[rv.y + cv.y], a[rv.y + cv.z], a[rv.z + cv.y],
                                                                 a[rv.z + cv.z], st.px[lx], st.py[ly + 1]));
      }
    }
  };
  if constexpr (RCAS) {
    for (int k = threadIdx.x; k < RH * PW; k += NT) {
      const int ly = k / PW;
      const int lx = 2 * (k % PW);
      h2 v[3];
      easu_staged(st, ly, lx, lx + 1, v);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        __half* row = reinterpret_cast<__half*>(st.ring[c][ly]);
        row[lx + 1] = __low2half(v[c]);
        row[lx + 2] = __high2half(v[c]);
      }
    }
    __syncthreads();
    const h2 sharp = h16::k2(p.sharp);
    for (int k = threadIdx.x; k < TH * (TW / 2); k += NT) {
      const int ly = k / (TW / 2);
      const int m = k % (TW / 2);
      if (y0 + ly >= p.hout || x0 + 2 * m >= p.wout) continue;
      // The pair's centres are halves 2m + 2 and 2m + 3 of their ring row:
      // word m + 1; the left neighbours straddle words m and m + 1, the
      // right ones m + 1 and m + 2.
      h2 b[3], d[3], e[3], f[3], hh[3], v[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const unsigned int* mid = st.ring[c][ly + 1];
        const unsigned int ew = mid[m + 1];
        b[c] = h16::as_h2(st.ring[c][ly][m + 1]);
        d[c] = h16::as_h2(__byte_perm(mid[m], ew, 0x5432));
        e[c] = h16::as_h2(ew);
        f[c] = h16::as_h2(__byte_perm(ew, mid[m + 2], 0x5432));
        hh[c] = h16::as_h2(st.ring[c][ly + 2][m + 1]);
      }
      h16::rcas_pair<DENOISE>(b, d, e, f, hh, sharp, v);
      store(ly, m, v);
    }
  } else {
    for (int k = threadIdx.x; k < TH * (TW / 2); k += NT) {
      const int ly = k / (TW / 2);
      const int m = k % (TW / 2);
      if (y0 + ly >= p.hout || x0 + 2 * m >= p.wout) continue;
      h2 v[3];
      easu_staged(st, ly + 1, 2 * m + 1, 2 * m + 2, v);
      store(ly, m, v);
    }
  }
}

template <typename S, bool RCAS, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    easu_h_kernel(const S* __restrict__ src, __half* __restrict__ dst, HParams p) {
  easu_h_tile<S, RCAS, DENOISE, RGBA>(src, dst, p, NoTail{});
}

// The strip-source form (fsr_pixel.cuh:StripSrc): the same tile, each texel
// loaded from the part that holds its row of the virtual halo'd strip.
template <typename S, bool RCAS, bool DENOISE, bool RGBA>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    easu_h_kernel_strip(StripSrc<S> strip, __half* __restrict__ dst, HParams p) {
  easu_h_tile<S, RCAS, DENOISE, RGBA>(static_cast<const S*>(nullptr), dst, p, NoTail{}, strip);
}

// The tail forms: the same tiles with the frame tail, into an output of
// type O.
template <typename S, bool RCAS, bool DENOISE, bool RGBA, typename O>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    easu_h_kernel_tail(const S* __restrict__ src, O* __restrict__ dst, HParams p, TailParams t) {
  easu_h_tile<S, RCAS, DENOISE, RGBA>(src, dst, p, t);
}

template <typename S, bool RCAS, bool DENOISE, bool RGBA, typename O>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    easu_h_kernel_strip_tail(StripSrc<S> strip, O* __restrict__ dst, HParams p, TailParams t) {
  easu_h_tile<S, RCAS, DENOISE, RGBA>(static_cast<const S*>(nullptr), dst, p, t, strip);
}

#if !defined(FSR_STRIP_TU) && !defined(FSR_TAIL_TU)
// The reciprocal check: rcp (the kernel's) of every half bit pattern, two
// patterns a thread as one pair.
__global__ void rcp_check_kernel(unsigned int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 32768) out[i] = h16::bits(h16::rcp(h16::as_h2((2u * i) | (2u * i + 1) << 16)));
}
#endif

// STRIP: launch the strip-source form on sp, else the whole-frame form on
// src; a Tail of TailParams: the tail forms into an output of type O.  Each
// form is compiled in its own translation unit (easu_h_strip.cu,
// easu_h_tail.cu, easu_h_tail_strip.cu).
template <bool STRIP, typename S, bool RGBA, typename O, typename Tail>
int launch_planes(const void* src, const StripParts* sp, void* dst, int nb, const HParams& p, bool rcas,
                  bool denoise, const Tail& tail, cudaStream_t stream) {
  constexpr int C = RGBA ? 4 : 3;
  const int64_t in_frame = C * (int64_t)p.hin * p.win;
  const int64_t out_frame = C * (int64_t)p.hout * p.wout;
  return launch_frames<TH, TW>(nb, p.hout, p.wout, [&](dim3 grid, int n0) {
    O* d = static_cast<O*>(dst) + n0 * out_frame;
    // One of the three RCAS modes (off, on, denoise) as template flags.
    auto go = [&](auto rc, auto dn) {
      constexpr bool R = decltype(rc)::value, D = decltype(dn)::value;
      if constexpr (STRIP) {
        const StripSrc<S> s = strip_src<S>(*sp, n0);
        if constexpr (has_tail<Tail>)
          easu_h_kernel_strip_tail<S, R, D, RGBA, O><<<grid, NT, 0, stream>>>(s, d, p, tail);
        else
          easu_h_kernel_strip<S, R, D, RGBA><<<grid, NT, 0, stream>>>(s, d, p);
      } else {
        const S* s = static_cast<const S*>(src) + n0 * in_frame;
        if constexpr (has_tail<Tail>)
          easu_h_kernel_tail<S, R, D, RGBA, O><<<grid, NT, 0, stream>>>(s, d, p, tail);
        else
          easu_h_kernel<S, R, D, RGBA><<<grid, NT, 0, stream>>>(s, d, p);
      }
    };
    if (!rcas)
      go(std::false_type{}, std::false_type{});
    else if (denoise)
      go(std::true_type{}, std::true_type{});
    else
      go(std::true_type{}, std::false_type{});
  });
}

template <bool STRIP, typename S, typename O, typename Tail>
int launch(const void* src, const StripParts* sp, void* dst, int nb, int channels, const HParams& p, bool rcas,
           bool denoise, const Tail& tail, cudaStream_t stream) {
  return channels == 4 ? launch_planes<STRIP, S, true, O>(src, sp, dst, nb, p, rcas, denoise, tail, stream)
                       : launch_planes<STRIP, S, false, O>(src, sp, dst, nb, p, rcas, denoise, tail, stream);
}

// The dispatch on the source type (and, for the tail forms, the output
// type: out_dtype, fsr_pixel.cuh DType F16, U8 or U16).
template <bool STRIP, typename O, typename Tail>
int launch_types(const void* src, const StripParts* sp, void* dst, int src_dtype, int nb, int channels,
                 const HParams& p, bool rcas, bool denoise, const Tail& tail, cudaStream_t s) {
  switch (src_dtype) {
    case F16:
      return launch<STRIP, __half, O>(src, sp, dst, nb, channels, p, rcas, denoise, tail, s);
    case F32:
      return launch<STRIP, float, O>(src, sp, dst, nb, channels, p, rcas, denoise, tail, s);
    case BF16:
      return launch<STRIP, __nv_bfloat16, O>(src, sp, dst, nb, channels, p, rcas, denoise, tail, s);
    case U8:
      return launch<STRIP, uint8_t, O>(src, sp, dst, nb, channels, p, rcas, denoise, tail, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The C entry points' body: the parameters, the checks and the dispatch on
// the source type, for the whole-frame form (STRIP false: src) or the
// strip-source form (sp); TAIL: the tail forms, with the prologue (srtm),
// the epilogue (epi, its grain's plane stride gplane) and the output type
// (out_dtype).
template <bool STRIP, bool TAIL>
int easu_h(const void* src, const StripParts* sp, void* dst, int src_dtype, int out_dtype, int nb, int channels,
           int hin, int win, int hout, int wout, const void* rows, const void* cols, const void* py, const void* px,
           float sharp, int apply_rcas, int denoise, int srtm, int64_t gplane, const EpilogueParams* epi,
           void* stream) {
  if (STRIP && !strip_ok(sp, hin)) return (int)cudaErrorInvalidValue;
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
  if constexpr (TAIL) {
    if (epi == nullptr) return (int)cudaErrorInvalidValue;
    const TailParams t{*epi, gplane, srtm};
    switch (out_dtype) {
      case F16:
        return launch_types<STRIP, __half>(src, sp, dst, src_dtype, nb, channels, p, r, dn, t, s);
      case U8:
        return launch_types<STRIP, uint8_t>(src, sp, dst, src_dtype, nb, channels, p, r, dn, t, s);
      case U16:
        return launch_types<STRIP, uint16_t>(src, sp, dst, src_dtype, nb, channels, p, r, dn, t, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    return launch_types<STRIP, __half>(src, sp, dst, src_dtype, nb, channels, p, r, dn, NoTail{}, s);
  }
}

}  // namespace

#if defined(FSR_TAIL_TU) && !defined(FSR_STRIP_TU)
// K6 with the frame tail, whole frames: fsr_easu_h's arguments, then
// out_dtype (fsr_pixel.cuh DType: F16, U8 or U16; the output's, plane 3
// included), srtm (1: the SRTM prologue on each loaded texel) and epi (the
// K5 epilogue, a host struct with device pointers, kernels/epilogue.py:
// c_params; all zeros for none) with its grain's plane stride gplane in
// elements (the grain's rows contiguous, hout of them in each plane).
// easu_h_tail.cu compiles it.
extern "C" int fsr_easu_h_tail(const void* src, void* dst, int src_dtype, int out_dtype, int nb, int channels,
                               int hin, int win, int hout, int wout, const void* rows, const void* cols,
                               const void* py, const void* px, float sharp, int apply_rcas, int denoise, int srtm,
                               long long gplane, const EpilogueParams* epi, void* stream) {
  return easu_h<false, true>(src, nullptr, dst, src_dtype, out_dtype, nb, channels, hin, win, hout, wout, rows, cols,
                             py, px, sharp, apply_rcas, denoise, srtm, gplane, epi, stream);
}
#elif defined(FSR_TAIL_TU)
// K6 with the frame tail on a row strip read in place (sp, as
// fsr_easu_h_strip takes it); the epilogue's row0 is the strip's first
// global output row, its grain the strip's rows of the frame's grain
// (gplane: the frame's plane stride).  The other arguments are
// fsr_easu_h_tail's.  easu_h_tail_strip.cu compiles it.
extern "C" int fsr_easu_h_tail_strip(const StripParts* sp, void* dst, int src_dtype, int out_dtype, int nb,
                                     int channels, int hin, int win, int hout, int wout, const void* rows,
                                     const void* cols, const void* py, const void* px, float sharp, int apply_rcas,
                                     int denoise, int srtm, long long gplane, const EpilogueParams* epi,
                                     void* stream) {
  return easu_h<true, true>(nullptr, sp, dst, src_dtype, out_dtype, nb, channels, hin, win, hout, wout, rows, cols,
                            py, px, sharp, apply_rcas, denoise, srtm, gplane, epi, stream);
}
#elif !defined(FSR_STRIP_TU)
// src_dtype: the source's dtype code (fsr_pixel.cuh DType: float16,
// float32, bfloat16 or uint8); the output is float16.  channels: 3, or 4
// with alpha in plane 3 of the source and the output.  rows/cols (int32
// [4][hout + 2], [4][wout]) and py/px (float32 [hout + 2], [wout]) are
// device pointers, K2's tables; the row tables cover output rows -1..hout.
// sharp: sharpness_f16.
extern "C" int fsr_easu_h(const void* src, void* dst, int src_dtype, int nb, int channels, int hin, int win,
                          int hout, int wout, const void* rows, const void* cols, const void* py, const void* px,
                          float sharp, int apply_rcas, int denoise, void* stream) {
  return easu_h<false, false>(src, nullptr, dst, src_dtype, F16, nb, channels, hin, win, hout, wout, rows, cols, py,
                              px, sharp, apply_rcas, denoise, 0, 0, nullptr, stream);
}

// Test entry: writes rcp (fsr_half.cuh, the kernel's reciprocal) of every
// float16 bit pattern v = 0..65535 to out[v] (a device buffer of 65,536
// halves) on stream; chip_smoke.py holds it against torch's `1.0 / x`.
extern "C" int fsr_easu_h_rcp_check(void* out, void* stream) {
  rcp_check_kernel<<<128, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<unsigned int*>(out));
  return (int)cudaGetLastError();
}
#else
// K6 on a row strip read in place from its three parts (sp: fsr_pixel.cuh's
// StripParts); hin is the virtual halo'd strip's rows, own's rows plus
// 2 * halo, which the row tables (K2's, easu_gather.py:shard_plan) index.
// The other arguments are fsr_easu_h's.
extern "C" int fsr_easu_h_strip(const StripParts* sp, void* dst, int src_dtype, int nb, int channels, int hin,
                                int win, int hout, int wout, const void* rows, const void* cols, const void* py,
                                const void* px, float sharp, int apply_rcas, int denoise, void* stream) {
  return easu_h<true, false>(nullptr, sp, dst, src_dtype, F16, nb, channels, hin, win, hout, wout, rows, cols, py,
                             px, sharp, apply_rcas, denoise, 0, 0, nullptr, stream);
}
#endif
