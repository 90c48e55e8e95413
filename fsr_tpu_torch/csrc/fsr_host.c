/* fsr_host: native host-side constant setup for the TPU FSR library.
 *
 * The reference computes its constant blocks on the CPU in C
 * (FsrEasuCon / FsrEasuConOffset / FsrRcasCon, ffx_fsr1.h:156-225,662-672,
 * compiled with A_CPU); this is the equivalent native layer for our
 * runtime: per-frame constant setup callable from C/C++ hosts or through
 * the ctypes binding (fsr_tpu.core.native), producing bit-identical
 * constant blocks to the Python implementation (verified in
 * tests/test_native.py).
 *
 * Build: make -C csrc   ->  csrc/libfsr_host.so
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

#define FSR_EXPORT __attribute__((visibility("default")))

static uint32_t f32_bits(float f) {
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  return u;
}

/* float32 -> IEEE binary16 bits, round-to-nearest-even (including
 * denormals, overflow to +/-inf). */
FSR_EXPORT uint16_t fsr_f32_to_f16_bits(float f) {
  uint32_t x = f32_bits(f);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = x & 0x7FFFFFu;

  if (((x >> 23) & 0xFF) == 0xFF) { /* inf/NaN */
    return (uint16_t)(sign | 0x7C00u | (mant ? 0x200u : 0u));
  }
  if (exp >= 0x1F) { /* overflow -> inf */
    return (uint16_t)(sign | 0x7C00u);
  }
  if (exp <= 0) { /* subnormal or zero */
    if (exp < -10) return (uint16_t)sign;
    mant |= 0x800000u; /* implicit bit */
    int shift = 14 - exp; /* 14..24 */
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1u);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half & 1u))) half++;
    return (uint16_t)(sign | half);
  }
  /* normal */
  uint32_t half = (uint32_t)(exp << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) half++;
  return (uint16_t)(sign | half);
}

/* EASU constants: 4x uvec4 of bit-cast float32, exactly the reference's
 * con0..con3 layout.  All arithmetic in float32. */
FSR_EXPORT void fsr_easu_con(
    uint32_t con[16],
    float input_viewport_w, float input_viewport_h,
    float input_size_w, float input_size_h,
    float output_size_w, float output_size_h) {
  float rw = 1.0f / output_size_w;
  float rh = 1.0f / output_size_h;
  float ix = 1.0f / input_size_w;
  float iy = 1.0f / input_size_h;
  con[0] = f32_bits(input_viewport_w * rw);
  con[1] = f32_bits(input_viewport_h * rh);
  con[2] = f32_bits(0.5f * input_viewport_w * rw - 0.5f);
  con[3] = f32_bits(0.5f * input_viewport_h * rh - 0.5f);
  con[4] = f32_bits(ix);
  con[5] = f32_bits(iy);
  con[6] = f32_bits(1.0f * ix);
  con[7] = f32_bits(-1.0f * iy);
  con[8] = f32_bits(-1.0f * ix);
  con[9] = f32_bits(2.0f * iy);
  con[10] = f32_bits(1.0f * ix);
  con[11] = f32_bits(2.0f * iy);
  con[12] = f32_bits(0.0f * ix);
  con[13] = f32_bits(4.0f * iy);
  con[14] = 0;
  con[15] = 0;
}

FSR_EXPORT void fsr_easu_con_offset(
    uint32_t con[16],
    float input_viewport_w, float input_viewport_h,
    float input_size_w, float input_size_h,
    float output_size_w, float output_size_h,
    float input_offset_x, float input_offset_y) {
  fsr_easu_con(con, input_viewport_w, input_viewport_h,
               input_size_w, input_size_h, output_size_w, output_size_h);
  /* ARcpF1 semantics: multiply by the reciprocal, not a direct divide. */
  float rw = 1.0f / output_size_w;
  float rh = 1.0f / output_size_h;
  con[2] = f32_bits(0.5f * input_viewport_w * rw - 0.5f + input_offset_x);
  con[3] = f32_bits(0.5f * input_viewport_h * rh - 0.5f + input_offset_y);
}

/* RCAS constant: sharpness in stops -> linear, plus packed-half pair. */
FSR_EXPORT void fsr_rcas_con(uint32_t con[4], float sharpness_stops) {
  float sharp = exp2f(-sharpness_stops);
  con[0] = f32_bits(sharp);
  uint32_t h = fsr_f32_to_f16_bits(sharp);
  con[1] = h | (h << 16);
  con[2] = 0;
  con[3] = 0;
}
