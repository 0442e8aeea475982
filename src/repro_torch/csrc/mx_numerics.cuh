// MX element numerics on the card, shared by the quantize (B6), fake-quant
// (B7) and Slice-and-Scale (B5) kernels.
//
// Every function gives, per element, the result of the plain PyTorch
// arithmetic of src/repro_torch/core/mx.py (which is bit-exact with the
// JAX package's core/mx.py), not of the Pallas helpers in
// src/repro/kernels/common.py where the two differ:
//   - floor(log2 a) is frexp's (exact for subnormal a, -1 for inf), not
//     the biased exponent bits (which read a subnormal as -127);
//   - 2^e is 0 below -126 (as XLA's ldexp flushes it), not saturated at
//     2^-126, so a block whose scale clips to -127 dequantizes to zeros;
//   - MXFP codes decode as the 256-entry LUT does, the E4M3 pattern
//     S.1111.111 included (NaN; the quantizers never produce it).
// Rounding is half to even (rintf, or on an MXFP value's bits), never
// roundf; the MXFP element path has no division. Products and sums that
// the plain version rounds one at a time use the _rn intrinsics, so nvcc
// cannot contract them into an FMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One MX element format, as kernels/common.py::MxFmt passes it (by value).
struct MxFmt {
  int fp;          // 0: MXINT (int8 codes), 1: MXFP (uint8 bit patterns)
  int bits;
  int ebits;
  int mbits;
  int bias;        // MXFP exponent bias
  int emin;        // MXFP smallest normal exponent
  int emax;        // exponent of the largest element (MXINT: bits - 2)
  int maxq;        // MXINT largest magnitude, 2^(bits-1) - 1
  float fp_max;    // MXFP largest magnitude
};

constexpr int kScaleExpMin = -127;
constexpr int kScaleExpMax = 127;

// 2^e as core/mx.py::_exp2i: exact on [-126, 127], +inf above, 0 below.
__device__ __forceinline__ float exp2i(int e) {
  if (e < -126) return 0.0f;
  return __int_as_float((min(e, 128) + 127) << 23);
}

// floor(log2 a) for a > 0, as frexp gives it (subnormals included). For
// +-inf (and NaN) frexp stores exponent 0, so this gives -1, as the plain
// version's frexp does: a block holding inf gets that scale.
__device__ __forceinline__ int floor_log2(float a) {
  const int b = __float_as_int(a);
  const int ef = (b >> 23) & 0xFF;
  if (ef == 0xFF) return -1;
  if (ef != 0) return ef - 127;
  return -149 + (31 - __clz(b & 0x7FFFFF));
}

// Shared block exponent from the block's max |v|, clipped to E8M0.
__device__ __forceinline__ int block_scale_exp(float amax, const MxFmt& f) {
  const int e = amax > 0.0f ? floor_log2(amax) : kScaleExpMin + f.emax;
  return min(max(e - f.emax, kScaleExpMin), kScaleExpMax);
}

// The bits a of a normal f32 (sign cleared) rounded half to even to mbits
// mantissa bits, as one integer: (exponent field << mbits) | mantissa, a
// mantissa carry stepping the exponent.
__device__ __forceinline__ uint32_t round_bits(uint32_t a, int mbits) {
  const int shift = 23 - mbits;
  return (a + (1u << (shift - 1)) - 1u + ((a >> shift) & 1u)) >> shift;
}

// core/mx.py::quantize_fp_element_value: round half to even into the
// MXFP value set, saturating; zero (of either sign) and NaN give +0.
//
// The plain version divides y by quantum = 2^(e - mbits) and rounds. Here
// the rounding is done on the float's bits, with no division: where
// |y| >= 2^emin, y is a normal f32 and round_bits gives the nearest value;
// below 2^emin the quantum is 2^(emin - mbits), an exact power of two, so
// rint(|y| * 2^(mbits - emin)) * 2^(emin - mbits) is the plain version's
// y / quantum rounded, bit for bit. Saturation is a min with fp_max (inf,
// and a finite value that rounds up to inf, included); the sign is put
// back last, so a negative value that rounds to zero is -0 as in the plain
// version.
__device__ __forceinline__ float quantize_fp_value(float y, const MxFmt& f) {
  const uint32_t b = __float_as_uint(y);
  const uint32_t a = b & 0x7FFFFFFFu;
  // both roundings, then a select: neighbouring lanes take either
  const float normal = fminf(
      __uint_as_float(round_bits(a, f.mbits) << (23 - f.mbits)), f.fp_max);
  const float sub = __fmul_rn(rintf(__fmul_rn(__uint_as_float(a),
                                              exp2i(f.mbits - f.emin))),
                              exp2i(f.emin - f.mbits));
  const float q = a >= (uint32_t)(f.emin + 127) << 23 ? normal : sub;
  return a - 1u < 0x7F800000u                 // not +-0, not NaN
      ? __uint_as_float(__float_as_uint(q) | (b & 0x80000000u)) : 0.0f;
}

// core/mx.py::encode_fp: an exactly representable value (never NaN) -> bit
// pattern. A normal value of the format is a normal f32 whose exponent and
// top mbits mantissa bits are the code's fields, so they are read off the
// float's bits; a subnormal one (below 2^emin) is m * 2^(emin - mbits)
// with an integer m < 2^mbits, which the product gives exactly.
__device__ __forceinline__ uint8_t encode_fp(float v, const MxFmt& f) {
  const uint32_t b = __float_as_uint(v);
  const uint32_t s = b >> 31;
  const float a = fabsf(v);
  const int expo = (int)((b >> 23) & 0xFFu) - 127;
  uint32_t e_field, mant;
  if (expo < f.emin) {                     // format subnormals and zeros
    e_field = 0u;
    mant = (uint32_t)__fmul_rn(a, exp2i(f.mbits - f.emin));
  } else {
    e_field = (uint32_t)(expo + f.bias);
    mant = (b >> (23 - f.mbits)) & ((1u << f.mbits) - 1u);
  }
  return (uint8_t)((s << (f.bits - 1)) | (e_field << f.mbits) | mant);
}

// core/mx.py::decode_fp (the LUT): bit pattern -> value.
__device__ __forceinline__ float decode_fp(uint32_t c, const MxFmt& f) {
  c &= (1u << f.bits) - 1u;
  const uint32_t s = (c >> (f.bits - 1)) & 1u;
  const int e = (int)((c >> f.mbits) & ((1u << f.ebits) - 1u));
  const uint32_t m = c & ((1u << f.mbits) - 1u);
  if (f.ebits == 4 && f.mbits == 3 && e == 15 && m == 7u)
    return __int_as_float(0x7FC00000);
  const float mag = e > 0
      ? __fmul_rn(1.0f + (float)m * exp2i(-f.mbits), exp2i(e - f.bias))
      : __fmul_rn((float)m, exp2i(f.emin - f.mbits));
  return s ? -mag : mag;
}

// The quantized element value of y (already divided by the block scale):
// MXINT clip(round(y)), MXFP the nearest representable value.
__device__ __forceinline__ float quantize_value(float y, const MxFmt& f) {
  if (f.fp) return quantize_fp_value(y, f);
  return fminf(fmaxf(rintf(y), (float)-f.maxq), (float)f.maxq);
}

// The largest MXFP code magnitude: the code of fp_max (E4M3: 0x7E, the
// pattern above it is NaN; the other formats: all ones).
__device__ __forceinline__ uint32_t fp_max_code(const MxFmt& f) {
  return encode_fp(f.fp_max, f);
}

// The stored code of quantize_value(y, f) in one pass, for the quantizer.
// MXFP: where |y| >= 2^emin the rounded bits (round_bits) are the code's
// fields less a constant exponent offset; below 2^emin the code is
// rint(|y| * 2^(mbits - emin)), the subnormal mantissa. Codes grow with the
// magnitude, so saturation at fp_max is a min with its code (inf included:
// its bits round past every code). +-0 and NaN give +0; a negative value
// that rounds to zero keeps its sign bit, as the plain encoder of -0 does.
__device__ __forceinline__ uint8_t quantize_code(float y, const MxFmt& f,
                                                 uint32_t max_code) {
  if (!f.fp) return (uint8_t)(int8_t)(int)quantize_value(y, f);
  const uint32_t b = __float_as_uint(y);
  const uint32_t a = b & 0x7FFFFFFFu;
  const uint32_t normal =
      round_bits(a, f.mbits) - ((uint32_t)(127 - f.bias) << f.mbits);
  const uint32_t sub = __float2uint_rz(rintf(
      __fmul_rn(__uint_as_float(a), exp2i(f.mbits - f.emin))));
  const uint32_t mag = a >= (uint32_t)(f.emin + 127) << 23 ? normal : sub;
  const uint32_t code = ((b >> 31) << (f.bits - 1)) | min(mag, max_code);
  return (uint8_t)(a - 1u < 0x7F800000u ? code : 0u);   // +-0, NaN: 0
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The value rounded to T (round half to even), back in f32.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
