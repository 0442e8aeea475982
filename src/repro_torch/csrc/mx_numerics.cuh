// MX element numerics on the card, shared by the quantize (B6), fake-quant
// (B7) and Slice-and-Scale (B5) kernels.
//
// Every function mirrors, per element, the plain PyTorch arithmetic of
// src/repro_torch/core/mx.py (which is bit-exact with the JAX package's
// core/mx.py), not the Pallas helpers in src/repro/kernels/common.py where
// the two differ:
//   - floor(log2 a) is frexp's (exact for subnormal a), not the biased
//     exponent bits (which read a subnormal as -127);
//   - 2^e is 0 below -126 (as XLA's ldexp flushes it), not saturated at
//     2^-126, so a block whose scale clips to -127 dequantizes to zeros;
//   - MXFP codes decode as the 256-entry LUT does, the E4M3 pattern
//     S.1111.111 included (NaN; the quantizers never produce it).
// Rounding is half to even (rintf), never roundf. Products and sums that
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

// floor(log2 a) for a > 0, as frexp gives it (subnormals included).
__device__ __forceinline__ int floor_log2(float a) {
  const int b = __float_as_int(a);
  const int ef = (b >> 23) & 0xFF;
  if (ef != 0) return ef - 127;
  return -149 + (31 - __clz(b & 0x7FFFFF));
}

// Shared block exponent from the block's max |v|, clipped to E8M0.
__device__ __forceinline__ int block_scale_exp(float amax, const MxFmt& f) {
  const int e = amax > 0.0f ? floor_log2(amax) : kScaleExpMin + f.emax;
  return min(max(e - f.emax, kScaleExpMin), kScaleExpMax);
}

// core/mx.py::quantize_fp_element_value: round half to even into the
// MXFP value set, saturating; zero (of either sign) gives +0.
__device__ __forceinline__ float quantize_fp_value(float y, const MxFmt& f) {
  const float a = fabsf(y);
  if (!(a > 0.0f)) return 0.0f;
  const int e = max(floor_log2(a), f.emin);
  const float quantum = exp2i(e - f.mbits);
  const float q = __fmul_rn(rintf(__fdiv_rn(y, quantum)), quantum);
  return fminf(fmaxf(q, -f.fp_max), f.fp_max);
}

// core/mx.py::encode_fp: an exactly representable value -> bit pattern.
__device__ __forceinline__ uint8_t encode_fp(float v, const MxFmt& f) {
  const uint32_t s = (v < 0.0f) || (v == 0.0f && signbit(v));
  const float a = fabsf(v);
  const int expo = a > 0.0f ? floor_log2(a) : 0;
  uint32_t e_field, mant;
  if (expo < f.emin || a == 0.0f) {
    e_field = 0u;
    mant = (uint32_t)(int)rintf(__fmul_rn(a, exp2i(f.mbits - f.emin)));
  } else {
    e_field = (uint32_t)(expo + f.bias);
    mant = (uint32_t)(int)rintf(__fmul_rn(
        __fsub_rn(__fmul_rn(a, exp2i(-expo)), 1.0f),
        (float)(1 << f.mbits)));
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

// The stored code of a quantized element value.
__device__ __forceinline__ uint8_t encode_value(float q, const MxFmt& f) {
  if (f.fp) return encode_fp(q, f);
  return (uint8_t)(int8_t)(int)q;
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
