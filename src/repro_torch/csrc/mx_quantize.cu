// Hopper (sm_90a) block-wise MX quantization: float values -> element codes
// plus one E8M0 scale exponent per block.
//
// Replaces the TPU kernel repro/kernels/mx_quantize.py::mx_quantize_pallas
// (B6). Computes, per block of bs values along the block axis, what
// src/repro_torch/core/mx.py::quantize computes: the shared exponent
// floor(log2 max|v|) - emax clipped to [-127, 127], then each value divided
// by 2^exponent and rounded (MXINT: clip(rint), int8 codes) or encoded
// (MXFP: nearest representable value, uint8 bit patterns). The element
// arithmetic is in mx_numerics.cuh.
//
// What bounds it on the H100: bytes. It reads each value once (4 or 2
// bytes) and writes one code byte per value and one scale byte per block,
// for a few dozen integer and float operations per value, far below the
// card's operation rate; the bound is those bytes over 3.35 TB/s.
//
// What this design does about it: the tensor is read where it lies, viewed
// as (outer, K, inner) with blocks of bs along K — a weight (K, N) blocked
// along K, or a stacked (G, K, N) leaf, with no transposed copy (the JAX
// wrapper moves the block axis last first). One thread owns one
// (outer, K-block, inner column): consecutive threads take consecutive
// inner columns, so each of the bs loads of a warp is one coalesced
// 128-byte row segment, all bs loads are issued before any is used, and
// the block max stays in registers. Scales are written in MXTensor's
// blocked layout (outer, inner, K/bs). Simple and right first; vector
// loads and wider code stores are later work.

#include "mx_numerics.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads)
mx_quantize_kernel(const T* __restrict__ v, uint8_t* __restrict__ codes,
                   int8_t* __restrict__ scales, long long outer, int nkb,
                   long long inner, MxFmt f) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= outer * nkb * inner) return;
  const long long i = t % inner;
  const long long r = t / inner;
  const int kb = (int)(r % nkb);
  const long long o = r / nkb;
  const long long base = (o * nkb * BS + (long long)kb * BS) * inner + i;

  float x[BS];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < BS; ++j) x[j] = load_f32(v + base + j * inner);
#pragma unroll
  for (int j = 0; j < BS; ++j) amax = fmaxf(amax, fabsf(x[j]));
  const int se = block_scale_exp(amax, f);
  const float inv = exp2i(-se);
#pragma unroll
  for (int j = 0; j < BS; ++j)
    codes[base + j * inner] =
        encode_value(quantize_value(__fmul_rn(x[j], inv), f), f);
  scales[(o * inner + i) * nkb + kb] = (int8_t)se;
}

template <typename T>
int launch(const void* v, uint8_t* codes, int8_t* scales, long long outer,
           int k, long long inner, int bs, MxFmt f, cudaStream_t stream) {
  const long long work = outer * (k / bs) * inner;
  if (work <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((work + kThreads - 1) / kThreads);
  const T* vt = static_cast<const T*>(v);
  const int nkb = k / bs;
  switch (bs) {
    case 8:
      mx_quantize_kernel<T, 8><<<grid, kThreads, 0, stream>>>(
          vt, codes, scales, outer, nkb, inner, f);
      break;
    case 16:
      mx_quantize_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
          vt, codes, scales, outer, nkb, inner, f);
      break;
    case 32:
      mx_quantize_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          vt, codes, scales, outer, nkb, inner, f);
      break;
    case 64:
      mx_quantize_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          vt, codes, scales, outer, nkb, inner, f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B6. v is a contiguous (outer, K, inner) tensor, f32 (v_bf16 == 0) or bf16
// (v_bf16 == 1); codes is (outer, K, inner) bytes, scales (outer, inner,
// K/bs) int8. bs is 8, 16, 32 or 64 and divides K. Returns
// cudaGetLastError() after the launch.
int mx_quantize_launch(const void* v, int v_bf16, uint8_t* codes,
                       int8_t* scales, long long outer, int k,
                       long long inner, int bs, MxFmt f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return v_bf16 ? launch<__nv_bfloat16>(v, codes, scales, outer, k, inner,
                                        bs, f, s)
                : launch<float>(v, codes, scales, outer, k, inner, bs, f, s);
}

}  // extern "C"
