// Hopper (sm_90a) block-wise MX quantization: float values -> element codes
// plus one E8M0 scale exponent per block.
//
// Replaces the TPU kernel repro/kernels/mx_quantize.py::mx_quantize_pallas
// (B6). Computes, per block of bs values along the block axis, what
// src/repro_torch/core/mx.py::quantize computes: the shared exponent
// floor(log2 max|v|) - emax clipped to [-127, 127], then each value divided
// by 2^exponent and rounded (MXINT: clip(rint), int8 codes) or encoded
// (MXFP: nearest representable value, uint8 bit patterns). The element
// arithmetic is mx_numerics.cuh's quantize_code: MXFP rounds on the float's
// bits, with no division and no value rebuilt before it is encoded.
//
// What bounds it on the H100: bytes. It reads each value once (4 or 2
// bytes) and writes one code byte per value and one scale byte per block,
// for a few dozen integer and float operations per value; the bound is
// those bytes over 3.35 TB/s.
//
// What this design does about it: the tensor is read where it lies, viewed
// as (outer, K, inner) with blocks of bs along K — a weight (K, N) blocked
// along K, or a stacked (G, K, N) leaf, with no transposed copy (the JAX
// wrapper moves the block axis last first).
//   - A thread holds 4 adjacent columns of 8 rows of one K-block:
//     eight 16-byte loads of f32 (8-byte of bf16) issued together, 32
//     registers of values for every bs. The bs / 8 lanes that hold the
//     other rows of the same columns combine the block max by shuffles.
//   - A warp covers one K-block of 128 / (bs / 8) columns: each load
//     instruction reads whole 128-byte row segments, and each thread stores
//     its four codes of a row as one 4-byte word.
//   - A block of 8 warps covers 8 consecutive K-blocks of the same
//     columns. Their scales are staged in shared memory and written out as
//     runs of 8 contiguous bytes per column (the (outer, inner, K/bs)
//     layout), not one byte per 32-byte sector.
// A tensor whose inner width is not a multiple of 4, or a buffer off the
// vector grid, runs the same kernel with one column per thread and scalar
// accesses.

#include "mx_numerics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // = K-blocks per block
constexpr int kRows = 8;               // rows of a K-block per thread

template <int C, typename T>
__device__ __forceinline__ void load_cols(const T* p, float* x, int valid);

template <>
__device__ __forceinline__ void load_cols<4, float>(const float* p, float* x,
                                                    int valid) {
  const float4 w = valid ? *reinterpret_cast<const float4*>(p)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
}

template <>
__device__ __forceinline__ void load_cols<4, __nv_bfloat16>(
    const __nv_bfloat16* p, float* x, int valid) {
  const uint2 w =
      valid ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
  x[0] = __uint_as_float(w.x << 16);
  x[1] = __uint_as_float(w.x & 0xFFFF0000u);
  x[2] = __uint_as_float(w.y << 16);
  x[3] = __uint_as_float(w.y & 0xFFFF0000u);
}

template <>
__device__ __forceinline__ void load_cols<1, float>(const float* p, float* x,
                                                    int valid) {
  x[0] = valid ? *p : 0.0f;
}

template <>
__device__ __forceinline__ void load_cols<1, __nv_bfloat16>(
    const __nv_bfloat16* p, float* x, int valid) {
  x[0] = valid ? __bfloat162float(*p) : 0.0f;
}

// (outer, K, inner) values -> codes of the same layout, scales
// (outer, inner, K/bs). Block b covers K-blocks [8 kt, 8 kt + 8) of columns
// [W ct, W ct + W) of slice o, W = (32 / S) * C.
template <typename T, int BS, int C>
__global__ void __launch_bounds__(kThreads)
mx_quantize_kernel(const T* __restrict__ v, uint8_t* __restrict__ codes,
                   int8_t* __restrict__ scales, int nkb, long long inner,
                   int k_tiles, long long c_tiles, MxFmt f) {
  constexpr int S = BS / kRows;        // lanes sharing one column group
  constexpr int G = 32 / S;            // column groups per warp
  constexpr int W = G * C;             // columns per block
  __shared__ int8_t staged[W][kWarps];

  long long b = blockIdx.x;
  const long long ct = b % c_tiles;
  b /= c_tiles;
  const int kt = (int)(b % k_tiles);
  const long long o = b / k_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = lane % G, rg = lane / G;
  const long long col = ct * W + (long long)cg * C;
  const int kb = kt * kWarps + warp;

  if (kb < nkb) {                      // warp-uniform
    const long long row0 = ((long long)o * nkb + kb) * BS + rg * kRows;
    const int valid = col < inner;     // C == 4: inner % 4 == 0
    float x[kRows][C];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      load_cols<C>(v + (row0 + r) * inner + col, x[r], valid);
    float amax[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      amax[c] = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        amax[c] = fmaxf(amax[c], fabsf(x[r][c]));
#pragma unroll
      for (int m = G; m < 32; m <<= 1)
        amax[c] = fmaxf(amax[c], __shfl_xor_sync(0xFFFFFFFFu, amax[c], m));
    }
    int se[C];
    float inv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      se[c] = block_scale_exp(amax[c], f);
      inv[c] = exp2i(-se[c]);
    }
    if (valid) {
      const uint32_t max_code = f.fp ? fp_max_code(f) : 0u;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        uint32_t word = 0u;
#pragma unroll
        for (int c = 0; c < C; ++c)
          word |= (uint32_t)quantize_code(__fmul_rn(x[r][c], inv[c]), f,
                                          max_code)
                  << (8 * c);
        uint8_t* dst = codes + (row0 + r) * inner + col;
        if constexpr (C == 4)
          *reinterpret_cast<uint32_t*>(dst) = word;
        else
          *dst = (uint8_t)word;
      }
      if (rg == 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) staged[cg * C + c][warp] = (int8_t)se[c];
      }
    }
  }
  __syncthreads();
  const int kb0 = kt * kWarps;
  const int n_kb = min(kWarps, nkb - kb0);
  for (int t = threadIdx.x; t < W * kWarps; t += kThreads) {
    const int c = t / kWarps, k = t % kWarps;
    const long long i = ct * W + c;
    if (k < n_kb && i < inner)
      scales[((long long)o * inner + i) * nkb + kb0 + k] = staged[c][k];
  }
}

template <typename T, int BS, int C>
void launch_one(const T* v, uint8_t* codes, int8_t* scales, long long outer,
                int nkb, long long inner, MxFmt f, cudaStream_t stream) {
  constexpr int W = (32 / (BS / kRows)) * C;
  const int k_tiles = (nkb + kWarps - 1) / kWarps;
  const long long c_tiles = (inner + W - 1) / W;
  const long long grid = outer * k_tiles * c_tiles;
  mx_quantize_kernel<T, BS, C><<<(unsigned)grid, kThreads, 0, stream>>>(
      v, codes, scales, nkb, inner, k_tiles, c_tiles, f);
}

template <typename T, int C>
int launch_bs(const T* v, uint8_t* codes, int8_t* scales, long long outer,
              int k, long long inner, int bs, MxFmt f, cudaStream_t s) {
  const int nkb = k / bs;
  switch (bs) {
    case 8:
      launch_one<T, 8, C>(v, codes, scales, outer, nkb, inner, f, s);
      break;
    case 16:
      launch_one<T, 16, C>(v, codes, scales, outer, nkb, inner, f, s);
      break;
    case 32:
      launch_one<T, 32, C>(v, codes, scales, outer, nkb, inner, f, s);
      break;
    case 64:
      launch_one<T, 64, C>(v, codes, scales, outer, nkb, inner, f, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* v, uint8_t* codes, int8_t* scales, long long outer,
           int k, long long inner, int bs, MxFmt f, cudaStream_t stream) {
  if (outer * (k / bs) * inner <= 0) return (int)cudaSuccess;
  const T* vt = static_cast<const T*>(v);
  const bool vec = inner % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  return vec ? launch_bs<T, 4>(vt, codes, scales, outer, k, inner, bs, f,
                               stream)
             : launch_bs<T, 1>(vt, codes, scales, outer, k, inner, bs, f,
                               stream);
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
