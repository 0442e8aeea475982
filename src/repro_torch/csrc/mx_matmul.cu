// Hopper (sm_90a) dequant-fused GEMMs over packed MX weights.
//
// Replaces the TPU kernels in repro/kernels/mx_matmul.py:
//   mx_matmul_launch      <- mx_matmul_pallas      (B1: int8 / MXFP codes)
//   mx_matmul_int4_launch <- mx_matmul_int4_pallas (B2: split-N int4 nibbles)
//
// Both compute y (M, N) f32 = x (M, K) @ dequant(W), x in bf16 or f32,
// where W's element codes are (K, N) [or split-N packed (K, N/2)] and its
// E8M0 scales sit in the serving layout (N, K/bs): one int8 exponent per
// column per K-block. Each code is decoded (MXINT as is, MXFP
// arithmetically, as repro/kernels/common.py::decode_fp_arith), scaled by
// an exact 2^e (pow2i, clamped to [-126, 127]) and accumulated in f32.
//
// What bounds it on the H100: at decode (M = batch slots, a handful of rows)
// the whole weight streams from HBM once per call for ~2·M flops per code
// byte, so the bound is bytes: codes + scales over 3.35 TB/s. In prefill the
// flops grow with M while the bytes do not; every dequantized MX value is
// exact in bf16, so bf16 tensor cores (989 TFLOP/s) could do the work, and
// the flop bound takes over once M passes about 150 at 8 bits (about 75 at
// 4 bits).
//
// What this design does about it: it reads every code byte once per M-tile
// of 8 rows with coalesced 4-byte loads along N (4 output columns per
// thread), never materialises a dense weight, and spreads K over 32 thread
// groups inside a block so that even N = 1024 gives 32 blocks. With one
// block or two per SM, latency, not bandwidth, limits it, so each thread
// issues a chunk of 16 code rows' loads before using any. It uses the CUDA
// cores (FMA), not tensor cores: simple and right first, and far from both
// bounds; wgmma/TMA pipelines are later work.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmx_matmul.so mx_matmul.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerThread = 4;
constexpr int kBlockN = 32;                               // columns per block
constexpr int kColThreads = kBlockN / kColsPerThread;     // 8
constexpr int kKGroups = kThreads / kColThreads;          // 32
constexpr int kBlockM = 8;                                // rows per block

constexpr int kModeInt = 0;    // int8 two's-complement MXINT codes
constexpr int kModeFp = 1;     // uint8 MXFP bit patterns
constexpr int kModeInt4 = 2;   // split-N packed int4 nibbles

struct Fmt {
  int bits, ebits, mbits, bias, emin, bs;
};

__device__ __forceinline__ float pow2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ float decode_fp(uint32_t c, const Fmt& f) {
  const uint32_t s = (c >> (f.bits - 1)) & 1u;
  const int e = (int)((c >> f.mbits) & ((1u << f.ebits) - 1u));
  const float mf = (float)(c & ((1u << f.mbits) - 1u)) * pow2i(-f.mbits);
  const float mag = e > 0 ? (1.0f + mf) * pow2i(e - f.bias)
                          : mf * pow2i(f.emin);
  return s ? -mag : mag;
}

// int4 loads are sign-extended to int8 byte lanes when loaded, so MXINT4
// decodes like MXINT8 (one byte-to-float conversion per code).
template <int MODE>
__device__ __forceinline__ float decode(uint32_t c, const Fmt& f) {
  if (MODE == kModeFp) return decode_fp(c, f);
  return (float)(int)(int8_t)(uint8_t)c;
}

// Four zero-extended nibbles, one per byte lane -> four int8 values:
// ((n ^ 8) - 8) in each lane, with no borrow across lanes.
__device__ __forceinline__ uint32_t sign_extend_nibbles(uint32_t w) {
  return __vsub4(w ^ 0x08080808u, 0x08080808u);
}

// Codes of output columns n0..n0+3 at row k, one per byte lane of the
// returned word. Columns >= N read as code 0, which decodes to 0 in every
// format. On the vector path (``full``: 4 in-range columns, aligned) int4
// returns the raw packed word, whose nibbles ``int4_lanes`` extracts after
// all of a chunk's loads are issued; the scalar path returns finished int8
// lanes.
template <int MODE>
__device__ __forceinline__ uint32_t load_codes(
    const uint8_t* __restrict__ codes, int k, int n0, int N, bool full) {
  if (MODE != kModeInt4) {
    const uint8_t* row = codes + (size_t)k * N;
    if (full) return *reinterpret_cast<const uint32_t*>(row + n0);
    uint32_t word = 0u;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      if (n0 + j < N) word |= (uint32_t)row[n0 + j] << (8 * j);
    return word;
  }
  // Split-N: byte j holds column j (low nibble) and j + N/2 (high).
  const int half = N / 2;
  const uint8_t* row = codes + (size_t)k * half;
  if (full) {
    // the vector path needs half % 4 == 0: the 4 columns share one half
    return *reinterpret_cast<const uint32_t*>(row + (n0 >= half ? n0 - half
                                                                : n0));
  }
  uint32_t word = 0u;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int n = n0 + j;
    const uint32_t b = n >= N ? 0u
                       : n < half ? row[n] & 0xFu : row[n - half] >> 4;
    word |= b << (8 * j);
  }
  return sign_extend_nibbles(word);
}

// The four int8 lanes of a raw split-N word: low nibbles for columns in the
// first half (hi == 0), high nibbles for the second.
__device__ __forceinline__ uint32_t int4_lanes(uint32_t raw, int hi) {
  return sign_extend_nibbles((raw >> (4 * hi)) & 0x0F0F0F0Fu);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Grid: (ceil(N / 32), ceil(M / 8)). Thread t owns columns
// n0 = 32·bx + 4·(t % 8) .. n0+3 and the K-blocks kb ≡ t / 8 (mod 32); the
// 32 K-group partial sums meet in shared memory at the end. Each K-block is
// walked CHUNK rows at a time, all CHUNK code loads issued before any is
// used, so every thread keeps CHUNK loads in flight.
template <int MODE, typename XT, int CHUNK>
__global__ void __launch_bounds__(kThreads)
mx_mm_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ codes,
             const int8_t* __restrict__ scales, float* __restrict__ y, int M,
             int K, int N, Fmt f, int vec) {
  __shared__ float red[kKGroups][kBlockM][kBlockN];   // 32 KB
  const int ct = threadIdx.x % kColThreads;
  const int g = threadIdx.x / kColThreads;
  const int n0 = blockIdx.x * kBlockN + ct * kColsPerThread;
  const int m0 = blockIdx.y * kBlockM;
  const int mcount = min(kBlockM, M - m0);
  const int nkb = K / f.bs;
  const bool full = vec != 0 && n0 + kColsPerThread <= N;
  const int hi = n0 >= N / 2;          // int4: which nibble these columns use

  float acc[kBlockM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kBlockM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.0f;

  for (int kb = g; kb < nkb; kb += kKGroups) {
    float s[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int n = n0 + j;
      s[j] = n < N ? pow2i(scales[(size_t)n * nkb + kb]) : 0.0f;
    }
    for (int k0 = kb * f.bs; k0 < (kb + 1) * f.bs; k0 += CHUNK) {
      uint32_t word[CHUNK];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u)
        word[u] = load_codes<MODE>(codes, k0 + u, n0, N, full);
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        if (MODE == kModeInt4 && full) word[u] = int4_lanes(word[u], hi);
        float w[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          w[j] = decode<MODE>((word[u] >> (8 * j)) & 0xFFu, f) * s[j];
        const XT* xk = x + (size_t)m0 * K + k0 + u;
#pragma unroll
        for (int m = 0; m < kBlockM; ++m) {
          if (m < mcount) {
            const float xv = to_float(xk[(size_t)m * K]);
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j)
              acc[m][j] = fmaf(xv, w[j], acc[m][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kBlockM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      red[g][m][ct * kColsPerThread + j] = acc[m][j];
  __syncthreads();

  // kThreads == kBlockM * kBlockN: one output element per thread.
  const int m = threadIdx.x / kBlockN;
  const int col = threadIdx.x % kBlockN;
  const int n = blockIdx.x * kBlockN + col;
  if (m < mcount && n < N) {
    float sum = 0.0f;
#pragma unroll 8
    for (int gg = 0; gg < kKGroups; ++gg) sum += red[gg][m][col];
    y[(size_t)(m0 + m) * N + n] = sum;
  }
}

template <int MODE, typename XT>
int launch(const void* x, const uint8_t* codes, const int8_t* scales,
           float* y, int M, int K, int N, Fmt f, int vec,
           cudaStream_t stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
  const XT* xt = static_cast<const XT*>(x);
  if (f.bs % 16 == 0) {
    mx_mm_kernel<MODE, XT, 16><<<grid, kThreads, 0, stream>>>(
        xt, codes, scales, y, M, K, N, f, vec);
  } else if (f.bs % 8 == 0) {
    mx_mm_kernel<MODE, XT, 8><<<grid, kThreads, 0, stream>>>(
        xt, codes, scales, y, M, K, N, f, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_x(const void* x, int x_bf16, const uint8_t* codes,
             const int8_t* scales, float* y, int M, int K, int N, Fmt f,
             int vec, cudaStream_t stream) {
  return x_bf16 ? launch<MODE, __nv_bfloat16>(x, codes, scales, y, M, K, N,
                                              f, vec, stream)
                : launch<MODE, float>(x, codes, scales, y, M, K, N, f, vec,
                                      stream);
}

}  // namespace

extern "C" {

// B1. x is (M, K) f32 (x_bf16 == 0) or bf16 (x_bf16 == 1), row-major.
// fp == 0: int8 MXINT codes; fp == 1: uint8 MXFP bit patterns with the given
// (bits, ebits, mbits, bias, emin). bs must be a multiple of 8. vec != 0
// promises N % 4 == 0 and a 4-byte-aligned codes pointer. Returns
// cudaGetLastError() after the launch.
int mx_matmul_launch(const void* x, int x_bf16, const uint8_t* codes,
                     const int8_t* scales, float* y, int M, int K, int N,
                     int fp, int bits, int ebits, int mbits, int bias,
                     int emin, int bs, int vec, void* stream) {
  const Fmt f{bits, ebits, mbits, bias, emin, bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fp ? launch_x<kModeFp>(x, x_bf16, codes, scales, y, M, K, N, f, vec,
                                s)
            : launch_x<kModeInt>(x, x_bf16, codes, scales, y, M, K, N, f,
                                 vec, s);
}

// B2. packed is split-N (K, N/2) uint8; vec != 0 promises (N/2) % 4 == 0 and
// a 4-byte-aligned packed pointer.
int mx_matmul_int4_launch(const void* x, int x_bf16, const uint8_t* packed,
                          const int8_t* scales, float* y, int M, int K, int N,
                          int bs, int vec, void* stream) {
  const Fmt f{4, 0, 0, 0, 0, bs};
  return launch_x<kModeInt4>(x, x_bf16, packed, scales, y, M, K, N, f, vec,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
