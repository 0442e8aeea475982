// Hopper (sm_90a) Slice-and-Scale: convert packed MX codes and scales from a
// high-precision format to a lower one of the same kind, without the float
// weights.
//
// Replaces the TPU kernel repro/kernels/ss_convert.py::ss_convert_pallas
// (B5). Computes what src/repro_torch/core/slice_scale.py::slice_and_scale
// computes, with de = emax(high) - emax(low):
//   MXINT (paper Eq. 4): each int8 code shifted right by de with round half
//         to even on int32, then clipped to +-maxq(low);
//   MXFP  (Eq. 6): each code decoded (the LUT's values), multiplied by
//         2^-de, rounded into the low format and encoded;
//   scales: exponent + de, clipped to [-127, 127].
// A code's result depends on the code byte alone — not on its neighbours,
// not on its block's scale — so every conversion, MXINT and MXFP alike, is
// a 256-entry byte table, and the kernel walks codes and scales as flat
// byte arrays in whatever layout they have.
//
// A second mode writes the served 4-bit MXINT container directly: codes
// (rows, N) become split-N nibble bytes (rows, N/2), byte j of a row holding
// the converted code j in its low nibble and code j + N/2 in its high one —
// core/packed.py::pack_int4_splitn of the converted codes, which B2 reads —
// with no int8 temporary.
//
// What bounds it on the H100: bytes. It reads and writes one byte per code
// (the split-N mode writes half a byte) and one per block scale; the bound
// is those bytes over 3.35 TB/s.
//
// What this design does about it: each block first builds the table in
// shared memory, one entry per thread with the device functions of
// mx_numerics.cuh (exact by construction), behind one barrier; the MXFP
// arithmetic is then paid 256 times per block instead of once per code.
// Codes then move by 16-byte loads and stores (streaming cache hints), up
// to four in flight per thread, each byte one shared-memory lookup (a
// 256-byte table: at most 2-way bank conflicts); scales move 16 bytes at a
// time too, four per SIMD add. The grid is up to 8 blocks per SM (the SM
// count the runtime reports), a thread per 16-byte chunk for a small leaf,
// walking the buffers in a grid-stride loop, so a whole stacked leaf is one
// launch with no host read. A ragged tail, or a buffer off the 16-byte
// grid, takes a byte-at-a-time path in the same kernel.

#include <algorithm>

#include "mx_numerics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kUnroll = 4;            // 16-byte chunks in flight per thread

__device__ __forceinline__ uint8_t ss_code(uint8_t c, int de,
                                           const MxFmt& hi,
                                           const MxFmt& lo) {
  if (!hi.fp) {
    const int p = (int)(int8_t)c;
    int q = p;
    if (de > 0) {
      q = p >> de;                          // floor division
      const int r = p - q * (1 << de);      // remainder in [0, 2^de)
      const int half = 1 << (de - 1);
      q += (r > half) || (r == half && (q & 1));
    }
    q = min(max(q, -lo.maxq), lo.maxq);
    return (uint8_t)(int8_t)q;
  }
  const float y = __fmul_rn(decode_fp(c, hi), exp2i(-de));
  return encode_fp(quantize_fp_value(y, lo), lo);
}

// Four bytes of w looked up in t.
__device__ __forceinline__ uint32_t lookup4(const uint8_t* t, uint32_t w) {
  return (uint32_t)t[w & 0xFFu] | ((uint32_t)t[(w >> 8) & 0xFFu] << 8) |
         ((uint32_t)t[(w >> 16) & 0xFFu] << 16) |
         ((uint32_t)t[w >> 24] << 24);
}

__device__ __forceinline__ uint4 lookup16(const uint8_t* t, uint4 w) {
  return make_uint4(lookup4(t, w.x), lookup4(t, w.y), lookup4(t, w.z),
                    lookup4(t, w.w));
}

// Four bytes of nibbles: byte k = t[lo byte k] | t[hi byte k] << 4 (t holds
// the codes' low nibbles).
__device__ __forceinline__ uint32_t nibbles4(const uint8_t* t, uint32_t lo,
                                             uint32_t hi) {
  return lookup4(t, lo) | (lookup4(t, hi) << 4);
}

__device__ __forceinline__ uint4 nibbles16(const uint8_t* t, uint4 lo,
                                           uint4 hi) {
  return make_uint4(nibbles4(t, lo.x, hi.x), nibbles4(t, lo.y, hi.y),
                    nibbles4(t, lo.z, hi.z), nibbles4(t, lo.w, hi.w));
}

__device__ __forceinline__ int8_t bump_scale(int8_t s, int de) {
  return (int8_t)min(max((int)s + de, kScaleExpMin), kScaleExpMax);
}

// clip(s + de, -127, 127) on four int8 lanes: a saturating add, then a max
// with -127 (0x81).
__device__ __forceinline__ uint32_t bump4(uint32_t s, uint32_t de4) {
  return __vmaxs4(__vaddss4(s, de4), 0x81818181u);
}

template <bool kSplitN>
__global__ void __launch_bounds__(kThreads)
ss_convert_kernel(const uint8_t* __restrict__ codes,
                  uint8_t* __restrict__ out, long long n, long long half,
                  const int8_t* __restrict__ scales,
                  int8_t* __restrict__ out_scales, long long n_scales,
                  int de, int vec_codes, int vec_scales, MxFmt hi,
                  MxFmt lo) {
  __shared__ uint8_t table[256];
  {
    const uint8_t c = ss_code((uint8_t)threadIdx.x, de, hi, lo);
    table[threadIdx.x] = kSplitN ? (uint8_t)(c & 0xFu) : c;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (!kSplitN) {
    // n codes -> n codes
    const long long n16 = vec_codes ? n / 16 : 0;
    const uint4* in16 = reinterpret_cast<const uint4*>(codes);
    uint4* out16 = reinterpret_cast<uint4*>(out);
    for (long long c0 = t0; c0 < n16; c0 += kUnroll * stride) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + u * stride < n16) w[u] = __ldcs(in16 + c0 + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + u * stride < n16)
          __stcs(out16 + c0 + u * stride, lookup16(table, w[u]));
    }
    for (long long t = 16 * n16 + t0; t < n; t += stride)
      out[t] = table[codes[t]];
  } else {
    // rows of 2 * half codes -> rows of half nibble bytes
    const long long rows = n / (2 * half);
    const long long per_row = vec_codes ? half / 16 : 0;
    const long long n16 = rows * per_row;
    for (long long c0 = t0; c0 < n16; c0 += kUnroll * stride) {
      uint4 lo_w[kUnroll], hi_w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long c = c0 + u * stride;
        if (c < n16) {
          // 32-bit division (the launcher keeps the chunk count below
          // 2^32; a 64-bit one costs several times more)
          const long long r = (uint32_t)c / (uint32_t)per_row;
          const long long j = (c - r * per_row) * 16;
          const uint8_t* src = codes + r * 2 * half + j;
          lo_w[u] = __ldcs(reinterpret_cast<const uint4*>(src));
          hi_w[u] = __ldcs(reinterpret_cast<const uint4*>(src + half));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long c = c0 + u * stride;
        if (c < n16)
          __stcs(reinterpret_cast<uint4*>(out) + c,
                 nibbles16(table, lo_w[u], hi_w[u]));
      }
    }
    // every byte when the 16-byte path did not run (it covers whole rows)
    const long long n_out = rows * half;
    for (long long t = 16 * n16 + t0; t < n_out; t += stride) {
      const long long r = t / half, j = t - r * half;
      const uint8_t* src = codes + r * 2 * half + j;
      out[t] = (uint8_t)(table[src[0]] | (table[src[half]] << 4));
    }
  }

  const long long s16 = vec_scales ? n_scales / 16 : 0;
  const uint32_t de4 = (uint32_t)de * 0x01010101u;
  for (long long t = t0; t < s16; t += stride) {
    const uint4 s = reinterpret_cast<const uint4*>(scales)[t];
    reinterpret_cast<uint4*>(out_scales)[t] = make_uint4(
        bump4(s.x, de4), bump4(s.y, de4), bump4(s.z, de4), bump4(s.w, de4));
  }
  for (long long t = 16 * s16 + t0; t < n_scales; t += stride)
    out_scales[t] = bump_scale(scales[t], de);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// B5. codes hold n code bytes (int8 MXINT or uint8 MXFP), scales/out_scales
// n_scales int8 exponents; hi and lo are formats of the same kind and
// de = emax(hi) - emax(lo) >= 0.
//   half == 0: out holds n converted codes;
//   half > 0 : codes are rows of 2 * half codes (split-N, 4-bit MXINT low
//              format) and out holds rows of half nibble bytes.
// Returns the CUDA error of the launch (cudaSuccess if nothing to do).
int ss_convert_launch(const uint8_t* codes, uint8_t* out, long long n,
                      long long half, const int8_t* scales,
                      int8_t* out_scales, long long n_scales, int de,
                      MxFmt hi, MxFmt lo, void* stream) {
  if (n <= 0 && n_scales <= 0) return (int)cudaSuccess;
  if (half < 0 || (half > 0 && (n % (2 * half) != 0 ||
                                n / 32 > 0xFFFFFFFFLL)))  // 32-bit chunks
    return (int)cudaErrorInvalidValue;
  const int vec_codes = aligned16(codes) && aligned16(out) &&
                        (half == 0 || half % 16 == 0);
  const int vec_scales = aligned16(scales) && aligned16(out_scales);
  // a thread for each 16-byte chunk (each byte off the vector path) up to
  // kBlocksPerSm blocks per SM, so a small leaf still spreads over the card
  const long long work_codes =
      half == 0 ? (vec_codes ? n / 16 + n % 16 : n)
                : (vec_codes ? n / 32 : n / 2);
  const long long work_scales = vec_scales ? n_scales / 16 + 16 : n_scales;
  const long long work = std::max({work_codes, work_scales, 1LL});
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = std::min((work + kThreads - 1) / kThreads,
                                    (long long)sms * kBlocksPerSm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half == 0)
    ss_convert_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        codes, out, n, 0, scales, out_scales, n_scales, de, vec_codes,
        vec_scales, hi, lo);
  else
    ss_convert_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        codes, out, n, half, scales, out_scales, n_scales, de, vec_codes,
        vec_scales, hi, lo);
  return (int)cudaGetLastError();
}

}  // extern "C"
