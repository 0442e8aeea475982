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
// Both are elementwise — a code needs no other code and not its block's
// scale — so the kernel walks codes and scales as flat byte arrays in
// whatever layout they have.
//
// What bounds it on the H100: bytes. It reads and writes one byte per code
// and one per block scale, for a handful of integer operations per code
// (MXFP: a few dozen); the bound is those bytes over 3.35 TB/s.
//
// What this design does about it: each thread converts four codes from one
// aligned 4-byte load and stores them with one 4-byte store (a warp moves
// 128 contiguous bytes each way), in a grid-stride loop that also carries
// the scales, so a whole stacked leaf is one launch. The last n % 4 codes,
// or every code when the buffers are not 4-byte aligned, go one byte at a
// time.

#include "mx_numerics.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

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

__global__ void __launch_bounds__(kThreads)
ss_convert_kernel(const uint8_t* __restrict__ codes,
                  uint8_t* __restrict__ out_codes, long long n,
                  const int8_t* __restrict__ scales,
                  int8_t* __restrict__ out_scales, long long n_scales,
                  int de, int vec, MxFmt hi, MxFmt lo) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n_words = vec ? n / 4 : 0;
  const uint32_t* w_in = reinterpret_cast<const uint32_t*>(codes);
  uint32_t* w_out = reinterpret_cast<uint32_t*>(out_codes);
  for (long long t = t0; t < n_words; t += stride) {
    const uint32_t w = w_in[t];
    uint32_t o = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      o |= (uint32_t)ss_code((uint8_t)(w >> (8 * b)), de, hi, lo) << (8 * b);
    w_out[t] = o;
  }
  for (long long t = 4 * n_words + t0; t < n; t += stride)
    out_codes[t] = ss_code(codes[t], de, hi, lo);
  for (long long t = t0; t < n_scales; t += stride)
    out_scales[t] = (int8_t)min(max((int)scales[t] + de, kScaleExpMin),
                                kScaleExpMax);
}

}  // namespace

extern "C" {

// B5. codes/out_codes hold n code bytes (int8 MXINT or uint8 MXFP),
// scales/out_scales n_scales int8 exponents; hi and lo are formats of the
// same kind and de = emax(hi) - emax(lo) >= 0. vec != 0 promises 4-byte
// aligned code pointers. Returns cudaGetLastError() after the launch.
int ss_convert_launch(const uint8_t* codes, uint8_t* out_codes, long long n,
                      const int8_t* scales, int8_t* out_scales,
                      long long n_scales, int de, int vec, MxFmt hi,
                      MxFmt lo, void* stream) {
  const long long work = (vec ? n / 4 + 3 : n) > n_scales
                             ? (vec ? n / 4 + 3 : n) : n_scales;
  if (work <= 0) return (int)cudaSuccess;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ss_convert_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      codes, out_codes, n, scales, out_scales, n_scales, de, vec, hi, lo);
  return (int)cudaGetLastError();
}

}  // extern "C"
