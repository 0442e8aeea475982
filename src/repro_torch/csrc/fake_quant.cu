// Hopper (sm_90a) fused MX fake-quantization: quantize -> dequantize in one
// pass, the weight value of the QAT forward.
//
// Replaces the TPU kernel repro/kernels/fake_quant.py::fake_quant_pallas
// (B7). Computes what src/repro_torch/core/mx.py::quantize_dequantize
// computes — the block scale of mx_quantize.cu, each value rounded into the
// element format and multiplied back by the exact 2^exponent (0 for a scale
// clipped to -127) — in the input's dtype, and optionally its epilogue in
// the QAT forward:
//   ste:  w + (w_q - w) in the input's dtype, the straight-through value
//         JAX's core/fake_quant.py::_ste gives (it can differ from w_q by
//         one rounding);
//   out:  the result cast to the output dtype (the layer's compute dtype),
//         as models/common.py's dense casts it.
// Fusing the epilogue saves the f32 round trips of three more elementwise
// passes over the weight.
//
// What bounds it on the H100: bytes — each value read once and written
// once (f32 or bf16 each way), for a few dozen operations per value; the
// bound is those bytes over 3.35 TB/s.
//
// What this design does about it: the same walk as mx_quantize.cu — the
// tensor viewed in place as (outer, K, inner) with blocks of bs along K, no
// transposed copy, one thread per (outer, K-block, inner column), coalesced
// bs-deep loads issued together, the block held in registers between the
// max and the rescale, so nothing but the output is written. A stacked
// (G, K, N) leaf is one launch.

#include "mx_numerics.cuh"

namespace {

constexpr int kThreads = 256;

template <typename TI, typename TO, int BS>
__global__ void __launch_bounds__(kThreads)
fake_quant_kernel(const TI* __restrict__ v, TO* __restrict__ out,
                  long long outer, int nkb, long long inner, int ste,
                  MxFmt f) {
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
  const float scale = exp2i(se);
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    float w = round_to<TI>(
        __fmul_rn(quantize_value(__fmul_rn(x[j], inv), f), scale));
    if (ste)
      w = round_to<TI>(__fadd_rn(x[j], round_to<TI>(__fsub_rn(w, x[j]))));
    store(out + base + j * inner, w);
  }
}

template <typename TI, typename TO>
int launch(const void* v, void* out, long long outer, int k, long long inner,
           int bs, int ste, MxFmt f, cudaStream_t stream) {
  const long long work = outer * (k / bs) * inner;
  if (work <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((work + kThreads - 1) / kThreads);
  const TI* vt = static_cast<const TI*>(v);
  TO* ot = static_cast<TO*>(out);
  const int nkb = k / bs;
  switch (bs) {
    case 8:
      fake_quant_kernel<TI, TO, 8><<<grid, kThreads, 0, stream>>>(
          vt, ot, outer, nkb, inner, ste, f);
      break;
    case 16:
      fake_quant_kernel<TI, TO, 16><<<grid, kThreads, 0, stream>>>(
          vt, ot, outer, nkb, inner, ste, f);
      break;
    case 32:
      fake_quant_kernel<TI, TO, 32><<<grid, kThreads, 0, stream>>>(
          vt, ot, outer, nkb, inner, ste, f);
      break;
    case 64:
      fake_quant_kernel<TI, TO, 64><<<grid, kThreads, 0, stream>>>(
          vt, ot, outer, nkb, inner, ste, f);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B7. v is a contiguous (outer, K, inner) tensor, f32 (v_bf16 == 0) or bf16
// (v_bf16 == 1); out has v's shape, f32 (out_bf16 == 0) or bf16. ste != 0
// adds the straight-through epilogue. bs is 8, 16, 32 or 64 and divides K.
// Returns cudaGetLastError() after the launch.
int fake_quant_launch(const void* v, int v_bf16, void* out, int out_bf16,
                      long long outer, int k, long long inner, int bs,
                      int ste, MxFmt f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (v_bf16)
    return out_bf16
        ? launch<bf16, bf16>(v, out, outer, k, inner, bs, ste, f, s)
        : launch<bf16, float>(v, out, outer, k, inner, bs, ste, f, s);
  return out_bf16
      ? launch<float, bf16>(v, out, outer, k, inner, bs, ste, f, s)
      : launch<float, float>(v, out, outer, k, inner, bs, ste, f, s);
}

}  // extern "C"
