// Hopper (sm_90a) dequant-fused GEMMs over packed MX weights.
//
// Replace the TPU kernels in repro/kernels/mx_matmul.py:
//   B1 <- mx_matmul_pallas       (int8 MXINT / uint8 MXFP codes)
//   B2 <- mx_matmul_int4_pallas  (split-N int4 nibbles)
// Each has two bodies here, templated on the same three modes, and
// kernels/mx_matmul.py picks one by M alone: the decode body up to
// DECODE_MAX_M = 4 rows (mx_matmul_decode_launch), the tiled body above
// (mx_matmul_tiled_launch). The bodies cross between M = 4 and 8 for B1
// (below 4 for B2), measured on the card (PERF.md).
//
// Both compute y (M, N) f32 = x (M, K) @ dequant(W), x in bf16 or f32,
// where W's element codes are (K, N) [or split-N packed (K, N/2)] and its
// E8M0 scales sit in the serving layout (N, K/bs): one int8 exponent per
// column per K-block. Each code is decoded exactly (MXINT as is, MXFP as
// repro/kernels/common.py::decode_fp_arith), scaled by an exact 2^e (pow2i,
// clamped to [-126, 127]) and each product table[c] * 2^e accumulated in
// f32; the bodies differ only in the order of the sum.
//
// The decode body (M <= 4). What bounds it on the H100: the weight streams
// from HBM once per call for ~2·M flops per code, so bytes bound it (codes +
// scales over 3.35 TB/s; one qwen3-4b layer: 0.031 ms at 8 bits, 0.016 ms
// at 4); the CUDA-core work of decoding, scaling and M FMAs per code (~7
// instructions at M = 4) comes close to it at 8 bits and passes it at 4,
// and each launch pays a fixed chain (staging, two barriers, the cluster
// reduction) of a few microseconds. What the design does: K is split over
// the blocks of a thread-block cluster (up to 8; 16 where 16-byte strips
// alone give fewer than 264 blocks), whose partial tiles meet in rank order
// through distributed shared memory, so the card fills (>= 264 blocks at
// every qwen3-4b shape at M = 4, within the 4 blocks per SM that fit at
// once) without global scratch and a call is deterministic (a CUDA-graph
// replay is bit-identical); every thread moves 16 consecutive code bytes
// of a row by cp.async into its own ring in shared memory, a chunk ahead
// of the one it computes; x and the scales (as f32 2^e) are staged in
// shared memory once per block, their loads issued ahead of the codes';
// int8 codes become floats by a byte permute and one add, MXFP codes
// through a shared-memory table of the exactly decoded values (16 copies:
// at most 2-way bank conflicts), so mxfp8 costs about what mxint8 does; a
// split-N int4 byte is read once and feeds both of its columns.
//
// The tiled body (M > 4: prefill buckets, the mixed tick's M = 256). What
// bounds it on the H100: the flops grow with M while the bytes do not, so
// past M ~ 150 at 8 bits (~75 at 4) the work is operation-bound (one
// qwen3-4b layer at M = 256: 51.7 GFLOP, 0.052 ms at the bf16 tensor-core
// peak, against 0.031 ms for its bytes) and only the tensor cores can do
// it; below that the weight bytes bind, read once per M-tile. Measured on
// the card, a layer is held back most by shared-memory traffic and the
// per-stage chain (wait, barrier, decode) of each block, and at M <= 64 by
// a fixed cost of a few microseconds per launch. What the design does:
// dequantize in shared memory, multiply on tensor cores with wgmma.
//   - A block owns a BM x 64 output tile (BM 64 or 128; split-N int4: 32
//     packed columns, which hold both of the tile's nibble column ranges)
//     and walks its K range in stages of 64 rows. Code tiles (16-byte
//     pieces of the leaf's rows) and x tiles arrive by cp.async in a ring
//     of four stages, issued two stages ahead of the one decoded.
//   - The block's threads decode each code tile once per M-tile into a
//     bf16 tile already multiplied by 2^e: each thread reads 4 code bytes
//     of KR consecutive rows (one 4-byte load each) and writes, column by
//     column, KR values along K (int8 by a byte permute and one add per
//     value, int4 nibbles as bf16 128 + u minus 136 per pair, MXFP through
//     a shared-memory table of decode_fp's values in bf16, 8 copies; the
//     scales staged 16 K-blocks at a time, fetched one window ahead).
//   - The product runs as wgmma.m64n64k16 (bf16 in, f32 accumulate), one
//     warpgroup per 64 rows, with A (x) and B (the decoded tile) both
//     K-major under the 128-byte swizzle, so every operand is read from
//     shared memory once per warpgroup (ldmatrix and mma.sync, this body's
//     first version, read each A tile 4 and each B tile 2 times, and ran
//     slower on the card). The MMAs of a stage are issued, then the
//     next stage is decoded into the other of two W tiles while they run;
//     a proxy fence makes the threads' writes visible to wgmma.
//   - f32 x (callers outside the serving path) is split into bf16 hi + lo,
//     two MMAs per product, so x keeps ~16 significant bits.
//   - The card fills at every shape: kernels/mx_matmul.py::tiled_plan
//     splits K, in whole K-blocks, over the cs ranks of a thread-block
//     cluster (from shapes alone), and the ranks' partial tiles meet in
//     rank order through distributed shared memory. No float atomics, no
//     scratch, no host read: a call is deterministic and a CUDA-graph
//     replay bit-identical.
//   - Edges in the same kernel: ragged M, N and K ranges are zero-filled
//     (by zero-filling cp.async where the leaf and x lie on the 16-byte
//     grid); codes or x off the grid, and f32 x, take scalar loads.
// Exactness: MXINT codes have |c| <= 127 and pow2i clamps e to [-126, 127],
// so c * 2^e is an exact (normal) bf16 value. The MXFP values (e4m3, e5m2,
// e3m2, e2m3, e2m1) carry at most 3 mantissa bits, so value * 2^e is exact
// in bf16 too, except where it falls below 2^-126, where bf16 keeps fewer
// subnormal bits than f32. bf16 x times these values is exact in f32; only
// the order of the f32 sums differs from the plain version.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmx_matmul.so mx_matmul.cu

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

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

// Four zero-extended nibbles, one per byte lane -> four int8 values:
// ((n ^ 8) - 8) in each lane, with no borrow across lanes.
__device__ __forceinline__ uint32_t sign_extend_nibbles(uint32_t w) {
  return __vsub4(w ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// The decode body (M <= DECODE_MAX_M): a streaming reduction over the
// weight.
//
// Grid (CS, strips, M-tiles), clusters of (CS, 1, 1). A strip is ``strip``
// consecutive code bytes of every row (split-N int4: of every packed row,
// i.e. both its nibble column ranges); the CS blocks of a cluster split the
// strip's K-blocks into contiguous ranges, one per rank. Thread t owns the
// 16 code bytes at ct = t % (strip / 16) of the strip and walks the block's
// rows in chunks of 4, chunk c going to thread group g = t / (strip / 16)
// when c = g (mod groups), each chunk's loads issued while the previous
// one is computed. x (the M-tile's rows, f32) and the block's scales (2^e
// as f32) are staged in shared memory once per block; MXFP codes decode
// through a table of the 2^bits exactly decoded values. Partial sums meet
// in shared memory across the block's thread groups, then across the
// cluster's ranks through distributed shared memory, each in a fixed order:
// a call is deterministic and needs no scratch or counters.
constexpr int kDecRows = 4;            // rows per chunk: bs % 4 == 0
constexpr int kDecStages = 2;          // ring slots per thread
constexpr int kDecCopies = 16;         // MXFP table copies: <= 2-way conflicts

// 4 int8 lanes of q -> floats, exactly: each biased byte (c + 128) becomes
// the low mantissa byte of 2^23, and the bias comes off in one FADD.
__device__ __forceinline__ void int8x4(uint32_t q, float v[4]) {
  const uint32_t u = q ^ 0x80808080u;
  v[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  v[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  v[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  v[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
}

// 16 code bytes of one row from column byte c0 on, one byte at a time (the
// edge path); bytes at or past W read as 0 (code 0 decodes to 0 in every
// format, and as two zero nibbles).
__device__ __forceinline__ uint4 load16_edge(
    const uint8_t* __restrict__ row, int c0, int W) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (c0 + j < W) w[j / 4] |= (uint32_t)row[c0 + j] << (8 * (j % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// kMT x rows per M-tile: 4 at M <= 4, else 8 (int4: always 4, as its
// 32 columns per thread already hold 128 partial sums). Four blocks fit
// on an SM: 128 threads of <= 128 registers, or 64 of <= 255 where a
// thread holds 128 partial sums; so every plan's grid runs in one wave.
// One chunk (kDecRows rows of this thread's 16 code bytes, from row k on)
// into the thread's own ring slot: cp.async where the row is aligned and
// whole (no register holds a load in flight), else the scalar edge path.
// The thread alone reads the slot back, after cp.async.wait_group.
__device__ __forceinline__ void issue_chunk(uint4* slot, int stride,
                                           const uint8_t* __restrict__ codes,
                                           int k, int W, int c0, bool full) {
  const uint8_t* base = codes + (size_t)k * W;
#pragma unroll
  for (int u = 0; u < kDecRows; ++u) {
    uint4* dst = slot + u * stride;
    if (full) {
      const unsigned s =
          static_cast<unsigned>(__cvta_generic_to_shared(dst));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(s), "l"(base + (size_t)u * W + c0) : "memory");
    } else {
      *dst = load16_edge(base + (size_t)u * W, c0, W);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int MODE, int kMT>
struct DecTraits {
  static constexpr int kCols = MODE == kModeInt4 ? 32 : 16;  // per thread
  static constexpr int kThreads = kCols * kMT > 64 ? 64 : 128;
};

template <int MODE, typename XT, int kDecMT>
__global__ void __launch_bounds__(DecTraits<MODE, kDecMT>::kThreads, 4)
mx_mm_decode_kernel(const XT* __restrict__ x,
                    const uint8_t* __restrict__ codes,
                    const int8_t* __restrict__ scales, float* __restrict__ y,
                    int M, int K, int N, Fmt f, int strip, int vec,
                    int inbox_off) {
  namespace cg = cooperative_groups;
  constexpr int kCols = DecTraits<MODE, kDecMT>::kCols;
  constexpr int kDecThreads = DecTraits<MODE, kDecMT>::kThreads;
  constexpr int kDecXChunk = kDecRows * kDecMT + 4;  // x floats per chunk
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int W = MODE == kModeInt4 ? N / 2 : N;   // code bytes per row
  const int bn = MODE == kModeInt4 ? 2 * strip : strip;   // block columns
  const int ct_n = strip / 16;
  const int groups = kDecThreads / ct_n;
  const int ct = threadIdx.x % ct_n;
  const int g = threadIdx.x / ct_n;
  const int s0 = blockIdx.y * strip;            // strip's first code byte
  const int m0 = blockIdx.z * kDecMT;
  const int nkb = K / f.bs;
  const int kb_lo = rank * nkb / cs;
  const int kb_hi = (rank + 1) * nkb / cs;
  const int nkbl = kb_hi - kb_lo;
  const int rows = nkbl * f.bs;
  const int k_lo = kb_lo * f.bs;
  const int kbl_max = (nkb + cs - 1) / cs;
  const int table_n = MODE == kModeFp ? (kDecCopies << f.bits) : 0;
  const int chunks = rows / kDecRows;
  const int c0 = s0 + ct * 16;                  // this thread's code byte
  const bool full = (vec & 1) != 0 && c0 + 16 <= W;
  const int lane = threadIdx.x & 31;
  const uint32_t fmask = (1u << f.bits) - 1u;   // decode_fp reads bits only

  // Every block of the cluster must have started before one writes into
  // another's shared memory (the partial tiles, at the end): arrive now,
  // wait there.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Shared memory, laid out so that no warp access conflicts on banks:
  // x padded by 4 floats per chunk (the groups of a warp read different
  // chunks), the scales at an odd pitch (staged with consecutive lanes on
  // consecutive K-blocks).
  const int sp = bn + 1;                             // scale pitch
  float* table = smem;                               // [code][lane % 16]
  float* xs = smem + table_n                         // [chunk][k][m] + pad
              + (MODE == kModeFp ? ((1 << f.bits) + 3) / 4 * 4 : 0);
  float* ss = xs + kbl_max * f.bs / kDecRows * kDecXChunk;   // [kb][col]

  // column c of the block (0 <= c < bn) -> output column, or -1
  auto out_col = [&](int c) -> int {
    if (MODE != kModeInt4) return s0 + c < N ? s0 + c : -1;
    const int b = s0 + (c < strip ? c : c - strip);
    return b < W ? (c < strip ? b : W + b) : -1;
  };

  // The code ring: kDecStages slots of kDecRows rows x 16 bytes per
  // thread, at the end of shared memory ([slot][row][thread]: a warp's
  // accesses are consecutive). Its first chunks go out right behind the
  // staging's first loads, which are few and so are not queued behind
  // them.
  const int tile = kDecMT * bn;
  uint4* ring = reinterpret_cast<uint4*>(
      smem + inbox_off + ((tile + cs - 1) / cs * cs + 3) / 4 * 4);
  uint4* mine = ring + threadIdx.x;
  constexpr int kSlot = kDecRows * kDecThreads;      // uint4 per slot
  int ch_issue = g;
  bool ring_started = false;
  auto start_ring = [&]() {
#pragma unroll
    for (int st = 0; st < kDecStages - 1; ++st) {
      if (ch_issue < chunks)
        issue_chunk(mine + st * kSlot, kDecThreads, codes,
                    k_lo + ch_issue * kDecRows, W, c0, full);
      cp_async_commit();
      ch_issue += groups;
    }
    ring_started = true;
  };

  // The MXFP table: each code decoded once, then copied kDecCopies times
  // (a lane reads copy lane % kDecCopies).
  float* table_base = table + table_n;               // [code]
  if (MODE == kModeFp) {
    for (int c = threadIdx.x; c < (1 << f.bits); c += kDecThreads)
      table_base[c] = decode_fp((uint32_t)c, f);
    __syncthreads();
    for (int i = threadIdx.x; i < table_n; i += kDecThreads)
      table[i] = table_base[i / kDecCopies];
  }
  // x (kDecMT rows of the block's K range, as f32) and the scales (bn x
  // nkbl, as 2^e), staged in rounds that issue every load before any
  // store. Where x's rows are 16-byte aligned (vec bit 1) a thread takes
  // one 16-byte vector of every x row at the same K and writes its K
  // positions as float4s of the kDecMT rows. Scale pairs (column c,
  // K-block kb) go in kb-fastest order, kDecThreads at a time, with no
  // division past the first.
  constexpr int kXb = 2;                        // x vectors per row, round
  constexpr int kSv = 24;                       // scales per round
  constexpr int kXper = 16 / (int)sizeof(XT);   // x elements per vector
  const bool xvec = (vec & 2) != 0;
  const int nxb = xvec ? rows / kXper : 0;      // vectors per x row
  const int dc = nkbl > 0 ? kDecThreads / nkbl : 0;
  const int dk = nkbl > 0 ? kDecThreads % nkbl : 0;
  int sc_c = nkbl > 0 ? threadIdx.x / nkbl : bn;
  int sc_k = nkbl > 0 ? threadIdx.x % nkbl : 0;
  auto x_at = [&](int m, int kl) -> float* {
    return xs + (kl / kDecRows) * kDecXChunk + (kl % kDecRows) * kDecMT + m;
  };
  for (int b0 = threadIdx.x; b0 < nxb || sc_c < bn;
       b0 += kXb * kDecThreads) {
    uint4 xr[kXb][kDecMT];
    int sv[kSv];
#pragma unroll
    for (int u = 0; u < kXb; ++u) {
      const int b = b0 + u * kDecThreads;
#pragma unroll
      for (int m = 0; m < kDecMT; ++m)
        xr[u][m] = b < nxb && m0 + m < M
                       ? __ldg(reinterpret_cast<const uint4*>(
                             x + (size_t)(m0 + m) * K + k_lo) + b)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    const int c_first = sc_c, k_first = sc_k;
#pragma unroll
    for (int u = 0; u < kSv; ++u) {
      const int n = sc_c < bn ? out_col(sc_c) : -1;
      sv[u] = n >= 0 ? scales[(size_t)n * nkb + kb_lo + sc_k] : -1000;
      sc_c += dc;
      sc_k += dk;
      if (sc_k >= nkbl) { sc_k -= nkbl; ++sc_c; }
    }
    if (!ring_started) start_ring();
#pragma unroll
    for (int u = 0; u < kXb; ++u) {
      const int b = b0 + u * kDecThreads;
      if (b < nxb) {
#pragma unroll
        for (int e = 0; e < kXper; ++e) {
          float val[kDecMT];
#pragma unroll
          for (int m = 0; m < kDecMT; ++m) {
            const uint32_t w[4] = {xr[u][m].x, xr[u][m].y, xr[u][m].z,
                                   xr[u][m].w};
            val[m] = sizeof(XT) == 2
                         ? __uint_as_float(e % 2 ? w[e / 2] & 0xFFFF0000u
                                                 : w[e / 2] << 16)
                         : __uint_as_float(w[e]);
          }
          float* row = x_at(0, b * kXper + e);
#pragma unroll
          for (int m = 0; m < kDecMT; m += 4)
            *reinterpret_cast<float4*>(row + m) =
                make_float4(val[m], val[m + 1], val[m + 2], val[m + 3]);
        }
      }
    }
    int c = c_first, kb = k_first;
#pragma unroll
    for (int u = 0; u < kSv; ++u) {
      if (c < bn) ss[kb * sp + c] = sv[u] == -1000 ? 0.0f : pow2i(sv[u]);
      c += dc;
      kb += dk;
      if (kb >= nkbl) { kb -= nkbl; ++c; }
    }
  }
  if (!ring_started) start_ring();
  if (!xvec) {                                  // x off the 16-byte grid
    for (int i = threadIdx.x; i < kDecMT * rows; i += kDecThreads) {
      const int m = i / rows, kl = i % rows;
      *x_at(m, kl) = m0 + m < M
                         ? to_float(x[(size_t)(m0 + m) * K + k_lo + kl])
                         : 0.0f;
    }
  }
  __syncthreads();

  float acc[kDecMT][kCols];
#pragma unroll
  for (int m = 0; m < kDecMT; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.0f;

  int it = 0;
  for (int ch = g; ch < chunks; ch += groups, ++it) {
    // keep kDecStages - 1 chunks in flight ahead of this one
    if (ch_issue < chunks)
      issue_chunk(mine + ((it + kDecStages - 1) % kDecStages) * kSlot,
                  kDecThreads, codes, k_lo + ch_issue * kDecRows, W, c0,
                  full);
    cp_async_commit();
    ch_issue += groups;
    cp_async_wait<kDecStages - 1>();
    const uint4* slot = mine + (it % kDecStages) * kSlot;
    const int kl0 = ch * kDecRows;
    const float* sk = ss + (kl0 / f.bs) * sp + ct * 16;
    float s[kCols];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[j] = sk[j];
      if (MODE == kModeInt4) s[16 + j] = sk[strip + j];
    }
    const float* xrow = xs + ch * kDecXChunk;
#pragma unroll
    for (int u = 0; u < kDecRows; ++u) {
      float xv[kDecMT];
#pragma unroll
      for (int m = 0; m < kDecMT; m += 4) {
        const float4 a =
            *reinterpret_cast<const float4*>(xrow + u * kDecMT + m);
        xv[m] = a.x; xv[m + 1] = a.y; xv[m + 2] = a.z; xv[m + 3] = a.w;
      }
      const uint4 qu = slot[u * kDecThreads];
      const uint32_t qw[4] = {qu.x, qu.y, qu.z, qu.w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        float v[kCols == 32 ? 8 : 4];
        if (MODE == kModeInt4) {
          int8x4(sign_extend_nibbles(qw[wi] & 0x0F0F0F0Fu), v);
          int8x4(sign_extend_nibbles((qw[wi] >> 4) & 0x0F0F0F0Fu), v + 4);
        } else if (MODE == kModeFp) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            v[jj] = table[((qw[wi] >> (8 * jj)) & fmask) * kDecCopies
                          + lane % kDecCopies];
        } else {
          int8x4(qw[wi], v);
        }
#pragma unroll
        for (int jj = 0; jj < (kCols == 32 ? 8 : 4); ++jj) {
          // int4: lanes 0-3 are the low nibbles (first column range),
          // 4-7 the high ones (the second range, 16 columns on)
          const int j = jj < 4 ? wi * 4 + jj : 16 + wi * 4 + jj - 4;
          const float w = v[jj] * s[j];
#pragma unroll
          for (int m = 0; m < kDecMT; ++m)
            acc[m][j] = fmaf(xv[m], w, acc[m][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // this block's partial tile: the groups that walked a chunk, summed in
  // group order. A group's tile is [m][quad][ct][4] (quad: 4 of the
  // thread's columns) at a pitch of kDecMT * bn + 4 * ct_n floats, so that
  // a warp's float4 stores fall on distinct banks.
  __syncthreads();                 // table, x and scales are dead: reuse
  float* red = smem;
  const int pitch = tile + 4 * ct_n;
  const int active = min(groups, chunks);
  if (g < active) {
#pragma unroll
    for (int m = 0; m < kDecMT; ++m)
#pragma unroll
      for (int qd = 0; qd < kCols / 4; ++qd)
        *reinterpret_cast<float4*>(red + g * pitch + m * bn
                                   + (qd * ct_n + ct) * 4) =
            make_float4(acc[m][4 * qd], acc[m][4 * qd + 1],
                        acc[m][4 * qd + 2], acc[m][4 * qd + 3]);
  }
  __syncthreads();
  // Element e of the tile belongs to rank e / per: each rank pushes its
  // sum of e into slot (its rank, e % per) of the owner's inbox, and after
  // one cluster barrier the owner adds its slots in rank order.
  const int per = (tile + cs - 1) / cs;
  float* inbox = smem + inbox_off;                 // [rank][per]
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = threadIdx.x; e < tile; e += kDecThreads) {
    float sum = 0.0f;
#pragma unroll 8
    for (int gg = 0; gg < active; ++gg) sum += red[gg * pitch + e];
    cluster.map_shared_rank(inbox, e / per)[rank * per + e % per] = sum;
  }
  cluster.sync();                  // every push has landed
  for (int i = threadIdx.x; i < per && rank * per + i < tile;
       i += kDecThreads) {
    float sum = 0.0f;
    for (int r = 0; r < cs; ++r) sum += inbox[r * per + i];
    // e = m * bn + (qd * ct_n + ct) * 4 + lane4 -> block column
    const int e = rank * per + i;
    const int m = e / bn, qc = (e % bn) / 4, l4 = e % 4;
    const int qd = qc / ct_n, cti = qc % ct_n;
    const int n = out_col(qd < 4 ? cti * 16 + qd * 4 + l4
                                 : strip + cti * 16 + (qd - 4) * 4 + l4);
    if (m0 + m < M && n >= 0) y[(size_t)(m0 + m) * N + n] = sum;
  }
}

template <int MODE, typename XT, int kDecMT>
int launch_decode(const void* x, const uint8_t* codes, const int8_t* scales,
                  float* y, int M, int K, int N, Fmt f, int strip, int cs,
                  int vec, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (f.bs % kDecRows != 0 || strip % 16 != 0 || strip < 16
      || strip > (MODE == kModeInt4 ? 128 : 256) || cs < 1 || cs > 16)
    return (int)cudaErrorInvalidValue;
  auto kernel = mx_mm_decode_kernel<MODE, XT, kDecMT>;
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         232448);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attrs_set = true;
  }
  const int W = MODE == kModeInt4 ? N / 2 : N;
  const int bn = MODE == kModeInt4 ? 2 * strip : strip;
  const int nkb = K / f.bs;
  const int kbl_max = (nkb + cs - 1) / cs;
  const size_t table_n =                       // copies + decode base
      MODE == kModeFp ? ((size_t)(kDecCopies + 1) << f.bits) + 3 : 0;
  const size_t main_n =
      table_n + (size_t)kbl_max * f.bs / kDecRows * (kDecRows * kDecMT + 4)
      + (size_t)kbl_max * (bn + 1);
  const int threads = DecTraits<MODE, kDecMT>::kThreads;
  const int chunks_max = kbl_max * f.bs / kDecRows;
  const int groups = threads / (strip / 16);
  const size_t red_n = (size_t)(groups < chunks_max ? groups : chunks_max)
                       * (kDecMT * bn + 4 * (strip / 16));
  const size_t body_n = ((main_n > red_n ? main_n : red_n) + 3) / 4 * 4;
  const size_t tile = (size_t)kDecMT * bn;
  const size_t inbox_n = ((tile + cs - 1) / cs * cs + 3) / 4 * 4;
  const size_t ring_n = (size_t)kDecStages * kDecRows * threads * 4;
  const size_t smem = 4 * (body_n + inbox_n + ring_n);
  if (smem > 232448) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (W + strip - 1) / strip, (M + kDecMT - 1) / kDecMT);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const XT*>(x), codes, scales, y, M, K, N, f,
      strip, vec, (int)body_n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE, int kDecMT>
int launch_decode_x(const void* x, int x_bf16, const uint8_t* codes,
                    const int8_t* scales, float* y, int M, int K, int N,
                    Fmt f, int strip, int cs, int vec, cudaStream_t stream) {
  return x_bf16 ? launch_decode<MODE, __nv_bfloat16, kDecMT>(
                      x, codes, scales, y, M, K, N, f, strip, cs, vec, stream)
                : launch_decode<MODE, float, kDecMT>(
                      x, codes, scales, y, M, K, N, f, strip, cs, vec,
                      stream);
}

// M-tiles of 4 x rows at M <= 4 (and always at int4), of 8 above.
template <int MODE>
int launch_decode_m(const void* x, int x_bf16, const uint8_t* codes,
                    const int8_t* scales, float* y, int M, int K, int N,
                    Fmt f, int strip, int cs, int vec, cudaStream_t stream) {
  if constexpr (MODE == kModeInt4) {
    return launch_decode_x<MODE, 4>(x, x_bf16, codes, scales, y, M, K, N, f,
                                    strip, cs, vec, stream);
  } else {
    if (M <= 4)
      return launch_decode_x<MODE, 4>(x, x_bf16, codes, scales, y, M, K, N,
                                      f, strip, cs, vec, stream);
    return launch_decode_x<MODE, 8>(x, x_bf16, codes, scales, y, M, K, N, f,
                                    strip, cs, vec, stream);
  }
}

// ---------------------------------------------------------------------------
// The tiled body (M > DECODE_MAX_M): dequantize in shared memory, multiply
// on tensor cores by wgmma (see the note at the top).
//
// Grid (cs, N-tiles, M-tiles) in clusters of (cs, 1, 1). A block owns a
// BM x 64 output tile (split-N int4: 32 packed columns, i.e. 32 columns of
// each nibble range); its BM / 64 warpgroups each multiply a 64 x 64
// sub-tile with wgmma.m64n64k16, A (x) and B (the decoded weight) both
// K-major in shared memory under the 128-byte swizzle. Rank r of a
// cluster walks K-blocks [r * nkb / cs, (r+1) * nkb / cs) in stages of 64
// rows. One barrier per stage: after it, every thread issues the loads of
// a stage further on, starts the asynchronous MMAs of this stage on one of
// two W tiles and, while they run, decodes the next stage's codes into the
// other; it waits for its MMAs before the next barrier.
constexpr int kTK = 64;            // K rows per stage: one 128-byte row
constexpr int kTScaleWin = 16;     // K-blocks of scales staged at a time
constexpr int kTCopies = 8;        // MXFP table copies

template <int MODE, typename XT, int BM>
struct TiledCfg {
  static constexpr int BN = 64;            // output columns per block
  static constexpr int THREADS = 2 * BM;   // a warpgroup per 64 rows
  // Blocks per SM at bf16 x (shared memory ~71 KB at BM = 64, ~103 KB at
  // 128); f32 x adds a lo tile per stage.
  static constexpr int MIN_BLOCKS =
      sizeof(XT) == 2 ? (BM == 64 ? 3 : 2) : 1;
  static constexpr int STAGES = sizeof(XT) == 2 ? 4 : 3;
  static constexpr int CB = MODE == kModeInt4 ? BN / 2 : BN;  // code bytes
  static constexpr int CH = CB / 16;       // 16-byte chunks per code row
  static constexpr int SP = BN;            // scale window pitch (bf16)
  // Decode tasks: KR code rows x 4 code bytes each, one per thread.
  static constexpr int KR = (CB / 4) * kTK / THREADS;
  static constexpr int CU = (kTK * CH + THREADS - 1) / THREADS;  // chunks
  static constexpr int XU = BM * (kTK / 8) / THREADS;  // x pieces / thread
  static constexpr int ACC = 32;           // f32 sums per thread
  static_assert(KR == 2 || KR == 4 || KR == 8, "decode task rows");
};

// The hot loop addresses shared memory by 32-bit shared-window addresses
// (one conversion per kernel, none per access).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, of which the first src_bytes (0..16) come
// from src and the rest are zeros.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst,
                                                 const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t lds16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void sts64(uint32_t a, uint32_t v0, uint32_t v1) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n"
               :: "r"(a), "r"(v0), "r"(v1) : "memory");
}

__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Byte offset of 16-byte chunk q of row r in a tile of 128-byte rows under
// the 128-byte swizzle (the pattern wgmma's layout type 1 reads).
__device__ __forceinline__ uint32_t sw128(int r, int q) {
  return (uint32_t)(r * 128 + ((q ^ (r & 7)) << 4));
}

// wgmma operand descriptor of a K-major tile of 128-byte rows at a
// 1024-byte-aligned shared address under the 128-byte swizzle: 8-row
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Generic-proxy writes to shared memory (stores, cp.async) become visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64, f32, 32 per thread) += A (64 x 16) * B (16 x 64), bf16.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0(float (&d)[32]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                 "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                 "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
                 "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
                 "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                 "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
                 "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                 "+f"(d[30]), "+f"(d[31])
               :: "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

template <int MODE, typename XT, int BM, bool VEC>
__global__ void __launch_bounds__(TiledCfg<MODE, XT, BM>::THREADS,
                                  TiledCfg<MODE, XT, BM>::MIN_BLOCKS)
mx_mm_tiled_kernel(const XT* __restrict__ x,
                   const uint8_t* __restrict__ codes,
                   const int8_t* __restrict__ scales, float* __restrict__ y,
                   int M, int K, int N, Fmt f) {
  using C = TiledCfg<MODE, XT, BM>;
  constexpr int T = C::THREADS, S = C::STAGES, KR = C::KR, BN = C::BN;
  constexpr bool kSplitX = sizeof(XT) == 4;        // f32 x: hi + lo MMAs
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t tsm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / 128;                        // warpgroup: 64 rows
  const int W = MODE == kModeInt4 ? N / 2 : N;     // code bytes per row
  const int s0 = blockIdx.y * C::CB;               // tile's first code byte
  const int m0 = blockIdx.z * BM;
  const int nkb = K / f.bs;
  const int kb_lo = rank * nkb / cs, kb_hi = (rank + 1) * nkb / cs;
  const int k_lo = kb_lo * f.bs, k_hi = kb_hi * f.bs;
  const int nk = (k_hi - k_lo + kTK - 1) / kTK;    // stages
  // floor(k / bs) as (k + 0.5) * (1 / bs), truncated: exact for k < 2^20
  // (the quotient lies at least 0.5 / bs from an integer)
  const float inv_bs = 1.0f / (float)f.bs;

  // [x ring (hi, then lo for f32 x)][two W tiles][code ring][scales as
  // bf16 2^e][MXFP table, bf16], from a 1024-byte-aligned base (the
  // swizzle repeats every 1024 bytes).
  constexpr int kXStage = BM * 128;                // bytes per x stage
  constexpr int kWTile = BN * 128;                 // bytes per W tile
  const uint32_t a_base = (smem_u32(tsm) + 1023) & ~1023u;
  uint8_t* base = tsm + (a_base - smem_u32(tsm));
  const uint32_t a_xhi = a_base;
  const uint32_t a_xlo = a_xhi + S * kXStage;
  const uint32_t a_wt = a_xhi + (kSplitX ? 2 : 1) * S * kXStage;
  const uint32_t a_cring = a_wt + 2 * kWTile;
  const uint32_t a_sw = a_cring + S * kTK * C::CB;
  const uint32_t a_table = a_sw + kTScaleWin * C::SP * 2;
  uint8_t* cring = base + (a_cring - a_base);
  uint16_t* sw = reinterpret_cast<uint16_t*>(base + (a_sw - a_base));
  uint16_t* table = reinterpret_cast<uint16_t*>(base + (a_table - a_base));

  // column c of the tile (0 <= c < BN) -> output column, or -1
  auto out_col = [&](int c) -> int {
    if (MODE != kModeInt4) return s0 + c < N ? s0 + c : -1;
    const int b = s0 + (c < C::CB ? c : c - C::CB);
    return b < W ? (c < C::CB ? b : W + b) : -1;
  };

  if (MODE == kModeFp)
    for (int i = tid; i < (kTCopies << f.bits); i += T) {
      const __nv_bfloat16 v =
          __float2bfloat16_rn(decode_fp((uint32_t)(i / kTCopies), f));
      table[i] = *reinterpret_cast<const uint16_t*>(&v);
    }

  // This thread's code chunks and x pieces, at the rank's first K row; a
  // stage moves them kTK rows on. cbytes: the chunk's bytes inside the row.
  const uint8_t* csrc[C::CU];
  int coff[C::CU], crow[C::CU], cbytes[C::CU];
#pragma unroll
  for (int u = 0; u < C::CU; ++u) {
    const int j = tid + u * T;
    const int r = j / C::CH, b = s0 + (j % C::CH) * 16;
    crow[u] = j < kTK * C::CH ? r : kTK;           // kTK: no chunk
    coff[u] = r * C::CB + (j % C::CH) * 16;
    cbytes[u] = min(max(W - b, 0), 16);
    csrc[u] = codes + (size_t)(k_lo + r) * W + b;
  }
  const XT* xsrc[C::XU];
  int xoff[C::XU], xkc[C::XU];
  bool xlive[C::XU];
#pragma unroll
  for (int u = 0; u < C::XU; ++u) {
    const int j = tid + u * T;
    const int mr = j / (kTK / 8), q = j % (kTK / 8);
    xoff[u] = sw128(mr, q);
    xkc[u] = q * 8;
    xlive[u] = m0 + mr < M;
    xsrc[u] = x + (size_t)(m0 + mr) * K + k_lo + q * 8;
  }

  // Stage kt's codes and x into ring slot kt % S, zeros past M, N and the
  // rank's K range. VEC (code rows and x on the 16-byte grid, bf16 x): all
  // by zero-filling cp.async, branch-free; else scalar loads.
  auto issue = [&](int kt) {
    const int slot = kt % S;
    const int rows = min(kTK, k_hi - k_lo - kt * kTK);
    const uint32_t ac = a_cring + slot * kTK * C::CB;
    const uint32_t ax = a_xhi + slot * kXStage;
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < C::CU; ++u) {
        if (crow[u] >= kTK) continue;
        const int nb = crow[u] < rows ? cbytes[u] : 0;
        cp_async16_zfill(ac + coff[u],
                         nb ? csrc[u] + (size_t)kt * kTK * W : codes, nb);
      }
#pragma unroll
      for (int u = 0; u < C::XU; ++u) {
        const bool live = xlive[u] && xkc[u] < rows;
        cp_async16_zfill(ax + xoff[u], live ? xsrc[u] + kt * kTK : x,
                         live ? 16 : 0);
      }
    } else {
      uint8_t* cdst = cring + slot * kTK * C::CB;
#pragma unroll
      for (int u = 0; u < C::CU; ++u) {
        if (crow[u] >= kTK) continue;
        const uint8_t* src = csrc[u] + (size_t)kt * kTK * W;
        const int b = s0 + coff[u] % C::CB;
        *reinterpret_cast<uint4*>(cdst + coff[u]) =
            crow[u] < rows && cbytes[u] > 0 ? load16_edge(src - b, b, W)
                                            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < C::XU; ++u) {
        const XT* src = xsrc[u] + kt * kTK;
        const bool live = xlive[u] && xkc[u] < rows;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = live ? to_float(src[e]) : 0.0f;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[e] = bf16x2(v[2 * e], v[2 * e + 1]);
          const __nv_bfloat162 h = as_bf2(hi[e]);
          lo[e] = bf16x2(v[2 * e] - __low2float(h),
                         v[2 * e + 1] - __high2float(h));
        }
        sts128(ax + xoff[u], make_uint4(hi[0], hi[1], hi[2], hi[3]));
        if constexpr (kSplitX)
          sts128(a_xlo + slot * kXStage + xoff[u],
                 make_uint4(lo[0], lo[1], lo[2], lo[3]));
      }
    }
  };

  // Scale windows: the E8M0 exponents of K-blocks [kb, kb + kTScaleWin) of
  // the tile's columns, fetched into registers one window ahead (so their
  // loads overlap a window's stages; the first beside stage 0's) and
  // stored, when the walk reaches them, as bf16 2^e in [K-block][column].
  // (A 40-block window fetched when reached ran slower on the card.)
  constexpr int kSPer = BN * kTScaleWin / T;
  int8_t snext[kSPer];
  auto fetch_scales = [&](int kb) {
#pragma unroll
    for (int u = 0; u < kSPer; ++u) {
      const int i = tid + u * T;
      const int n = out_col(i / kTScaleWin), k = kb + i % kTScaleWin;
      snext[u] = n >= 0 && k < kb_hi ? scales[(size_t)n * nkb + k] : 0;
    }
  };
  // The window must hold stage kt's K-blocks (block-uniform). Its old
  // readers are done: every call follows a barrier that follows them.
  int kb0 = INT_MIN / 2, kb_next = -1;   // window held; window fetched
  auto window_for = [&](int kt) {
    const int k0 = k_lo + kt * kTK;
    const int kb_first = __float2int_rz((k0 + 0.5f) * inv_bs);
    const int kb_last = __float2int_rz((min(k0 + kTK, k_hi) - 0.5f) * inv_bs);
    if (kb_first < kb0 || kb_last >= kb0 + kTScaleWin) {
      if (kb_first != kb_next) fetch_scales(kb_first);
      kb0 = kb_first;
#pragma unroll
      for (int u = 0; u < kSPer; ++u) {
        const int i = tid + u * T;
        const int e = min(max((int)snext[u], -126), 127);
        sw[(i % kTScaleWin) * C::SP + i / kTScaleWin] =
            (uint16_t)((e + 127) << 7);
      }
      __syncthreads();
      kb_next = kb0 + kTScaleWin;
      if (kb_next < kb_hi) fetch_scales(kb_next);
    }
  };

  // Decode: thread t takes code bytes [4 cg, 4 cg + 4) of code rows
  // [KR rg, KR rg + KR) of the stage (cg = t % (CB / 4), rg = t / (CB /
  // 4)): KR 4-byte loads, then, column by column, KR values of one column
  // (one K-block: KR divides 8, bs is a multiple of 8) as KR / 2 bf16 pairs
  // times (2^e, 2^e), stored into that column's K-major row of the W tile.
  // Each thread starts at column (cg / 2) % 4 of its four, so the 8 threads
  // of a store phase reach 8 distinct rows modulo 8: distinct banks.
  const int cg4 = tid % (C::CB / 4), rg = tid / (C::CB / 4);
  const int krow = rg * KR;                          // first code row
  const int rot = (cg4 >> 1) & 3;
  const uint32_t a_tb = a_table + (lane % kTCopies) * 2;
  auto decode = [&](int kt, int kb0) {
    const uint32_t ac = a_cring + (kt % S) * kTK * C::CB + krow * C::CB
                        + cg4 * 4;
    const uint32_t aw = a_wt + (kt & 1) * kWTile;
    const int kbw = min(__float2int_rz((k_lo + kt * kTK + krow + 0.5f)
                                       * inv_bs) - kb0, kTScaleWin - 1);
    const uint32_t as = a_sw + kbw * C::SP * 2;
    uint32_t u[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r) u[r] = lds32(ac + r * C::CB);
    if (MODE == kModeInt4) {
#pragma unroll
      for (int r = 0; r < KR; ++r) u[r] ^= 0x88888888u;
    } else if (MODE == kModeInt) {
#pragma unroll
      for (int r = 0; r < KR; ++r) u[r] ^= 0x80808080u;
    }
    const __nv_bfloat162 k136 = __floats2bfloat162_rn(136.0f, 136.0f);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = (jj + rot) & 3;                // of the thread's four
      const int n = cg4 * 4 + col;                   // W row (tile column)
      const uint32_t s1 = lds16(as + n * 2);
      const uint32_t s2 = s1 | s1 << 16;             // (2^e, 2^e)
      uint32_t p[KR / 2], ph[KR / 2];
#pragma unroll
      for (int r = 0; r < KR; r += 2) {
        if (MODE == kModeInt4) {
          const uint32_t sel = col | col << 4 | (4 + col) << 8
                               | (4 + col) << 12;
          const uint32_t t2 = __byte_perm(u[r], u[r + 1], sel);
          const uint32_t lo = (t2 & 0x000F000Fu) | 0x43004300u;
          const uint32_t hi = ((t2 >> 4) & 0x000F000Fu) | 0x43004300u;
          p[r / 2] = as_u32(__hsub2(as_bf2(lo), k136));
          ph[r / 2] = as_u32(__hsub2(as_bf2(hi), k136));
        } else if (MODE == kModeFp) {
          const uint32_t fmask = (1u << f.bits) - 1u;
          const uint32_t c0 = (u[r] >> (8 * col)) & fmask;
          const uint32_t c1 = (u[r + 1] >> (8 * col)) & fmask;
          p[r / 2] = lds16(a_tb + c0 * (2 * kTCopies))
                     | lds16(a_tb + c1 * (2 * kTCopies)) << 16;
        } else {
          const uint32_t sel = 0x7540u | col;
          const float v0 =
              __int_as_float(__byte_perm(u[r], 0x4B000000u, sel)) - 8388736.0f;
          const float v1 = __int_as_float(__byte_perm(u[r + 1], 0x4B000000u,
                                                      sel)) - 8388736.0f;
          p[r / 2] = bf16x2(v0, v1);
        }
      }
      auto put = [&](int wn, const uint32_t* v, uint32_t sc) {
        uint32_t o[KR / 2];
#pragma unroll
        for (int i = 0; i < KR / 2; ++i)
          o[i] = as_u32(__hmul2(as_bf2(v[i]), as_bf2(sc)));
        const uint32_t a = aw + sw128(wn, krow / 8) + (krow % 8) * 2;
        if constexpr (KR == 8) sts128(a, make_uint4(o[0], o[1], o[2], o[3]));
        else if constexpr (KR == 4) sts64(a, o[0], o[1]);
        else sts32(a, o[0]);
      };
      put(n, p, s2);
      if (MODE == kModeInt4) {                       // high: j + N/2
        const uint32_t h1 = lds16(as + (C::CB + n) * 2);
        put(C::CB + n, ph, h1 | h1 << 16);
      }
    }
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  // The warpgroup's operands: rows wg * 64.. of the x stage, the whole W
  // tile; a K step of 16 moves 32 bytes.
  auto products = [&](int kt) {
    const uint32_t xa = a_xhi + (kt % S) * kXStage + wg * 64 * 128;
    const uint32_t xl = a_xlo + (kt % S) * kXStage + wg * 64 * 128;
    const uint32_t wb = a_wt + (kt & 1) * kWTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      wgmma_64x64x16(acc, wg_desc(xa + kk * 32), wg_desc(wb + kk * 32));
      if constexpr (kSplitX)
        wgmma_64x64x16(acc, wg_desc(xl + kk * 32), wg_desc(wb + kk * 32));
    }
    wgmma_commit();
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }
  kb_next = kb_lo;                   // the first window, beside stage 0
  fetch_scales(kb_next);
  if (nk > 0) {
    cp_async_wait<S - 2>();          // stage 0 landed
    __syncthreads();
    window_for(0);
    decode(0, kb0);
  }
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt + 1 landed; decode(kt) and stage kt - 1's MMAs done
    // everywhere, and visible to the async proxy
    cp_async_wait<S - 3>();
    fence_async_smem();
    __syncthreads();
    if (kt + S - 1 < nk) issue(kt + S - 1);        // into kt - 1's slot
    cp_async_commit();
    products(kt);                                  // asynchronous MMAs
    if (kt + 1 < nk) {                             // meanwhile, decode
      window_for(kt + 1);
      decode(kt + 1, kb0);                          // into the other W tile
    }
    wgmma_wait0(acc);
  }
  cp_async_wait<0>();

  // Sum r of a thread (r = 4 j + q: n8 tile j, quarter q of the fragment)
  // -> tile row, column.
  auto row_of = [&](int t, int r) {
    return (t / 128) * 64 + ((t / 32) % 4) * 16 + ((t & 31) >> 2)
           + ((r & 3) >> 1) * 8;
  };
  auto col_of = [&](int t, int r) {
    return (r / 4) * 8 + (t & 3) * 2 + (r & 1);
  };
  // Sums r and r + 1 (r even) sit in adjacent columns of one row: stored
  // as one 8-byte pair where both columns are live and the pair is aligned.
  auto store_pair = [&](int r, float v0, float v1) {
    const int m = m0 + row_of(tid, r);
    const int n = out_col(col_of(tid, r));
    if (m >= M || n < 0) return;
    float* p = y + (size_t)m * N + n;
    if (out_col(col_of(tid, r) + 1) == n + 1) {
      if ((reinterpret_cast<uintptr_t>(p) & 7) == 0)
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      else
        p[0] = v0, p[1] = v1;
    } else {
      p[0] = v0;
    }
  };
  if (cs == 1) {
#pragma unroll
    for (int r = 0; r < C::ACC; r += 2) store_pair(r, acc[r], acc[r + 1]);
    return;
  }
  // Split K: thread t's sums r in [o * rpc, (o + 1) * rpc) (rpc even, so a
  // pair stays with one rank) belong to rank o. Every rank pushes them into
  // its slot of rank o's inbox ([source rank][r - o * rpc][t], overlaying
  // the now idle rings), and rank o adds its slots in rank order.
  const int rpc = ((C::ACC + cs - 1) / cs + 1) & ~1;
  const int per = rpc * T;
  float* inbox = reinterpret_cast<float*>(base);
  __syncthreads();
  cluster.sync();                    // every rank is done with its rings
  {
    int o = 0, first = 0;
    float* dst = cluster.map_shared_rank(inbox, 0) + rank * per + tid;
#pragma unroll
    for (int r = 0; r < C::ACC; ++r) {
      if (r == first + rpc) {
        ++o;
        first = r;
        dst = cluster.map_shared_rank(inbox, o) + rank * per + tid;
      }
      dst[(r - first) * T] = acc[r];
    }
  }
  cluster.sync();                    // every push has landed
  for (int j = 0; j < rpc && rank * rpc + j < C::ACC; j += 2) {
    float v0 = 0.0f, v1 = 0.0f;
    for (int src = 0; src < cs; ++src) {
      v0 += inbox[src * per + j * T + tid];
      v1 += inbox[src * per + (j + 1) * T + tid];
    }
    store_pair(rank * rpc + j, v0, v1);
  }
}

template <int MODE, typename XT, int BM, bool VEC>
int launch_tiled(const void* x, const uint8_t* codes, const int8_t* scales,
                 float* y, int M, int K, int N, Fmt f, int cs,
                 cudaStream_t stream) {
  using C = TiledCfg<MODE, XT, BM>;
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const int nkb = K / f.bs;
  if (f.bs % 8 != 0 || cs < 1 || cs > 16 || cs > (nkb > 1 ? nkb : 1))
    return (int)cudaErrorInvalidValue;
  auto kernel = mx_mm_tiled_kernel<MODE, XT, BM, VEC>;
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         232448);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attrs_set = true;
  }
  const size_t table = MODE == kModeFp ? ((size_t)kTCopies << f.bits) * 2
                                       : 0;
  const size_t main_b = (size_t)C::STAGES * BM * 128
                            * (sizeof(XT) == 4 ? 2 : 1)
                        + 2 * (size_t)C::BN * 128
                        + (size_t)C::STAGES * kTK * C::CB
                        + (size_t)kTScaleWin * C::SP * 2 + table;
  const size_t inbox_b =
      4 * (size_t)cs * (((C::ACC + cs - 1) / cs + 1) & ~1) * C::THREADS;
  const size_t smem = (main_b > inbox_b ? main_b : inbox_b) + 1024;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int W = MODE == kModeInt4 ? N / 2 : N;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, (W + C::CB - 1) / C::CB, (M + BM - 1) / BM);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const XT*>(x), codes, scales, y, M, K, N, f);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE, typename XT, bool VEC>
int launch_tiled_tile(const void* x, const uint8_t* codes,
                      const int8_t* scales, float* y, int M, int K, int N,
                      Fmt f, int bm, int cs, cudaStream_t stream) {
  if (bm == 128)
    return launch_tiled<MODE, XT, 128, VEC>(x, codes, scales, y, M, K, N, f,
                                            cs, stream);
  if (bm == 64)
    return launch_tiled<MODE, XT, 64, VEC>(x, codes, scales, y, M, K, N, f,
                                           cs, stream);
  return (int)cudaErrorInvalidValue;
}

// bf16 x with code rows and x on the 16-byte grid takes the cp.async path;
// anything else (f32 x, a leaf or x off the grid) the scalar one.
template <int MODE>
int launch_tiled_x(const void* x, int x_bf16, const uint8_t* codes,
                   const int8_t* scales, float* y, int M, int K, int N, Fmt f,
                   int bm, int cs, int vec, cudaStream_t stream) {
  if (!x_bf16)
    return launch_tiled_tile<MODE, float, false>(x, codes, scales, y, M, K, N,
                                                 f, bm, cs, stream);
  if (vec == 3)
    return launch_tiled_tile<MODE, __nv_bfloat16, true>(
        x, codes, scales, y, M, K, N, f, bm, cs, stream);
  return launch_tiled_tile<MODE, __nv_bfloat16, false>(
      x, codes, scales, y, M, K, N, f, bm, cs, stream);
}

}  // namespace

extern "C" {

// B1 (mode 0: int8 MXINT codes, 1: MXFP bit patterns with the given
// (bits, ebits, mbits, bias, emin)) and B2 (mode 2: split-N int4), the
// tiled body for M > 4: grid (cs, ceil(N / 64), ceil(M / bm)) in clusters
// of cs blocks, bm x 64 output tiles (bm 64 or 128), as
// kernels/mx_matmul.py::tiled_plan picks them. x is (M, K) row-major, f32
// (x_bf16 == 0) or bf16; bs must be a multiple of 8. vec bit 0 promises
// 16-byte-aligned code rows (codes pointer and row width), bit 1 a
// 16-byte-aligned x. Returns the launch's error, else cudaGetLastError().
int mx_matmul_tiled_launch(const void* x, int x_bf16, const uint8_t* codes,
                           const int8_t* scales, float* y, int M, int K,
                           int N, int mode, int bits, int ebits, int mbits,
                           int bias, int emin, int bs, int bm, int cs,
                           int vec, void* stream) {
  const Fmt f{bits, ebits, mbits, bias, emin, bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kModeInt:
      return launch_tiled_x<kModeInt>(x, x_bf16, codes, scales, y, M, K, N,
                                      f, bm, cs, vec, s);
    case kModeFp:
      return launch_tiled_x<kModeFp>(x, x_bf16, codes, scales, y, M, K, N, f,
                                     bm, cs, vec, s);
    case kModeInt4:
      return launch_tiled_x<kModeInt4>(x, x_bf16, codes, scales, y, M, K, N,
                                       f, bm, cs, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}


// The decode body of B1 (mode 0: int8 MXINT codes, 1: MXFP bit patterns)
// and B2 (mode 2: split-N int4), for M <= 4: grid (cs, strips, ceil(M/4))
// in clusters of cs blocks, strip code bytes per block (a multiple of 16,
// at most 256; 128 for int4), as kernels/mx_matmul.py::decode_plan picks
// them. vec bit 0 promises 16-byte-aligned code rows (codes pointer and
// row width), bit 1 16-byte-aligned x rows. Returns the launch's error,
// else cudaGetLastError().
int mx_matmul_decode_launch(const void* x, int x_bf16, const uint8_t* codes,
                            const int8_t* scales, float* y, int M, int K,
                            int N, int mode, int bits, int ebits, int mbits,
                            int bias, int emin, int bs, int strip, int cs,
                            int vec, void* stream) {
  const Fmt f{bits, ebits, mbits, bias, emin, bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kModeInt:
      return launch_decode_m<kModeInt>(x, x_bf16, codes, scales, y, M, K, N,
                                       f, strip, cs, vec, s);
    case kModeFp:
      return launch_decode_m<kModeFp>(x, x_bf16, codes, scales, y, M, K, N,
                                      f, strip, cs, vec, s);
    case kModeInt4:
      return launch_decode_m<kModeInt4>(x, x_bf16, codes, scales, y, M, K,
                                        N, f, strip, cs, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
