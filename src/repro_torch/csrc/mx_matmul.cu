// Hopper (sm_90a) dequant-fused GEMMs over packed MX weights.
//
// Replace the TPU kernels in repro/kernels/mx_matmul.py:
//   B1 <- mx_matmul_pallas       (int8 MXINT / uint8 MXFP codes)
//   B2 <- mx_matmul_int4_pallas  (split-N int4 nibbles)
// Each has two bodies here, templated on the same three modes, and
// kernels/mx_matmul.py picks one by M alone: the decode body for M <= 16
// (mx_matmul_decode_launch), the tiled body above (mx_matmul_launch,
// mx_matmul_int4_launch).
//
// Both compute y (M, N) f32 = x (M, K) @ dequant(W), x in bf16 or f32,
// where W's element codes are (K, N) [or split-N packed (K, N/2)] and its
// E8M0 scales sit in the serving layout (N, K/bs): one int8 exponent per
// column per K-block. Each code is decoded exactly (MXINT as is, MXFP as
// repro/kernels/common.py::decode_fp_arith), scaled by an exact 2^e (pow2i,
// clamped to [-126, 127]) and each product table[c] * 2^e accumulated in
// f32; the bodies differ only in the order of the sum.
//
// The decode body (M <= 16). What bounds it on the H100: the weight streams
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
// The tiled body (M > 16: prefill buckets, the mixed tick's M = 256). What
// bounds it: the flops grow with M while the bytes do not; every
// dequantized MX value is exact in bf16, so bf16 tensor cores (989
// TFLOP/s) could do the work, and the flop bound takes over once M passes
// about 150 at 8 bits (about 75 at 4 bits). What it does: it reads every
// code byte once per M-tile of 8 rows with coalesced 4-byte loads along N
// (4 output columns per thread), never materialises a dense weight, and
// spreads K over 32 thread groups inside a block; each thread issues a
// chunk of 16 code rows' loads before using any. It runs on CUDA-core FMAs,
// far from both bounds; a tensor-core version is later work.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libmx_matmul.so mx_matmul.cu

#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------------
// The decode body (M <= 16): a streaming reduction over the weight.
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

// The decode body of B1 (mode 0: int8 MXINT codes, 1: MXFP bit patterns)
// and B2 (mode 2: split-N int4), for M <= 16: grid (cs, strips, ceil(M/4))
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
