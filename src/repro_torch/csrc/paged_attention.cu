// Hopper (sm_90a) paged attention read straight off the KV page pools.
//
// Replaces the TPU kernels in repro/kernels/paged_attention.py:
//   paged_attention_pallas    (B3: one query per slot, every pure-decode
//                              tick; here q_len == nullptr, C = 1)
//   paged_attention_pallas_mq (B4: a ragged span of q_len queries per slot
//                              at cursor q_offset, every mixed tick)
// Both go through paged_attention_launch and one kernel body.
//
// Both compute, in f32, softmax(q k^T * scale) v over the positions each
// query may see, with K/V read through the slot's block-table row from a
// pool (P, ps, Hkv, D) in bf16 or f32, GQA (G = H / Hkv query heads per kv
// head), an optional sliding window, and total masking: a dead score is
// set to -inf before the running max, its probability is selected to 0
// after the exp, and K/V rows that no query sees are never read (zeros are
// stored in their place), so NaN in recycled pages or in scratch page 0
// cannot reach the output. A query with no live position (cache_len == 0,
// a pad lane past q_len) gives exact zeros. B3 is B4 with one lane at
// q_offset = cache_len - 1.
//
// What binds it on the H100: latency, not bytes. qwen3-4b at 4 slots and
// cache_len 200 reads 13 pages x 16 x 8 x 128 x 2 B x 2 (K, V) = 0.85 MB
// per slot, about 1 us of HBM time for all 4 slots, and 4·H·D flops per
// key, far below the 295 flop/byte at which the tensor cores would bind.
// One block per (slot, kv head, q block) walking its pages one after
// another (B·Hkv = 32 blocks on 132 SMs, four barriers per 16-key page,
// f32 CUDA-core dots) spends microseconds per page in dependent latency.
// What remains is a chain of dependent steps per block (lengths, block
// table, K/V, MMAs, partial, ticket, merge), each a round trip to L2 or
// HBM, and the instructions one warp per scheduler issues between them.
//
// What this design does about it:
// - Split page walk (flash-decoding). The grid is (split, kv head, slot x
//   q block). A split is a fixed run of tiles_per_split tiles of
//   tile_pages pages (64 keys), planned on the host from shapes only
//   (split_plan in kernels/paged_attention.py): the lengths are read here,
//   never on the host, so a call can be captured in a CUDA graph. Each
//   block clamps its walk as the Pallas index maps clamp it ([first, last]
//   of its q block, so the union is pages_read / pages_read_mq) and
//   intersects it with its split; a split outside the walk exits at once.
//   A q block of more than 16 rows whose walk spans at most 4 tiles is
//   walked whole by the split of its first page: its merge would cost more
//   than the serial walk.
// - Deterministic combine in the same launch. With one live split the
//   block writes the output itself. Otherwise each live split writes its
//   partial (m, l, acc[rows, D]) in f32 to scratch and takes a ticket (an
//   acq_rel atomicAdd on a per-(slot, kv head, q block) counter, after a
//   barrier); the block that draws the last ticket merges the partials in
//   split order, so two calls are bit-identical whatever order the blocks
//   ran in, and resets the counter to 0 for the next call. No float
//   atomics. The merge issues a batch of splits' loads before using any.
// - Asynchronous page loads of raw elements. A tile's K and V rows for the
//   kv head are copied as stored (bf16 or f32, no conversion) with 16-byte
//   cp.async into shared memory rows padded by 16 bytes, so ldmatrix reads
//   have no bank conflicts; where a block walks more than one tile, two
//   stages are in flight. Rows no query sees are stored as zeros and not
//   read. Unaligned pools (vec == 0) take a plain element loop, chosen by
//   shape.
// - Tensor cores. Four warps; each owns 16 query rows (row = lane x G +
//   head; a q block holds up to 32, at most 64) and a slice of the tile's
//   keys: with <= 16 live rows (decode) the four warps split the 64 keys,
//   with more they split the rows. S = Q K^T is mma.sync m16n8k16 bf16
//   with ldmatrix operands and f32 accumulation (products of bf16 are
//   exact in f32). P V runs on the tensor cores with P split into
//   hi = bf16(p) and lo = bf16(p - hi), two MMAs, so P keeps ~16 bits (one
//   bf16 rounding, 2^-9, would break the 1e-4 tolerance against the plain
//   version). A warp walks its keys 16 at a time (one code path: the
//   kernel stays small enough for the instruction cache); the warps'
//   partials over key slices merge through shared memory in warp order.
//   f32 pools take CUDA-core dots in the same fragment layout and the same
//   structure.
//
// Build (plain C interface, loaded with ctypes): see kernels/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// kRows, kTileKeys, kFoldRows and kFoldTiles are mirrored by ROWS,
// TILE_KEYS, FOLD_ROWS and FOLD_TILES in kernels/paged_attention.py.
constexpr int kThreads = 128;    // four warps
constexpr int kRows = 64;        // query rows per block, 16 per warp
constexpr int kTileKeys = 64;    // key rows per staged tile
constexpr int kMaxD = 256;
// A q block of more than kFoldRows rows whose walk spans at most
// kFoldTiles tiles is walked by one block (the split holding its first
// page): its merge would cost more than the serial walk.
constexpr int kFoldRows = 16;
constexpr int kFoldTiles = 4;

struct Args {
  const void* q;            // (B, C, H, D)
  const void* k_pages;      // (P, ps, Hkv, D)
  const void* v_pages;
  const int* block_table;   // (B, mp)
  const int* lens;          // B3: cache_len (B,); B4: q_offset (B,)
  const int* q_len;         // B4: (B,); B3: nullptr
  float* out;               // (B, C, H, D) f32
  float* part_acc;          // (groups, splits, tq*G, D) f32
  float* part_ml;           // (groups, splits, 2, tq*G) f32: m, then l
  int* tickets;             // (groups,) int32, all 0 between calls
  int C, H, hkv, D, ps, mp, tq, window;   // window < 0: none
  int tile_pages, tiles_per_split, splits, stages;
  float scale;
  int vec;                  // 16-byte copies of q and K/V rows are aligned
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The split's ticket: an add with release semantics for the block's
// partial (its writes precede the barrier before this call) and acquire
// semantics for the partials of the splits that took earlier tickets (read
// after the barrier that follows). The pattern of CUTLASS's semaphore.
__device__ __forceinline__ int take_ticket(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi): the
// difference is exact in f32, so hi + lo keeps ~16 significant bits.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// floor(a / b) for 0 <= a < 2^20 and b >= 1, from inv_b = 1.0f / b: the
// quotient (a + 0.5) / b lies at least 0.5 / b from an integer, far more
// than the rounding of the product, so this is exact (and no division).
__device__ __forceinline__ int small_div(int a, float inv_b) {
  return __float2int_rz((a + 0.5f) * inv_b);
}

// The factor of acc / l as acc * (1 / l), or 0 for a row whose sum is not
// positive: a row that saw no live position, or one whose live keys hold
// NaN (the sum is NaN, and NaN > 0 is false). A factor of 0 marks the row
// dead, and its epilogue selects exact zeros (the Pallas kernels' where(l >
// 0, out, 0)); it never multiplies by the 0, since 0 * NaN is NaN. For a
// live row 1 / l is far from 0: l is at most the row's key count.
__device__ __forceinline__ float inv_sum(float l) {
  return l > 0.0f ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
}

__device__ __forceinline__ void scale4(float4& v, float f) {
  v.x *= f;
  v.y *= f;
  v.z *= f;
  v.w *= f;
}

// v * f, or exact zeros where f is 0 (a dead row, inv_sum).
__device__ __forceinline__ float4 normalized4(float4 v, float f) {
  if (f == 0.0f) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  scale4(v, f);
  return v;
}

__device__ __forceinline__ void axpy(float4& acc, float4 v, float e) {
  acc.x += v.x * e;
  acc.y += v.y * e;
  acc.z += v.z * e;
  acc.w += v.w * e;
}

// One warp's share of the softmax: 16 query rows (ra = row0 + lane/4 and
// rb = ra + 8, the mma fragment rows) against a slice of the tile's keys.
template <int D>
struct WarpState {
  float acc[D / 8][4];      // the mma accumulator layout over D columns
  float m[2], l[2];         // running max, and this thread's partial sum
};

// Scores, online softmax and P V for one warp's 16 query rows against the
// 16 tile keys [k0, k0 + 16). Row i of the thread (ra, rb) sees tile keys
// [klo[i], khi[i]).
template <typename T, int D>
__device__ __forceinline__ void attend16(WarpState<D>& w, const T* q_s,
                                         const T* k_s, const T* v_s,
                                         float* p_w, int row0, int k0,
                                         const int (&klo)[2],
                                         const int (&khi)[2], float scale) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kLd = D + 16 / sizeof(T);
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};

  // ---- S = Q K^T: two 8-key tiles
  if constexpr (kMma) {
    // odd 16-column steps of D accumulate apart: two chains of MMAs
    float so[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], kb[4];
      ldsm_x4(qa, q_s + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd
                       + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(kb, k_s + (k0 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16
                       + ((lane >> 3) & 1) * 8);
      mma_bf16((kk & 1) ? so[0] : sc[0], qa, kb[0], kb[1]);
      mma_bf16((kk & 1) ? so[1] : sc[1], qa, kb[2], kb[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] += so[j][c];
  } else {
    const float* xa = q_s + (row0 + g8) * kLd;
    const float* xb = xa + 8 * kLd;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* y0 = k_s + (k0 + j * 8 + 2 * t4) * kLd;
      const float* y1 = y0 + kLd;
      float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 u = *reinterpret_cast<const float4*>(xa + d);
        const float4 v = *reinterpret_cast<const float4*>(xb + d);
        const float4 c0 = *reinterpret_cast<const float4*>(y0 + d);
        const float4 c1 = *reinterpret_cast<const float4*>(y1 + d);
        s00 += u.x * c0.x + u.y * c0.y + u.z * c0.z + u.w * c0.w;
        s01 += u.x * c1.x + u.y * c1.y + u.z * c1.z + u.w * c1.w;
        s10 += v.x * c0.x + v.y * c0.y + v.z * c0.z + v.w * c0.w;
        s11 += v.x * c1.x + v.y * c1.y + v.z * c1.z + v.w * c1.w;
      }
      sc[j][0] = s00;
      sc[j][1] = s01;
      sc[j][2] = s10;
      sc[j][3] = s11;
    }
  }

  // ---- mask (dead scores -inf), online softmax (a quad shares a row)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kr = k0 + j * 8 + 2 * t4 + (c & 1), i = c >> 1;
      sc[j][c] = kr >= klo[i] && kr < khi[i] ? sc[j][c] * scale : -INFINITY;
      mx[i] = fmaxf(mx[i], sc[j][c]);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(w.m[i], mx[i]);
    // A row that has seen no live position keeps m = -inf: its carry is
    // 1 (exp(-inf - -inf) would be NaN) and its probabilities stay 0.
    alpha[i] = m_new > -INFINITY ? __expf(w.m[i] - m_new) : 1.0f;
    w.m[i] = m_new;
    w.l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kr = k0 + j * 8 + 2 * t4 + (c & 1), i = c >> 1;
      const float p = kr >= klo[i] && kr < khi[i]
          ? __expf(sc[j][c] - w.m[i]) : 0.0f;
      sc[j][c] = p;
      w.l[i] += p;
    }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    w.acc[n][0] *= alpha[0];
    w.acc[n][1] *= alpha[0];
    w.acc[n][2] *= alpha[1];
    w.acc[n][3] *= alpha[1];
  }

  // ---- acc += P V
  if constexpr (kMma) {
    uint32_t ph[4], pl[4];
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, v_s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd
                            + dp * 16 + (lane >> 4) * 8);
      mma_bf16(w.acc[2 * dp], ph, vb[0], vb[1]);
      mma_bf16(w.acc[2 * dp + 1], ph, vb[2], vb[3]);
      mma_bf16(w.acc[2 * dp], pl, vb[0], vb[1]);
      mma_bf16(w.acc[2 * dp + 1], pl, vb[2], vb[3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p_w[(g8 + 8 * (c >> 1)) * 16 + j * 8 + 2 * t4 + (c & 1)] = sc[j][c];
    __syncwarp();
#pragma unroll 2
    for (int k = 0; k < 16; ++k) {
      const float pa = p_w[g8 * 16 + k], pb = p_w[(g8 + 8) * 16 + k];
      const float* vr = v_s + (k0 + k) * kLd + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float2 v = *reinterpret_cast<const float2*>(vr + n * 8);
        w.acc[n][0] = fmaf(pa, v.x, w.acc[n][0]);
        w.acc[n][1] = fmaf(pa, v.y, w.acc[n][1]);
        w.acc[n][2] = fmaf(pb, v.x, w.acc[n][2]);
        w.acc[n][3] = fmaf(pb, v.y, w.acc[n][3]);
      }
    }
    __syncwarp();
  }
}

// The last split's merge of the splits' partials, for kCols float4
// columns per thread (column idx = e0 + k * kThreads: row idx / d4), over
// the splits in order, kBatch at a time: every load of a batch is issued
// before any is used (indices clamped in range, only the arithmetic is
// predicated), then the batch's max, one weight per split and one rescale
// of the carry.
template <int kCols, int kBatch>
__device__ __forceinline__ void merge_splits(float* out, const int64_t* row_out,
                                             const float* pm, const float* pa,
                                             int rows, int64_t stride_s,
                                             int ns, int e0, int E, int d4) {
  float M[kCols], L[kCols];
  float4 A[kCols];
  int64_t src[kCols];
  int r[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    M[k] = -INFINITY;
    L[k] = 0.0f;
    A[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int idx = min(e0 + k * kThreads, E - 1);
    r[k] = idx / d4;
    src[k] = (int64_t)r[k] * (4 * d4) + idx % d4 * 4;
  }
  for (int i0 = 0; i0 < ns; i0 += kBatch) {
    float ms[kBatch][kCols], ls[kBatch][kCols];
    float4 v[kBatch][kCols];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int64_t i = min(i0 + j, ns - 1);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        ms[j][k] = __ldcg(pm + 2 * i * rows + r[k]);
        ls[j][k] = __ldcg(pm + (2 * i + 1) * rows + r[k]);
        v[j][k] = __ldcg(reinterpret_cast<const float4*>(
            pa + i * stride_s + src[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      // a split (or the carry) with max -inf holds zeros: weight 0
      float m_new = M[k];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (i0 + j < ns) m_new = fmaxf(m_new, ms[j][k]);
      const float c = M[k] > -INFINITY ? __expf(M[k] - m_new) : 0.0f;
      L[k] *= c;
      scale4(A[k], c);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float e = i0 + j < ns && ms[j][k] > -INFINITY
            ? __expf(ms[j][k] - m_new) : 0.0f;
        L[k] += ls[j][k] * e;
        axpy(A[k], v[j][k], e);
      }
      M[k] = m_new;
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int idx = e0 + k * kThreads;
    if (idx < E)
      *reinterpret_cast<float4*>(out + row_out[r[k]] + idx % d4 * 4) =
          normalized4(A[k], inv_sum(L[k]));
  }
}

// One block: split s of the walk of (slot b, kv head h, q block qb), whose
// lanes are qb*tq .. +tq of the C query positions; lane i sits at logical
// position qoff + i and is live iff i < qlen. Rows r = lane*G + head.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a) {
  constexpr int kPad = 16 / sizeof(T);      // elements per 16 bytes
  constexpr int kLd = D + kPad;             // padded shared-memory row
  constexpr int kCpr = D / kPad;            // 16-byte chunks per row
  constexpr int kRowStep = kThreads / kCpr;
  constexpr int kD4 = D / 4;                // float4 columns per row
  extern __shared__ uint4 smem4[];
  __shared__ int is_last;
  __shared__ int64_t row_out[kRows];

  const int s = blockIdx.x, h = blockIdx.y;
  const int nq = (a.C + a.tq - 1) / a.tq;
  const int b = small_div(blockIdx.z, __frcp_rn((float)nq));
  const int qb = blockIdx.z - b * nq;
  const int bhq = (b * a.hkv + h) * nq + qb;
  const int G = a.H / a.hkv, ps = a.ps, W = a.window;
  const float inv_g = __frcp_rn((float)G), inv_ps = __frcp_rn((float)ps);
  const int tid = threadIdx.x;

  int qoff, qlen;
  if (a.q_len != nullptr) {
    qoff = __ldg(a.lens + b);
    qlen = __ldg(a.q_len + b);
  } else {
    qoff = __ldg(a.lens + b) - 1;
    qlen = 1;
  }
  const int i0 = qb * a.tq;
  const int lanes = min(a.tq, a.C - i0);
  const int live = max(min(qlen - i0, lanes), 0);
  const int R = live * G;                   // live rows; the others are 0
  auto out_row = [&](int r) {
    const int lane_r = small_div(r, inv_g);
    return (((int64_t)b * a.C + i0 + lane_r) * a.H + (int64_t)h * G + r
            - lane_r * G) * D;
  };
  if (s == 0) {                             // dead lanes
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = R + tid / kD4; r < lanes * G; r += kThreads / kD4)
      *reinterpret_cast<float4*>(a.out + out_row(r) + tid % kD4 * 4) = z;
  }
  if (R == 0) return;

  // The walk of the Pallas kv_index map: pages [first, last] of the row,
  // and the union [lo_pos, hi_pos] of the positions the live lanes see.
  const int hi = qoff + i0 + live;
  const int last = min(max(small_div(hi + ps - 1, inv_ps) - 1, 0), a.mp - 1);
  const int first =
      W >= 0 ? min(max(floor_div(qoff + i0 + 1 - W, ps), 0), last) : 0;
  const int lo_pos = W >= 0 ? max(qoff + i0 + 1 - W, 0) : 0;
  const int hi_pos = hi - 1;
  const int pps = a.tiles_per_split * a.tile_pages;
  const float inv_pps = __frcp_rn((float)pps);
  const bool fold = R > kFoldRows
      && last - first < kFoldTiles * a.tile_pages;
  const int s_first = small_div(first, inv_pps);
  const int s_last = fold ? s_first : small_div(last, inv_pps);
  if (s < s_first || s > s_last) return;    // this split reads nothing
  const int p_lo = max(first, s * pps);
  const int p_hi = fold ? last : min(last, s * pps + pps - 1);
  const int n_tiles = (p_hi - p_lo) / a.tile_pages + 1;

  T* q_s = reinterpret_cast<T*>(smem4);                 // kRows x kLd
  T* stages = q_s + kRows * kLd;                        // per stage: K, V
  float* p_s = reinterpret_cast<float*>(stages + a.stages * 2 * kTileKeys
                                        * kLd);         // f32 path: P

  // Tile tt holds pages p_lo + tt*tile_pages .. (at most p_hi) as key rows
  // 0..63; rows [lo, hi_r) hold positions some live lane sees, the others
  // are stored as zeros and not read.
  // This thread's 16-byte column and rows of a tile (kr = my_row +
  // i * kRowStep): the page of the tile each falls in and its offset in
  // the page, the same for every tile.
  constexpr int kRowsPer = kTileKeys / kRowStep;
  const int my_row = tid / kCpr, my_col = tid % kCpr * kPad;
  const int64_t row_stride = (int64_t)a.hkv * D;
  const int64_t page_stride = (int64_t)ps * row_stride;
  const int* bt_row = a.block_table + (int64_t)b * a.mp;
  int row_page[kRowsPer];
  int64_t row_off[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int kr = my_row + i * kRowStep;
    row_page[i] = small_div(kr, inv_ps);
    row_off[i] = (kr - row_page[i] * ps) * row_stride + my_col;
  }
  const T* kpool = static_cast<const T*>(a.k_pages) + (int64_t)h * D;
  const T* vpool = static_cast<const T*>(a.v_pages) + (int64_t)h * D;
  auto live_rows = [&](int tt, int& lo, int& hi_r) {
    const int j0 = p_lo + tt * a.tile_pages;
    const int j1 = min(j0 + a.tile_pages - 1, p_hi);
    lo = max(lo_pos - j0 * ps, 0);
    hi_r = min(hi_pos + 1, (j1 + 1) * ps) - j0 * ps;
  };
  auto load_tile = [&](int tt, int st) {
    T* k_s = stages + st * 2 * kTileKeys * kLd;
    T* v_s = k_s + kTileKeys * kLd;
    const int j0 = p_lo + tt * a.tile_pages;
    int lo, hi_r;
    live_rows(tt, lo, hi_r);
    if (a.vec) {
      // this thread's rows: their pages' table entries first (clamped into
      // the walk, all issued together), then the copies
      int page[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
        page[i] = __ldg(bt_row + min(j0 + row_page[i], p_hi));
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const int kr = my_row + i * kRowStep;
        T* kd = k_s + kr * kLd + my_col;
        T* vd = v_s + kr * kLd + my_col;
        if (kr >= lo && kr < hi_r) {
          const int64_t src = page[i] * page_stride + row_off[i];
          cp_async16(kd, kpool + src);
          cp_async16(vd, vpool + src);
        } else {
          *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      cp_async_commit();
    } else {
      for (int idx = tid; idx < kTileKeys * D; idx += kThreads) {
        const int kr = idx / D, c = idx % D;
        T kv = zero_of<T>(), vv = zero_of<T>();
        if (kr >= lo && kr < hi_r) {
          const int jj = small_div(kr, inv_ps);
          const int64_t src =
              ((int64_t)bt_row[j0 + jj] * ps + kr - jj * ps) * row_stride + c;
          kv = kpool[src];
          vv = vpool[src];
        }
        k_s[kr * kLd + c] = kv;
        v_s[kr * kLd + c] = vv;
      }
    }
  };

  // q rows by cp.async in tile 0's group (the others are zeros), so the
  // two loads overlap; each live row's output offset for the epilogue.
  const T* q = static_cast<const T*>(a.q);
  if (a.vec) {
    const int c = tid % kCpr * kPad;
    for (int r = tid / kCpr; r < kRows; r += kRowStep) {
      T* dst = q_s + r * kLd + c;
      if (r < R)
        cp_async16(dst, q + out_row(r) + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int idx = tid; idx < kRows * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      q_s[r * kLd + c] = r < R ? q[out_row(r) + c] : zero_of<T>();
    }
  }
  if (tid < R) row_out[tid] = out_row(tid);

  // Warp roles: with <= 16 live rows the four warps split the tile's keys,
  // with more they split the rows.
  const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const int wr_count = R <= 16 ? 1 : (R <= 32 ? 2 : 4);
  const int wk_count = 4 / wr_count;
  const int wr = warp % wr_count, wk = warp / wr_count;
  const int kw = kTileKeys / wk_count;      // keys per warp: 16, 32 or 64
  const int kbase = wk * kw, row0 = wr * 16;
  const int ra = row0 + g8, rb = ra + 8;
  const int qp[2] = {qoff + i0 + small_div(ra, inv_g),
                     qoff + i0 + small_div(rb, inv_g)};
  const bool row_live[2] = {ra < R, rb < R};

  WarpState<D> st;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) st.acc[n][c] = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = -INFINITY;
    st.l[i] = 0.0f;
  }

  // Tiles are issued up to a.stages ahead: tile tt goes to stage
  // tt % stages, whose last reader finished before the previous barrier.
  int issued = 0;
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int stage = tt % a.stages;
    for (; issued < min(tt + a.stages, n_tiles); ++issued)
      load_tile(issued, issued % a.stages);
    if (issued > tt + 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const T* k_s = stages + stage * 2 * kTileKeys * kLd;
    const T* v_s = k_s + kTileKeys * kLd;
    const int pos0 = (p_lo + tt * a.tile_pages) * ps;
    int lo, hi_r;
    live_rows(tt, lo, hi_r);
    // the keys of the tile each of this thread's rows sees: causal,
    // within the window, live
    int klo[2], khi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      klo[i] = W >= 0 ? max(lo, qp[i] - W + 1 - pos0) : lo;
      khi[i] = row_live[i] ? min(hi_r, qp[i] + 1 - pos0) : 0;
    }
    if (row0 < R && kbase < hi_r && kbase + kw > lo) {
      // the warp's keys in 16-key steps, from the first step with a live
      // key (the online softmax is exact at any step)
      float* p_w = p_s + warp * 16 * 16;
      const int k_end = min(kbase + kw, hi_r);
      for (int k0 = max(kbase, lo & ~15); k0 < k_end; k0 += 16)
        attend16<T, D>(st, q_s, k_s, v_s, p_w, row0, k0, klo, khi, a.scale);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 1);
    st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], 2);
  }

  const bool single = s_first == s_last;
  const int rows = a.tq * G;
  const int64_t stride_s = (int64_t)rows * D;
  float* pacc = a.part_acc + ((int64_t)bhq * a.splits) * stride_s;
  float* pml = a.part_ml + ((int64_t)bhq * a.splits) * 2 * rows;
  if (wk_count == 1) {
    // ---- one key slice per row: the fragments are the block's result
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? rb : ra;
      if (r < R) {
        float* dst = single ? a.out + row_out[r]
                            : pacc + s * stride_s + (int64_t)r * D;
        const float f = single ? inv_sum(st.l[i]) : 1.0f;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(dst + n * 8 + 2 * t4) = f == 0.0f
              ? make_float2(0.0f, 0.0f)
              : make_float2(st.acc[n][2 * i] * f, st.acc[n][2 * i + 1] * f);
        if (!single && t4 == 0) {
          pml[(2 * s) * rows + r] = st.m[i];
          pml[(2 * s + 1) * rows + r] = st.l[i];
        }
      }
    }
  } else {
    // ---- merge the warps' key slices through shared memory (q and the
    // stages are free now): acc rows (wk, r) of D f32 padded by 8 (no
    // bank conflicts), then per (wk, r) the max, turned into the weight,
    // the sum, and per row the factor of the output.
    constexpr int kMg = D + 8;
    float* mg = reinterpret_cast<float*>(smem4);
    float* mg_m = mg + kRows * kMg;
    float* mg_l = mg_m + kRows;
    float* row_f = mg_l + kRows;
    const int rw = wr_count * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? rb : ra;
      if (r < R) {
        const int slot = wk * rw + r;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(mg + slot * kMg + n * 8 + 2 * t4) =
              make_float2(st.acc[n][2 * i], st.acc[n][2 * i + 1]);
        if (t4 == 0) {
          mg_m[slot] = st.m[i];
          mg_l[slot] = st.l[i];
        }
      }
    }
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      float M = -INFINITY, L = 0.0f;
      for (int w = 0; w < wk_count; ++w) M = fmaxf(M, mg_m[w * rw + r]);
      for (int w = 0; w < wk_count; ++w) {
        // a slice with no live key has weight 0 and an accumulator of 0
        const float mw = mg_m[w * rw + r];
        const float e = mw > -INFINITY ? __expf(mw - M) : 0.0f;
        mg_m[w * rw + r] = e;
        L += mg_l[w * rw + r] * e;
      }
      row_f[r] = single ? inv_sum(L) : 1.0f;
      if (!single) {
        pml[(2 * s) * rows + r] = M;
        pml[(2 * s + 1) * rows + r] = L;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < R * kD4; idx += kThreads) {
      const int r = idx / kD4, d = idx % kD4 * 4;
      float4 A = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (w < wk_count)
          axpy(A, *reinterpret_cast<const float4*>(mg + (w * rw + r) * kMg
                                                   + d),
               mg_m[w * rw + r]);
      *reinterpret_cast<float4*>(single ? a.out + row_out[r] + d
                                 : pacc + s * stride_s + (int64_t)r * D + d)
          = normalized4(A, row_f[r]);
    }
  }
  if (single) return;

  // ---- the last live split of (b, h, qb) to finish merges all of them,
  // in split order, and resets the ticket
  __syncthreads();
  if (tid == 0) is_last = take_ticket(a.tickets + bhq) == s_last - s_first;
  __syncthreads();
  if (!is_last) return;
  const int ns = s_last - s_first + 1;
  const float* pm = pml + (2 * s_first) * rows;       // split i: m at
  const float* pa = pacc + s_first * stride_s;        // pm[2i*rows + r]
  const int E = R * kD4;
  if (E <= kThreads) {
    if (tid < E)
      merge_splits<1, 8>(a.out, row_out, pm, pa, rows, stride_s, ns, tid,
                          E, kD4);
  } else {
    for (int e0 = tid; e0 < E; e0 += 4 * kThreads)
      merge_splits<4, 4>(a.out, row_out, pm, pa, rows, stride_s, ns, e0, E,
                         kD4);
  }
  if (tid == 0) a.tickets[bhq] = 0;
}

// Shared memory: q rows, then the stages, then the f32 path's
// probabilities. The warps' merge reuses q and the first stage: 64 rows x
// (D + 8) f32 plus 3 x 64 fit in 3 x 64 rows x (D + 16 bytes). Mirrored by
// _smem in kernels/paged_attention.py.
size_t smem_bytes(const Args& a, size_t elem) {
  const size_t ld = a.D + 16 / elem;
  return elem * (kRows + a.stages * 2 * kTileKeys) * ld
      + (elem == 4 ? sizeof(float) * 4 * 16 * 16 : 0);
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t s) {
  const auto kern = paged_attention_kernel<T, D>;
  const size_t smem = smem_bytes(a, sizeof(T));
  static size_t opted_in = 48 * 1024;   // dynamic shared memory allowed
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const int nq = (a.C + a.tq - 1) / a.tq;
  kern<<<dim3(a.splits, a.hkv, B * nq), kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a, int B, cudaStream_t s) {
  switch (a.D) {
    case 16: return launch<T, 16>(a, B, s);
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    default: return launch<T, 256>(a, B, s);
  }
}

bool shape_ok(const Args& a, int B) {
  if (a.hkv <= 0 || a.H % a.hkv || a.D < 16 || a.D > kMaxD
      || (a.D & (a.D - 1)))
    return false;
  if (a.tq < 1 || a.tq * (a.H / a.hkv) > kRows || a.C < 1 || a.mp < 1)
    return false;
  if (a.tile_pages < 1 || a.tile_pages * a.ps > kTileKeys || a.ps < 1)
    return false;
  if (a.tiles_per_split < 1 || a.splits < 1 || a.stages < 1 || a.stages > 2)
    return false;
  const int nq = (a.C + a.tq - 1) / a.tq;
  return a.hkv <= 65535 && (int64_t)B * nq <= 65535;
}

}  // namespace

extern "C" {

// B3 (q_len == nullptr: q (B, 1, H, D), lens = cache_len, this tick's token
// included) and B4 (q (B, C, H, D), lens = q_offset, q_len (B,)). Pools
// (P, ps, Hkv, D) in bf16 (bf16 != 0) or f32, as q; block_table (B, mp)
// int32; out (B, C, H, D) f32. The split plan (tq, tile_pages,
// tiles_per_split, splits, stages) and the scratch sizes come from
// split_plan in kernels/paged_attention.py; tickets must be zeros and are
// zeros again when the kernel ends. window < 0: none. vec != 0 promises
// 16-byte-aligned q and pools. Returns cudaGetLastError() after the launch.
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const int* block_table,
                           const int* lens, const int* q_len, float* out,
                           float* part_acc, float* part_ml, int* tickets,
                           int B, int C, int H, int hkv, int D, int ps,
                           int mp, int tq, int tile_pages,
                           int tiles_per_split, int splits, int stages,
                           int window, float scale, int bf16, int vec,
                           void* stream) {
  const Args a{q, k_pages, v_pages, block_table, lens, q_len, out, part_acc,
               part_ml, tickets, C, H, hkv, D, ps, mp, tq, window,
               tile_pages, tiles_per_split, splits, stages, scale, vec};
  if (!shape_ok(a, B)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_d<__nv_bfloat16>(a, B, s) : dispatch_d<float>(a, B, s);
}

}  // extern "C"
