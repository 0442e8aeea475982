// Hopper (sm_90a) paged attention read straight off the KV page pools.
//
// Replaces the TPU kernels in repro/kernels/paged_attention.py:
//   paged_attention_launch    <- paged_attention_pallas    (B3: one query
//                                per slot, every pure-decode tick)
//   paged_attention_mq_launch <- paged_attention_pallas_mq (B4: a ragged
//                                span of q_len queries per slot at cursor
//                                q_offset, every mixed prefill+decode tick)
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
// q_offset = cache_len - 1, and both share one kernel body.
//
// What bounds it on the H100: bytes. At decode each slot streams its live
// K and V once for 4·H·D flops per token, far below the 295 flop/byte at
// which the tensor cores would bind. qwen3-4b at 4 slots and cache_len 200
// reads 13 pages x 16 x 8 x 128 x 2 B x 2 (K, V) = 0.85 MB per slot, about
// 1.0 us for 4 slots at 3.35 TB/s: below the latency of one launch.
//
// What this design does about it: the TPU walked the pages as a grid axis
// with the softmax carried in scratch between grid steps. Here one block
// owns one (slot, kv head, q block) and walks that slot's pages in a loop,
// reading the block-table row and the lengths itself. The walk is clamped
// as the Pallas index maps clamp it, so the pages one slot reads are
// pages_read / pages_read_mq. A page's ps rows of K and V for the kv head
// (each row D contiguous elements, rows Hkv·D apart) are loaded with
// 16-byte loads into registers while the previous page is computed, then
// staged in shared memory and shared by the G query heads. Only live rows
// (lane, head) are computed: a score is a dot split into four chains over
// 16-byte shared loads; the running max and sum are per row in f32; each
// thread holds two 4-row x 4-column tiles of the f32 accumulator in
// registers. B4 adds the q-block axis: tq lanes per block, at most 16 and
// few enough that the block's (lanes·G) x D accumulator fits those tiles
// (16 lanes x 4 heads x 128 at qwen3-4b), the m == -inf alpha guard, and a
// walk clamped per q block; a q block with no live lane reads nothing and
// writes zeros. At decode that is B·Hkv = 32 blocks for 132 SMs, each
// walking its pages one after another: latency, not bandwidth, sets its
// time. Splitting the walk across blocks (flash-decoding with a combine
// pass), TMA and wgmma are later work.
//
// Build (plain C interface, loaded with ctypes): see kernels/build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kAccPerThread = 32;   // f32 accumulator registers per thread
constexpr int kTile = 4;            // a PV item: 4 rows x 4 columns
constexpr int kItems = kAccPerThread / (kTile * kTile);
constexpr int kPrefetch = 8;        // 16-byte registers for the next page
constexpr int kB3Threads = 128;
constexpr int kB4Threads = 256;

struct Args {
  const void* q;            // (B, C, H, D)
  const void* k_pages;      // (P, ps, Hkv, D)
  const void* v_pages;
  const int* block_table;   // (B, mp)
  const int* lens;          // B3: cache_len (B,); B4: q_offset (B,)
  const int* q_len;         // B4 only (B,)
  float* out;               // (B, C, H, D) f32
  int C, H, hkv, D, ps, mp, tq, window;   // window < 0: none
  float scale;
  int vec;                  // 16-byte loads of K/V rows are aligned
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// A page's (ps, D) slice for one kv head into f32 shared memory at dst
// (row stride ds). Rows [t_lo, t_hi) are read; the others, which no query
// of the block sees, become zeros and are not read.
template <typename T>
__device__ void stage_rows(float* dst, int ds, const T* src, int64_t stride,
                           int rows, int t_lo, int t_hi, int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int t = idx / D, c = idx % D;
    dst[t * ds + c] = t >= t_lo && t < t_hi ? to_f32(src[t * stride + c])
                                            : 0.0f;
  }
}

// The next page's K and V rows for one kv head, held in registers as
// 16-byte chunks: fetched before the current page is computed, so their
// global latency overlaps that work, and stored to shared memory after.
// Rows outside [t_lo, t_hi) are zeros and are not read.
template <typename T>
struct NextPage {
  static constexpr int kV = 16 / sizeof(T);
  uint4 reg[kPrefetch];

  __device__ void fetch(const T* k, const T* v, int64_t stride, int ps,
                        int D, int t_lo, int t_hi) {
    const int per_row = D / kV, n = ps * per_row;
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int idx = threadIdx.x + i * blockDim.x;
      reg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < 2 * n) {
        const bool is_v = idx >= n;
        const int j = is_v ? idx - n : idx;
        const int t = j / per_row, c = (j % per_row) * kV;
        if (t >= t_lo && t < t_hi)
          reg[i] = *reinterpret_cast<const uint4*>((is_v ? v : k)
                                                   + t * stride + c);
      }
    }
  }

  __device__ void store(float* k_s, float* v_s, int ds, int ps,
                        int D) const {
    const int per_row = D / kV, n = ps * per_row;
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int idx = threadIdx.x + i * blockDim.x;
      if (idx < 2 * n) {
        const bool is_v = idx >= n;
        const int j = is_v ? idx - n : idx;
        float* d = (is_v ? v_s : k_s) + (j / per_row) * ds
            + (j % per_row) * kV;
        const T* e = reinterpret_cast<const T*>(&reg[i]);
#pragma unroll
        for (int u = 0; u < kV; ++u) d[u] = to_f32(e[u]);
      }
    }
  }
};

// Does the query at qpos see the key at pos? Causal, self-inclusive,
// within the window; the frontier and dead lanes are handled by the
// caller (only live rows are computed).
__device__ __forceinline__ bool sees(int qpos, int pos, int W) {
  return pos <= qpos && (W < 0 || qpos - pos < W);
}

// One block: slot b, kv head h, q block qb (lanes qb*tq .. +tq of the C
// query positions, lane i at logical position qoff + i, live iff i < qlen).
// Rows r = il*G + g pair a live lane with one of the G query heads.
template <typename T>
__device__ void attend(const Args& a, int b, int h, int qb, int qoff,
                       int qlen, float* smem) {
  const int G = a.H / a.hkv, D = a.D, ps = a.ps, W = a.window;
  const int ds = D + 4;              // padded rows, 16-byte aligned
  const int i0 = qb * a.tq;
  const int lanes = min(a.tq, a.C - i0);
  const int live_lanes = max(min(qlen - i0, lanes), 0);
  const int R = live_lanes * G;      // live rows; the others are zeros
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nt / 32;
  const int rows_max = a.tq * G;
  auto out_row = [&](int r) {
    return ((int64_t)b * a.C + i0 + r / G) * a.H + (int64_t)h * G + r % G;
  };

  for (int idx = tid; idx < (lanes * G - R) * D; idx += nt)
    a.out[out_row(R + idx / D) * D + idx % D] = 0.0f;     // dead lanes
  if (R == 0) return;                                     // the whole block

  float* q_s = smem;                 // rows_max x ds
  float* k_s = q_s + rows_max * ds;  // ps x ds
  float* v_s = k_s + ps * ds;        // ps x ds
  float* p_s = v_s + ps * ds;        // rows_max x ps: scores, then probs
  float* m_s = p_s + rows_max * ps;  // running max per row
  float* l_s = m_s + rows_max;       // running sum per row
  float* al_s = l_s + rows_max;      // this page's rescale per row

  const T* q = static_cast<const T*>(a.q);
  for (int idx = tid; idx < R * D; idx += nt)
    q_s[(idx / D) * ds + idx % D] = to_f32(q[out_row(idx / D) * D + idx % D]);
  for (int r = tid; r < R; r += nt) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }
  float acc[kItems][kTile][kTile];
#pragma unroll
  for (int k = 0; k < kItems; ++k)
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int u = 0; u < kTile; ++u) acc[k][i][u] = 0.0f;
  __syncthreads();

  // The walk of the Pallas kv_index map: pages [first, last] of the row,
  // and the union [lo_pos, hi_pos] of the positions the live lanes see.
  const int hi = qoff + i0 + live_lanes;
  const int last = max((hi + ps - 1) / ps - 1, 0);
  const int first =
      W >= 0 ? min(max(floor_div(qoff + i0 + 1 - W, ps), 0), last) : 0;
  const int lo_pos = W >= 0 ? max(qoff + i0 + 1 - W, 0) : 0;
  const int hi_pos = hi - 1;
  const int64_t stride = (int64_t)a.hkv * D;
  const T* kpool = static_cast<const T*>(a.k_pages);
  const T* vpool = static_cast<const T*>(a.v_pages);
  auto base = [&](int j) {
    return ((int64_t)a.block_table[(int64_t)b * a.mp + j] * ps * a.hkv + h)
        * (int64_t)D;
  };
  auto t_lo = [&](int j) { return max(lo_pos - j * ps, 0); };
  auto t_hi = [&](int j) { return min(hi_pos - j * ps + 1, ps); };
  const bool pipelined = a.vec
      && 2 * ps * (D / NextPage<T>::kV) <= nt * kPrefetch;
  NextPage<T> next;
  if (pipelined)
    next.fetch(kpool + base(first), vpool + base(first), stride, ps, D,
               t_lo(first), t_hi(first));
  const int n_items = (R + kTile - 1) / kTile * (D / kTile);

  for (int j = first; j <= last; ++j) {
    const int p0 = j * ps;
    const bool dead = p0 > hi_pos || p0 + ps - 1 < lo_pos;   // no live key
    if (pipelined) {
      next.store(k_s, v_s, ds, ps, D);
      if (j < last)
        next.fetch(kpool + base(j + 1), vpool + base(j + 1), stride, ps, D,
                   t_lo(j + 1), t_hi(j + 1));
    } else if (!dead) {
      stage_rows(k_s, ds, kpool + base(j), stride, ps, t_lo(j), t_hi(j), D);
      stage_rows(v_s, ds, vpool + base(j), stride, ps, t_lo(j), t_hi(j), D);
    }
    __syncthreads();
    if (dead) continue;

    // scores: one (row, key) per item, the dot split into four chains
    for (int idx = tid; idx < R * ps; idx += nt) {
      const int r = idx / ps, t = idx % ps;
      float s = -INFINITY;
      if (sees(qoff + i0 + r / G, p0 + t, W)) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + r * ds);
        const float4* kr = reinterpret_cast<const float4*>(k_s + t * ds);
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 x = qr[d4], y = kr[d4];
          s0 = fmaf(x.x, y.x, s0);
          s1 = fmaf(x.y, y.y, s1);
          s2 = fmaf(x.z, y.z, s2);
          s3 = fmaf(x.w, y.w, s3);
        }
        s = ((s0 + s1) + (s2 + s3)) * a.scale;
      }
      p_s[idx] = s;
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < R; r += nwarps) {
      const int qpos = qoff + i0 + r / G;
      float mx = -INFINITY;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, p_s[r * ps + t]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // A row that has seen no live position keeps m = -inf: its carry is 1
      // (exp(-inf - -inf) would be NaN) and its probabilities stay 0.
      const float alpha = m_new > -INFINITY ? expf(m_old - m_new) : 1.0f;
      float sum = 0.0f;
      for (int t = lane; t < ps; t += 32) {
        const float p = sees(qpos, p0 + t, W)
            ? expf(p_s[r * ps + t] - m_new) : 0.0f;
        p_s[r * ps + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        al_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: each item a 4-row x 4-column tile
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int it = k * nt + tid;
      if (it < n_items) {
        const int r0 = it / (D / kTile) * kTile, d0 = it % (D / kTile) * kTile;
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const float al = r0 + i < R ? al_s[r0 + i] : 1.0f;
#pragma unroll
          for (int u = 0; u < kTile; ++u) acc[k][i][u] *= al;
        }
        for (int t = 0; t < ps; ++t) {
          const float4 v = *reinterpret_cast<const float4*>(v_s + t * ds + d0);
#pragma unroll
          for (int i = 0; i < kTile; ++i) {
            const float p = r0 + i < R ? p_s[(r0 + i) * ps + t] : 0.0f;
            acc[k][i][0] = fmaf(p, v.x, acc[k][i][0]);
            acc[k][i][1] = fmaf(p, v.y, acc[k][i][1]);
            acc[k][i][2] = fmaf(p, v.z, acc[k][i][2]);
            acc[k][i][3] = fmaf(p, v.w, acc[k][i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int it = k * nt + tid;
    if (it < n_items) {
      const int r0 = it / (D / kTile) * kTile, d0 = it % (D / kTile) * kTile;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        if (r0 + i < R) {
          const float l = l_s[r0 + i];
          float* o = a.out + out_row(r0 + i) * D + d0;
#pragma unroll
          for (int u = 0; u < kTile; ++u)
            o[u] = l > 0.0f ? acc[k][i][u] / fmaxf(l, 1e-30f) : 0.0f;
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kB3Threads)
paged_attention_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  attend<T>(a, b, blockIdx.x, 0, a.lens[b] - 1, 1,
            reinterpret_cast<float*>(smem4));
}

template <typename T>
__global__ void __launch_bounds__(kB4Threads)
paged_attention_mq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  attend<T>(a, b, blockIdx.x, blockIdx.z, a.lens[b], a.q_len[b],
            reinterpret_cast<float*>(smem4));
}

size_t smem_bytes(const Args& a) {
  const size_t rows = (size_t)a.tq * (a.H / a.hkv), ds = a.D + 4;
  return sizeof(float) * (rows * ds + 2 * (size_t)a.ps * ds
                          + rows * a.ps + 3 * rows);
}

template <typename T, bool kMQ>
int launch(const Args& a, int B, cudaStream_t s) {
  const auto kern = kMQ ? paged_attention_mq_kernel<T>
                        : paged_attention_kernel<T>;
  const int threads = kMQ ? kB4Threads : kB3Threads;
  const int nq = (a.C + a.tq - 1) / a.tq;
  const size_t smem = smem_bytes(a);
  static size_t opted_in = 48 * 1024;   // dynamic shared memory allowed
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  if (B <= 0) return (int)cudaSuccess;
  kern<<<dim3(a.hkv, B, nq), threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

bool shape_ok(const Args& a, int threads) {
  if (a.hkv <= 0 || a.H % a.hkv || a.tq < 1 || a.D % kTile) return false;
  const int rows = a.tq * (a.H / a.hkv);
  return (rows + kTile - 1) / kTile * (a.D / kTile) <= threads * kItems;
}

}  // namespace

extern "C" {

// B3. q (B, H, D) and the pools (P, ps, Hkv, D) in bf16 (bf16 != 0) or f32;
// block_table (B, mp) int32; cache_len (B,) int32 (this tick's token
// included); out (B, H, D) f32. window < 0: none. vec != 0 promises
// 16-byte-aligned pools and D * sizeof(element) % 16 == 0. Returns
// cudaGetLastError() after the launch.
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const int* block_table,
                           const int* cache_len, float* out, int B, int H,
                           int hkv, int D, int ps, int mp, int window,
                           float scale, int bf16, int vec, void* stream) {
  const Args a{q, k_pages, v_pages, block_table, cache_len, nullptr, out,
               1, H, hkv, D, ps, mp, 1, window, scale, vec};
  if (!shape_ok(a, kB3Threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, false>(a, B, s)
              : launch<float, false>(a, B, s);
}

// B4. q (B, C, H, D); q_offset, q_len (B,) int32; out (B, C, H, D) f32; tq
// lanes per block whose accumulator fits (shape_ok). Otherwise as B3.
int paged_attention_mq_launch(const void* q, const void* k_pages,
                              const void* v_pages, const int* block_table,
                              const int* q_offset, const int* q_len,
                              float* out, int B, int C, int H, int hkv, int D,
                              int ps, int mp, int tq, int window, float scale,
                              int bf16, int vec, void* stream) {
  const Args a{q, k_pages, v_pages, block_table, q_offset, q_len, out,
               C, H, hkv, D, ps, mp, tq, window, scale, vec};
  if (!shape_ok(a, kB4Threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, true>(a, B, s)
              : launch<float, true>(a, B, s);
}

}  // extern "C"
