// Pieces shared by the exact top-k kernels (topk.cu: B1, topk_int8.cu: B4)
// and the retrieval probes (probes.cu: P1, P2).
//
// Score tile: a CTA of 256 threads scores 32 queries against 128 corpus rows.
// Each thread holds 4 queries x 4 rows of accumulators (queries ty*4 + i,
// rows tx + 32*r) and the depth walks in shared-memory chunks. The float
// tile runs IEEE FP32 FMAs (f32 or bf16 corpus); the int8 tile runs __dp4a
// on packed 4-byte words into int32.
//
// Selection: each warp owns 4 queries and keeps each query's running top-k
// in lanes 0..k-1 of one register (k <= 32). A tile row is merged in with a
// ballot against the current k-th score, so almost every tile skips the
// merge once the list has filled. A second kernel reduces the
// (B, n_ctas * k) candidates of all CTAs to (B, k).
//
// Ties resolve to the lowest corpus index in both passes: rows reach a
// CTA's list in increasing index order, a new candidate goes after every
// held entry with an equal or larger score, and the merge orders by
// (score desc, index asc).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QG = 32;             // queries per CTA (grid.y covers B)
constexpr int NT = 128;            // corpus rows per tile
constexpr int THREADS = 256;       // 8 warps
constexpr int QS_STRIDE = QG + 4;  // keeps the 16-byte broadcast read aligned
constexpr int MERGE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

constexpr int KC = 32;             // float tile: depth of one chunk (elements)
constexpr int KW = 32;             // int8 tile: depth of one chunk (4-byte words)

struct FloatTileSmem {
  __align__(16) float Qs[KC][QS_STRIDE];  // query chunk, depth-major
  float Cs[NT][KC + 1];                   // conflict-free column reads
};

struct Int8TileSmem {
  __align__(16) int Qs[KW][QS_STRIDE];
  int Cs[NT][KW + 1];
};

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[i][r] = q[q_base + ty*4 + i] . corpus[n0 + tx + 32*r] over all D, in
// IEEE f32 FMAs. q is (B, D) f32, corpus (N, D) f32 or bf16, D % 4 == 0,
// both 16-byte aligned. Out-of-range queries and rows read as 0. With
// ROUND_BF16 each corpus element is rounded to bf16 first (the caller rounds
// q), so every product is exact: one bf16 pass with f32 accumulation.
template <typename T, bool ROUND_BF16>
__device__ __forceinline__ void float_tile(const float* __restrict__ q,
                                           const T* __restrict__ corpus, int B, int N,
                                           int D, int q_base, int n0, FloatTileSmem& sm,
                                           float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;

  for (int d0 = 0; d0 < D; d0 += KC) {
    // corpus chunk: 128 rows x 32 depth, one 4-vector per thread per pass
#pragma unroll
    for (int it = 0; it < (NT * KC / 4) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int row = idx >> 3;
      const int d4 = (idx & 7) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      const int n = n0 + row;
      if (n < N && d0 + d4 < D) load4(corpus + (int64_t)n * D + d0 + d4, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) sm.Cs[row][d4 + e] = ROUND_BF16 ? round_bf16(v[e]) : v[e];
    }
    // query chunk: 32 queries x 32 depth, stored depth-major
    {
      const int b = tid >> 3;
      const int d4 = (tid & 7) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (q_base + b < B && d0 + d4 < D) load4(q + (int64_t)(q_base + b) * D + d0 + d4, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) sm.Qs[d4 + e][b] = v[e];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 qv = *reinterpret_cast<const float4*>(&sm.Qs[kk][ty * 4]);
      const float qf[4] = {qv.x, qv.y, qv.z, qv.w};
      float cf[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cf[r] = sm.Cs[tx + 32 * r][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][r] = fmaf(qf[i], cf[r], acc[i][r]);
    }
    __syncthreads();
  }
}

// The int8 counterpart of float_tile: int32 dot products of int8 rows,
// __dp4a on packed 4-byte words. D % 16 == 0, both 16-byte aligned.
// |q|, |c| <= 127 keep |acc| <= D * 127^2, exact in int32.
__device__ __forceinline__ void int8_tile(const int8_t* __restrict__ q,
                                          const int8_t* __restrict__ corpus, int B, int N,
                                          int D, int q_base, int n0, Int8TileSmem& sm,
                                          int (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0;

  for (int d0 = 0; d0 < D; d0 += KW * 4) {
    // corpus chunk: 128 rows x 128 bytes, one 16-byte vector per thread per pass
#pragma unroll
    for (int it = 0; it < (NT * KW / 4) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int row = idx >> 3;
      const int w4 = (idx & 7) * 4;
      int4 v = make_int4(0, 0, 0, 0);
      const int n = n0 + row;
      if (n < N && d0 + w4 * 4 < D)
        v = *reinterpret_cast<const int4*>(corpus + (int64_t)n * D + d0 + w4 * 4);
      sm.Cs[row][w4] = v.x;
      sm.Cs[row][w4 + 1] = v.y;
      sm.Cs[row][w4 + 2] = v.z;
      sm.Cs[row][w4 + 3] = v.w;
    }
    // query chunk: 32 queries x 128 bytes, one vector per thread, depth-major
    {
      const int b = tid >> 3;
      const int w4 = (tid & 7) * 4;
      int4 v = make_int4(0, 0, 0, 0);
      if (q_base + b < B && d0 + w4 * 4 < D)
        v = *reinterpret_cast<const int4*>(q + (int64_t)(q_base + b) * D + d0 + w4 * 4);
      sm.Qs[w4][b] = v.x;
      sm.Qs[w4 + 1][b] = v.y;
      sm.Qs[w4 + 2][b] = v.z;
      sm.Qs[w4 + 3][b] = v.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KW; ++kk) {
      const int4 qv = *reinterpret_cast<const int4*>(&sm.Qs[kk][ty * 4]);
      const int qw[4] = {qv.x, qv.y, qv.z, qv.w};
      int cw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cw[r] = sm.Cs[tx + 32 * r][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][r] = __dp4a(qw[i], cw[r], acc[i][r]);
    }
    __syncthreads();
  }
}

// (s1, i1) ranks before (s2, i2): higher score, then lower index.
__device__ __forceinline__ bool ranks_before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void init_lists(float (&top_s)[4], int (&top_i)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    top_s[j] = -INFINITY;
    top_i[j] = INT_MAX;
  }
}

// Merge one query's tile row (the NT scores of rows n0..n0+NT-1) into the
// running list of lanes 0..k-1. Called by a whole warp.
__device__ __forceinline__ void merge_row(const float* srow, int n0, int k, int lane,
                                          float& top_s, int& top_i) {
  float thr = __shfl_sync(FULL, top_s, k - 1);
  for (int c = 0; c < NT / 32; ++c) {
    const float s = srow[c * 32 + lane];
    unsigned cand = __ballot_sync(FULL, s > thr);
    while (cand) {  // lowest lane first = increasing corpus index
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      const float sv = __shfl_sync(FULL, s, src);
      if (!(sv > thr)) continue;  // warp-uniform
      const int iv = n0 + c * 32 + src;
      // insert after every held entry scoring >= sv (those hold lower indices)
      const int pos = __popc(__ballot_sync(FULL, lane < k && top_s >= sv));
      const float up_s = __shfl_up_sync(FULL, top_s, 1);
      const int up_i = __shfl_up_sync(FULL, top_i, 1);
      if (lane == pos) {
        top_s = sv;
        top_i = iv;
      } else if (lane > pos && lane < k) {
        top_s = up_s;
        top_i = up_i;
      }
      thr = __shfl_sync(FULL, top_s, k - 1);
    }
  }
}

// Merge a (QG, NT) score tile into this warp's 4 lists (queries warp*4 + j).
__device__ __forceinline__ void merge_tile(const float (&Ss)[QG][NT], int q_base, int B,
                                           int n0, int k, float (&top_s)[4],
                                           int (&top_i)[4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int bl = warp * 4 + j;
    if (q_base + bl >= B) continue;  // warp-uniform
    merge_row(Ss[bl], n0, k, lane, top_s[j], top_i[j]);
  }
}

// Write this CTA's lists to its slot of the (B, gridDim.x * k) candidates.
__device__ __forceinline__ void store_candidates(const float (&top_s)[4], const int (&top_i)[4],
                                                 int q_base, int B, int k,
                                                 float* __restrict__ cand_s,
                                                 int* __restrict__ cand_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = q_base + warp * 4 + j;
    if (b < B && lane < k) {
      const int64_t o = ((int64_t)b * gridDim.x + blockIdx.x) * k + lane;
      cand_s[o] = top_s[j];
      cand_i[o] = top_i[j];
    }
  }
}

// One CTA per query: k rounds, each taking the best candidate that ranks
// after the previous pick.
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
                  int C, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ float red_s[MERGE_THREADS / 32];
  __shared__ int red_i[MERGE_THREADS / 32];
  __shared__ float prev_s;
  __shared__ int prev_i;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* cs = cand_s + (int64_t)b * C;
  const int* ci = cand_i + (int64_t)b * C;
  if (tid == 0) {
    prev_s = INFINITY;
    prev_i = -1;
  }
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    const float ps = prev_s;
    const int pi = prev_i;
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int c = tid; c < C; c += MERGE_THREADS) {
      const float s = cs[c];
      const int i = ci[c];
      if (ranks_before(ps, pi, s, i) && ranks_before(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(FULL, bs, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      if (ranks_before(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < MERGE_THREADS / 32; ++w) {
        if (ranks_before(red_s[w], red_i[w], bs, bi)) {
          bs = red_s[w];
          bi = red_i[w];
        }
      }
      out_s[(int64_t)b * k + r] = bs;
      out_i[(int64_t)b * k + r] = bi;
      prev_s = bs;
      prev_i = bi;
    }
    __syncthreads();
  }
}

// Launch the candidate merge after a partial kernel; returns a cudaError_t.
inline int launch_topk_merge(const void* cand_s, const void* cand_i, int B, int C, int k,
                             void* out_s, void* out_i, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();  // the partial kernel's launch
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<B, MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(cand_s), static_cast<const int*>(cand_i), C, k,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace
