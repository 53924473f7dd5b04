// Exact cosine top-k of normalized queries against a pre-normalized corpus
// (kernel B1).
//
// Replaces: rag_serving_system_tpu/ops/topk.py:_topk_kernel (wrapper
// cosine_topk_pallas). The TPU kernel walks the corpus in a sequential grid
// and carries one running (B, k) list in VMEM scratch from block to block.
//
// What bounds it here: one read of the corpus (N * D * 4 bytes in f32) and
// 2 * B * N * D flops. The oracle is an IEEE f32 product (Precision.HIGHEST),
// so the f32 path uses FP32 FMAs, not TF32 tensor cores, and at the serving
// batch (B = 32) the kernel sits near the balance point of HBM bandwidth and
// FP32 issue rate. Measured on an H100 80GB HBM3 at a 700 W limit: 2.42 ms
// at N = 1M, D = 1024, B = 32, k = 16 (1.69 TB/s of corpus, 27 TFLOP/s):
// no copy is in flight while a tile's FMAs run, which caps both.
//
// Design: blocks run in parallel on the SMs, so the corpus is split across
// CTAs instead of walked in order. Each CTA streams a contiguous span of
// 128-row tiles: a register-tiled FP32 GEMM (32 queries x 128 rows per tile,
// 4x4 outputs per thread, D in 32-wide shared-memory chunks) writes the score
// tile to shared memory, where it stays; one warp per 4 queries then merges
// the tile into that query's running top-k, which lives in the registers of
// lanes 0..k-1. A ballot against the current k-th score skips the merge for
// almost every tile once the list has filled, as the TPU kernel's block skip
// does. A second kernel reduces the (B, n_ctas * k) candidates to (B, k).
//
// Ties: equal scores resolve to the lowest corpus index in both passes, as
// lax.top_k does. Rows reach a CTA's list in increasing index order, so a
// new candidate goes after every held entry with an equal or larger score;
// the merge orders by (score desc, index asc).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QG = 32;            // queries per CTA (grid.y covers B)
constexpr int NT = 128;            // corpus rows per tile
constexpr int KC = 32;             // depth of one shared-memory chunk
constexpr int THREADS = 256;       // 8 warps
constexpr int CS_STRIDE = KC + 1;  // conflict-free column reads of the tile
constexpr int QS_STRIDE = QG + 4;  // keeps the float4 broadcast read aligned
constexpr int MERGE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

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

// (s1, i1) ranks before (s2, i2): higher score, then lower index.
__device__ __forceinline__ bool ranks_before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_partial_kernel(const float* __restrict__ q, const T* __restrict__ corpus,
                    int B, int N, int D, int k, int tiles_per_cta,
                    float* __restrict__ cand_s, int* __restrict__ cand_i) {
  __shared__ __align__(16) float Qs[KC][QS_STRIDE];
  __shared__ float Cs[NT][CS_STRIDE];
  __shared__ float Ss[QG][NT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = lane;       // GEMM: rows tx + 32 * r
  const int ty = warp;       // GEMM: queries ty * 4 + i; select: same queries
  const int q_base = blockIdx.y * QG;
  const int n_tiles = (N + NT - 1) / NT;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);

  // running top-k of this warp's 4 queries: entry `lane` (lane < k)
  float top_s[4];
  int top_i[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    top_s[j] = -INFINITY;
    top_i[j] = INT_MAX;
  }

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int n0 = tile * NT;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;

    for (int d0 = 0; d0 < D; d0 += KC) {
      // corpus chunk: 128 rows x 32 depth, one float4 per thread per pass
#pragma unroll
      for (int it = 0; it < (NT * KC / 4) / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        const int row = idx >> 3;
        const int d4 = (idx & 7) * 4;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        const int n = n0 + row;
        if (n < N && d0 + d4 < D) load4(corpus + (int64_t)n * D + d0 + d4, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) Cs[row][d4 + e] = v[e];
      }
      // query chunk: 32 queries x 32 depth, stored depth-major
      {
        const int b = tid >> 3;
        const int d4 = (tid & 7) * 4;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (q_base + b < B && d0 + d4 < D) load4(q + (int64_t)(q_base + b) * D + d0 + d4, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) Qs[d4 + e][b] = v[e];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[kk][ty * 4]);
        const float qf[4] = {qv.x, qv.y, qv.z, qv.w};
        float cf[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cf[r] = Cs[tx + 32 * r][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][r] = fmaf(qf[i], cf[r], acc[i][r]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = tx + 32 * r;
        Ss[ty * 4 + i][col] = (n0 + col < N) ? acc[i][r] : -INFINITY;
      }
    __syncthreads();

    // merge the tile into each of this warp's 4 running lists
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bl = ty * 4 + j;
      if (q_base + bl >= B) continue;  // warp-uniform
      float thr = __shfl_sync(FULL, top_s[j], k - 1);
      for (int c = 0; c < NT / 32; ++c) {
        const float s = Ss[bl][c * 32 + lane];
        unsigned cand = __ballot_sync(FULL, s > thr);
        while (cand) {  // lowest lane first = increasing corpus index
          const int src = __ffs(cand) - 1;
          cand &= cand - 1;
          const float sv = __shfl_sync(FULL, s, src);
          if (!(sv > thr)) continue;  // warp-uniform
          const int iv = n0 + c * 32 + src;
          // insert after every held entry scoring >= sv (those hold lower indices)
          const int pos = __popc(__ballot_sync(FULL, lane < k && top_s[j] >= sv));
          const float up_s = __shfl_up_sync(FULL, top_s[j], 1);
          const int up_i = __shfl_up_sync(FULL, top_i[j], 1);
          if (lane == pos) {
            top_s[j] = sv;
            top_i[j] = iv;
          } else if (lane > pos && lane < k) {
            top_s[j] = up_s;
            top_i[j] = up_i;
          }
          thr = __shfl_sync(FULL, top_s[j], k - 1);
        }
      }
    }
    // the next tile rewrites Ss only after the __syncthreads of its first chunk
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = q_base + ty * 4 + j;
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

}  // namespace

// q: (B, D) f32 normalized queries; corpus: (N, D) f32 or bf16; D % 4 == 0,
// both 16-byte aligned. cand_s / cand_i: (B, n_ctas * k) scratch, with
// n_ctas = ceil(ceil(N / 128) / tiles_per_cta). out_s / out_i: (B, k).
extern "C" int rag_cosine_topk(const void* q, const void* corpus, int corpus_is_bf16,
                               int B, int N, int D, int k, int tiles_per_cta, int n_ctas,
                               void* cand_s, void* cand_i, void* out_s, void* out_i,
                               void* stream) {
  if (k < 1 || k > 32 || B < 1 || N < 1 || D % 4 != 0 || tiles_per_cta < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(n_ctas, (B + QG - 1) / QG);
  if (corpus_is_bf16) {
    topk_partial_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(corpus), B, N, D, k,
        tiles_per_cta, static_cast<float*>(cand_s), static_cast<int*>(cand_i));
  } else {
    topk_partial_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(corpus), B, N, D, k,
        tiles_per_cta, static_cast<float*>(cand_s), static_cast<int*>(cand_i));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<B, MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(cand_s), static_cast<const int*>(cand_i), n_ctas * k, k,
      static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
