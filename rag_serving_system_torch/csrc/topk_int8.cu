// Exact top-k over an int8, mean-centred corpus with per-row scales
// (kernel B4).
//
// Replaces: rag_serving_system_tpu/ops/topk.py:_topk_kernel_int8 (wrapper
// cosine_topk_pallas_int8, chunk loop cosine_topk_int8_chunked). It serves
// RETRIEVAL_CORPUS_DTYPE=int8: a quarter of f32's corpus bytes, so a
// 10M x 1024 corpus (10.2 GB) fits on one card.
//
// What it computes: score[b, n] = float(int32 dot(q_i8[b], c_i8[n])) * scale[n],
// then the running top-k of B1. The query scale and the q . mean term are
// applied outside, by the wrapper. |q|, |c| <= 127 and D = 1024 give
// |acc| <= 1024 * 127^2 < 2^24, so the int32 -> f32 conversion is exact and
// each score is one correctly rounded product: the kernel and its plain
// version agree bit for bit (at any D the int32 is exact, and both round it
// to f32 to nearest even).
//
// What bounds it here: one read of N * D + 4 * N bytes (1.052 GB at
// 1M x 1024, 0.31 ms at 3.35 TB/s) against B * N * D int8 multiply-adds on
// the integer pipe (__dp4a does 4 per instruction; about 0.5 ms of issue at
// B = 32, estimated before measuring). int8 tensor-core MMA (mma.sync or
// wgmma s8) would lift the second bound and is later work.
//
// Design: B1's first one (topk.cu): contiguous spans of 128-row tiles
// across ~4 CTAs per SM, the int8 score tile of topk_common.cuh (16-byte
// loads, int32 dp4a accumulators), the per-row scale applied as the tile
// lands in shared memory, and the shared warp-list selection (k <= 256, KR
// list registers a lane) and candidate merge. For k > 256,
// rag_score_rows_int8 writes the scaled scores instead and select.cu ranks
// them.

#include "topk_common.cuh"

namespace {

template <int KR>
__global__ void __launch_bounds__(THREADS)
topk_int8_partial_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ corpus,
                         const float* __restrict__ scales, int B, int N, int D, int k,
                         int tiles_per_cta, float* __restrict__ cand_s,
                         int* __restrict__ cand_i) {
  __shared__ Int8TileSmem sm;
  __shared__ float Ss[QG][NT];

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int q_base = blockIdx.y * QG;
  const int n_tiles = (N + NT - 1) / NT;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);

  WarpLists<KR> lists;
  lists.init(q_base, B, k, cand_s, cand_i);

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int n0 = tile * NT;
    int acc[4][4];
    int8_tile(q, corpus, B, N, D, q_base, n0, sm, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int col = tx + 32 * r;
      const bool valid = n0 + col < N;
      const float sc = valid ? scales[n0 + col] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ss[ty * 4 + i][col] = valid ? __int2float_rn(acc[i][r]) * sc : -INFINITY;
    }
    __syncthreads();
    merge_tile<KR, NT>(Ss, q_base, B, n0, k, lists, cand_s, cand_i);
  }
  lists.finish(q_base, B, k, cand_s, cand_i);
}

template <int KR>
void launch_partial(const int8_t* q, const int8_t* corpus, const float* scales, int B, int N,
                    int D, int k, int tiles_per_cta, int n_ctas, float* cand_s, int* cand_i,
                    cudaStream_t st) {
  const dim3 grid(n_ctas, (B + QG - 1) / QG);
  topk_int8_partial_kernel<KR><<<grid, THREADS, 0, st>>>(q, corpus, scales, B, N, D, k,
                                                         tiles_per_cta, cand_s, cand_i);
}

// The scores alone, for k beyond the warp lists (select.cu ranks them): the
// int8 tile with the row scale applied as in topk_int8_partial_kernel, so
// each score is bit-identical to the one B4 ranks. out: (B, N), row stride N.
__global__ void __launch_bounds__(THREADS)
score_rows_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ corpus,
                       const float* __restrict__ scales, int B, int N, int D,
                       int tiles_per_cta, float* __restrict__ out) {
  __shared__ Int8TileSmem sm;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int q_base = blockIdx.y * QG;
  const int n_tiles = (N + NT - 1) / NT;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int n0 = tile * NT;
    int acc[4][4];
    int8_tile(q, corpus, B, N, D, q_base, n0, sm, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + tx + 32 * r;
      if (n >= N) continue;
      const float sc = scales[n];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = q_base + ty * 4 + i;
        if (b < B) out[(int64_t)b * N + n] = __int2float_rn(acc[i][r]) * sc;
      }
    }
  }
}

}  // namespace

// The (B, N) f32 scores (before the query scale) of q against the int8
// corpus, as rag_cosine_topk_int8 computes them (same arguments;
// n_ctas = ceil(ceil(N / 128) / tiles_per_cta)).
extern "C" int rag_score_rows_int8(const void* q, const void* corpus, const void* scales,
                                   int B, int N, int D, int tiles_per_cta, int n_ctas,
                                   void* out, void* stream) {
  if (B < 1 || N < 1 || D % 16 != 0 || tiles_per_cta < 1 || n_ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  score_rows_int8_kernel<<<dim3(n_ctas, (B + QG - 1) / QG), THREADS, 0,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus),
      static_cast<const float*>(scales), B, N, D, tiles_per_cta, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// q: (B, D) int8 quantized queries; corpus: (N, D) int8; scales: (N,) f32;
// D % 16 == 0, q and corpus 16-byte aligned; 1 <= k <= min(256, N). cand_s / cand_i:
// (B, n_ctas * k) scratch, n_ctas = ceil(ceil(N / 128) / tiles_per_cta);
// tmp_s / tmp_i: (B, ceil(n_ctas / 8) * k) scratch.
// out_s / out_i: (B, k) scores (before the query scale) and indices.
extern "C" int rag_cosine_topk_int8(const void* q, const void* corpus, const void* scales,
                                    int B, int N, int D, int k, int tiles_per_cta,
                                    int n_ctas, void* cand_s, void* cand_i, void* tmp_s,
                                    void* tmp_i, void* out_s, void* out_i, void* stream) {
  if (k < 1 || k > 32 * MAX_KR || k > N || B < 1 || D % 16 != 0 || tiles_per_cta < 1 ||
      n_ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const int8_t* c = static_cast<const int8_t*>(corpus);
  const float* sc = static_cast<const float*>(scales);
  float* cs = static_cast<float*>(cand_s);
  int* ci = static_cast<int*>(cand_i);
  switch (list_regs(k)) {
    case 1:
      launch_partial<1>(qi, c, sc, B, N, D, k, tiles_per_cta, n_ctas, cs, ci, st);
      break;
    case 2:
      launch_partial<2>(qi, c, sc, B, N, D, k, tiles_per_cta, n_ctas, cs, ci, st);
      break;
    case 4:
      launch_partial<4>(qi, c, sc, B, N, D, k, tiles_per_cta, n_ctas, cs, ci, st);
      break;
    default:
      launch_partial<8>(qi, c, sc, B, N, D, k, tiles_per_cta, n_ctas, cs, ci, st);
  }
  return launch_topk_merge(cand_s, cand_i, B, n_ctas, k, tmp_s, tmp_i, out_s, out_i, st);
}
