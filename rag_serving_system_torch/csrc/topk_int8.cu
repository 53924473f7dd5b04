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
// Design: B1's (topk.cu): contiguous spans of 128-row tiles across ~4 CTAs
// per SM, the int8 score tile of topk_common.cuh (16-byte loads, int32 dp4a
// accumulators), the per-row scale applied as the tile lands in shared
// memory, and the shared warp-list selection and candidate merge.

#include "topk_common.cuh"

namespace {

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

  float top_s[4];
  int top_i[4];
  init_lists(top_s, top_i);

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
    merge_tile(Ss, q_base, B, n0, k, top_s, top_i);
  }
  store_candidates(top_s, top_i, q_base, B, k, cand_s, cand_i);
}

}  // namespace

// q: (B, D) int8 quantized queries; corpus: (N, D) int8; scales: (N,) f32;
// D % 16 == 0, q and corpus 16-byte aligned. cand_s / cand_i:
// (B, n_ctas * k) scratch, n_ctas = ceil(ceil(N / 128) / tiles_per_cta).
// out_s / out_i: (B, k) scores (before the query scale) and indices.
extern "C" int rag_cosine_topk_int8(const void* q, const void* corpus, const void* scales,
                                    int B, int N, int D, int k, int tiles_per_cta,
                                    int n_ctas, void* cand_s, void* cand_i, void* out_s,
                                    void* out_i, void* stream) {
  if (k < 1 || k > 32 || k > N || B < 1 || D % 16 != 0 || tiles_per_cta < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(n_ctas, (B + QG - 1) / QG);
  topk_int8_partial_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus),
      static_cast<const float*>(scales), B, N, D, k, tiles_per_cta,
      static_cast<float*>(cand_s), static_cast<int*>(cand_i));
  return launch_topk_merge(cand_s, cand_i, B, n_ctas * k, k, out_s, out_i, st);
}
