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
// 128-row tiles: the register-tiled FP32 score tile of topk_common.cuh
// (32 queries x 128 rows) goes to shared memory, where it stays, and is
// merged into the warps' running lists; a second kernel reduces the
// (B, n_ctas * k) candidates to (B, k). Selection, tie order and the merge
// are shared with kernel B4 (topk_int8.cu).

#include "topk_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_partial_kernel(const float* __restrict__ q, const T* __restrict__ corpus,
                    int B, int N, int D, int k, int tiles_per_cta,
                    float* __restrict__ cand_s, int* __restrict__ cand_i) {
  __shared__ FloatTileSmem sm;
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
    float acc[4][4];
    float_tile<T, false>(q, corpus, B, N, D, q_base, n0, sm, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = tx + 32 * r;
        Ss[ty * 4 + i][col] = (n0 + col < N) ? acc[i][r] : -INFINITY;
      }
    __syncthreads();
    merge_tile(Ss, q_base, B, n0, k, top_s, top_i);
    // the next tile rewrites Ss only after the __syncthreads of its first chunk
  }
  store_candidates(top_s, top_i, q_base, B, k, cand_s, cand_i);
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
  return launch_topk_merge(cand_s, cand_i, B, n_ctas * k, k, out_s, out_i, st);
}
