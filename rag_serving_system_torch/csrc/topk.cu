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
// FP32 issue rate (16 FLOP per corpus byte against the card's 20). The
// first tile loaded each chunk, then computed, with no copy in flight: 2.57
// ms at N = 1,048,576, D = 1024, B = 32, k = 16 on an NVIDIA H100 80GB HBM3
// at a 700 W limit. The tile of topk_common.cuh keeps two chunks in flight
// under the FMAs: 1.84-1.89 ms on the same shapes and card, of which 1.71
// ms is the tile (P2) and the rest the selection, which stalls the FMAs of
// the whole CTA once a tile. Lists of 8 registers a lane (k = 256) took
// 4.15 ms: from k = 64 on the scores and select.cu beat the lists (PERF.md,
// the crossover), so the lists hold k <= 32.
//
// Design: blocks run in parallel on the SMs, so the corpus is split across
// CTAs instead of walked in order: one CTA per SM (the ring and the score
// tile take 207-215 KB of shared memory), each streaming a contiguous span
// of 512-row tiles through the float score tile of topk_common.cuh (32
// queries x 512 rows). Each tile's scores go to shared memory and are
// merged into the warps' running lists (k <= 32); a tree of merge kernels
// reduces the (B, n_ctas, k) candidates to (B, k). Selection, tie order
// and the merge are shared with kernel B4 (topk_int8.cu). Beyond the
// wrapper's LIST_K, rag_score_rows writes the tile's scores instead and
// select.cu ranks them (1.9-2.0 ms at k = 1024 on the shapes above).

#include "topk_common.cuh"

namespace {

// score tile rows: one float of pad, so the 4 query groups of a warp
// store to 4 different bank groups
constexpr int SS_LD = FT_ROWS + 1;

template <typename T>
constexpr int partial_smem_bytes() {
  return FloatTile<T>::RING_BYTES + QG * SS_LD * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
topk_partial_kernel(const float* __restrict__ q, const T* __restrict__ corpus,
                    int B, int N, int D, int k, int tiles_per_cta,
                    float* __restrict__ cand_s, int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float(*Ss)[SS_LD] = reinterpret_cast<float(*)[SS_LD]>(smem + FloatTile<T>::RING_BYTES);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q_base = blockIdx.y * QG;
  const int n_tiles = (N + FT_ROWS - 1) / FT_ROWS;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);

  WarpLists lists;
  float_scan<T, false>(q, corpus, B, N, D, q_base, tile_lo, tile_hi, smem,
                       [&](const float(&acc)[8][8], int n0) {
                         __syncthreads();  // every warp is done merging the last tile
#pragma unroll
                         for (int j = 0; j < 8; ++j) {
                           const int col = warp * 8 + (lane & 7) + 64 * j;
                           const bool valid = n0 + col < N;
#pragma unroll
                           for (int i = 0; i < 8; ++i)
                             Ss[(lane >> 3) * 8 + i][col] = valid ? acc[j][i] : -INFINITY;
                         }
                         __syncthreads();
                         merge_tile<FT_ROWS, SS_LD>(Ss, q_base, B, n0, k, lists);
                       });
  lists.finish(q_base, B, k, cand_s, cand_i);
}

template <typename T>
int launch_partial(const float* q, const T* corpus, int B, int N, int D, int k,
                   int tiles_per_cta, int n_ctas, float* cand_s, int* cand_i,
                   cudaStream_t st) {
  constexpr int smem = partial_smem_bytes<T>();
  const cudaError_t attr = allow_smem(topk_partial_kernel<T>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(n_ctas, (B + QG - 1) / QG);
  topk_partial_kernel<T><<<grid, THREADS, smem, st>>>(q, corpus, B, N, D, k, tiles_per_cta,
                                                      cand_s, cand_i);
  return (int)cudaSuccess;
}

// The scores alone, for k beyond the warp lists (select.cu ranks them): the
// float tile of topk_partial_kernel with a store epilogue, so each score is
// bit-identical to the one B1 ranks. out: (B, N), row stride N.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
score_rows_kernel(const float* __restrict__ q, const T* __restrict__ corpus, int B, int N,
                  int D, int tiles_per_cta, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q_base = blockIdx.y * QG;
  const int n_tiles = (N + FT_ROWS - 1) / FT_ROWS;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  float_scan<T, false>(q, corpus, B, N, D, q_base, tile_lo, tile_hi, smem,
                       [&](const float(&acc)[8][8], int n0) {
#pragma unroll
                         for (int j = 0; j < 8; ++j) {
                           const int n = n0 + warp * 8 + (lane & 7) + 64 * j;
#pragma unroll
                           for (int i = 0; i < 8; ++i) {
                             const int b = q_base + (lane >> 3) * 8 + i;
                             if (n < N && b < B) out[(int64_t)b * N + n] = acc[j][i];
                           }
                         }
                       });
}

template <typename T>
int launch_scores(const float* q, const T* corpus, int B, int N, int D, int tiles_per_cta,
                  int n_ctas, float* out, cudaStream_t st) {
  constexpr int smem = FloatTile<T>::RING_BYTES;
  const cudaError_t attr = allow_smem(score_rows_kernel<T>, smem);
  if (attr != cudaSuccess) return (int)attr;
  score_rows_kernel<T><<<dim3(n_ctas, (B + QG - 1) / QG), THREADS, smem, st>>>(
      q, corpus, B, N, D, tiles_per_cta, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The (B, N) f32 scores of q against corpus, as rag_cosine_topk computes
// them (same arguments; n_ctas = ceil(ceil(N / 512) / tiles_per_cta)).
extern "C" int rag_score_rows(const void* q, const void* corpus, int corpus_is_bf16, int B,
                              int N, int D, int tiles_per_cta, int n_ctas, void* out,
                              void* stream) {
  const int itemsize = corpus_is_bf16 ? 2 : 4;
  if (B < 1 || N < 1 || D < 1 || (D * itemsize) % 16 != 0 || tiles_per_cta < 1 || n_ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  return corpus_is_bf16
             ? launch_scores(qf, static_cast<const __nv_bfloat16*>(corpus), B, N, D,
                             tiles_per_cta, n_ctas, o, st)
             : launch_scores(qf, static_cast<const float*>(corpus), B, N, D, tiles_per_cta,
                             n_ctas, o, st);
}

// q: (B, D) f32 normalized queries; corpus: (N, D) f32 or bf16, with
// D * itemsize % 16 == 0, both 16-byte aligned. 1 <= k <= min(32, N).
// cand_s / cand_i: (B, n_ctas * k) scratch, with
// n_ctas = ceil(ceil(N / 512) / tiles_per_cta); tmp_s / tmp_i:
// (B, ceil(n_ctas / 8) * k) scratch. out_s / out_i: (B, k).
extern "C" int rag_cosine_topk(const void* q, const void* corpus, int corpus_is_bf16,
                               int B, int N, int D, int k, int tiles_per_cta, int n_ctas,
                               void* cand_s, void* cand_i, void* tmp_s, void* tmp_i,
                               void* out_s, void* out_i, void* stream) {
  const int itemsize = corpus_is_bf16 ? 2 : 4;
  if (k < 1 || k > LIST_MAX || k > N || B < 1 || D < 1 || (D * itemsize) % 16 != 0 ||
      tiles_per_cta < 1 || n_ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  float* cs = static_cast<float*>(cand_s);
  int* ci = static_cast<int*>(cand_i);
  const int err =
      corpus_is_bf16
          ? launch_partial(qf, static_cast<const __nv_bfloat16*>(corpus), B, N, D, k,
                           tiles_per_cta, n_ctas, cs, ci, st)
          : launch_partial(qf, static_cast<const float*>(corpus), B, N, D, k, tiles_per_cta,
                           n_ctas, cs, ci, st);
  if (err != cudaSuccess) return err;
  return launch_topk_merge(cand_s, cand_i, B, n_ctas, k, tmp_s, tmp_i, out_s, out_i, st);
}
