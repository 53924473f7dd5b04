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
// applied outside, by the wrapper. |q|, |c| <= 127 and D <= 4096 give
// |acc| <= D * 127^2 < 2^31, exact in int32 in any summation order, and each
// score is one correctly rounded conversion and one correctly rounded
// product: the kernel and its plain version agree bit for bit.
//
// What bounds it: bytes. One read of N * D + 4 * N bytes (1.08 GB at
// 1M x 1024, 0.32 ms at 3.35 TB/s) against B * N * D int8 multiply-adds,
// 0.035 ms on the s8 tensor cores at B = 32. The first version ran the
// products as __dp4a through registers, loaded each chunk before computing
// it and reloaded the query chunk for every tile: 0.933 ms at 1M x 1024,
// B = 32, k = 16, 35% of the byte bound. On the same shapes and an NVIDIA
// H100 80GB HBM3 at 700 W (nvidia-smi), this version takes 0.46-0.49 ms
// over four runs (the kernel itself 0.39 ms of device time, the rest the
// wrapper's query quantization and the merge tree), and 3.7-3.8 ms over
// 10M rows in 3 chunks (was 7.89). ptxas: 72 registers a thread, no
// spills, 2 CTAs an SM at D = 1024 (PERF.md).
//
// Design: contiguous spans of 128-row tiles, one wave of CTAs sized from the
// occupancy of the instantiation that runs (rag_int8_tile_info: 2 CTAs an
// SM at D = 1024), each CTA scoring through the int8 tile of
// topk_common.cuh (s8 mma.sync, the query block resident in shared memory,
// the corpus through a 4-stage cp.async ring); the per-row scale is applied
// as the C fragment lands in the padded score tile, and the shared
// warp-list selection (one list register a lane, k <= 32) and candidate
// merge rank it. Beyond the wrapper's LIST_K, rag_score_rows_int8 writes
// the scaled scores instead and select.cu ranks them.

#include "topk_common.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 2)
topk_int8_partial_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ corpus,
                         const float* __restrict__ scales, int B, int N, int D, int k,
                         int tiles_per_cta, float* __restrict__ cand_s,
                         int* __restrict__ cand_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float(*Ss)[SS_LD8] = reinterpret_cast<float(*)[SS_LD8]>(smem + int8_ss_offset(D));
  const int q_base = blockIdx.y * QG;
  const int n_tiles = (N + NT - 1) / NT;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);

  WarpLists lists;
  int8_scan(q, corpus, scales, B, N, D, q_base, tile_lo, tile_hi, smem,
            [&](const int(&acc)[4][4], const float(&sc)[2], int n0) {
              __syncthreads();  // every warp is done merging the last tile
#pragma unroll
              for (int nb = 0; nb < 4; ++nb)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int row = int8_row(i);
                  Ss[int8_query(nb, i)][row] =
                      n0 + row < N ? __int2float_rn(acc[nb][i]) * sc[i >> 1] : -INFINITY;
                }
              __syncthreads();
              merge_tile<NT, SS_LD8>(Ss, q_base, B, n0, k, lists);
            });
  lists.finish(q_base, B, k, cand_s, cand_i);
}

// The scores alone, for k beyond the warp lists (select.cu ranks them): the
// int8 tile with the row scale applied as in topk_int8_partial_kernel, so
// each score is bit-identical to the one B4 ranks. out: (B, N), row stride N.
__global__ void __launch_bounds__(THREADS, 2)
score_rows_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ corpus,
                       const float* __restrict__ scales, int B, int N, int D,
                       int tiles_per_cta, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q_base = blockIdx.y * QG;
  const int n_tiles = (N + NT - 1) / NT;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  int8_scan(q, corpus, scales, B, N, D, q_base, tile_lo, tile_hi, smem,
            [&](const int(&acc)[4][4], const float(&sc)[2], int n0) {
#pragma unroll
              for (int nb = 0; nb < 4; ++nb)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int n = n0 + int8_row(i);
                  const int b = q_base + int8_query(nb, i);
                  if (n < N && b < B)
                    out[(int64_t)b * N + n] = __int2float_rn(acc[nb][i]) * sc[i >> 1];
                }
            });
}

}  // namespace

// CTAs an SM, registers and stack bytes a thread, and dynamic shared bytes
// (out[0..3]) of an int8 kernel at depth D: kind 0 is the top-k kernel, 1
// the score kernel.
extern "C" int rag_int8_tile_info(int kind, int D, void* out) {
  if (D < 16 || D % 16 != 0 || D > I8_MAX_D || kind < 0 || kind > 1) {
    return (int)cudaErrorInvalidValue;
  }
  return kind == 0
             ? int8_kernel_info(topk_int8_partial_kernel, int8_smem_bytes(D, true),
                                static_cast<int*>(out))
             : int8_kernel_info(score_rows_int8_kernel, int8_smem_bytes(D, false),
                                static_cast<int*>(out));
}

// The (B, N) f32 scores (before the query scale) of q against the int8
// corpus, as rag_cosine_topk_int8 computes them (same arguments;
// n_ctas = ceil(ceil(N / 128) / tiles_per_cta)).
extern "C" int rag_score_rows_int8(const void* q, const void* corpus, const void* scales,
                                   int B, int N, int D, int tiles_per_cta, int n_ctas,
                                   void* out, void* stream) {
  if (B < 1 || N < 1 || D < 16 || D % 16 != 0 || D > I8_MAX_D || tiles_per_cta < 1 ||
      n_ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = int8_smem_bytes(D, false);
  const cudaError_t attr = allow_smem(score_rows_int8_kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  score_rows_int8_kernel<<<dim3(n_ctas, (B + QG - 1) / QG), THREADS, smem,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus),
      static_cast<const float*>(scales), B, N, D, tiles_per_cta, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// q: (B, D) int8 quantized queries; corpus: (N, D) int8; scales: (N,) f32;
// D % 16 == 0, 16 <= D <= 4096, q and corpus 16-byte aligned;
// 1 <= k <= min(32, N). cand_s / cand_i: (B, n_ctas * k) scratch,
// n_ctas = ceil(ceil(N / 128) / tiles_per_cta); tmp_s / tmp_i:
// (B, ceil(n_ctas / 8) * k) scratch.
// out_s / out_i: (B, k) scores (before the query scale) and indices.
extern "C" int rag_cosine_topk_int8(const void* q, const void* corpus, const void* scales,
                                    int B, int N, int D, int k, int tiles_per_cta,
                                    int n_ctas, void* cand_s, void* cand_i, void* tmp_s,
                                    void* tmp_i, void* out_s, void* out_i, void* stream) {
  if (k < 1 || k > LIST_MAX || k > N || B < 1 || D < 16 || D % 16 != 0 || D > I8_MAX_D ||
      tiles_per_cta < 1 || n_ctas < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int smem = int8_smem_bytes(D, true);
  const cudaError_t attr = allow_smem(topk_int8_partial_kernel, smem);
  if (attr != cudaSuccess) return (int)attr;
  topk_int8_partial_kernel<<<dim3(n_ctas, (B + QG - 1) / QG), THREADS, smem, st>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus),
      static_cast<const float*>(scales), B, N, D, k, tiles_per_cta, static_cast<float*>(cand_s),
      static_cast<int*>(cand_i));
  return launch_topk_merge(cand_s, cand_i, B, n_ctas, k, tmp_s, tmp_i, out_s, out_i, st);
}
