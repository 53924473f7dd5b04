// Retrieval roofline probes: the two halves of the top-k kernels' work,
// each run alone (kernels P1 and P2).
//
// Replaces: scripts/profile_topk.py:_stream_kernel (P1) and _dot_kernel
// (P2), which split the TPU top-k kernel's time into a DMA-only part and a
// matmul-only part over the same blocks.
//
// P1, stream: out[d] = sum over whole blocks of block_n rows of the max over
// the block's rows of c[n, d]; the tail N % block_n rows are dropped. Bound
// by one read of the corpus and nothing else: its time is the streaming
// floor of B1 (f32, bf16) and B4 (int8). Each CTA takes the column max of
// one block with 16-byte loads; a second pass sums the (n_blocks, D)
// partials in block order. No atomics, so it is deterministic.
//
// P2, dot: out[b, l] = sum over n < n_rows with n mod 128 == l of
// q[b] . c[n]. This is B1's (and B4's) score tile from topk_common.cuh
// without the selection, on its kernel's grid (one CTA per SM, 512-row
// tiles for f32 and bf16; for int8, 128-row tiles and as many CTAs an SM as
// the occupancy calculator counts): IEEE f32 FMAs for f32, bf16 widened to
// f32, int8 on s8 tensor cores into int32 (converted to f32 before the
// fold). With round_bf16 an f32 corpus is rounded to bf16 as it leaves
// the ring (the wrapper rounds q): the TPU's one-pass Precision.DEFAULT.
// Each CTA folds its tiles' columns into lanes in registers and writes a
// (B, 128) partial; a second pass sums the CTAs' partials in CTA order.
// What bounds the float tile: its FP32 FMA issue. At 1M x 1024, B = 32 on
// an NVIDIA H100 80GB HBM3 at 700 W, P2 f32 takes 1.71 ms against 1.40 ms
// for P1 (the HBM stream) and 1.52 ms for the tile's FMAs alone, and cuBLAS's
// FP32 GEMM plus the fold takes 2.29 ms; details in topk_common.cuh and
// PERF.md.

#include "topk_common.cuh"

namespace {

constexpr int STREAM_THREADS = 256;
constexpr int SUM_THREADS = 256;
constexpr int LANES = 128;  // P2 folds row n into output lane n % 128

enum Dtype { F32 = 0, BF16 = 1, INT8 = 2 };

__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    o[2 * e] = f.x;
    o[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const int8_t* p, float (&o)[16]) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 16; ++e) o[e] = (float)(int8_t)(w[e / 4] >> (8 * (e % 4)));
}

// Thread t of a CTA reads 16-byte column vector t % cols of the rows
// t / cols, t / cols + rpp, ...: a row narrower than the CTA still keeps
// every thread loading. The rpp partial maxima meet in shared memory.
template <typename T>
__global__ void __launch_bounds__(STREAM_THREADS)
stream_partial_kernel(const T* __restrict__ c, int D, int block_n,
                      float* __restrict__ partial) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[STREAM_THREADS][VEC];
  const int vcols = D / VEC;                  // 16-byte vectors in a row
  const int cols = min(vcols, STREAM_THREADS);
  const int rpp = STREAM_THREADS / cols;      // rows per pass
  const int r0 = threadIdx.x / cols;
  const int v = blockIdx.y * cols + threadIdx.x % cols;
  float m[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) m[e] = -INFINITY;
  if (r0 < rpp && v < vcols) {
    const T* p = c + (int64_t)blockIdx.x * block_n * D + (int64_t)v * VEC;
#pragma unroll 8
    for (int r = r0; r < block_n; r += rpp) {
      float x[VEC];
      load16(p + (int64_t)r * D, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) m[e] = fmaxf(m[e], x[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) red[threadIdx.x][e] = m[e];
  __syncthreads();
  if (r0 != 0 || v >= vcols) return;
  for (int j = 1; j < rpp; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) m[e] = fmaxf(m[e], red[threadIdx.x + j * cols][e]);
  float* o = partial + (int64_t)blockIdx.x * D + (int64_t)v * VEC;
#pragma unroll
  for (int e = 0; e < VEC; ++e) o[e] = m[e];
}

// out[c] = sum over r of partial[r, c], in increasing r.
__global__ void __launch_bounds__(SUM_THREADS)
sum_rows_kernel(const float* __restrict__ partial, int rows, int cols,
                float* __restrict__ out) {
  const int c = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partial[(int64_t)r * cols + c];
  out[c] = s;
}

// The float tile's fold: fold[h][i] holds lane warp * 8 + (lane & 7) +
// 64 * h of query q_base + (lane >> 3) * 8 + i (rows j = h, h + 2, ... of
// each tile, as n mod 128 repeats every 128 rows).
template <typename T, bool ROUND_BF16>
__global__ void __launch_bounds__(THREADS, 1)
dot_probe_kernel(const float* __restrict__ q, const T* __restrict__ corpus, int B, int N,
                 int D, int tiles_per_cta, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q_base = blockIdx.y * QG;
  const int n_tiles = (N + FT_ROWS - 1) / FT_ROWS;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  float fold[2][8] = {};
  float_scan<T, ROUND_BF16>(q, corpus, B, N, D, q_base, tile_lo, tile_hi, smem,
                            [&](const float(&acc)[8][8], int) {
#pragma unroll
                              for (int j = 0; j < 8; ++j)
#pragma unroll
                                for (int i = 0; i < 8; ++i) fold[j & 1][i] += acc[j][i];
                            });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = q_base + (lane >> 3) * 8 + i;
    if (b >= B) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      partial[((int64_t)blockIdx.x * B + b) * LANES + warp * 8 + (lane & 7) + 64 * h] =
          fold[h][i];
  }
}

// The int8 tile's fold: fold[nb][i] holds lane int8_row(i) (a tile row is
// its own lane: tiles are 128 rows) of query q_base + int8_query(nb, i).
__global__ void __launch_bounds__(THREADS, 2)
dot_probe_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ corpus,
                      int B, int N, int D, int tiles_per_cta, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q_base = blockIdx.y * QG;
  const int n_tiles = (N + NT - 1) / NT;
  const int tile_lo = blockIdx.x * tiles_per_cta;
  const int tile_hi = min(tile_lo + tiles_per_cta, n_tiles);
  float fold[4][4] = {};
  int8_scan(q, corpus, nullptr, B, N, D, q_base, tile_lo, tile_hi, smem,
            [&](const int(&acc)[4][4], const float(&)[2], int) {
#pragma unroll
              for (int nb = 0; nb < 4; ++nb)
#pragma unroll
                for (int i = 0; i < 4; ++i) fold[nb][i] += __int2float_rn(acc[nb][i]);
            });
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = q_base + int8_query(nb, i);
      if (b < B) partial[((int64_t)blockIdx.x * B + b) * LANES + int8_row(i)] = fold[nb][i];
    }
}

template <typename T>
void launch_stream(const void* corpus, int D, int block_n, int n_blocks, void* partial,
                   cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int cols = D / VEC < STREAM_THREADS ? D / VEC : STREAM_THREADS;
  const dim3 grid(n_blocks, (D / VEC + cols - 1) / cols);
  stream_partial_kernel<T><<<grid, STREAM_THREADS, 0, st>>>(
      static_cast<const T*>(corpus), D, block_n, static_cast<float*>(partial));
}

}  // namespace

// corpus: (N, D) f32 / bf16 / int8 (dtype 0 / 1 / 2), 16-byte aligned with
// D * itemsize % 16 == 0. partial: (N / block_n, D) f32 scratch; out: (D,) f32.
extern "C" int rag_stream_probe(const void* corpus, int dtype, int N, int D, int block_n,
                                void* partial, void* out, void* stream) {
  const int itemsize = dtype == F32 ? 4 : dtype == BF16 ? 2 : 1;
  const int n_blocks = block_n > 0 ? N / block_n : 0;
  if (dtype < F32 || dtype > INT8 || n_blocks < 1 || D < 1 || (D * itemsize) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == F32) {
    launch_stream<float>(corpus, D, block_n, n_blocks, partial, st);
  } else if (dtype == BF16) {
    launch_stream<__nv_bfloat16>(corpus, D, block_n, n_blocks, partial, st);
  } else {
    launch_stream<int8_t>(corpus, D, block_n, n_blocks, partial, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(D + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, st>>>(
      static_cast<const float*>(partial), n_blocks, D, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

namespace {

template <typename T, bool ROUND_BF16>
cudaError_t launch_dot(const float* q, const T* corpus, int B, int N, int D,
                       int tiles_per_cta, int n_ctas, float* partial, cudaStream_t st) {
  constexpr int smem = FloatTile<T>::RING_BYTES;
  const cudaError_t err = allow_smem(dot_probe_kernel<T, ROUND_BF16>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_ctas, (B + QG - 1) / QG);
  dot_probe_kernel<T, ROUND_BF16><<<grid, THREADS, smem, st>>>(q, corpus, B, N, D,
                                                               tiles_per_cta, partial);
  return cudaGetLastError();
}

}  // namespace

// q: (B, D) f32 (int8 for an int8 corpus); corpus: (N, D) as above, where N
// is the number of rows probed (a multiple of 128). D * itemsize % 16 == 0.
// partial: (n_ctas, B, 128) f32 scratch, with n_ctas = ceil(N / rows /
// tiles_per_cta) for tiles of 512 rows (f32, bf16) or 128 rows (int8);
// out: (B, 128) f32.
extern "C" int rag_dot_probe(const void* q, const void* corpus, int dtype, int round_bf16,
                             int B, int N, int D, int tiles_per_cta, int n_ctas,
                             void* partial, void* out, void* stream) {
  const int itemsize = dtype == F32 ? 4 : dtype == BF16 ? 2 : 1;
  if (dtype < F32 || dtype > INT8 || B < 1 || N < LANES || N % LANES != 0 ||
      tiles_per_cta < 1 || n_ctas < 1 || D < 1 || (D * itemsize) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const float* qf = static_cast<const float*>(q);
  cudaError_t err;
  if (dtype == INT8) {
    if (D > I8_MAX_D) return (int)cudaErrorInvalidValue;
    const int smem = int8_smem_bytes(D, false);
    err = allow_smem(dot_probe_int8_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dot_probe_int8_kernel<<<dim3(n_ctas, (B + QG - 1) / QG), THREADS, smem, st>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus), B, N, D,
        tiles_per_cta, part);
    err = cudaGetLastError();
  } else if (dtype == BF16) {
    err = launch_dot<__nv_bfloat16, false>(qf, static_cast<const __nv_bfloat16*>(corpus), B,
                                           N, D, tiles_per_cta, n_ctas, part, st);
  } else if (round_bf16) {
    err = launch_dot<float, true>(qf, static_cast<const float*>(corpus), B, N, D,
                                  tiles_per_cta, n_ctas, part, st);
  } else {
    err = launch_dot<float, false>(qf, static_cast<const float*>(corpus), B, N, D,
                                   tiles_per_cta, n_ctas, part, st);
  }
  if (err != cudaSuccess) return (int)err;
  const int cols = B * LANES;
  sum_rows_kernel<<<(cols + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, st>>>(
      part, n_ctas, cols, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// As rag_int8_tile_info (topk_int8.cu), for P2's int8 kernel at depth D.
extern "C" int rag_dot_probe_int8_info(int D, void* out) {
  if (D < 16 || D % 16 != 0 || D > I8_MAX_D) return (int)cudaErrorInvalidValue;
  return int8_kernel_info(dot_probe_int8_kernel, int8_smem_bytes(D, false),
                          static_cast<int*>(out));
}
