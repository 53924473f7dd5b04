// Online-softmax causal attention for prefill, padded (kernel B2) and packed
// (kernel B3), sharing one body.
//
// Replaces: rag_serving_system_tpu/ops/attention.py:_flash_kernel (wrapper
// flash_attention; a (B, S) key-padding mask plus causal) and
// rag_serving_system_tpu/ops/attention.py:_flash_packed_kernel (wrapper
// flash_attention_packed; one (1, T) stream of back-to-back segments, token i
// attends to j iff seg[i] == seg[j] and j <= i).
//
// What bounds it here: prefill attention at the serving shapes (Hq = 12,
// Hk = 2, D = 128, segments or buckets of 128-1024 tokens) does about
// 4 * D flops per (query, visible key) pair against 2 * D bytes of K/V per
// key, so it is compute-bound; this first kernel runs the products on the
// FP32 CUDA cores rather than the bf16 tensor cores (mma / wgmma), which is
// where the next version gains. The (S, S) score matrix never reaches
// device memory. Measured on an H100 80GB HBM3 at a 700 W limit: B2 2.26 ms
// at B = 32, S = 512 in bf16 (11.4 TFLOP/s of causal work), B3 1.91 ms for
// a T = 8192 stream of 32 segments.
//
// Design: one CTA per (q-block of 64 rows, q-head, batch row), four warps of
// 16 query rows each. The q-block sits in shared memory, pre-scaled by
// 1/sqrt(D) as the TPU kernel scales it; 32-key K/V tiles stream through
// shared memory in f32 (bf16 inputs are widened on load). For a tile, lane j
// scores key j against the warp's 16 rows (float4 reads of a padded K row
// and broadcast float4 reads of Q), the warp reduces max and sum by shuffles,
// and the probabilities pass through shared memory to the P.V update, where
// lane c owns output columns c, c + 32, ... The running (m, l, acc) stays in
// registers. GQA reads kv head h / (Hq / Hk); K/V are never repeated.
//   B2: the key loop runs from tile 0 to the tile holding the block's last
//       row (the causal diagonal); the key mask comes from mask[b, j].
//   B3: the key loop starts at the tile holding the segment start of the
//       block's first token, found by a binary search over the ascending
//       segment ids (the TPU kernel got it as a scalar-prefetched `qstart`),
//       so the work grows with sum(len^2), not T^2.
// Masked scores take NEG_INF = -1e30 as in the TPU kernel; a row whose
// visible keys are all masked ends with m == NEG_INF and writes 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per CTA
constexpr int BK = 32;                 // keys per tile
constexpr int WARPS = 4;
constexpr int ROWS = BQ / WARPS;       // query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

struct AttnArgs {
  const void* q;     // (B, S, Hq, D)
  const void* k;     // (B, S, Hk, D)
  const void* v;     // (B, S, Hk, D)
  void* o;           // (B, S, Hq, D)
  const int* mask;   // B2: (B, S) key mask {0, 1}
  const int* seg;    // B3: (S,) ascending segment ids (B == 1)
  int B, S, Hq, Hk;
  int causal;
  float sm_scale;
};

template <int D>
constexpr int smem_floats() {
  return BQ * D + BK * (D + 4) + BK * D + WARPS * ROWS * BK;
}

template <typename T, int D, bool PACKED>
__global__ void __launch_bounds__(THREADS) flash_kernel(AttnArgs a) {
  constexpr int KS = D + 4;     // padded K row: conflict-free float4 reads
  constexpr int DPL = D / 32;   // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [BQ][D]
  float* Ks = Qs + BQ * D;             // [BK][KS]
  float* Vs = Ks + BK * KS;            // [BK][D]
  float* Ps = Vs + BK * D;             // [WARPS][ROWS][BK]
  __shared__ int key_tag[BK];          // B2: mask bit; B3: segment id
  __shared__ int row_tag[BQ];          // B3: segment id of each query row
  __shared__ int seg_start;

  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  T* O = static_cast<T*>(a.o);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hk);
  const int S = a.S;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int row = idx / D;
    const int d = idx - row * D;
    const int qi = q0 + row;
    Qs[idx] = qi < S ? to_f32(Q[(((int64_t)b * S + qi) * a.Hq + h) * D + d]) * a.sm_scale : 0.f;
  }
  if (PACKED) {
    for (int r = tid; r < BQ; r += THREADS) row_tag[r] = q0 + r < S ? a.seg[q0 + r] : -1;
    if (tid == 0) {
      // first index of the segment holding token q0 (segments ascend)
      const int target = a.seg[q0];
      int lo = 0, hi = q0;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a.seg[mid] < target) lo = mid + 1; else hi = mid;
      }
      seg_start = lo;
    }
  }
  __syncthreads();

  const int last_row = min(q0 + BQ - 1, S - 1);
  const int kt_begin = PACKED ? seg_start / BK : 0;
  const int kt_end = a.causal ? last_row / BK : (S - 1) / BK;

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const int row0 = warp * ROWS;
  float* Pw = Ps + warp * ROWS * BK;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < S) {
        const int64_t off = (((int64_t)b * S + kj) * a.Hk + hk) * D + d;
        kv = to_f32(K[off]);
        vv = to_f32(V[off]);
      }
      Ks[j * KS + d] = kv;
      Vs[j * D + d] = vv;
    }
    if (tid < BK) {
      const int kj = k0 + tid;
      if (PACKED) key_tag[tid] = kj < S ? a.seg[kj] : -2;
      else key_tag[tid] = kj < S ? a.mask[(int64_t)b * S + kj] : 0;
    }
    __syncthreads();

    // scores of key (k0 + lane) against the warp's rows
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (row0 + r) * D + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const int kj = k0 + lane;
    const int tag = key_tag[lane];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = q0 + row0 + r;
      bool ok = kj < S && (!a.causal || kj <= qi);
      ok = ok && (PACKED ? tag == row_tag[row0 + r] : tag > 0);
      const float sc = ok ? s[r] : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = expf(sc - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      Pw[r * BK + lane] = p;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vf[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DPL; ++c) vf[jj][c] = Vs[(j + jj) * D + c * 32 + lane];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(Pw + r * BK + j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          float t = acc[r][c];
          t = fmaf(p4.x, vf[0][c], t);
          t = fmaf(p4.y, vf[1][c], t);
          t = fmaf(p4.z, vf[2][c], t);
          t = fmaf(p4.w, vf[3][c], t);
          acc[r][c] = t;
        }
      }
    }
    __syncthreads();  // Ks / Vs / key_tag are rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= S) continue;
    const bool live = m[r] > NEG_INF * 0.5f;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = O + (((int64_t)b * S + qi) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) store(orow + c * 32 + lane, live ? acc[r][c] * inv : 0.f);
  }
}

template <typename T, int D, bool PACKED>
int launch(const AttnArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D, PACKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, a.B);
  flash_kernel<T, D, PACKED><<<grid, THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const AttnArgs& a, int D, int packed, cudaStream_t st) {
  if (D == 128) return packed ? launch<T, 128, true>(a, st) : launch<T, 128, false>(a, st);
  if (D == 64) return packed ? launch<T, 64, true>(a, st) : launch<T, 64, false>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out: (B, S, Hq, D); k/v: (B, S, Hk, D), contiguous, f32 or bf16 alike.
// packed == 0 (B2): mask is (B, S) int32, seg unused.
// packed == 1 (B3): B must be 1, seg is (S,) int32 ascending, mask unused.
extern "C" int rag_flash_attention(const void* q, const void* k, const void* v,
                                   const void* mask, const void* seg, void* out,
                                   int is_bf16, int packed, int causal,
                                   int B, int S, int Hq, int Hk, int D, float sm_scale,
                                   void* stream) {
  if (B < 1 || S < 1 || Hk < 1 || Hq % Hk != 0 || (packed && B != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.mask = static_cast<const int*>(mask);
  a.seg = static_cast<const int*>(seg);
  a.B = B;
  a.S = S;
  a.Hq = Hq;
  a.Hk = Hk;
  a.causal = causal;
  a.sm_scale = sm_scale;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, D, packed, st) : dispatch<float>(a, D, packed, st);
}
