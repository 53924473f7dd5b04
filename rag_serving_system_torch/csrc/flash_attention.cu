// Online-softmax causal attention for prefill, padded (kernel B2) and packed
// (kernel B3), sharing one body per element type.
//
// Replaces: rag_serving_system_tpu/ops/attention.py:_flash_kernel (wrapper
// flash_attention; a (B, S) key-padding mask plus causal) and
// rag_serving_system_tpu/ops/attention.py:_flash_packed_kernel (wrapper
// flash_attention_packed; one (1, T) stream of back-to-back segments, token i
// attends to j iff seg[i] == seg[j] and j <= i).
//
// Semantics of both kernels: masked scores take NEG_INF = -1e30 as in the
// TPU kernel; a row whose visible keys are all masked ends with m == NEG_INF
// and writes 0; query head h reads kv head h / (Hq / Hk), and K/V are never
// repeated. The (S, S) score matrix never reaches device memory.
//   B2: key tiles up to the one holding the block's last row (the causal
//       diagonal); the key mask comes from mask[b, j]. The f32 kernel starts
//       at tile 0, the bf16 one at the tile of the block's first unmasked
//       key (the tiles before it add nothing).
//   B3: key tiles from the one holding the segment start of the block's
//       first token, found by a binary search over the ascending segment ids
//       (the TPU kernel got it as a scalar-prefetched `qstart`), so the work
//       grows with sum(len^2), not T^2.
//
// bf16 (the served dtype): a tensor-core kernel in the FlashAttention-2 form.
//   What bounds it: at the serving shapes (Hq = 12, Hk = 2, D = 128,
//   128-1024 tokens a row) the least time is set by bytes (q, k, v, o read
//   or written once: 0.035 ms for B2 at B = 32, S = 512; 0.018 ms for B3 at
//   T = 8192, 32 segments, on an NVIDIA H100 80GB HBM3 at 700 W), the
//   visible products a quarter to a third of that on the tensor cores. Measured
//   on that card: 0.107 ms (B2) and 0.182 ms (B3), against 2.28 and 1.90 ms
//   for the first version on the FP32 CUDA cores. What holds it there is
//   per-CTA latency, not either rate: a 64-row CTA sees 2-8 key tiles, one
//   tile in flight, each from L2; and B3 computes the packed stream's pad
//   tail as a causal segment of its own (PERF.md).
//   Design: a CTA of 4 warps owns 64 query rows of one head; each warp owns
//   16 rows (CTAs of 8 warps and 128 rows were slower at every served shape,
//   PERF.md). Q is copied once into shared memory and kept in registers as
//   mma A fragments (ldmatrix); its shared memory is the ring's, so 3 CTAs
//   fit an SM. Tiles of 64 keys of K
//   and V (16 KB each at D = 128) and their 64 mask or segment tags stream
//   through a 2-stage ring of 16-byte cp.async copies, with one block barrier
//   a tile: the barrier that publishes tile t also frees the stage of tile
//   t - 1, which then receives tile t + 1 while tile t is computed. Rows of
//   the ring and of Q are XOR-swizzled (16-byte column ^ row & 7), so each
//   8-row ldmatrix read falls in 8 distinct bank groups. S = Q K^T and
//   O += P V run on mma.sync.m16n8k16 bf16 with f32 accumulators (K through
//   ldmatrix, V through ldmatrix.trans: no transpose is written). The
//   softmax runs on the S fragments in registers: scores scaled by
//   1/sqrt(D) * log2(e) in f32, masked, a row max over the 4 lanes of a quad
//   (two shfl_xor), exp2f; two adjacent n8 C fragments become one bf16 A
//   fragment of P with no trip through shared memory; l sums the f32
//   probabilities. Key tiles strictly below the diagonal check only the key
//   tag; the diagonal tile and the last (ragged) tile also check j <= i and
//   j < S. A warp skips a tile wholly above its rows, wholly masked (B2) or
//   wholly of earlier segments (B3). The epilogue divides by l, writes 0 on
//   dead rows, and stores bf16 through shared memory as 16-byte rows.
//
// f32: the first kernel, on the FP32 CUDA cores, unchanged (the f32 engine is
// held token-identical to the plain versions): one CTA per (q-block of 64
// rows, q-head, batch row), four warps of 16 query rows each. The q-block
// sits in shared memory, pre-scaled by 1/sqrt(D) as the TPU kernel scales
// it; 32-key K/V tiles stream through shared memory. For a tile, lane j
// scores key j against the warp's 16 rows, the warp reduces max and sum by
// shuffles, and the probabilities pass through shared memory to the P.V
// update, where lane c owns output columns c, c + 32, ... The running
// (m, l, acc) stays in registers. 1.48 ms (B2) and 1.43 ms (B3) at the
// shapes above.
//
// Narrow heads (D = 16 and 32, the tiny preset and small test models): the
// same scalar body for f32 and, with bf16 loads and stores around its f32
// math, for bf16 (the tensor-core kernel's swizzle needs rows of 128 bytes).
// At D = 16 a lane owns one output column or none. These sizes carry no
// served model: the body is there to be right, not fast.

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
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // output columns per lane
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
  // at D = 16 only the first 16 lanes own an output column
  const bool own = D >= 32 || lane < D;

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
        for (int c = 0; c < DPL; ++c) vf[jj][c] = own ? Vs[(j + jj) * D + c * 32 + lane] : 0.f;
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
    for (int c = 0; c < DPL; ++c)
      if (own) store(orow + c * 32 + lane, live ? acc[r][c] * inv : 0.f);
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TC_BK = 64;  // keys per tile
constexpr int NW = 4;      // warps a CTA, 16 query rows each
constexpr float LOG2E = 1.4426950408889634f;

// Byte offset of 16-byte column c of row r in a tile of rows of rb bytes,
// XOR-swizzled by the row's low 3 bits.
__device__ __forceinline__ unsigned swz(int r, int c, int rb) {
  return (unsigned)(r * rb + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned& r0, unsigned& r1,
                                          unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The ring's two stages (K, V, key tags each). The Q block is first copied
// into stage 1's K rows, read into registers before stage 1 is first
// filled, and the epilogue stages O there too: 66 KB a CTA at D = 128, so 3
// CTAs fit an SM.
template <int D>
struct TcSmem {
  static constexpr int RB = D * 2;                   // bytes of a row
  static constexpr int KV_BYTES = TC_BK * RB;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + TC_BK * 4;
  static constexpr int BYTES = 2 * STAGE_BYTES;
  static_assert(16 * NW * RB <= KV_BYTES, "the Q block fits stage 1's K rows");
};

template <int D, bool PACKED>
__global__ void __launch_bounds__(NW * 32, 3) flash_tc_kernel(AttnArgs a) {
  using L = TcSmem<D>;
  constexpr int CH = D / 8;       // 16-byte columns of a row
  constexpr int KC = D / 16;      // k-steps of Q K^T
  constexpr int NT = TC_BK / 8;   // n8 tiles of S
  constexpr int DT = D / 8;       // n8 tiles of O
  constexpr int BQR = 16 * NW;    // query rows of the CTA
  constexpr int NTH = NW * 32;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __shared__ int start_key;

  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hk);
  const int S = a.S;
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(tc_smem));
  const unsigned q_s = ring + L::STAGE_BYTES;
  unsigned char* const q_p = tc_smem + L::STAGE_BYTES;
  const int last_row = min(q0 + BQR - 1, S - 1);
  const int kt_end = a.causal ? last_row / TC_BK : (S - 1) / TC_BK;

  // the first key tile with a visible key: B3, the one holding the start of
  // token q0's segment (a binary search over the ascending ids); B2, the one
  // holding the first unmasked key up to the last row (none: the diagonal
  // tile alone, wholly masked). Tiles before it add nothing.
  if (PACKED) {
    if (tid == 0) {
      const int target = a.seg[q0];
      int lo = 0, hi = q0;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a.seg[mid] < target) lo = mid + 1; else hi = mid;
      }
      start_key = lo;
    }
  } else {
    if (tid == 0) start_key = kt_end * TC_BK;
    __syncthreads();
    const int* mrow = a.mask + (int64_t)b * S;
    const int j_end = a.causal ? last_row : S - 1;
    for (int j = tid; j <= j_end; j += NTH) {
      if (mrow[j] > 0) {
        atomicMin(&start_key, j);
        break;
      }
    }
  }
  __syncthreads();
  const int kt_begin = start_key / TC_BK;

  // the Q block, once
  for (int idx = tid; idx < BQR * CH; idx += NTH) {
    const int r = idx / CH, c = idx - (idx / CH) * CH;
    const int qi = q0 + r;
    cp_async16(q_s + swz(r, c, L::RB),
               Q + (((int64_t)b * S + min(qi, S - 1)) * a.Hq + h) * D + c * 8, qi < S);
  }
  // K, V and the 64 key tags of tile kt into ring stage st. This thread
  // copies column cc of rows cr, cr + RP, ...: one swizzle, pointers that
  // advance by a row stride
  constexpr int RP = NTH / CH;  // rows a pass
  const int cr = tid / CH, cc = tid - (tid / CH) * CH;
  const unsigned c_off = swz(cr, cc, L::RB);
  const int64_t kv_row = (int64_t)a.Hk * D;
  const __nv_bfloat16* kb = K + ((int64_t)b * S * a.Hk + hk) * D + cc * 8;
  const __nv_bfloat16* vb = V + ((int64_t)b * S * a.Hk + hk) * D + cc * 8;
  auto issue = [&](int kt, int st) {
    const unsigned ks = ring + st * L::STAGE_BYTES + c_off;
    const int k0 = kt * TC_BK;
#pragma unroll
    for (int i = 0; i < TC_BK / RP; ++i) {
      const int kj = k0 + cr + i * RP;
      const int64_t off = (kj < S ? kj : 0) * kv_row;
      cp_async16(ks + i * RP * L::RB, kb + off, kj < S);
      cp_async16(ks + L::KV_BYTES + i * RP * L::RB, vb + off, kj < S);
    }
    if (tid < TC_BK) {
      const int kj = k0 + tid;
      const int* src = PACKED ? a.seg + min(kj, S - 1) : a.mask + (int64_t)b * S + min(kj, S - 1);
      cp_async4(ring + st * L::STAGE_BYTES + 2 * L::KV_BYTES + tid * 4, src, kj < S);
    }
  };
  issue(kt_begin, 0);
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  const int wrow = warp * 16;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int row_a = q0 + wrow + g;
  const int row_b = row_a + 8;
  int tag_a = 0, tag_b = 0, first_tag = 0;
  if (PACKED) {
    tag_a = row_a < S ? a.seg[row_a] : -1;
    tag_b = row_b < S ? a.seg[row_b] : -1;
    first_tag = a.seg[min(q0 + wrow, S - 1)];
  }
  const float scale = a.sm_scale * LOG2E;

  unsigned qa[KC][4];
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  for (int kt = kt_begin, it = 0; kt <= kt_end; ++kt, ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int m = lane >> 3;
        const int r = wrow + (lane & 7) + 8 * (m & 1);
        ldsm_x4(q_s + swz(r, 2 * kc + (m >> 1), L::RB), qa[kc][0], qa[kc][1], qa[kc][2],
                qa[kc][3]);
      }
      __syncthreads();  // every warp holds its Q before stage 1 is refilled
    }
    if (kt < kt_end) issue(kt + 1, (it + 1) & 1);
    cp_async_commit();

    const int k0 = kt * TC_BK;
    // a warp whose rows all precede the tile's first key has nothing to add
    if (a.causal && k0 > q0 + wrow + 15) continue;
    const unsigned ks = ring + (it & 1) * L::STAGE_BYTES;
    const unsigned vs = ks + L::KV_BYTES;
    const int* tags = reinterpret_cast<const int*>(tc_smem + (vs - ring) + L::KV_BYTES);
    // nor has a warp any key of a tile whose keys are all masked (B2) or all
    // of segments before its first row's (B3, segments ascend): skipping it
    // leaves (m, l, O) exactly as the masked products would
    if (PACKED ? tags[min(TC_BK - 1, S - 1 - k0)] < first_tag
               : !__any_sync(FULL, tags[lane] > 0 || tags[lane + 32] > 0))
      continue;

    // S = Q K^T: 16 rows x 64 keys a warp
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int m = lane >> 3;
        const int r = 16 * jp + 8 * (m >> 1) + (lane & 7);
        unsigned b0, b1, b2, b3;
        ldsm_x4(ks + swz(r, 2 * kc + (m & 1), L::RB), b0, b1, b2, b3);
        mma_bf16(sc[2 * jp], qa[kc], b0, b1);
        mma_bf16(sc[2 * jp + 1], qa[kc], b2, b3);
      }
    }

    // mask and scale; the diagonal and the ragged last tile also check
    // j <= i and j < S
    const bool edge = (a.causal && k0 + TC_BK - 1 > q0 + wrow) || k0 + TC_BK > S;
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c0 = 8 * j + 2 * qd;
      const int2 t = *reinterpret_cast<const int2*>(tags + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tg = (e & 1) ? t.y : t.x;
        const int row_tag = (e >> 1) ? tag_b : tag_a;
        bool ok = PACKED ? tg == row_tag : tg > 0;
        if (edge) {
          const int kj = k0 + c0 + (e & 1);
          const int qi = (e >> 1) ? row_b : row_a;
          ok = ok && kj < S && (!a.causal || kj <= qi);
        }
        const float s = ok ? sc[j][e] * scale : NEG_INF;
        sc[j][e] = s;
        if (e >> 1) mx_b = fmaxf(mx_b, s); else mx_a = fmaxf(mx_a, s);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row live only now clears what its masked tiles added: exp2(-1e30 - m) = 0
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      sc[j][0] = exp2f(sc[j][0] - mn_a);
      sc[j][1] = exp2f(sc[j][1] - mn_a);
      sc[j][2] = exp2f(sc[j][2] - mn_b);
      sc[j][3] = exp2f(sc[j][3] - mn_b);
      sum_a += sc[j][0] + sc[j][1];
      sum_b += sc[j][2] + sc[j][3];
    }
    l_a = l_a * al_a + sum_a;  // this lane's columns; the quad is summed at the end
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= al_a;
      o[j][1] *= al_a;
      o[j][2] *= al_b;
      o[j][3] *= al_b;
    }

    // O += P V: P's C fragments of n8 tiles 2kc and 2kc + 1 are the A
    // fragment of keys 16kc .. 16kc + 15
#pragma unroll
    for (int kc = 0; kc < TC_BK / 16; ++kc) {
      const unsigned pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        const int m = lane >> 3;
        const int r = 16 * kc + 8 * (m & 1) + (lane & 7);
        unsigned v0, v1, v2, v3;
        ldsm_x4_t(vs + swz(r, 2 * dp + (m >> 1), L::RB), v0, v1, v2, v3);
        mma_bf16(o[2 * dp], pa, v0, v1);
        mma_bf16(o[2 * dp + 1], pa, v2, v3);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring

  // epilogue: O / l, 0 on dead rows, staged as bf16 in stage 1's K rows
  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);
  const float inv_a = m_a > NEG_INF * 0.5f ? 1.f / fmaxf(l_a, 1e-30f) : 0.f;
  const float inv_b = m_b > NEG_INF * 0.5f ? 1.f / fmaxf(l_b, 1e-30f) : 0.f;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = 2 * j * 4 + 2 * qd;  // element column of this lane's pair
    *reinterpret_cast<unsigned*>(q_p + swz(wrow + g, c >> 3, L::RB) + (c & 7) * 2) =
        pack_bf16(o[j][0] * inv_a, o[j][1] * inv_a);
    *reinterpret_cast<unsigned*>(q_p + swz(wrow + g + 8, c >> 3, L::RB) + (c & 7) * 2) =
        pack_bf16(o[j][2] * inv_b, o[j][3] * inv_b);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx - (idx / CH) * CH;
    const int qi = q0 + wrow + r;
    if (qi < S) {
      *reinterpret_cast<uint4*>(O + (((int64_t)b * S + qi) * a.Hq + h) * D + c * 8) =
          *reinterpret_cast<const uint4*>(q_p + swz(wrow + r, c, L::RB));
    }
  }
}

template <int D, bool PACKED>
int launch_tc(const AttnArgs& a, cudaStream_t st) {
  constexpr int bytes = TcSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<D, PACKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + 16 * NW - 1) / (16 * NW), a.Hq, a.B);
  flash_tc_kernel<D, PACKED><<<grid, NW * 32, bytes, st>>>(a);
  return (int)cudaGetLastError();
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

// bf16: the tensor-core kernel at D = 64 and 128, the scalar body (f32 math
// on bf16 loads and stores) at the narrow heads
int dispatch_tc(const AttnArgs& a, int D, int packed, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (D == 128) return packed ? launch_tc<128, true>(a, st) : launch_tc<128, false>(a, st);
  if (D == 64) return packed ? launch_tc<64, true>(a, st) : launch_tc<64, false>(a, st);
  if (D == 32) return packed ? launch<bf16, 32, true>(a, st) : launch<bf16, 32, false>(a, st);
  if (D == 16) return packed ? launch<bf16, 16, true>(a, st) : launch<bf16, 16, false>(a, st);
  return (int)cudaErrorInvalidValue;
}

int dispatch_f32(const AttnArgs& a, int D, int packed, cudaStream_t st) {
  if (D == 128) return packed ? launch<float, 128, true>(a, st) : launch<float, 128, false>(a, st);
  if (D == 64) return packed ? launch<float, 64, true>(a, st) : launch<float, 64, false>(a, st);
  if (D == 32) return packed ? launch<float, 32, true>(a, st) : launch<float, 32, false>(a, st);
  if (D == 16) return packed ? launch<float, 16, true>(a, st) : launch<float, 16, false>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out: (B, S, Hq, D); k/v: (B, S, Hk, D), contiguous and 16-byte aligned,
// f32 or bf16 alike; D in {16, 32, 64, 128}.
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
  return is_bf16 ? dispatch_tc(a, D, packed, st) : dispatch_f32(a, D, packed, st);
}
