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
// Both kernels compute query rows 0 .. n_q - 1 only: B2 all S of them, B3
// the real tokens at the head of the stream (the wrapper's n_real; rows past
// it belong to the pad tail, which no caller reads, and the wrapper zeroes
// them). No CTA is launched for a query block wholly past n_q.
//
// bf16 at D = 64 and 128 (the served dtype): a Hopper kernel on wgmma and TMA.
//   What bounds it: at the serving shapes (Hq = 12, Hk = 2, D = 128,
//   128-1024 tokens a row) the least time is set by bytes (q, k, v, o read
//   or written once: 0.032 ms for B2 at B = 32, S = 512; 0.015 ms for B3 at
//   T = 8192 with 6,373 real tokens, on an NVIDIA H100 80GB HBM3 at 700 W),
//   the visible products a quarter to a third of that on the tensor cores.
//   The mma.sync kernel it replaces took 0.105 ms (B2) and 0.189 ms (B3) on
//   that card; what held it there was per-CTA latency (2-8 key tiles a CTA,
//   one in flight, each from L2), K/V copied into shared memory once for
//   each of the G = Hq / Hk query heads that read them, and B3's pad tail
//   computed as a causal segment of its own (PERF.md).
//   Design:
//   - Work items: P = 128 / G query positions of one kv head and batch row
//     with all G query heads that read that kv head, as 128 rows (position,
//     head) = p * G + g, P * G of them in use (126 at G = 6). Each K/V tile
//     an item loads serves all G heads. q and o keep the JAX package's
//     layouts: a position's G heads lie side by side.
//   - Persistent: one CTA an SM (384 threads) walks items c, c + #SMs, ...,
//     later positions first. Two consumer warp groups own 64 rows each (one
//     wgmma m64 tile); the third warp group gives most of its registers to
//     them (setmaxnreg 40 / 232) and runs a producer warp and a storer warp.
//   - The producer finds an item's key tiles (B3: from its first segment's
//     start, a warp-wide search over the ascending ids, 32 tiles a probe;
//     B2: from the first unmasked key to the last, 256 keys a probe, so a
//     right-padded tail is never loaded), loads the item's Q rows by TMA (a 5-D
//     map (D, G, Hk, S, B) whose box is the item's P x G rows) into one of
//     two buffers, and keeps K/V tiles of 64 keys in flight, by TMA from a
//     4-D map (D, Hk, S, B) (keys past S arrive as zeros inside the batch
//     row), through a ring of NSTAGE stages with "full" and "empty"
//     mbarriers. The 64 key tags (B2's mask ints, B3's segment ids) come by
//     cp.async, counted by the same "full" barrier, and a stage header gives
//     its first key and whether it ends its item. The ring runs on across
//     items. No block barrier is taken inside the key loop.
//   - Boxes are 64 columns (128 bytes) wide in the 128-byte swizzle; D = 128
//     is two. S = Q K^T is wgmma m64n64k16 with both operands K-major in
//     shared memory; O += P V takes P from registers (the S accumulator of a
//     k16 step is its A fragment once packed to bf16) and V MN-major through
//     the transpose bit, one box a product: no transposed V is ever written.
//   - The online softmax stays in registers in the exp2 form. A tile whose
//     keys are all unmasked (B2) or of one segment (B3) and off the diagonal
//     skips the per-key checks; O and l are rescaled only where a row's max
//     grew. A warp group skips a tile wholly above its rows, wholly masked
//     (B2) or wholly of earlier segments (B3). A row with no visible key
//     writes 0, and so does a row past n_q. What bounds the kernel now is
//     the softmax between the two products (the largest share of a consumer
//     warp group's time in a clock64 profile); taking turns at it between
//     the groups, and issuing a tile's P V behind the next tile's Q K^T,
//     were both slower on that card.
//   - The epilogue stages O as bf16 in the item's Q buffer; the storer warp
//     stores the item's P x G rows by TMA and then frees the buffer for the
//     next Q but one.
//   - The tensor maps are built on the host at each call and passed as
//     __grid_constant__ parameters; cuTensorMapEncodeTiled comes from
//     cudaGetDriverEntryPoint, so the library needs no -lcuda.
//   Measured on that card (chip_smoke.py --phases attention, the mma.sync
//   kernel and this one in turns; PERF.md): B2 at (32, 512) left-padded
//   0.084-0.085 ms against 0.106-0.107; B3 at T = 8192 0.063-0.065 ms with
//   n_real = 6,373 (varlen_attn over the real segments: 0.103-0.110) and
//   0.096-0.102 with every row, against 0.186-0.188.
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

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda
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
  int n_q;           // query rows computed and written: S, or B3's real tokens
  int pos_per_cta;   // the wgmma body's positions a CTA (set at its launch)
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
    if (qi >= a.n_q) continue;
    const bool live = m[r] > NEG_INF * 0.5f;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = O + (((int64_t)b * S + qi) * a.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (own) store(orow + c * 32 + lane, live ? acc[r][c] * inv : 0.f);
  }
}


// ---------------------------------------------------------------------------
// bf16 at D = 64 and 128: wgmma on TMA-fed tiles
// ---------------------------------------------------------------------------

constexpr int WG_BK = 64;                   // keys a tile
constexpr int NWG = 2;                      // consumer warp groups, one m64 row tile each
constexpr int WG_BM = 64 * NWG;             // (position, head) rows of a CTA
constexpr int NSTAGE = 4;                   // stages of the K/V ring
constexpr int WG_THREADS = NWG * 128 + 128;  // + the producer's warp group
// setmaxnreg: the launch gives each of the 3 warp groups 168 registers a
// thread; 128 x (40 + 2 x 232) = 64,512 of the SM's 65,536 after the move
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int FULL_ARRIVALS = 33;           // the producer's expect_tx + its 32 lanes' tag copies
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of a CTA, from a base aligned to 1024 bytes (the 128-byte
// swizzle's period). A box is rows of 64 bf16 columns, 128 bytes a row, in
// TMA's 128-byte swizzle: 16-byte chunk c of row r lies at chunk c ^ (r & 7).
// A K or V tile is D / 64 boxes of 64 keys; a Q buffer is D / 64 boxes of
// WG_BM rows, which hold an item's rows on the way in and its O on the way
// out.
template <int D>
struct WgSmem {
  static constexpr int BOX = 64 * 128;                  // a K / V box
  static constexpr int TILE = (D / 64) * BOX;
  static constexpr int QBOX = WG_BM * 128;              // a Q / O box
  static constexpr int QTILE = (D / 64) * QBOX;
  static constexpr int Q = 0;                           // [2] Q buffers
  static constexpr int K = Q + 2 * QTILE;               // [NSTAGE] tiles of 64 keys
  static constexpr int V = K + NSTAGE * TILE;           // [NSTAGE]
  static constexpr int TAGS = V + NSTAGE * TILE;        // [NSTAGE][64] int32
  static constexpr int HDR = TAGS + NSTAGE * WG_BK * 4;  // [NSTAGE] (first key, last of item)
  static constexpr int FULL = HDR + NSTAGE * 8;         // [NSTAGE] mbarriers
  static constexpr int EMPTY = FULL + NSTAGE * 8;       // [NSTAGE] mbarriers
  static constexpr int Q_FULL = EMPTY + NSTAGE * 8;     // [2] mbarriers
  static constexpr int Q_EMPTY = Q_FULL + 2 * 8;        // [2] mbarriers
  static constexpr int O_FULL = Q_EMPTY + 2 * 8;        // [2] mbarriers
  static constexpr int BYTES = O_FULL + 2 * 8 + 1024;   // + room to align the base
};

// Byte offset of chunk c of row r in a tile of boxes of box_bytes.
__device__ __forceinline__ uint32_t box_off(int r, int c, int box_bytes) {
  return (uint32_t)((c >> 3) * box_bytes + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A 4-byte copy that lands as zeros when !ok; cp_async_arrive makes the
// mbarrier count this thread's earlier cp.async copies as one of its
// expected arrivals once they land.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// One box of the (D, Hk, S, B) tensor map at (column, kv head, key, batch
// row) into shared memory; rows past S arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a (D, G, Hk, S, B) view of q or o at (column, 0, kv head,
// position, batch row): the item's P positions x G query heads as P * G
// rows of 64 columns; positions past S are zeros on the way in and dropped
// on the way out.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(0), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, uint32_t src, int c0, int c2,
                                             int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(0), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep registers that an asynchronous wgmma reads or writes in place until
// the wait before this point.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void hold(unsigned (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A shared-memory matrix descriptor of a tile in the 128-byte swizzle: the
// start address, the leading byte offset, the stride byte offset (1024: 8
// rows of 128 bytes, from one 8-row group to the next) and the layout type
// (1, 128-byte swizzle). K-major (Q, K): a k16 step reads 32 bytes of each
// row, inside the swizzle's 128, so the leading offset is unused; it is 16
// as in CUTLASS. MN-major (V, 64 columns: one swizzle atom wide): the k16
// step's two 8-key groups lie 1024 bytes apart, and 1024 is given for the
// leading offset too, which no product of one atom's width reads.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem), bf16, both
// K-major; acc == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major:
// the transpose bit), bf16.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The work of a call is a list of items (position block, kv head hk, batch
// row b), the blocks of later positions (more keys under the causal mask)
// first; CTA c takes items c, c + gridDim.x, ... (one CTA an SM). An item's
// rows R = p * G + g are its P = WG_BM / G positions p0 + p and the G query
// heads hk * G + g; consumer warp group w owns rows 64w .. 64w + 63.
struct Item {
  int p0, hk, b;
};

__device__ __forceinline__ Item item_of(int i, const AttnArgs& a) {
  const int hb = a.Hk * a.B;
  const int n_blocks = (a.n_q + a.pos_per_cta - 1) / a.pos_per_cta;
  const int r = i % hb;
  return {(n_blocks - 1 - i / hb) * a.pos_per_cta, r % a.Hk, r / a.Hk};
}

constexpr int NO_KEY = 0x7fffffff;

// x / G for 0 <= x < 2^16 and G <= WG_BM, exactly, from 1 / G in f32:
// (x + 0.5) / G lies at least 0.5 / G from an integer, far beyond the
// product's rounding.
__device__ __forceinline__ int div_g(int x, float inv_g) {
  return __float2int_rz((x + 0.5f) * inv_g);
}

// The max (MAX) or sum of this thread's 16 values of one accumulator row:
// sc[4j + e] with e & 2 == r2 (0: row g, 2: row g + 8), as a tree.
template <bool MAX>
__device__ __forceinline__ float row_tree(const float (&sc)[32], int r2) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x = sc[4 * j + r2], y = sc[4 * j + r2 + 1];
    v[j] = MAX ? fmaxf(x, y) : x + y;
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] = MAX ? fmaxf(v[j], v[j + w]) : v[j] + v[j + w];
  return v[0];
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; a very negative x gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An item's key tiles with a visible key (warp-collective): (first, last).
// B3: from the tile holding the start of position p0's segment, i.e. the
// first tile whose last id is >= seg[p0] (the ids ascend), probed 32 tiles a
// step back from p0's own (the TPU kernel got the start as a
// scalar-prefetched `qstart`), to kt_end. B2: from the tile of the first
// unmasked key up to j_end to the tile of the last, 256 keys a probe (a
// right-padded row's masked tail is never loaded); with none, kt_end alone
// (the diagonal tile, wholly masked). Tiles outside add nothing.
template <bool PACKED>
__device__ int2 key_tiles(const AttnArgs& a, const Item& w, int j_end, int kt_end, int lane) {
  const int S = a.S;
  if (PACKED) {
    const int target = a.seg[w.p0];
    for (int top = w.p0 / WG_BK;; top -= 32) {
      const int t = top - lane;
      const bool ends_in = t >= 0 && a.seg[min(t * WG_BK + WG_BK - 1, S - 1)] >= target;
      const unsigned before = ~__ballot_sync(FULL, ends_in);  // lanes past the start's tile
      if (before) return make_int2(top - (__ffs(before) - 1) + 1, kt_end);
    }
  }
  const int* mrow = a.mask + (int64_t)w.b * S;
  const bool tail_masked = mrow[j_end] <= 0;  // else the last tile is j_end's
  int first = NO_KEY;
  for (int j0 = 0; j0 <= j_end && first == NO_KEY; j0 += 8 * 32) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + 32 * u + lane;
      if (j <= j_end && mrow[j] > 0) first = min(first, j);
    }
    first = __reduce_min_sync(FULL, first);
  }
  if (first == NO_KEY) return make_int2(kt_end, kt_end);
  int last = tail_masked ? -1 : j_end;
  for (int j1 = j_end; j1 >= first && last < 0; j1 -= 8 * 32) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j1 - 32 * u - lane;
      if (j >= first && mrow[j] > 0) last = max(last, j);
    }
    last = __reduce_max_sync(FULL, last);
  }
  return make_int2(first / WG_BK, last / WG_BK);
}

// Warp 4 * NWG is the producer. The K/V ring runs on across items: the
// producer finds an item's key tiles and loads its first while the consumers
// finish the one before. A stage carries its tile's first key and whether it
// is its item's last, beside the K/V boxes and the 64 key tags. Q comes by
// TMA into one of two buffers, an item ahead; O leaves from the same buffer
// by TMA once the item is done, which frees it.
template <int D, bool PACKED>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_wg_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const __grid_constant__ CUtensorMap tmo, AttnArgs a) {
  using L = WgSmem<D>;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = wg_smem + (base - raw);
  const int* const tag_ring = reinterpret_cast<const int*>(gbase + L::TAGS);
  int* const hdr_ring = reinterpret_cast<int*>(gbase + L::HDR);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = a.Hq / a.Hk;
  const int P = a.pos_per_cta;
  const int rows = P * G;  // rows in use, of WG_BM
  const int S = a.S;
  const int n_q = a.n_q;
  const int n_items = (n_q + P - 1) / P * a.Hk * a.B;

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(base + L::FULL + 8 * s, FULL_ARRIVALS);
      mbar_init(base + L::EMPTY + 8 * s, NWG * 4);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(base + L::Q_FULL + 8 * s, 1);
      mbar_init(base + L::Q_EMPTY + 8 * s, 1);
      mbar_init(base + L::O_FULL + 8 * s, 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // the last warp group gives its registers to the consumers; its first
    // warp is the producer, its second stores each item's O once the
    // consumers have staged it and then frees the buffer for the next Q
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 4 * NWG + 1 && lane == 0) {
      for (int i = blockIdx.x, n = 0; i < n_items; i += gridDim.x, ++n) {
        const Item w = item_of(i, a);
        mbar_wait(base + L::O_FULL + 8 * (n & 1), (n >> 1) & 1);
#pragma unroll
        for (int h = 0; h < D / 64; ++h)
          tma_store_5d(&tmo, base + L::Q + (n & 1) * L::QTILE + h * L::QBOX, 64 * h, w.hk, w.p0,
                       w.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(base + L::Q_EMPTY + 8 * (n & 1));
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    if (warp > 4 * NWG) return;
    // producer: once the consumers have released the next stage, its header
    // by lane 0's stores, K and V by TMA, the 64 key tags by cp.async (zeros
    // past S: the ragged tile checks j < S), all counted by "full"
    int it = 0, n = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      const Item w = item_of(i, a);
      if (lane == 0) {  // the item's Q, once its buffer's last O has left
        const uint32_t qf = base + L::Q_FULL + 8 * (n & 1);
        mbar_wait(base + L::Q_EMPTY + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(qf, P * G * 128 * (D / 64));
#pragma unroll
        for (int h = 0; h < D / 64; ++h)
          tma_load_5d(base + L::Q + (n & 1) * L::QTILE + h * L::QBOX, &tmq, qf, 64 * h, w.hk,
                      w.p0, w.b);
      }
      const int last_pos = min(w.p0 + P, n_q) - 1;
      const int2 kt = key_tiles<PACKED>(a, w, a.causal ? last_pos : S - 1,
                                        a.causal ? last_pos / WG_BK : (S - 1) / WG_BK, lane);
      const int* tag_src = PACKED ? a.seg : a.mask + (int64_t)w.b * S;
      for (int t = kt.x; t <= kt.y; ++t, ++it) {
        const int st = it % NSTAGE;
        const uint32_t full = base + L::FULL + 8 * st;
        mbar_wait(base + L::EMPTY + 8 * st, ((it / NSTAGE) & 1) ^ 1);
        const int k0 = t * WG_BK;
        if (lane == 0) {
          hdr_ring[2 * st] = k0;
          hdr_ring[2 * st + 1] = t == kt.y;
          mbar_arrive_expect_tx(full, 2 * L::TILE);
#pragma unroll
          for (int h = 0; h < D / 64; ++h) {
            tma_load_4d(base + L::K + st * L::TILE + h * L::BOX, &tmk, full, 64 * h, w.hk, k0,
                        w.b);
            tma_load_4d(base + L::V + st * L::TILE + h * L::BOX, &tmv, full, 64 * h, w.hk, k0,
                        w.b);
          }
        }
#pragma unroll
        for (int u = 0; u < WG_BK / 32; ++u) {
          const int kj = k0 + lane + 32 * u;
          cp_async4(base + L::TAGS + 4 * (st * WG_BK + lane + 32 * u), tag_src + min(kj, S - 1),
                    kj < S);
        }
        cp_async_arrive(full);
      }
    }
    return;
  }

  // consumers, with the registers the last warp group gave up
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp >> 2;
  const int wq = warp & 3;
  const float scale = a.sm_scale * LOG2E;
  // this thread's rows g and g + 8 of its warp's 16
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int w0 = wg * 64;       // the warp group's first row
  const int r_a = w0 + wq * 16 + g;  // in the item
  const float inv_g = 1.f / G;
  // rows P * G .. WG_BM - 1 of the Q buffers, which TMA never writes and
  // the epilogue skips, stay zero: their products are finite, and no row of
  // theirs is stored
  for (int idx = tid; idx < 2 * (D / 64) * (WG_BM - rows) * 8; idx += 4 * 32 * NWG) {
    const int c = idx % 8, r = rows + (idx / 8) % (WG_BM - rows), hb = idx / 8 / (WG_BM - rows);
    *reinterpret_cast<uint4*>(gbase + L::Q + hb * L::QBOX + box_off(r, c, L::QBOX)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NWG) : "memory");

  int it = 0, n = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
    const Item w = item_of(i, a);
    const int p0 = w.p0;
    // a row's position, or -1 outside the block
    auto row_pos = [&](int R) {
      const int pos = p0 + div_g(R, inv_g);
      return R < rows && pos < n_q ? pos : -1;
    };
    const int pos_a = row_pos(r_a), pos_b = row_pos(r_a + 8);
    // the warp group's first and last positions; B3, the rows' segment ids
    const int pw0 = p0 + div_g(w0, inv_g);
    const bool has_rows = w0 < rows && pw0 < n_q;
    const int pw1 = has_rows ? min(p0 + div_g(min(w0 + 63, rows - 1), inv_g), n_q - 1) : -1;
    int tag_a = -1, tag_b = -1, first_tag = 0;
    if (PACKED) {
      if (pos_a >= 0) tag_a = a.seg[pos_a];
      if (pos_b >= 0) tag_b = a.seg[pos_b];
      if (has_rows) first_tag = a.seg[pw0];
    }
    const uint32_t q_s = base + L::Q + (n & 1) * L::QTILE + w0 * 128;  // this warp group's rows
    unsigned char* const q_p = gbase + L::Q + (n & 1) * L::QTILE;
    mbar_wait(base + L::Q_FULL + 8 * (n & 1), (n >> 1) & 1);

    float o[D / 64][32];
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[h][e] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

    for (bool last = false; !last; ++it) {
      const int st = it % NSTAGE;
      mbar_wait(base + L::FULL + 8 * st, (it / NSTAGE) & 1);
      const int k0 = hdr_ring[2 * st];
      last = hdr_ring[2 * st + 1] != 0;
      const int* tags = tag_ring + st * WG_BK;
      // a warp group has nothing to add from a tile wholly above its rows,
      // wholly masked (B2) or wholly of segments before its first row's
      // (B3, segments ascend): skipping it leaves (m, l, O) exactly as the
      // masked products would. Every warp of the group reads the same answer.
      bool live = has_rows && !(a.causal && k0 > pw1);
      if (live)
        live = PACKED ? tags[min(WG_BK - 1, S - 1 - k0)] >= first_tag
                      : __any_sync(FULL, tags[lane] > 0 || tags[lane + 32] > 0);
      if (live) {
        // S = Q K^T: 64 rows x 64 keys a warp group
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
        const uint32_t k_s = base + L::K + st * L::TILE;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks >> 2) * L::QBOX + (ks & 3) * 32;
          const uint32_t koff = (ks >> 2) * L::BOX + (ks & 3) * 32;
          wgmma_ss_n64(sc, sw128_desc(q_s + off, 16), sw128_desc(k_s + koff, 16), ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(sc);

        // mask and scale: sc[4j + e] is row (e < 2 ? g : g + 8), key 8j +
        // 2qd + (e & 1). The diagonal and the ragged last tile check j <= i,
        // j < S and each key's tag; any other tile whose keys are all
        // unmasked (B2) or of one segment (B3) masks whole rows at most.
        const bool edge = (a.causal && k0 + WG_BK - 1 > pw0) || k0 + WG_BK > S;
        const bool whole =
            !edge && (PACKED ? tags[0] == tags[WG_BK - 1]
                             : __all_sync(FULL, tags[lane] > 0 && tags[lane + 32] > 0));
        if (whole) {
          const bool ok_a = !PACKED || tag_a == tags[0], ok_b = !PACKED || tag_b == tags[0];
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const bool ok = (e & 2) ? ok_b : ok_a;
            sc[e] = ok ? sc[e] * scale : NEG_INF;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c0 = 8 * j + 2 * qd;
            const int2 t = *reinterpret_cast<const int2*>(tags + c0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int tg = (e & 1) ? t.y : t.x;
              bool ok = PACKED ? tg == ((e >> 1) ? tag_b : tag_a) : tg > 0;
              if (edge) {
                const int kj = k0 + c0 + (e & 1);
                const int qi = (e >> 1) ? pos_b : pos_a;
                ok = ok && kj < S && (!a.causal || kj <= qi);
              }
              sc[4 * j + e] = ok ? sc[4 * j + e] * scale : NEG_INF;
            }
          }
        }
        float mx_a = row_tree<true>(sc, 0), mx_b = row_tree<true>(sc, 2);
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        // O and l are rescaled only in a warp where some row's max grew: a
        // factor of exp2(0) = 1 leaves them as they are. A row live only now
        // clears what its masked tiles added: exp2(-1e30 - m) = 0.
        if (__any_sync(FULL, mn_a > m_a || mn_b > m_b)) {
          const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
          l_a *= al_a;
          l_b *= al_b;
#pragma unroll
          for (int h = 0; h < D / 64; ++h)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              o[h][4 * j] *= al_a;
              o[h][4 * j + 1] *= al_a;
              o[h][4 * j + 2] *= al_b;
              o[h][4 * j + 3] *= al_b;
            }
        }
        m_a = mn_a;
        m_b = mn_b;
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = ex2(sc[e] - ((e & 2) ? mn_b : mn_a));
        // this lane's columns of each row, summed as a tree; the quad is
        // summed at the end
        l_a += row_tree<false>(sc, 0);
        l_b += row_tree<false>(sc, 2);

        // O += P V: the C fragments of key columns 16kc .. 16kc + 15 are the
        // A fragment of a k16 step, from registers; V is read MN-major, one
        // box (64 columns) a product, with no transposed copy
        unsigned pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          pa[kc][0] = pack_bf16(sc[8 * kc], sc[8 * kc + 1]);
          pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
          pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
          pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
        }
        const uint32_t v_s = base + L::V + st * L::TILE;
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
#pragma unroll
          for (int h = 0; h < D / 64; ++h)
            wgmma_rs_n64(o[h], pa[kc], sw128_desc(v_s + h * L::BOX + kc * 16 * 128, 1024));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int h = 0; h < D / 64; ++h) hold(o[h]);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) hold(pa[kc]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(base + L::EMPTY + 8 * st);  // this warp is done with the stage
    }

    // epilogue: O / l, 0 on dead rows (rows past n_q among them), as bf16
    // into this thread's rows of the item's Q buffer (no wgmma reads it any
    // more), for the storing warp
    l_a += __shfl_xor_sync(FULL, l_a, 1);
    l_a += __shfl_xor_sync(FULL, l_a, 2);
    l_b += __shfl_xor_sync(FULL, l_b, 1);
    l_b += __shfl_xor_sync(FULL, l_b, 2);
    const float inv_a = m_a > NEG_INF * 0.5f ? 1.f / fmaxf(l_a, 1e-30f) : 0.f;
    const float inv_b = m_b > NEG_INF * 0.5f ? 1.f / fmaxf(l_b, 1e-30f) : 0.f;
#pragma unroll
    for (int h = 0; h < D / 64; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // rows g and g + 8 share the swizzle
        const uint32_t off = box_off(r_a, 8 * h + j, L::QBOX) + 4 * qd;
        if (r_a < rows)
          *reinterpret_cast<unsigned*>(q_p + off) =
              pack_bf16(o[h][4 * j] * inv_a, o[h][4 * j + 1] * inv_a);
        if (r_a + 8 < rows)
          *reinterpret_cast<unsigned*>(q_p + off + 8 * 128) =
              pack_bf16(o[h][4 * j + 2] * inv_b, o[h][4 * j + 3] * inv_b);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(base + L::O_FULL + 8 * (n & 1));
  }
}

// cuTensorMapEncodeTiled lives in libcuda, which the library does not link:
// it is fetched once through the runtime's cudaGetDriverEntryPoint.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K or V, (B, S, Hk, D), as a 4-D map (D, Hk, S, B), boxes of 64 columns x
// 64 keys of one kv head and batch row: TMA zero-fills keys past S inside
// each batch row.
bool kv_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, const AttnArgs& a, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)a.Hk, (cuuint64_t)a.S, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)a.Hk * D * 2,
                                 (cuuint64_t)a.S * a.Hk * D * 2};
  const cuuint32_t box[4] = {64, 1, WG_BK, 1};
  return encode_map(encode, map, ptr, 4, dims, strides, box);
}

// q or o, (B, S, Hq, D), as a 5-D map (D, G, Hk, S, B): a box of 64 columns
// x G heads x P positions of one kv head and batch row is an item's P * G
// rows, position-major.
bool qo_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, const AttnArgs& a, int D) {
  const int G = a.Hq / a.Hk;
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)a.Hk, (cuuint64_t)a.S,
                              (cuuint64_t)a.B};
  const cuuint64_t strides[4] = {(cuuint64_t)D * 2, (cuuint64_t)G * D * 2,
                                 (cuuint64_t)a.Hq * D * 2, (cuuint64_t)a.S * a.Hq * D * 2};
  const cuuint32_t box[5] = {64, (cuuint32_t)G, 1, (cuuint32_t)a.pos_per_cta, 1};
  return encode_map(encode, map, ptr, 5, dims, strides, box);
}

template <int D, bool PACKED>
int launch_wg(AttnArgs a, cudaStream_t st) {
  using L = WgSmem<D>;
  const int G = a.Hq / a.Hk;
  if (G > WG_BM) return (int)cudaErrorInvalidValue;
  a.pos_per_cta = WG_BM / G;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tmq, tmk, tmv, tmo;
  if (!qo_map(encode, &tmq, a.q, a, D) || !kv_map(encode, &tmk, a.k, a, D) ||
      !kv_map(encode, &tmv, a.v, a, D) || !qo_map(encode, &tmo, a.o, a, D))
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(flash_wg_kernel<D, PACKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // persistent: one CTA an SM, or one an item when there are fewer items
  const int items = (a.n_q + a.pos_per_cta - 1) / a.pos_per_cta * a.Hk * a.B;
  flash_wg_kernel<D, PACKED><<<min(items, sms), WG_THREADS, L::BYTES, st>>>(tmq, tmk, tmv, tmo, a);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool PACKED>
int launch(const AttnArgs& a, cudaStream_t st) {
  const size_t bytes = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D, PACKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n_q + BQ - 1) / BQ, a.Hq, a.B);
  flash_kernel<T, D, PACKED><<<grid, THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// bf16: the wgmma body at D = 64 and 128, the scalar body (f32 math on bf16
// loads and stores) at the narrow heads
int dispatch_bf16(const AttnArgs& a, int D, int packed, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (D == 128) return packed ? launch_wg<128, true>(a, st) : launch_wg<128, false>(a, st);
  if (D == 64) return packed ? launch_wg<64, true>(a, st) : launch_wg<64, false>(a, st);
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
// f32 or bf16 alike; D in {16, 32, 64, 128}. Query rows 0 .. n_q - 1 are
// computed and written; rows from n_q on are neither (the caller zeroes
// them): no CTA is launched for a query block wholly past n_q.
// packed == 0 (B2): mask is (B, S) int32, seg unused; n_q must be S.
// packed == 1 (B3): B must be 1, seg is (S,) int32 ascending, mask unused;
// n_q is the count of real tokens at the head of the stream.
extern "C" int rag_flash_attention(const void* q, const void* k, const void* v,
                                   const void* mask, const void* seg, void* out,
                                   int is_bf16, int packed, int causal,
                                   int B, int S, int n_q, int Hq, int Hk, int D, float sm_scale,
                                   void* stream) {
  if (B < 1 || S < 1 || Hk < 1 || Hq % Hk != 0 || (packed && B != 1) || n_q < 1 || n_q > S ||
      (!packed && n_q != S)) {
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
  a.n_q = n_q;
  a.pos_per_cta = 0;
  a.Hq = Hq;
  a.Hk = Hk;
  a.causal = causal;
  a.sm_scale = sm_scale;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bf16(a, D, packed, st) : dispatch_f32(a, D, packed, st);
}
