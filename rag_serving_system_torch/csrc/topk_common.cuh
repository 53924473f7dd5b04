// Pieces shared by the exact top-k kernels (topk.cu: B1, topk_int8.cu: B4)
// and the retrieval probes (probes.cu: P1, P2).
//
// Float score tile (B1 and P2; f32 or bf16 corpus, IEEE FP32 FMAs):
//   A CTA of 256 threads, one per SM, scores 32 queries against tiles of 512
//   corpus rows and walks the depth in chunks of 64 bytes of each row (16
//   f32 or 32 bf16 elements). The chunks stream through a 4-stage ring in
//   shared memory, filled by cp.async.cg 16-byte copies straight from
//   global memory (zero-filled past N, B and D; the corpus copies ask L2
//   for whole 256-byte segments, which the row's next chunks read). Each
//   stage has two mbarriers: "full" completes when every thread's copies
//   into it have landed (cp.async.mbarrier.arrive), "empty" when all 8
//   warps have read it. A warp waits only for its chunk's data, runs the
//   FMAs, marks the stage read, then refills the stage of the chunk before
//   with chunk i + 3: a thread's copies of chunks i + 1 and i + 2 are in
//   flight while its chunk i's FMAs run, warps drift apart by up to a
//   chunk, and the loop has no block-wide barrier. The ring runs on across
//   tile boundaries, so it keeps loading during the selection too. The
//   query chunk travels in the same stage, as f32: a resident (32, D) query
//   block (128 KB at D = 1024) would leave too little shared memory for
//   the ring.
//   Each thread holds 8 rows x 8 queries of accumulators (rows
//   warp * 8 + (lane & 7) + 64 * j, queries (lane >> 3) * 8 + i): a warp
//   covers all 32 queries and 8 rows at a time, so each 16-byte corpus
//   vector is read by 4 lanes at one address and each warp-wide read moves
//   8 distinct vectors of 8 consecutive rows, which the XOR swizzle of
//   ft_vec puts in 8 distinct bank groups: one wavefront, as is a query
//   read (4 vectors, padded apart). Per 4 depth steps a thread reads 8
//   query and 8 corpus vectors (64 words) and runs 256 FFMAs: 4 FFMAs per
//   word read. A bf16 corpus is read 8 elements at a time (5.3 FFMAs per
//   word) and widened to f32 in registers (a shift and a mask per word).
//   Every score is a sequential fmaf chain over the depth, the order of the
//   earlier tile, so equal rows tie exactly.
//   Bound, at 1M x 1024, B = 32 on an NVIDIA H100 80GB HBM3 at 700 W: the
//   copies alone take 1.40 ms (3.1 TB/s, the HBM stream), the FMAs alone
//   1.52 ms f32 (45 TFLOP/s; 254 registers a thread, no spills, 2 warps an
//   SM sub-partition; the card draws its 700 W and holds 1.73-1.88 GHz) and
//   1.63 ms bf16 (the widening adds issue). Together P2 takes 1.71 ms f32
//   and 1.75-1.81 ms bf16: the FMAs bound the tile, and the copies do not
//   hide under them completely (numbers and history in PERF.md).
//
// int8 score tile (B4 and P2 on an int8 corpus): 32 queries x 128 rows,
// 4 x 4 int32 accumulators a thread, __dp4a on packed 4-byte words, chunks
// loaded through registers (not redesigned yet).
//
// Selection: each warp owns 4 queries and keeps each query's running top-k
// in KR = ceil(k / 32) registers a lane while it merges (KR in 1, 2, 4, 8:
// k <= 256; entry j * 32 + lane in register j), and its k-th score always.
// A tile row is merged in with a ballot against the k-th score, and a row
// whose scores all fall at or below it is skipped, as almost every row is
// once the list has filled. A list of one register stays resident; a wider
// one waits in the CTA's slot of the candidate buffer between tiles. Each CTA's list comes
// out sorted; a tree of merge kernels reduces the (B, n_ctas, k)
// candidates to (B, k), 8 lists to 1 a level (three rounds of pairwise
// merge paths in shared memory): 3 launches for up to 512 CTAs.
//
// Ties resolve to the lowest corpus index in both passes: rows reach a
// CTA's list in increasing index order, a new candidate goes after every
// held entry with an equal or larger score, and the merge orders by
// (score desc, index asc).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QG = 32;             // queries per CTA (grid.y covers B)
constexpr int THREADS = 256;       // 8 warps
constexpr int MERGE_THREADS = 256;
constexpr int MAX_KR = 8;          // list registers a lane: k <= 32 * MAX_KR
constexpr unsigned FULL = 0xffffffffu;

// float tile
constexpr int FT_ROWS = 512;      // corpus rows per tile
constexpr int FT_STAGES = 4;      // ring depth
constexpr int FT_ROW_BYTES = 64;  // bytes of each corpus row per chunk, unpadded in the ring
constexpr int FT_C_BYTES = FT_ROWS * FT_ROW_BYTES;

// Byte offset in the ring of 16-byte vector v (0..3) of a row chunk: XOR
// swizzled by bits 1-2 of the row, so 8 consecutive rows' vector v fall in
// 8 distinct bank groups.
__device__ __forceinline__ int ft_vec(int row, int v) {
  return row * FT_ROW_BYTES + ((v ^ ((row >> 1) & 3)) << 4);
}

// int8 tile
constexpr int NT = 128;            // corpus rows per tile
constexpr int QS_STRIDE = QG + 4;  // keeps the 16-byte broadcast read aligned
constexpr int KW = 32;             // depth of one chunk (4-byte words)

struct Int8TileSmem {
  __align__(16) int Qs[KW][QS_STRIDE];
  int Cs[NT][KW + 1];
};

// ---------------------------------------------------------------------------
// Float tile
// ---------------------------------------------------------------------------

// Geometry of one stage for corpus element type T: DK depth elements a
// chunk, the query chunk (QG x DK f32) after the corpus rows.
template <typename T>
struct FloatTile {
  static constexpr int DK = FT_ROW_BYTES / sizeof(T);
  static constexpr int Q_STRIDE = DK + 4;  // floats; keeps 16-byte alignment
  // query b at float b * Q_STRIDE + (b / 8) * 4: the 4 groups of 8 queries
  // a warp reads at once fall in 4 distinct bank groups
  static constexpr int Q_BYTES = (QG * Q_STRIDE + QG / 8 * 4) * 4;
  static constexpr int STAGE_BYTES = FT_C_BYTES + Q_BYTES;
  // the stages, then a "full" and an "empty" mbarrier for each
  static constexpr int RING_BYTES = FT_STAGES * STAGE_BYTES + 2 * FT_STAGES * 8;
};

// mbarriers in shared memory, by shared-space address
__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// An arrival on bar once all of this thread's earlier cp.async copies land.
__device__ __forceinline__ void mbar_arrive_copies(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The two bf16 of a word (low element first) as f32: one shift, one mask.
__device__ __forceinline__ float2 bf16x2(unsigned w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// acc[i] += q[i] . c over 4 depth steps, in order, for one row c.
template <bool ROUND_BF16>
__device__ __forceinline__ void fma4(const float4 (&qv)[8], float4 cv, float (&acc)[8]) {
  if (ROUND_BF16) {
    cv.x = round_bf16(cv.x);
    cv.y = round_bf16(cv.y);
    cv.z = round_bf16(cv.z);
    cv.w = round_bf16(cv.w);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] = fmaf(qv[i].x, cv.x, acc[i]);
    acc[i] = fmaf(qv[i].y, cv.y, acc[i]);
    acc[i] = fmaf(qv[i].z, cv.z, acc[i]);
    acc[i] = fmaf(qv[i].w, cv.w, acc[i]);
  }
}

// One chunk's FMAs from ring stage `stage` into acc[row j][query i].
template <typename T, bool ROUND_BF16>
__device__ __forceinline__ void float_chunk(const unsigned char* stage, float (&acc)[8][8]) {
  using G = FloatTile<T>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // rows warp * 8 + (lane & 7) + 64 * j share their swizzle (bits 1-2)
  const int row = warp * 8 + (lane & 7);
  const float* qs = reinterpret_cast<const float*>(stage + FT_C_BYTES) +
                    (lane >> 3) * (8 * G::Q_STRIDE + 4);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int g = 0; g < G::DK / 4; ++g) {
      float4 qv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + i * G::Q_STRIDE + g * 4);
      const unsigned char* c = stage + ft_vec(row, g);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 cv = *reinterpret_cast<const float4*>(c + j * 64 * FT_ROW_BYTES);
        fma4<ROUND_BF16>(qv, cv, acc[j]);
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < G::DK / 8; ++g) {
      uint4 cp[8];  // 8 bf16 of each row
      const unsigned char* c = stage + ft_vec(row, g);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        cp[j] = *reinterpret_cast<const uint4*>(c + j * 64 * FT_ROW_BYTES);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 qv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + i * G::Q_STRIDE + g * 8 + h * 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 a = bf16x2(h ? cp[j].z : cp[j].x);
          const float2 b = bf16x2(h ? cp[j].w : cp[j].y);
          fma4<false>(qv, make_float4(a.x, a.y, b.x, b.y), acc[j]);
        }
      }
    }
  }
}

// One thread's share of the copies into the ring: the CTA's chunks in
// order (tile by tile, depth chunk by depth chunk), 8 corpus vectors and at
// most one query vector a chunk. Pointers advance by addition; a copy past
// N, B or D moves 0 bytes and zero-fills. The corpus copies ask L2 for the
// whole 256-byte segment, which the row's next chunks read.
template <typename T>
struct FloatIssuer {
  using G = FloatTile<T>;
  static constexpr int RV = FT_ROW_BYTES / 16;  // 16-byte vectors of a row chunk
  static constexpr int QV = G::DK / 4;          // 16-byte vectors of a query chunk
  static constexpr int QX = 4 / sizeof(T);      // f32 query bytes a corpus byte

  const char* base;    // a valid address: the source of 0-byte copies
  const char* row;     // this thread's first row of the tile being issued, depth 0
  const char* qrow;    // this thread's query row, depth 0
  int64_t row_step;    // bytes from one of this thread's rows to the next
  int64_t tile_step;   // bytes from one tile to the next
  int row_bytes;       // D * sizeof(T)
  int rows_left;       // corpus rows from this thread's first row of the tile on
  int dbytes;          // depth of the next chunk, in corpus bytes
  int part;            // this thread's 16-byte column of a row chunk
  bool q_copy;         // this thread copies a query vector, of a query below B
  int q_part;          // which one
  int dc, cpt;         // depth chunk of the next issue, chunks a tile
  int stage;           // ring stage of the next issue
  unsigned smem;       // this thread's first corpus byte in stage 0 (shared space)
  unsigned qsmem;      // this thread's query byte in stage 0 (shared space)

  __device__ __forceinline__ FloatIssuer(const float* q, const T* corpus, int B, int N, int D,
                                         int q_base, int tile_lo, unsigned char* ring) {
    const int tid = threadIdx.x;
    base = reinterpret_cast<const char*>(corpus);
    row_bytes = D * (int)sizeof(T);
    row_step = (int64_t)(THREADS / RV) * row_bytes;
    tile_step = (int64_t)FT_ROWS * row_bytes;
    const int row0 = tid / RV;
    part = tid % RV;
    row = base + ((int64_t)tile_lo * FT_ROWS + row0) * row_bytes;
    rows_left = N - tile_lo * FT_ROWS - row0;
    const int b = tid / QV;
    q_part = tid % QV;
    q_copy = tid < QG * QV && q_base + b < B;
    qrow = reinterpret_cast<const char*>(q) + (q_copy ? (int64_t)(q_base + b) * D * 4 : 0);
    dbytes = 0;
    dc = 0;
    cpt = (row_bytes + FT_ROW_BYTES - 1) / FT_ROW_BYTES;
    stage = 0;
    const unsigned r = static_cast<unsigned>(__cvta_generic_to_shared(ring));
    smem = r + ft_vec(row0, part);  // rows row0 + 64 * it share its swizzle
    qsmem = r + FT_C_BYTES + ((b % QG) * G::Q_STRIDE + (b % QG) / 8 * 4) * 4 + q_part * 16;
  }

  // Copy the next chunk into its stage; `full` (stage 0's "full" mbarrier;
  // stage s's is 8 * s bytes on) gets this thread's arrival when they land.
  __device__ __forceinline__ void issue(unsigned full) {
    const unsigned s = smem + stage * G::STAGE_BYTES;
    const bool d_ok = dbytes + part * 16 < row_bytes;
    const char* src = row + dbytes + part * 16;
#pragma unroll
    for (int it = 0; it < FT_ROWS * RV / THREADS; ++it) {
      const bool ok = d_ok && rows_left > it * (THREADS / RV);
      asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                       s + it * (THREADS / RV) * FT_ROW_BYTES),
                   "l"(ok ? src + it * row_step : base), "r"(ok ? 16 : 0));
    }
    if (threadIdx.x < QG * QV) {
      const int qbytes = dbytes * QX + q_part * 16;
      const bool ok = q_copy && qbytes < row_bytes * QX;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       qsmem + stage * G::STAGE_BYTES),
                   "l"(ok ? qrow + qbytes : base), "r"(ok ? 16 : 0));
    }
    mbar_arrive_copies(full + 8 * stage);
    if (++dc == cpt) {
      dc = 0;
      dbytes = 0;
      row += tile_step;
      rows_left -= FT_ROWS;
    } else {
      dbytes += FT_ROW_BYTES;
    }
    stage = stage == FT_STAGES - 1 ? 0 : stage + 1;
  }
};

// Score tiles tile_lo .. tile_hi - 1 (512 rows each) of a (N, D) f32 or
// bf16 corpus against queries q_base .. q_base + 31 of the (B, D) f32 q,
// in IEEE f32 FMAs; (D * sizeof(T)) % 16 == 0, both 16-byte aligned.
// After each tile, all threads call epilogue(acc, n0): acc[j][i] is the
// score of query q_base + (lane >> 3) * 8 + i against row
// n0 + warp * 8 + (lane & 7) + 64 * j. Rows past N, queries past B and
// depth past D read as 0. With ROUND_BF16 each corpus element is rounded to
// bf16 first (the caller rounds q), so every product is exact: one bf16
// pass with f32 accumulation. `ring` holds FloatTile<T>::RING_BYTES of
// shared memory.
template <typename T, bool ROUND_BF16, typename Epilogue>
__device__ __forceinline__ void float_scan(const float* __restrict__ q,
                                           const T* __restrict__ corpus, int B, int N, int D,
                                           int q_base, int tile_lo, int tile_hi,
                                           unsigned char* ring, Epilogue&& epilogue) {
  using G = FloatTile<T>;
  const int cpt = (D * (int)sizeof(T) + FT_ROW_BYTES - 1) / FT_ROW_BYTES;
  const int total = (tile_hi - tile_lo) * cpt;
  // stage s is full once every thread's copies into it have landed, and
  // empty once every warp has read it
  const unsigned full = static_cast<unsigned>(__cvta_generic_to_shared(ring)) +
                        FT_STAGES * G::STAGE_BYTES;
  const unsigned empty = full + 8 * FT_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FT_STAGES; ++s) {
      mbar_init(full + 8 * s, THREADS);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
  }
  __syncthreads();
  FloatIssuer<T> copies(q, corpus, B, N, D, q_base, tile_lo, ring);
  for (int s = 0; s < FT_STAGES - 1 && s < total; ++s) copies.issue(full);
  int c = 0;      // chunks done
  int stage = 0;  // stage of chunk c
  int phase = 0;  // parity of chunk c's use of its stage
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    float acc[8][8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
    for (int dc = 0; dc < cpt; ++dc, ++c) {
      // chunk c + 3 refills the stage of chunk c - 1 once every warp is done
      // with it; chunks c + 1 and c + 2 are in flight meanwhile
      const int prev = stage == 0 ? FT_STAGES - 1 : stage - 1;
      const int prev_phase = stage == 0 ? phase ^ 1 : phase;
      mbar_wait(full + 8 * stage, phase);
      float_chunk<T, ROUND_BF16>(ring + stage * G::STAGE_BYTES, acc);
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * stage);
      // after the FMAs: by now the other warps are most likely done with
      // chunk c - 1 too, so the wait rarely stalls
      if (c + FT_STAGES - 1 < total) {
        if (c > 0) mbar_wait(empty + 8 * prev, prev_phase);
        copies.issue(full);
      }
      if (++stage == FT_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    epilogue(acc, tile * FT_ROWS);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory a float-tile kernel asks for beyond 48 KB must be opted
// into (on the current device, before each launch: it is cheap).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------------------
// int8 tile
// ---------------------------------------------------------------------------

// int32 dot products of int8 rows, __dp4a on packed 4-byte words:
// acc[i][r] = q[q_base + ty*4 + i] . corpus[n0 + tx + 32*r]. D % 16 == 0,
// both 16-byte aligned. |q|, |c| <= 127 keep |acc| <= D * 127^2, exact in
// int32. Out-of-range queries and rows read as 0.
__device__ __forceinline__ void int8_tile(const int8_t* __restrict__ q,
                                          const int8_t* __restrict__ corpus, int B, int N,
                                          int D, int q_base, int n0, Int8TileSmem& sm,
                                          int (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0;

  for (int d0 = 0; d0 < D; d0 += KW * 4) {
    // corpus chunk: 128 rows x 128 bytes, one 16-byte vector per thread per pass
#pragma unroll
    for (int it = 0; it < (NT * KW / 4) / THREADS; ++it) {
      const int idx = tid + it * THREADS;
      const int row = idx >> 3;
      const int w4 = (idx & 7) * 4;
      int4 v = make_int4(0, 0, 0, 0);
      const int n = n0 + row;
      if (n < N && d0 + w4 * 4 < D)
        v = *reinterpret_cast<const int4*>(corpus + (int64_t)n * D + d0 + w4 * 4);
      sm.Cs[row][w4] = v.x;
      sm.Cs[row][w4 + 1] = v.y;
      sm.Cs[row][w4 + 2] = v.z;
      sm.Cs[row][w4 + 3] = v.w;
    }
    // query chunk: 32 queries x 128 bytes, one vector per thread, depth-major
    {
      const int b = tid >> 3;
      const int w4 = (tid & 7) * 4;
      int4 v = make_int4(0, 0, 0, 0);
      if (q_base + b < B && d0 + w4 * 4 < D)
        v = *reinterpret_cast<const int4*>(q + (int64_t)(q_base + b) * D + d0 + w4 * 4);
      sm.Qs[w4][b] = v.x;
      sm.Qs[w4 + 1][b] = v.y;
      sm.Qs[w4 + 2][b] = v.z;
      sm.Qs[w4 + 3][b] = v.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KW; ++kk) {
      const int4 qv = *reinterpret_cast<const int4*>(&sm.Qs[kk][ty * 4]);
      const int qw[4] = {qv.x, qv.y, qv.z, qv.w};
      int cw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cw[r] = sm.Cs[tx + 32 * r][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][r] = __dp4a(qw[i], cw[r], acc[i][r]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Selection
// ---------------------------------------------------------------------------

// (s1, i1) ranks before (s2, i2): higher score, then lower index.
__device__ __forceinline__ bool ranks_before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// The smallest list width that holds k entries.
inline int list_regs(int k) { return k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : 8; }

// The running lists of a warp's 4 queries (warp * 4 + j). With KR = 1 (k
// <= 32) each list is one register a lane and stays in registers for the
// CTA's whole span. A wider list lives in the CTA's slot of the
// (B, gridDim.x, k) candidates between tiles, so the score tile keeps its
// register budget for any k; it is loaded only to merge a row in. Either
// way the warp keeps each list's k-th score in a register.
template <int KR>
struct WarpLists {
  static constexpr bool RESIDENT = KR == 1;
  float thr[4];
  float s[4];  // the resident lists
  int i[4];

  // Start the lists empty.
  __device__ __forceinline__ void init(int q_base, int B, int k, float* __restrict__ cand_s,
                                       int* __restrict__ cand_i) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      thr[j] = -INFINITY;
      s[j] = -INFINITY;
      i[j] = INT_MAX;
      const int b = q_base + warp * 4 + j;
      if (RESIDENT || b >= B) continue;
      const int64_t o = ((int64_t)b * gridDim.x + blockIdx.x) * k;
      for (int p = lane; p < k; p += 32) {
        cand_s[o + p] = -INFINITY;
        cand_i[o + p] = INT_MAX;
      }
    }
  }

  // Write resident lists to the CTA's slot of the candidates.
  __device__ __forceinline__ void finish(int q_base, int B, int k, float* __restrict__ cand_s,
                                         int* __restrict__ cand_i) {
    if (!RESIDENT) return;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = q_base + warp * 4 + j;
      if (b < B && lane < k) {
        const int64_t o = ((int64_t)b * gridDim.x + blockIdx.x) * k + lane;
        cand_s[o] = s[j];
        cand_i[o] = i[j];
      }
    }
  }
};

// The list's k-th score (entry k - 1), on every lane.
template <int KR>
__device__ __forceinline__ float kth_score(const float (&top_s)[KR], int k) {
  float v = top_s[0];
#pragma unroll
  for (int r = 1; r < KR; ++r)
    if (r == (k - 1) >> 5) v = top_s[r];
  return __shfl_sync(FULL, v, (k - 1) & 31);
}

// Merge one query's tile row (the W scores of rows n0 .. n0 + W - 1, from
// row n0 + 32 * c0 on) into its running list: entry r * 32 + lane in
// top_s[r] / top_i[r], k entries. Called by a whole warp.
template <int KR, int W>
__device__ __forceinline__ void merge_row(const float* srow, int n0, int k, int lane, int c0,
                                          float (&top_s)[KR], int (&top_i)[KR]) {
  float thr = kth_score<KR>(top_s, k);
  for (int c = c0; c < W / 32; ++c) {
    const float s = srow[c * 32 + lane];
    unsigned cand = __ballot_sync(FULL, s > thr);
    while (cand) {  // lowest lane first = increasing corpus index
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      const float sv = __shfl_sync(FULL, s, src);
      if (!(sv > thr)) continue;  // warp-uniform
      const int iv = n0 + c * 32 + src;
      // insert after every held entry scoring >= sv (those hold lower indices)
      int pos = 0;
#pragma unroll
      for (int r = 0; r < KR; ++r)
        pos += __popc(__ballot_sync(FULL, r * 32 + lane < k && top_s[r] >= sv));
      // shift entries pos .. k - 2 up by one; lane 31 of register r carries
      // into lane 0 of register r + 1
      float carry_s = -INFINITY;
      int carry_i = INT_MAX;
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        float up_s = __shfl_up_sync(FULL, top_s[r], 1);
        int up_i = __shfl_up_sync(FULL, top_i[r], 1);
        const float last_s = __shfl_sync(FULL, top_s[r], 31);
        const int last_i = __shfl_sync(FULL, top_i[r], 31);
        if (lane == 0) {
          up_s = carry_s;
          up_i = carry_i;
        }
        const int p = r * 32 + lane;
        if (p == pos) {
          top_s[r] = sv;
          top_i[r] = iv;
        } else if (p > pos && p < k) {
          top_s[r] = up_s;
          top_i[r] = up_i;
        }
        carry_s = last_s;
        carry_i = last_i;
      }
      thr = kth_score<KR>(top_s, k);
    }
  }
}

// Merge a (QG, W) score tile (rows LD floats apart) into this warp's 4
// lists. A row is merged from its first 32 scores that hold one above the
// list's k-th, and skipped when none does.
template <int KR, int W, int LD = W>
__device__ __forceinline__ void merge_tile(const float (*Ss)[LD], int q_base, int B, int n0,
                                           int k, WarpLists<KR>& lists,
                                           float* __restrict__ cand_s,
                                           int* __restrict__ cand_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int bl = warp * 4 + j;
    if (q_base + bl >= B) continue;  // warp-uniform
    int c0 = 0;
    while (c0 < W / 32 && !__any_sync(FULL, Ss[bl][c0 * 32 + lane] > lists.thr[j])) ++c0;
    if (c0 == W / 32) continue;
    const int64_t o = ((int64_t)(q_base + bl) * gridDim.x + blockIdx.x) * k;
    float top_s[KR];
    int top_i[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      const int p = r * 32 + lane;
      if (WarpLists<KR>::RESIDENT) {
        top_s[r] = lists.s[j];
        top_i[r] = lists.i[j];
      } else {
        top_s[r] = p < k ? cand_s[o + p] : -INFINITY;
        top_i[r] = p < k ? cand_i[o + p] : INT_MAX;
      }
    }
    merge_row<KR, W>(Ss[bl], n0, k, lane, c0, top_s, top_i);
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      const int p = r * 32 + lane;
      if (WarpLists<KR>::RESIDENT) {
        lists.s[j] = top_s[r];
        lists.i[j] = top_i[r];
      } else if (p < k) {
        cand_s[o + p] = top_s[r];
        cand_i[o + p] = top_i[r];
      }
    }
    lists.thr[j] = kth_score<KR>(top_s, k);
  }
}

// Entry t of the k best of two lists a and b (k entries each, or none for
// b when nb = 0), both sorted by (score desc, index asc): a merge path, a
// binary search for how many of the first t entries come from a.
__device__ __forceinline__ void merge_path(const float* as, const int* ai, const float* bs,
                                           const int* bi, int nb, int t, float& s, int& i) {
  int lo = max(0, t - nb);
  int hi = t;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (ranks_before(as[m], ai[m], bs[t - m - 1], bi[t - m - 1])) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  const int j = t - lo;
  const bool take_a = j >= nb || ranks_before(as[lo], ai[lo], bs[j], bi[j]);
  s = take_a ? as[lo] : bs[j];
  i = take_a ? ai[lo] : bi[j];
}

constexpr int MERGE_GROUP = 8;  // lists merged by one CTA of the merge tree

// One level of the candidate merge: lists MERGE_GROUP * g .. of query b
// (k entries each, sorted) become list g of the next level, their k best,
// sorted, by three rounds of pairwise merge paths in shared memory.
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const float* __restrict__ in_s, const int* __restrict__ in_i, int L, int k,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ float buf_s[2][MERGE_GROUP * 32 * MAX_KR];
  __shared__ int buf_i[2][MERGE_GROUP * 32 * MAX_KR];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int lists = min(MERGE_GROUP, L - g * MERGE_GROUP);
  const int64_t in0 = ((int64_t)b * L + (int64_t)g * MERGE_GROUP) * k;
  for (int e = threadIdx.x; e < lists * k; e += MERGE_THREADS) {
    buf_s[0][e] = in_s[in0 + e];
    buf_i[0][e] = in_i[in0 + e];
  }
  __syncthreads();
  int src = 0;
  for (int n = lists; n > 1; n = (n + 1) / 2) {
    for (int e = threadIdx.x; e < (n + 1) / 2 * k; e += MERGE_THREADS) {
      const int p = e / k;
      const int t = e % k;
      const float* as = buf_s[src] + 2 * p * k;
      const int* ai = buf_i[src] + 2 * p * k;
      merge_path(as, ai, as + k, ai + k, 2 * p + 1 < n ? k : 0, t, buf_s[src ^ 1][e],
                 buf_i[src ^ 1][e]);
    }
    __syncthreads();
    src ^= 1;
  }
  const int64_t o = ((int64_t)b * ((L + MERGE_GROUP - 1) / MERGE_GROUP) + g) * k;
  for (int t = threadIdx.x; t < k; t += MERGE_THREADS) {
    out_s[o + t] = buf_s[src][t];
    out_i[o + t] = buf_i[src][t];
  }
}

// Reduce the (B, L, k) candidate lists of a partial kernel to (B, k) by a
// tree of merges, ping-ponging between cand and tmp ((B, ceil(L / 8), k)
// each); returns a cudaError_t.
inline int launch_topk_merge(void* cand_s, void* cand_i, int B, int L, int k, void* tmp_s,
                             void* tmp_i, void* out_s, void* out_i, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();  // the partial kernel's launch
  if (err != cudaSuccess) return (int)err;
  void* src_s = cand_s;
  void* src_i = cand_i;
  while (true) {
    const int l_out = (L + MERGE_GROUP - 1) / MERGE_GROUP;
    void* dst_s = l_out == 1 ? out_s : src_s == cand_s ? tmp_s : cand_s;
    void* dst_i = l_out == 1 ? out_i : src_i == cand_i ? tmp_i : cand_i;
    topk_merge_kernel<<<dim3(l_out, B), MERGE_THREADS, 0, st>>>(
        static_cast<const float*>(src_s), static_cast<const int*>(src_i), L, k,
        static_cast<float*>(dst_s), static_cast<int*>(dst_i));
    err = cudaGetLastError();
    if (err != cudaSuccess || l_out == 1) return (int)err;
    src_s = dst_s;
    src_i = dst_i;
    L = l_out;
  }
}

}  // namespace
