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
// int8 score tile (B4 and P2 on an int8 corpus; s8 tensor cores):
//   A CTA of 256 threads scores 32 queries against tiles of 128 corpus rows
//   with mma.sync.m16n8k32 s8 x s8 -> s32: A is 16 corpus rows x 32 bytes
//   (ldmatrix.x4 from the ring), B 8 queries x 32 bytes (ldmatrix.x4 from
//   the query block: a (B, D) row-major block is already the .col layout).
//   Warp w owns rows 16w .. 16w + 15 of every tile and all 32 queries: per
//   32-byte depth step one ldmatrix of A, two of B and four mma. The
//   (32, D) int8 query block is copied into shared memory once per CTA
//   (32 KB at D = 1024), each query row padded to a multiple of 128 bytes
//   and XOR-swizzled by 16-byte column, as the ring is, so every 8-lane
//   ldmatrix phase reads 8 distinct bank groups. The corpus streams in
//   128-byte depth chunks of the 128 rows (16 KB a stage) through a 4-stage
//   ring filled by cp.async (zero-filled past N and D), with the float
//   tile's per-stage "full" and "empty" mbarriers and no block barrier in
//   the chunk loop; the ring keeps loading while the selection runs. Integer
//   sums are exact in any order: |acc| <= D * 127^2 < 2^31 (D <= 4096), and
//   each score is __int2float_rn(acc) * scale[row], bit-identical to the
//   plain version. The C fragment (rows g, g + 8 of the warp's 16; queries
//   2t, 2t + 1 of each n8 block) goes to the epilogue.
//   Bound: bytes. At 1M x 1024, B = 32 the products need 68.7 G int8
//   operations, 0.035 ms at the card's 1,979 TOP/s, against 0.32 ms for one
//   read of the corpus at 3.35 TB/s. Shared memory: 32 * D query bytes +
//   64 KB of ring (+ 16.5 KB of score tile for B4): 2 CTAs an SM at
//   D = 1024, 1 at D = 2048; the grid is sized from the occupancy of the
//   kernel that runs (rag_int8_tile_info). ptxas (sm_90a): 72 registers a
//   thread for B4, 53 for its score kernel, 66 for P2, no spills. On an
//   NVIDIA H100 80GB HBM3 at 700 W (nvidia-smi), P2 int8 takes 0.36-0.37
//   ms at 1M x 1024, B = 32 (2.9 TB/s; P1 streams the same bytes in 0.44
//   ms), against 0.770 for the first tile (__dp4a through registers, the
//   query chunk reloaded for every tile, no copy in flight); B4's times are
//   in topk_int8.cu's note, the history in PERF.md.
//
// Selection: each warp owns 4 queries and keeps each query's running top-k
// (k <= 32) in one register a lane for the CTA's whole span, and its k-th
// score. A tile row is merged in with a ballot against the k-th score, and
// a row whose scores all fall at or below it is skipped, as almost every row
// is once the list has filled. Wider lists (2, 4 or 8 registers a lane,
// k <= 256) were measured against the score kernel and select.cu on the
// card and lost from k = 64 on (PERF.md, the crossover), so they are gone:
// the wrappers take the scores and the select beyond their LIST_K. Each
// CTA's list comes out sorted; a tree of merge kernels reduces the
// (B, n_ctas, k) candidates to (B, k), 8 lists to 1 a level (three rounds of
// pairwise merge paths in shared memory): 3 launches for up to 512 CTAs.
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
constexpr int LIST_MAX = 32;       // list entries a query: one register a lane
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
constexpr int NT = 128;                       // corpus rows per tile
constexpr int I8_CHUNK = 128;                 // depth bytes of a row chunk
constexpr int I8_STAGES = 4;                  // ring depth
constexpr int I8_STAGE_BYTES = NT * I8_CHUNK;  // 16 KB
constexpr int I8_MAX_D = 4096;                // the query block fits shared memory
// score tile rows (floats): 4 of pad put the fragment stores of a warp
// (8 rows x 4 queries) in 32 distinct banks
constexpr int SS_LD8 = NT + 4;

// Bytes of a query row in the resident block: D padded to whole 128-byte
// chunks, so every row has 8-vector swizzle groups.
__host__ __device__ constexpr int int8_qrow_bytes(int D) {
  return (D + I8_CHUNK - 1) / I8_CHUNK * I8_CHUNK;
}

// Offset of the ring, of its 2 * I8_STAGES mbarriers, and of B4's score
// tile in an int8 kernel's dynamic shared memory; its size with and without
// the score tile.
__host__ __device__ constexpr int int8_ring_offset(int D) { return QG * int8_qrow_bytes(D); }
__host__ __device__ constexpr int int8_bar_offset(int D) {
  return int8_ring_offset(D) + I8_STAGES * I8_STAGE_BYTES;
}
__host__ __device__ constexpr int int8_ss_offset(int D) {
  return int8_bar_offset(D) + 2 * I8_STAGES * 8;
}
__host__ __device__ constexpr int int8_smem_bytes(int D, bool score_tile) {
  return int8_ss_offset(D) + (score_tile ? QG * SS_LD8 * 4 : 0);
}

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

// Shared memory a kernel asks for beyond 48 KB must be opted into (on the
// current device, before each launch: it is cheap). The carveout asks for
// the largest shared-memory split of L1, so as many CTAs fit as the
// occupancy calculator counts.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// ---------------------------------------------------------------------------
// int8 tile
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 accumulate (exact).
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte column v of row r in rows of rb bytes (rb a
// multiple of 128), XOR-swizzled by the row's low 3 bits.
__device__ __forceinline__ unsigned swz(int r, int v, int rb) {
  return (unsigned)(r * rb + ((v ^ (r & 7)) << 4));
}

// One thread's share of the ring's copies: the CTA's chunks in order (tile
// by tile, 128-byte depth chunk by chunk), 4 vectors a chunk (rows row0,
// row0 + 32, row0 + 64, row0 + 96 of the tile, 16-byte column `part`). A
// copy past N or D moves 0 bytes and zero-fills.
struct Int8Copies {
  const char* base;  // a valid address: the source of 0-byte copies
  const char* row;   // this thread's first row of the tile being copied, depth 0
  int64_t row_step;  // bytes from one of this thread's rows to the next (32 rows)
  int64_t tile_step;
  int D;
  int rows_left;     // corpus rows from this thread's first row of the tile on
  int dbytes;        // depth of the next chunk
  int part;
  int dc, cpt;       // depth chunk of the next copy, chunks a tile
  int stage;         // ring stage of the next copy
  unsigned smem;     // this thread's first vector in stage 0 (shared space)

  __device__ __forceinline__ Int8Copies(const int8_t* corpus, int N, int D_, int tile_lo,
                                        unsigned ring) {
    const int tid = threadIdx.x;
    const int row0 = tid >> 3;
    base = reinterpret_cast<const char*>(corpus);
    D = D_;
    part = tid & 7;
    row_step = (int64_t)32 * D;
    tile_step = (int64_t)NT * D;
    row = base + ((int64_t)tile_lo * NT + row0) * D;
    rows_left = N - tile_lo * NT - row0;
    dbytes = 0;
    dc = 0;
    cpt = (D + I8_CHUNK - 1) / I8_CHUNK;
    stage = 0;
    smem = ring + swz(row0, part, I8_CHUNK);  // rows row0 + 32 * it share its swizzle
  }

  // Copy the next chunk into its stage; `full` (stage 0's "full" mbarrier;
  // stage s's is 8 * s bytes on) gets this thread's arrival when they land.
  __device__ __forceinline__ void next(unsigned full) {
    const unsigned s = smem + stage * I8_STAGE_BYTES;
    const bool d_ok = dbytes + part * 16 < D;
    const char* src = row + dbytes + part * 16;
#pragma unroll
    for (int it = 0; it < NT / 32; ++it) {
      const bool ok = d_ok && rows_left > it * 32;
      asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                       s + it * 32 * I8_CHUNK),
                   "l"(ok ? src + it * row_step : base), "r"(ok ? 16 : 0));
    }
    mbar_arrive_copies(full + 8 * stage);
    if (++dc == cpt) {
      dc = 0;
      dbytes = 0;
      row += tile_step;
      rows_left -= NT;
    } else {
      dbytes += I8_CHUNK;
    }
    stage = stage == I8_STAGES - 1 ? 0 : stage + 1;
  }
};

// One ring stage's products into this warp's accumulators: ksteps (1-4)
// 32-byte depth steps from depth d0. acc[nb][i] is row 16 * warp + g +
// 8 * (i >> 1) of the tile against query 8 * nb + 2 * t + (i & 1), with
// g = lane >> 2, t = lane & 3 (the m16n8 C fragment).
__device__ __forceinline__ void int8_chunk(unsigned stage, unsigned qs, int qrow, int d0,
                                           int ksteps, int (&acc)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // A: lanes 0-15 address rows 0-15 at the step's first 16 bytes, lanes
  // 16-31 the same rows 16 bytes on (a0..a3 of the fragment)
  const int arow = warp * 16 + (lane & 15);
  // B: matrix m = lane >> 3 holds queries 8 * (m >> 1) .. + 7 at 16-byte
  // column (m & 1) of the step: b0, b1 of n8 block 0, then of block 1
  const int bq = ((lane >> 4) << 3) + (lane & 7);
  const int bsub = (lane >> 3) & 1;
#pragma unroll
  for (int ks = 0; ks < I8_CHUNK / 32; ++ks) {
    if (ks < ksteps) {
      unsigned a[4], b[8];
      ldsm_x4(stage + swz(arow, 2 * ks + (lane >> 4), I8_CHUNK), a[0], a[1], a[2], a[3]);
      const int vb = (d0 >> 4) + 2 * ks + bsub;
      ldsm_x4(qs + swz(bq, vb, qrow), b[0], b[1], b[2], b[3]);
      ldsm_x4(qs + swz(bq + 16, vb, qrow), b[4], b[5], b[6], b[7]);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) mma_s8(acc[nb], a, b[2 * nb], b[2 * nb + 1]);
    }
  }
}

// Score tiles tile_lo .. tile_hi - 1 (128 rows each) of a (N, D) int8
// corpus against int8 queries q_base .. q_base + 31 of the (B, D) q, on s8
// tensor cores; D % 16 == 0, D <= I8_MAX_D, both 16-byte aligned. After
// each tile, all threads call epilogue(acc, sc, n0): acc as int8_chunk
// leaves it (exact int32 dots; rows past N, queries past B and depth past D
// read as 0), sc[h] = scales[n0 + 16 * warp + g + 8 * h] (0 past N, or
// without scales). `smem` holds int8_smem_bytes(D, ...) of dynamic shared
// memory, 16-byte aligned.
template <typename Epilogue>
__device__ __forceinline__ void int8_scan(const int8_t* __restrict__ q,
                                          const int8_t* __restrict__ corpus,
                                          const float* __restrict__ scales, int B, int N,
                                          int D, int q_base, int tile_lo, int tile_hi,
                                          unsigned char* smem, Epilogue&& epilogue) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qrow = int8_qrow_bytes(D);
  const unsigned qs = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned ring = qs + int8_ring_offset(D);
  const unsigned full = qs + int8_bar_offset(D);
  const unsigned empty = full + 8 * I8_STAGES;
  if (tid == 0) {
    for (int s = 0; s < I8_STAGES; ++s) {
      mbar_init(full + 8 * s, THREADS);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
  }
  // the (32, D) query block, once: 16-byte column v of query b at swz(b, v)
  const char* qb = reinterpret_cast<const char*>(q);
  const int qv = qrow / 16;
  for (int e = tid; e < QG * qv; e += THREADS) {
    const int b = e / qv;
    const int v = e - b * qv;
    const bool ok = q_base + b < B && v * 16 < D;
    cp_async16(qs + swz(b, v, qrow), ok ? qb + (int64_t)(q_base + b) * D + v * 16 : qb, ok);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int cpt = (D + I8_CHUNK - 1) / I8_CHUNK;
  const int total = (tile_hi - tile_lo) * cpt;
  Int8Copies copies(corpus, N, D, tile_lo, ring);
  for (int s = 0; s < I8_STAGES - 1 && s < total; ++s) copies.next(full);
  int c = 0;      // chunks done
  int stage = 0;  // stage of chunk c
  int phase = 0;  // parity of chunk c's use of its stage
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int n0 = tile * NT;
    float sc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + warp * 16 + (lane >> 2) + 8 * h;
      sc[h] = scales != nullptr && n < N ? scales[n] : 0.f;  // lands during the chunks
    }
    int acc[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nb][i] = 0;
    for (int dc = 0; dc < cpt; ++dc, ++c) {
      // chunk c + 3 refills the stage of chunk c - 1 once every warp is done
      // with it; chunks c + 1 and c + 2 are in flight meanwhile
      const int prev = stage == 0 ? I8_STAGES - 1 : stage - 1;
      const int prev_phase = stage == 0 ? phase ^ 1 : phase;
      mbar_wait(full + 8 * stage, phase);
      const int left = D - dc * I8_CHUNK;
      int8_chunk(ring + stage * I8_STAGE_BYTES, qs, qrow, dc * I8_CHUNK,
                 left >= I8_CHUNK ? I8_CHUNK / 32 : (left + 31) / 32, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (c + I8_STAGES - 1 < total) {
        if (c > 0) mbar_wait(empty + 8 * prev, prev_phase);
        copies.next(full);
      }
      if (++stage == I8_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    epilogue(acc, sc, n0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The C fragment's coordinates: acc[nb][i] is tile row int8_row(i), query
// int8_query(nb, i) of the CTA's 32.
__device__ __forceinline__ int int8_row(int i) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int int8_query(int nb, int i) {
  return nb * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

// CTAs an SM, registers and local (stack) bytes a thread, and dynamic shared
// bytes of an int8-tile kernel at depth D, from the occupancy calculator:
// out[0..3]. Returns a cudaError_t.
template <typename Kernel>
inline int int8_kernel_info(Kernel kernel, int smem, int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, THREADS, smem);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = smem;
  return (int)err;
}

// ---------------------------------------------------------------------------
// Selection
// ---------------------------------------------------------------------------

// (s1, i1) ranks before (s2, i2): higher score, then lower index.
__device__ __forceinline__ bool ranks_before(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// The running lists of a warp's 4 queries (warp * 4 + j): k <= LIST_MAX
// entries, entry `lane` of query j's list in s[j] / i[j], in registers for
// the CTA's whole span, and each list's k-th score in thr[j].
struct WarpLists {
  float thr[4];
  float s[4];
  int i[4];

  // Start the lists empty.
  __device__ __forceinline__ WarpLists() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      thr[j] = -INFINITY;
      s[j] = -INFINITY;
      i[j] = INT_MAX;
    }
  }

  // Write the lists to the CTA's slot of the (B, gridDim.x, k) candidates.
  __device__ __forceinline__ void finish(int q_base, int B, int k, float* __restrict__ cand_s,
                                         int* __restrict__ cand_i) {
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

// Merge one query's tile row (the W scores of rows n0 .. n0 + W - 1, from
// row n0 + 32 * c0 on) into its running list (entry `lane` in top_s /
// top_i, k entries), whose k-th score is thr. Called by a whole warp.
template <int W>
__device__ __forceinline__ void merge_row(const float* srow, int n0, int k, int lane, int c0,
                                          float& top_s, int& top_i, float& thr) {
  for (int c = c0; c < W / 32; ++c) {
    const float s = srow[c * 32 + lane];
    unsigned cand = __ballot_sync(FULL, s > thr);
    while (cand) {  // lowest lane first = increasing corpus index
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      const float sv = __shfl_sync(FULL, s, src);
      if (!(sv > thr)) continue;  // warp-uniform
      // insert after every held entry scoring >= sv (those hold lower indices)
      const int pos = __popc(__ballot_sync(FULL, lane < k && top_s >= sv));
      // shift entries pos .. k - 2 up by one
      const float up_s = __shfl_up_sync(FULL, top_s, 1);
      const int up_i = __shfl_up_sync(FULL, top_i, 1);
      if (lane == pos) {
        top_s = sv;
        top_i = n0 + c * 32 + src;
      } else if (lane > pos && lane < k) {
        top_s = up_s;
        top_i = up_i;
      }
      thr = __shfl_sync(FULL, top_s, k - 1);
    }
  }
}

// Merge a (QG, W) score tile (rows LD floats apart) into this warp's 4
// lists. A row is merged from its first 32 scores that hold one above the
// list's k-th, and skipped when none does.
template <int W, int LD = W>
__device__ __forceinline__ void merge_tile(const float (*Ss)[LD], int q_base, int B, int n0,
                                           int k, WarpLists& lists) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int bl = warp * 4 + j;
    if (q_base + bl >= B) continue;  // warp-uniform
    int c0 = 0;
    while (c0 < W / 32 && !__any_sync(FULL, Ss[bl][c0 * 32 + lane] > lists.thr[j])) ++c0;
    if (c0 == W / 32) continue;
    merge_row<W>(Ss[bl], n0, k, lane, c0, lists.s[j], lists.i[j], lists.thr[j]);
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
  __shared__ float buf_s[2][MERGE_GROUP * LIST_MAX];
  __shared__ int buf_i[2][MERGE_GROUP * LIST_MAX];
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
