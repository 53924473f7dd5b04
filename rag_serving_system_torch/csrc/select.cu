// Exact top-k of each row of a (B, L) f32 score matrix, for k beyond the warp
// lists of B1 and B4: a digit search that stops as soon as a row's candidate
// list is short, a select over the candidates, then a bitonic sort of the k
// survivors.
//
// Replaces: the selection of rag_serving_system_tpu/ops/topk.py:_topk_kernel
// and :_topk_kernel_int8 (k rounds of max, first-index argmax and mask, with
// no cap on k) where the port's warp lists stop. The scores come from the
// same score tiles as B1 and B4 (topk.cu, topk_int8.cu: rag_score_rows*),
// bit-identical to the scores those kernels rank.
//
// Semantics: the k largest scores of a row, ordered by (score desc, position
// asc), so equal scores keep the lower position first, as a stable
// descending sort does (ops/topk.py:stable_topk). -0.0 and +0.0 are equal.
//
// What bounds it: bytes. One read of the scores is 4 * B * L bytes (0.040
// ms for (32, 1,048,576) at 3.35 TB/s). A row whose k-th key falls in an
// uncrowded bin is read twice; the first version (four radix digit passes,
// a count and a compaction over the full rows) read every row six times and
// took 0.589 ms on that shape at k = 1024 (NVIDIA H100 80GB HBM3, 700 W,
// nvidia-smi), against torch.topk's 0.512. On the same card this design
// takes 0.20 ms on normal scores, 0.28 on a crowded bin and 0.32 with
// every score equal, over four runs (torch.topk 0.49-0.52 on each).
// Of the 0.20 ms, the level-0 count is 54 us of device time (2.5 TB/s),
// the write pass 81 us, the candidate select 10 us and the sort 16 us
// (profile_topk's trace; PERF.md). ptxas: count 48 registers a thread, write 64,
// candidate select 64, find 32 with 8 bytes spilled, no other spills.
//
// Design (the candidate filter of AIR Top-K, Zhang et al., SC 2023), on the
// order-preserving 32-bit key of each score (sign set: flip every bit, else
// flip the sign bit), split into three digits of 12, 10 and 10 bits:
// 1. Level 0, one read (count_kernel): each of G slices of a row counts its
//    keys by their top 12 bits (4096 bins in shared memory; a warp whose 32
//    keys share a bin, as crowded scores do, adds them at once) into global
//    scratch, (B, G, 4096). One CTA a row (find_kernel) finds from the top
//    the bin holding the k-th key. The candidates are the keys at or above
//    that bin's lower edge; each slice's count of them is kept.
// 2. If a row has at most CAND_CAP = 65,536 candidates, its search stops
//    there. A crowded bin (served cosine scores crowd into a few exponent
//    bins; a row of one value puts every key in one) continues with
//    full-row passes of the next digits (levels 1 and 2, 10 bits each, over
//    the keys in the bin found so far), one read each, until its candidates
//    fit or the k-th key is fully known. Rows that stopped skip them.
// 3. The write pass, one read (write_kernel): a row that stopped writes
//    every candidate, with its position, into its candidate list (B,
//    min(L, CAND_CAP)), in position order (ballots in each warp that holds
//    one, then a scan of the warps' counts, over each 8,192-score tile
//    that holds one; the earlier slices' counts give each slice's offset). A row whose k-th key is known and still
//    has too many candidates (ties at the k-th key) writes its k survivors
//    straight to the sort buffer: every key above the k-th and the first r
//    equal to it, r from the digit search.
// 4. Over the candidates only (cand_select_kernel, one CTA a row; in shared
//    memory when they number 16,384 or fewer): the digits the row's search
//    left, then the same ordered compaction to exactly k survivors.
// 5. The survivors (key, position), padded with sentinels to P = 2^m >= k,
//    are sorted by a bitonic network: in shared memory for tiles of 4096, in
//    global memory for the steps that span tiles. A gather writes each
//    survivor's score (the input's bits) and index (position + base, or
//    indices[position] when given).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int SEL_THREADS = 1024;               // find and candidate-select CTAs
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_U = 16;                       // entries a thread per tile
constexpr int WARP_SPAN = 32 * SEL_U;           // contiguous positions a warp per tile
constexpr int SEL_TILE = SEL_THREADS * SEL_U;   // 16,384
constexpr int PASS_THREADS = 512;               // full-row pass CTAs: two an SM
constexpr int PASS_TILE = PASS_THREADS * SEL_U;  // 8,192
constexpr int BINS = 4096;                      // level 0's digit: the key's top 12 bits
constexpr int DIGITS = 1024;                    // levels 1 and 2: 10 bits each
constexpr int LEVELS = 3;
constexpr int CAND_CAP = 65536;                 // candidates a row may stop its search at
constexpr int CAND_SMEM = 16384;                // candidates a row held in shared memory
constexpr int SORT_TILE = 4096;                 // entries sorted in shared memory
constexpr int SORT_THREADS = 1024;
constexpr unsigned FULL_MASK = 0xffffffffu;

static_assert(DIGITS == SEL_THREADS, "a level-1/2 digit a thread");
static_assert(BINS == 4 * SEL_THREADS, "four level-0 bins a thread");

// The low bit of each level's digit in the key, and its number of values.
__device__ __forceinline__ int level_shift(int level) {
  return level == 0 ? 20 : level == 1 ? 10 : 0;
}
__device__ __forceinline__ int level_bins(int level) { return level == 0 ? BINS : DIGITS; }

// Larger score, larger key; -0.0 and +0.0 share the key of +0.0.
__device__ __forceinline__ unsigned score_key(float x) {
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (ka, pa) ranks before (kb, pb): higher key, then lower position.
__device__ __forceinline__ bool ranks_first(unsigned ka, int pa, unsigned kb, int pb) {
  return ka > kb || (ka == kb && pa < pb);
}

// The tile position of this thread's entry u: warp-major, so warp w owns
// positions w * WARP_SPAN .. + WARP_SPAN - 1 in order (u, lane), and each
// warp-wide access of an entry touches 128 contiguous bytes of scores.
__device__ __forceinline__ int tile_pos(int u) {
  return (int)(threadIdx.x >> 5) * WARP_SPAN + u * 32 + (int)(threadIdx.x & 31);
}

// Loads of one tile from position t0: SEL_U in flight a thread.
__device__ __forceinline__ void load_tile(const float* __restrict__ row, int L, int t0,
                                          float (&v)[SEL_U]) {
#pragma unroll
  for (int u = 0; u < SEL_U; ++u) {
    const int i = t0 + tile_pos(u);
    v[u] = i < L ? row[i] : 0.f;
  }
}

enum Mode : unsigned { SEARCHING = 0, CANDIDATES = 1, SURVIVORS = 2 };

// Per-row state in global scratch. The digits found so far are `prefix`
// under `mask`; the keys matching them are the row's region, and rem is the
// k-th key's rank among them. cands: keys at or above the region's lower
// edge (`prefix`); level: the last level searched.
struct SelState {
  unsigned prefix, mask, rem, cands, mode, level, pad0, pad1;
};

// The int32 scratch of rag_select_topk: (B, G, BINS) slice counts, B states
// of 8 words, then three (B, G) arrays of slice counts and offsets:
// B * (G * BINS + 8 + 3 * G) words.
struct Scratch {
  unsigned* hist;
  SelState* state;
  unsigned* above;    // a slice's keys above the region
  unsigned* start_a;  // a slice's offset: among the candidates, or the keys above the k-th
  unsigned* start_e;  // a slice's keys in the region; then its offset among the k-th's equals
};

// Exclusive scan of v over the block's threads in thread order; `wsum`
// holds SEL_WARPS words of shared memory.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = wsum[lane];
    unsigned wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned n = __shfl_up_sync(FULL_MASK, wi, o);
      if (lane >= o) wi += n;
    }
    wsum[lane] = wi - w;
  }
  __syncthreads();
  const unsigned r = wsum[warp] + incl - v;
  __syncthreads();  // wsum is rewritten by the next call
  return r;
}

// Position-ordered offsets in one tile (blockDim.x * SEL_U entries at
// tile_pos) of two flag sets, packed a | b << 16 (a tile holds at most
// 16,384 of each): bit u of fa / fb flags entry u. before[u] gets the
// flagged entries of this warp before entry u (set only in a warp that
// holds a flag), excl those of the earlier warps; returns the tile's totals.
// A ballot a flag set and entry in a warp that holds a flag, one scan of
// the warps' totals, two block barriers; `wtot` holds a word a warp of
// shared memory.
__device__ __forceinline__ unsigned tile_offsets(unsigned fa, unsigned fb, unsigned* wtot,
                                                 unsigned& excl, unsigned (&before)[SEL_U]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned run = 0;
  if (__any_sync(FULL_MASK, fa | fb)) {
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      const unsigned a = __ballot_sync(FULL_MASK, (fa >> u) & 1u);
      const unsigned b = __ballot_sync(FULL_MASK, (fb >> u) & 1u);
      before[u] = run + __popc(a & below) + (__popc(b & below) << 16);
      run += __popc(a) + (__popc(b) << 16);
    }
  }
  if (lane == 0) wtot[warp] = run;
  __syncthreads();
  const unsigned x = lane < (int)(blockDim.x >> 5) ? wtot[lane] : 0u;
  unsigned incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  excl = __shfl_sync(FULL_MASK, incl - x, warp);
  const unsigned total = __shfl_sync(FULL_MASK, incl, 31);
  __syncthreads();  // wtot is rewritten by the next tile
  return total;
}

// h[bin] += 1 for each lane with `in`. A warp whose lanes all share one bin
// (crowded scores) adds 32 at once; otherwise each lane adds its own. (Warp
// aggregation by __match_any_sync cost level 0 5.8x its byte bound on
// spread scores: its time grows with the distinct values a warp holds.)
__device__ __forceinline__ void count_bin(unsigned* h, unsigned bin, bool in) {
  const unsigned first = __shfl_sync(FULL_MASK, bin, 0);
  if (__all_sync(FULL_MASK, in && bin == first)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&h[bin], 32u);
  } else if (in) {
    atomicAdd(&h[bin], 1u);
  }
}

// One level's full-row pass over slice blockIdx.x (span scores) of row
// blockIdx.y: the count of the region's keys by this level's digit, into
// hist (B, G, BINS). Rows whose search has stopped skip it.
__global__ void __launch_bounds__(PASS_THREADS, 2)
count_kernel(const float* __restrict__ scores, int64_t ld, int L, int span, Scratch s,
             int level) {
  __shared__ unsigned h[BINS];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  unsigned prefix = 0, mask = 0;
  if (level > 0) {
    const SelState st = s.state[b];
    if (st.mode != SEARCHING) return;
    prefix = st.prefix;
    mask = st.mask;
  }
  const int shift = level_shift(level);
  const int bins = level_bins(level);
  const int lo = blockIdx.x * span;
  const int n = min(L, lo + span) - lo;
  const float* row = scores + b * ld + lo;
  for (int d = tid; d < bins; d += PASS_THREADS) h[d] = 0;
  __syncthreads();
  for (int t0 = 0; t0 < n; t0 += PASS_TILE) {
    float v[SEL_U];
    load_tile(row, n, t0, v);
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      const unsigned key = score_key(v[u]);
      count_bin(h, (key >> shift) & (bins - 1),
                t0 + tile_pos(u) < n && (key & mask) == prefix);
    }
  }
  __syncthreads();
  unsigned* out = s.hist + ((int64_t)b * gridDim.x + blockIdx.x) * BINS;
  for (int d = tid; d < bins; d += PASS_THREADS) out[d] = h[d];
}

// One CTA a row, after a level's count: the digit holding the k-th key
// (from the top) narrows the region; each slice's keys above the new region
// and in it; and the row's mode. A row stops (CANDIDATES) once its keys at or
// above the region's lower edge number CAND_CAP or fewer, with each slice's
// offset among them; at the last level a row that has not stopped takes its
// survivors from the scores (SURVIVORS), with each slice's offsets among the
// keys above the k-th and among its equals.
__global__ void __launch_bounds__(SEL_THREADS)
find_kernel(Scratch s, int G, int k, int level) {
  __shared__ unsigned wsum[SEL_WARPS];
  __shared__ unsigned s_digit, s_rem, s_cnt[SEL_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  SelState st{0u, 0u, (unsigned)k, 0u, SEARCHING, 0u, 0u, 0u};
  if (level > 0) {
    st = s.state[b];
    if (st.mode != SEARCHING) return;
  }
  const int shift = level_shift(level);
  const int bins = level_bins(level);
  const int per = bins / SEL_THREADS;  // digits a thread: 4 or 1
  const unsigned* hb = s.hist + (int64_t)b * G * BINS;
  // thread t sums digits bins - 1 - per * t - j over the slices
  unsigned c[4] = {0, 0, 0, 0};
#pragma unroll 4
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < per) c[j] += hb[(int64_t)g * BINS + bins - 1 - per * tid - j];
  }
  const unsigned sum = c[0] + c[1] + c[2] + c[3];
  unsigned cum = block_exclusive_scan(sum, wsum);
  if (cum < st.rem && st.rem <= cum + sum) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < per && cum < st.rem && st.rem <= cum + c[j]) {
        s_digit = bins - 1 - per * tid - j;
        s_rem = st.rem - cum;
      }
      cum += c[j];
    }
  }
  __syncthreads();
  const unsigned digit = s_digit;
  // each slice's keys above the new region (the earlier levels' and this
  // level's higher digits) and in it, 32 slices at a time (a warp each)
  unsigned cands = 0;
  for (int g0 = 0; g0 < G; g0 += SEL_WARPS) {
    const int g = g0 + warp;
    unsigned above = 0, in = 0;
    if (g < G) {
      const unsigned* hg = hb + (int64_t)g * BINS;
#pragma unroll 8
      for (int d = (int)digit + 1 + lane; d < bins; d += 32) above += hg[d];
      if (lane == 0) in = hg[digit];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      above += __shfl_xor_sync(FULL_MASK, above, o);
      in += __shfl_xor_sync(FULL_MASK, in, o);
    }
    if (g < G && lane == 0) {
      const int64_t o = (int64_t)b * G + g;
      above += level > 0 ? s.above[o] : 0u;
      s.above[o] = above;
      s.start_e[o] = in;
      s_cnt[warp] = above + in;
    } else if (lane == 0) {
      s_cnt[warp] = 0;
    }
    __syncthreads();
    if (warp == 0) {
      unsigned x = s_cnt[lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
      cands += x;
    }
    __syncthreads();  // s_cnt is rewritten
  }
  if (warp != 0) return;
  st.prefix |= digit << shift;
  st.mask |= (unsigned)(bins - 1) << shift;
  st.rem = s_rem;
  st.cands = cands;
  st.level = level;
  st.mode = cands <= CAND_CAP ? CANDIDATES : level == LEVELS - 1 ? SURVIVORS : SEARCHING;
  if (st.mode != SEARCHING) {
    // exclusive scans over the slices in order: the candidates (keys above
    // the region and in it), or the keys above the k-th and its equals
    unsigned run_a = 0, run_e = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const int64_t o = (int64_t)b * G + g;
      unsigned a = 0, e = 0;
      if (g < G) {
        a = s.above[o];
        e = s.start_e[o];
        if (st.mode == CANDIDATES) {
          a += e;
          e = 0;
        }
      }
      unsigned ia = a, ie = e;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned ya = __shfl_up_sync(FULL_MASK, ia, d);
        const unsigned ye = __shfl_up_sync(FULL_MASK, ie, d);
        if (lane >= d) {
          ia += ya;
          ie += ye;
        }
      }
      if (g < G) {
        s.start_a[o] = run_a + ia - a;
        s.start_e[o] = run_e + ie - e;
      }
      run_a += __shfl_sync(FULL_MASK, ia, 31);
      run_e += __shfl_sync(FULL_MASK, ie, 31);
    }
  }
  if (lane == 0) s.state[b] = st;
}

// The write pass over slice blockIdx.x of row blockIdx.y. CANDIDATES: every
// key at or above the region's lower edge, with its position, into the
// row's candidate list (row stride cand_ld), from the slice's offset on, in
// position order. SURVIVORS: every key above the k-th and the first rem
// equal to it, into the sort buffer sk / sp (row stride P), a survivor's
// slot being (keys above the k-th before it) + min(equals before it, rem);
// slice 0 writes sentinels (key 0, position INT_MAX, below any score) into
// slots k .. P - 1.
__global__ void __launch_bounds__(PASS_THREADS, 2)
write_kernel(const float* __restrict__ scores, int64_t ld, int L, int span, Scratch s,
             unsigned* __restrict__ ck, int* __restrict__ cp, int cand_ld, int k, int P,
             unsigned* __restrict__ sk, int* __restrict__ sp) {
  __shared__ unsigned wtot[PASS_THREADS / 32];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const SelState st = s.state[b];
  const bool cand = st.mode == CANDIDATES;
  const int lo = blockIdx.x * span;
  const int n = min(L, lo + span) - lo;
  const float* row = scores + b * ld + lo;
  const int64_t o = (int64_t)b * gridDim.x + blockIdx.x;
  unsigned done_a = s.start_a[o];
  unsigned done_e = cand ? 0u : s.start_e[o];
  unsigned* out_k = cand ? ck + (int64_t)b * cand_ld : sk + (int64_t)b * P;
  int* out_p = cand ? cp + (int64_t)b * cand_ld : sp + (int64_t)b * P;
  for (int t0 = 0; t0 < n; t0 += PASS_TILE) {
    float v[SEL_U];
    load_tile(row, n, t0, v);
    unsigned key[SEL_U];
    unsigned fa = 0, fe = 0;
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      key[u] = score_key(v[u]);
      if (t0 + tile_pos(u) < n) {
        fa |= (cand ? key[u] >= st.prefix : key[u] > st.prefix) ? 1u << u : 0u;
        fe |= !cand && key[u] == st.prefix ? 1u << u : 0u;
      }
    }
    if (!__syncthreads_or(fa | fe)) continue;  // nothing to write in the tile: no scan
    unsigned before[SEL_U], excl;
    const unsigned total = tile_offsets(fa, fe, wtot, excl, before);
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      if (!(((fa | fe) >> u) & 1u)) continue;
      const unsigned at = excl + before[u];
      const unsigned ab = done_a + (at & 0xffffu);
      const unsigned eb = done_e + (at >> 16);
      if (((fa >> u) & 1u) || eb < st.rem) {
        const unsigned slot = cand ? ab : ab + min(eb, st.rem);
        out_k[slot] = key[u];
        out_p[slot] = lo + t0 + tile_pos(u);
      }
    }
    done_a += total & 0xffffu;
    done_e += total >> 16;
  }
  if (!cand && blockIdx.x == 0) {
    for (int p = k + tid; p < P; p += PASS_THREADS) {
      out_k[p] = 0u;
      out_p[p] = INT_MAX;
    }
  }
}

// One CTA a row that stopped at CANDIDATES, over its candidate list only (in
// shared memory when it holds CAND_SMEM or fewer): the digits its search
// left fix the k-th key and r, the number of keys equal to it that are
// taken; then every key above it and the first r equal to it are written,
// in position order, to slots 0 .. k - 1 of sk / sp (row stride P), and
// sentinels to slots k .. P - 1, as write_kernel's SURVIVORS do.
__global__ void __launch_bounds__(SEL_THREADS)
cand_select_kernel(const SelState* __restrict__ state, const unsigned* __restrict__ ck,
                   const int* __restrict__ cp, int cand_ld, int k, int P,
                   unsigned* __restrict__ sk, int* __restrict__ sp) {
  extern __shared__ unsigned cand[];  // CAND_SMEM keys, then CAND_SMEM positions
  __shared__ unsigned h[DIGITS];
  __shared__ unsigned wsum[SEL_WARPS];
  __shared__ unsigned s_digit, s_rem;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const SelState st = state[b];
  if (st.mode != CANDIDATES) return;
  const int n = (int)st.cands;
  const unsigned* keys = ck + (int64_t)b * cand_ld;
  const int* pos = cp + (int64_t)b * cand_ld;
  if (n <= CAND_SMEM) {
    int* spos = reinterpret_cast<int*>(cand + CAND_SMEM);
    for (int i = tid; i < n; i += SEL_THREADS) {
      cand[i] = keys[i];
      spos[i] = pos[i];
    }
    keys = cand;
    pos = spos;
    __syncthreads();
  }
  unsigned prefix = st.prefix, mask = st.mask, rem = st.rem;
  for (int level = (int)st.level + 1; level < LEVELS; ++level) {
    const int shift = level_shift(level);
    h[tid] = 0;
    __syncthreads();
    for (int t0 = 0; t0 < n; t0 += SEL_TILE) {  // SEL_U loads in flight a thread
      unsigned key[SEL_U];
#pragma unroll
      for (int u = 0; u < SEL_U; ++u) {
        const int i = t0 + tile_pos(u);
        key[u] = i < n ? keys[i] : 0u;
      }
#pragma unroll
      for (int u = 0; u < SEL_U; ++u)
        count_bin(h, (key[u] >> shift) & (DIGITS - 1),
                  t0 + tile_pos(u) < n && (key[u] & mask) == prefix);
    }
    __syncthreads();
    // from the top: thread t holds digit DIGITS - 1 - t
    const unsigned c = h[DIGITS - 1 - tid];
    const unsigned cum = block_exclusive_scan(c, wsum);
    if (cum < rem && rem <= cum + c) {
      s_digit = DIGITS - 1 - tid;
      s_rem = rem - cum;
    }
    __syncthreads();
    prefix |= s_digit << shift;
    mask |= (unsigned)(DIGITS - 1) << shift;
    rem = s_rem;
    __syncthreads();  // h, s_digit and s_rem are rewritten by the next level
  }
  const unsigned kth = prefix;
  unsigned* out_k = sk + (int64_t)b * P;
  int* out_p = sp + (int64_t)b * P;
  unsigned done_g = 0, done_e = 0;  // survivors above and equal before this tile
  for (int t0 = 0; t0 < n; t0 += SEL_TILE) {
    unsigned key[SEL_U];
    unsigned fg = 0, fe = 0;
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      const int i = t0 + tile_pos(u);
      key[u] = i < n ? keys[i] : 0u;
      if (i < n) {
        fg |= (key[u] > kth ? 1u : 0u) << u;
        fe |= (key[u] == kth ? 1u : 0u) << u;
      }
    }
    unsigned before[SEL_U], excl;
    const unsigned total = tile_offsets(fg, fe, wsum, excl, before);
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      if (!(((fg | fe) >> u) & 1u)) continue;
      const unsigned at = excl + before[u];
      const unsigned gb = done_g + (at & 0xffffu);
      const unsigned eb = done_e + (at >> 16);
      if (((fg >> u) & 1u) || eb < rem) {
        const unsigned slot = gb + min(eb, rem);
        out_k[slot] = key[u];
        out_p[slot] = pos[t0 + tile_pos(u)];
      }
    }
    done_g += total & 0xffffu;
    done_e += total >> 16;
  }
  for (int p = k + tid; p < P; p += SEL_THREADS) {
    out_k[p] = 0u;
    out_p[p] = INT_MAX;
  }
}

// Bitonic steps inside tiles of min(P, SORT_TILE) entries (grid: tiles x
// rows): for kk = kk_begin .. kk_end (doubling), j from j_begin (first kk) or
// kk / 2 down to 1. A block of kk entries runs in rank order when bit kk of
// its first position is 0, so the last block (kk = P) ends in rank order.
__global__ void __launch_bounds__(SORT_THREADS)
bitonic_tile_kernel(unsigned* __restrict__ sk, int* __restrict__ sp, int P, int kk_begin,
                    int kk_end, int j_begin) {
  __shared__ unsigned ks[SORT_TILE];
  __shared__ int ps[SORT_TILE];
  const int ts = min(P, SORT_TILE);
  const int t0 = blockIdx.x * ts;
  unsigned* rk = sk + (int64_t)blockIdx.y * P + t0;
  int* rp = sp + (int64_t)blockIdx.y * P + t0;
  for (int i = threadIdx.x; i < ts; i += SORT_THREADS) {
    ks[i] = rk[i];
    ps[i] = rp[i];
  }
  __syncthreads();
  for (int kk = kk_begin; kk <= kk_end; kk <<= 1) {
    for (int j = kk == kk_begin ? j_begin : kk >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < ts / 2; p += SORT_THREADS) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i + j;
        const bool up = ((t0 + i) & kk) == 0;
        const unsigned ka = ks[i], kb = ks[l];
        const int pa = ps[i], pb = ps[l];
        if (up ? ranks_first(kb, pb, ka, pa) : ranks_first(ka, pa, kb, pb)) {
          ks[i] = kb;
          ks[l] = ka;
          ps[i] = pb;
          ps[l] = pa;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < ts; i += SORT_THREADS) {
    rk[i] = ks[i];
    rp[i] = ps[i];
  }
}

// One bitonic step (kk, j >= SORT_TILE) across tiles, in global memory: one
// thread a pair, over rows x P / 2 pairs.
__global__ void bitonic_step_kernel(unsigned* __restrict__ sk, int* __restrict__ sp, int B,
                                    int P, int kk, int j) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int half = P >> 1;
  if (t >= (int64_t)B * half) return;
  const int64_t r = t / half;
  const int p = (int)(t - r * half);
  const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  const int l = i + j;
  unsigned* rk = sk + r * P;
  int* rp = sp + r * P;
  const bool up = (i & kk) == 0;
  const unsigned ka = rk[i], kb = rk[l];
  const int pa = rp[i], pb = rp[l];
  if (up ? ranks_first(kb, pb, ka, pa) : ranks_first(ka, pa, kb, pb)) {
    rk[i] = kb;
    rk[l] = ka;
    rp[i] = pb;
    rp[l] = pa;
  }
}

// out_s / out_i (B, k): the score and index of each sorted survivor.
__global__ void select_gather_kernel(const float* __restrict__ scores,
                                     const int* __restrict__ indices, int64_t ld, int base,
                                     const int* __restrict__ sp, int B, int P, int k,
                                     float* __restrict__ out_s, int* __restrict__ out_i) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * k) return;
  const int64_t r = t / k;
  const int pos = sp[r * P + (t - r * k)];
  out_s[t] = scores[r * ld + pos];
  out_i[t] = indices != nullptr ? indices[r * ld + pos] : base + pos;
}

}  // namespace

// scores: (B, L) f32, row stride ld (>= L); indices: (B, L) i32 with the same
// stride, or null for index = base + position. 1 <= k <= L; P a power of two
// >= max(k, 2); G >= 1 CTAs a row in the passes over the scores; scratch:
// B * (G * 4096 + 8 + 3 * G) int32 words (no zeroing needed); ck / cp:
// (B, min(L, 65536)) u32 / i32 candidate lists; sk / sp: (B, P) u32 / i32
// scratch.
// out_s / out_i: (B, k), by (score desc, position asc).
extern "C" int rag_select_topk(const void* scores, const void* indices, int base, int B, int L,
                               int ld, int k, int P, int G, void* scratch, void* ck, void* cp,
                               void* sk, void* sp, void* out_s, void* out_i, void* stream) {
  if (B < 1 || L < 1 || ld < L || k < 1 || k > L || P < 2 || P < k || (P & (P - 1)) != 0 ||
      B > 65535 || G < 1 || G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scores);
  Scratch s;
  s.hist = static_cast<unsigned*>(scratch);
  s.state = reinterpret_cast<SelState*>(s.hist + (int64_t)B * G * BINS);
  s.above = reinterpret_cast<unsigned*>(s.state + B);
  s.start_a = s.above + (int64_t)B * G;
  s.start_e = s.start_a + (int64_t)B * G;
  unsigned* cand_k = static_cast<unsigned*>(ck);
  int* cand_p = static_cast<int*>(cp);
  unsigned* keys = static_cast<unsigned*>(sk);
  int* pos = static_cast<int*>(sp);
  const int span = (L + G - 1) / G;
  const int cand_ld = L < CAND_CAP ? L : CAND_CAP;  // a row's candidates never exceed L
  const dim3 slices(G, B);
  for (int level = 0; level < LEVELS; ++level) {
    count_kernel<<<slices, PASS_THREADS, 0, st>>>(sc, ld, L, span, s, level);
    find_kernel<<<B, SEL_THREADS, 0, st>>>(s, G, k, level);
  }
  write_kernel<<<slices, PASS_THREADS, 0, st>>>(sc, ld, L, span, s, cand_k, cand_p, cand_ld, k,
                                               P, keys, pos);
  constexpr int cand_smem = CAND_SMEM * 8;
  cudaError_t err = cudaFuncSetAttribute(
      cand_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cand_smem);
  if (err != cudaSuccess) return (int)err;
  cand_select_kernel<<<B, SEL_THREADS, cand_smem, st>>>(s.state, cand_k, cand_p, cand_ld, k, P,
                                                        keys, pos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ts = P < SORT_TILE ? P : SORT_TILE;
  bitonic_tile_kernel<<<dim3(P / ts, B), SORT_THREADS, 0, st>>>(keys, pos, P, 2, ts, 1);
  for (int kk = 2 * ts; kk <= P; kk <<= 1) {
    for (int j = kk >> 1; j >= ts; j >>= 1) {
      const int64_t pairs = (int64_t)B * (P >> 1);
      bitonic_step_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(keys, pos, B, P, kk,
                                                                          j);
    }
    bitonic_tile_kernel<<<dim3(P / ts, B), SORT_THREADS, 0, st>>>(keys, pos, P, kk, kk,
                                                                  ts >> 1);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)B * k;
  select_gather_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      sc, static_cast<const int*>(indices), ld, base, pos, B, P, k, static_cast<float*>(out_s),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
