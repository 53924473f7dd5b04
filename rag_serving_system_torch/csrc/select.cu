// Exact top-k of each row of a (B, L) f32 score matrix, for k beyond the warp
// lists of B1 and B4 (k > 256): a radix select, then a bitonic sort of the k
// survivors.
//
// Replaces: the selection of rag_serving_system_tpu/ops/topk.py:_topk_kernel
// and :_topk_kernel_int8 (k rounds of max, first-index argmax and mask, with
// no cap on k) where B1's and B4's running lists stop (32 * MAX_KR = 256).
// The scores come from the same score tiles as B1 and B4 (topk.cu,
// topk_int8.cu: rag_score_rows*), bit-identical to the scores those kernels
// rank.
//
// Semantics: the k largest scores of a row, ordered by (score desc, position
// asc), so equal scores keep the lower position first, as a stable
// descending sort does (ops/topk.py:stable_topk). -0.0 and +0.0 are equal.
//
// What bounds it: bytes. The scores are read 6 times (4 digit passes, a
// count and the compaction), 24 * B * L bytes, against 4 * B * L that one
// pass needs; each row is split into G slices of 1024-thread CTAs (enough
// CTAs for two an SM), one kernel a pass. The sort touches k entries only.
// (32, 1,048,576) scores at k = 1024 take 0.59 ms on an NVIDIA H100 80GB
// HBM3 at 700 W, against 0.04 ms for one read (PERF.md).
//
// Design:
// 1. The radix select, on the order-preserving 32-bit key of each score
//    (sign set: flip every bit, else flip the sign bit). Four passes of 8-bit
//    digit histograms (radix_hist_kernel: shared-memory counts,
//    warp-aggregated by __match_any_sync since scores crowd into a few
//    exponent bins, added into the row's global counts), each counting only
//    keys that match the digits found so far; then one warp a row
//    (radix_digit_kernel) finds, from the top, the bin that holds the k-th
//    key, which fixes the next digit. After four passes the k-th key and the
//    number r of keys equal to it that are taken are known. The compaction
//    counts each slice's keys above and equal to the k-th
//    (compact_count_kernel), then writes in position order every key above
//    the k-th and the first r equal to it (compact_write_kernel: the earlier
//    slices' counts, then a count and an exclusive scan over each
//    16,384-score tile), so exactly k survivors come out.
// 2. The survivors (key, position), padded with sentinels to P = 2^m >= k,
//    are sorted by a bitonic network: in shared memory for tiles of 4096, in
//    global memory for the steps that span tiles.
// 3. A gather writes each survivor's score (the input's bits) and index
//    (position + base, or indices[position] when given).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int SEL_THREADS = 1024;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_U = 16;                       // scores a thread per tile
constexpr int SEL_TILE = SEL_THREADS * SEL_U;   // 16,384
constexpr int SORT_TILE = 4096;                 // entries sorted in shared memory
constexpr int SORT_THREADS = 1024;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Larger score, larger key; -0.0 and +0.0 share the key of +0.0.
__device__ __forceinline__ unsigned score_key(float x) {
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (ka, pa) ranks before (kb, pb): higher key, then lower position.
__device__ __forceinline__ bool ranks_first(unsigned ka, int pa, unsigned kb, int pb) {
  return ka > kb || (ka == kb && pa < pb);
}

// Loads of one tile: score u of this thread is position t0 + u * 1024 + tid,
// so each warp-wide load reads 128 contiguous bytes and 16 are in flight.
__device__ __forceinline__ void load_tile(const float* __restrict__ row, int L, int t0,
                                          float (&v)[SEL_U]) {
#pragma unroll
  for (int u = 0; u < SEL_U; ++u) {
    const int i = t0 + u * SEL_THREADS + (int)threadIdx.x;
    v[u] = i < L ? row[i] : 0.f;
  }
}

// Per-row state of the select in global scratch: the digits of the k-th key
// found so far (prefix, under mask), and rem, the rank of the k-th key among
// the keys that match them.
struct SelState {
  unsigned prefix, mask, rem, pad;
};

// The scratch of rag_select_topk holds B states, then (B, 256) digit
// counts, then (B, G) counts of keys above and (B, G) equal to the k-th:
// B * (4 + 256 + 2 * G) int32 words.

// One digit pass over slice blockIdx.x (span scores) of row blockIdx.y: the
// 8-bit digit at `shift` of every key matching the row's prefix, counted in
// shared memory (warp-aggregated by __match_any_sync: scores crowd into a
// few exponent bins), then added to the row's global counts.
__global__ void __launch_bounds__(SEL_THREADS)
radix_hist_kernel(const float* __restrict__ scores, int64_t ld, int L, int span,
                  const SelState* __restrict__ state, unsigned* __restrict__ hist, int shift) {
  __shared__ unsigned h[256];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int lo = blockIdx.x * span;
  const int hi = min(L, lo + span);
  const float* row = scores + b * ld + lo;
  const unsigned prefix = state[b].prefix, mask = state[b].mask;
  for (int d = tid; d < 256; d += SEL_THREADS) h[d] = 0;
  __syncthreads();
  for (int t0 = 0; t0 < hi - lo; t0 += SEL_TILE) {
    float v[SEL_U];
    load_tile(row, hi - lo, t0, v);
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      const unsigned key = score_key(v[u]);
      const bool in = t0 + u * SEL_THREADS + tid < hi - lo && (key & mask) == prefix;
      const unsigned digit = in ? (key >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(FULL_MASK, digit);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&h[digit], __popc(peers));
    }
  }
  __syncthreads();
  for (int d = tid; d < 256; d += SEL_THREADS)
    if (h[d]) atomicAdd(&hist[b * 256 + d], h[d]);
}

// One warp a row: from the top, the bin holding the rem-th key (rem = k on
// the first pass) fixes the digit at `shift`; the counts are cleared for the
// next pass.
__global__ void radix_digit_kernel(SelState* __restrict__ state, unsigned* __restrict__ hist,
                                   int k, int shift) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  unsigned* hb = hist + b * 256;
  const unsigned rem = shift == 24 ? (unsigned)k : state[b].rem;
  // lane l holds bins 255 - 8l .. 248 - 8l
  unsigned c[8];
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = hb[255 - 8 * lane - j];
    hb[255 - 8 * lane - j] = 0;
    sum += c[j];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += n;
  }
  unsigned cum = incl - sum;
  if (cum < rem && rem <= incl) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (cum < rem && rem <= cum + c[j]) {
        state[b].prefix |= (unsigned)(255 - 8 * lane - j) << shift;
        state[b].mask |= 255u << shift;
        state[b].rem = rem - cum;
      }
      cum += c[j];
    }
  }
}

// Keys above the k-th and equal to it in slice blockIdx.x of row blockIdx.y.
__global__ void __launch_bounds__(SEL_THREADS)
compact_count_kernel(const float* __restrict__ scores, int64_t ld, int L, int span,
                     const SelState* __restrict__ state, unsigned* __restrict__ cnt_g,
                     unsigned* __restrict__ cnt_e) {
  __shared__ unsigned sg, se;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int lo = blockIdx.x * span;
  const int hi = min(L, lo + span);
  const float* row = scores + b * ld + lo;
  const unsigned kth = state[b].prefix;
  if (tid == 0) sg = se = 0;
  __syncthreads();
  unsigned g = 0, e = 0;
  for (int t0 = 0; t0 < hi - lo; t0 += SEL_TILE) {
    float v[SEL_U];
    load_tile(row, hi - lo, t0, v);
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      const unsigned key = score_key(v[u]);
      if (t0 + u * SEL_THREADS + tid < hi - lo) {
        g += key > kth;
        e += key == kth;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    g += __shfl_xor_sync(FULL_MASK, g, o);
    e += __shfl_xor_sync(FULL_MASK, e, o);
  }
  if ((tid & 31) == 0) {
    atomicAdd(&sg, g);
    atomicAdd(&se, e);
  }
  __syncthreads();
  if (tid == 0) {
    cnt_g[b * gridDim.x + blockIdx.x] = sg;
    cnt_e[b * gridDim.x + blockIdx.x] = se;
  }
}

// Slice blockIdx.x of row blockIdx.y: the (key, position) of every key above
// the k-th and of the first rem keys equal to it (rem from the state), in
// position order, into sk / sp (row stride P). A survivor's slot is (keys
// above it before it) + min(keys equal before it, rem): the earlier slices'
// counts, then a count and an exclusive scan over each 16,384-score tile.
// Slice 0 writes sentinels (key 0, position INT_MAX, below any score) into
// slots k .. P - 1.
__global__ void __launch_bounds__(SEL_THREADS)
compact_write_kernel(const float* __restrict__ scores, int64_t ld, int L, int span, int k,
                     int P, const SelState* __restrict__ state,
                     const unsigned* __restrict__ cnt_g, const unsigned* __restrict__ cnt_e,
                     unsigned* __restrict__ sk, int* __restrict__ sp) {
  __shared__ unsigned tot[SEL_U * SEL_WARPS];  // packed counts: above | equal << 16
  __shared__ unsigned s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int lo = blockIdx.x * span;
  const int hi = min(L, lo + span);
  const float* row = scores + b * ld + lo;
  const unsigned kth = state[b].prefix, rem = state[b].rem;
  unsigned done_g = 0, done_e = 0;  // survivors before this tile
  for (int s = 0; s < (int)blockIdx.x; ++s) {
    done_g += cnt_g[b * gridDim.x + s];
    done_e += cnt_e[b * gridDim.x + s];
  }
  unsigned* out_k = sk + (int64_t)b * P;
  int* out_p = sp + (int64_t)b * P;
  for (int t0 = 0; t0 < hi - lo; t0 += SEL_TILE) {
    float v[SEL_U];
    load_tile(row, hi - lo, t0, v);
    unsigned gm = 0, em = 0;
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      const unsigned key = score_key(v[u]);
      if (t0 + u * SEL_THREADS + tid < hi - lo) {
        gm |= (key > kth ? 1u : 0u) << u;
        em |= (key == kth ? 1u : 0u) << u;
      }
    }
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      const unsigned g = __ballot_sync(FULL_MASK, (gm >> u) & 1u);
      const unsigned e = __ballot_sync(FULL_MASK, (em >> u) & 1u);
      if (lane == 0) tot[u * SEL_WARPS + warp] = __popc(g) | (__popc(e) << 16);
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the 512 counts in position order (u, warp)
      constexpr int PER = SEL_U * SEL_WARPS / 32;
      unsigned c[PER];
      unsigned sum = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        c[j] = tot[lane * PER + j];
        sum += c[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned n = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += n;
      }
      unsigned run = incl - sum;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        tot[lane * PER + j] = run;
        run += c[j];
      }
      if (lane == 31) s_tile = incl;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int u = 0; u < SEL_U; ++u) {
      const unsigned g = __ballot_sync(FULL_MASK, (gm >> u) & 1u);
      const unsigned e = __ballot_sync(FULL_MASK, (em >> u) & 1u);
      const unsigned base = tot[u * SEL_WARPS + warp];
      const unsigned gb = done_g + (base & 0xffffu) + __popc(g & below);
      const unsigned eb = done_e + (base >> 16) + __popc(e & below);
      const bool take = ((gm >> u) & 1u) || (((em >> u) & 1u) && eb < rem);
      if (take) {
        const unsigned slot = gb + min(eb, rem);
        out_k[slot] = score_key(v[u]);
        out_p[slot] = lo + t0 + u * SEL_THREADS + tid;
      }
    }
    done_g += s_tile & 0xffffu;
    done_e += s_tile >> 16;
    __syncthreads();  // tot and s_tile are rewritten by the next tile
  }
  if (blockIdx.x == 0) {
    for (int p = k + tid; p < P; p += SEL_THREADS) {
      out_k[p] = 0u;
      out_p[p] = INT_MAX;
    }
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
// >= max(k, 2); G >= 1 CTAs a row in the passes; scratch: scratch_words(B, G)
// int32 words, zeroed; sk / sp: (B, P) u32 / i32 scratch. out_s / out_i:
// (B, k), by (score desc, position asc).
extern "C" int rag_select_topk(const void* scores, const void* indices, int base, int B, int L,
                               int ld, int k, int P, int G, void* scratch, void* sk, void* sp,
                               void* out_s, void* out_i, void* stream) {
  if (B < 1 || L < 1 || ld < L || k < 1 || k > L || P < 2 || P < k || (P & (P - 1)) != 0 ||
      B > 65535 || G < 1 || G > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scores);
  SelState* state = static_cast<SelState*>(scratch);
  unsigned* hist = reinterpret_cast<unsigned*>(state + B);
  unsigned* cnt_g = hist + (int64_t)B * 256;
  unsigned* cnt_e = cnt_g + (int64_t)B * G;
  unsigned* keys = static_cast<unsigned*>(sk);
  int* pos = static_cast<int*>(sp);
  const int span = (L + G - 1) / G;
  const dim3 slices(G, B);
  for (int shift = 24; shift >= 0; shift -= 8) {
    radix_hist_kernel<<<slices, SEL_THREADS, 0, st>>>(sc, ld, L, span, state, hist, shift);
    radix_digit_kernel<<<B, 32, 0, st>>>(state, hist, k, shift);
  }
  compact_count_kernel<<<slices, SEL_THREADS, 0, st>>>(sc, ld, L, span, state, cnt_g, cnt_e);
  compact_write_kernel<<<slices, SEL_THREADS, 0, st>>>(sc, ld, L, span, k, P, state, cnt_g,
                                                       cnt_e, keys, pos);
  cudaError_t err = cudaGetLastError();
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
