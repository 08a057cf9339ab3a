// Exact running top-k shared by the fused scan kernels (ivf_scan.cu,
// pq_scan.cu, rabitq_scan.cu).
//
// Each query keeps a sorted list of its k best (score, slot) pairs in shared
// memory, in lexicographic order (ties go to the lower slot, as lax.top_k
// does); empty entries are (+inf, SLOT_EMPTY). A kernel scores its slots in
// ascending slot order and offers them 32 at a time to a query's list with
// warp_offer: one warp filters the batch against the list's k-th entry with a
// ballot and inserts the survivors in lane (= slot) order, so a candidate that
// ties an existing score always ranks after it.
//
// To fill the card with few query tiles, a kernel may split a tile's valid
// probe units into n_split contiguous shares (grid z, unit_share): each CTA
// then writes an exact top-k of its share into a partial buffer
// [n_split][nq_pad][k], and merge_kernel folds the n_split sorted partial
// lists of each query (disjoint slots) into the same exact top-k.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {
namespace topk {

constexpr int SLOT_EMPTY = 0x7fffffff;
constexpr int MAX_SPLIT = 32;  // most shares of a tile's units (merge_kernel's heads)
constexpr int MAX_K = 256;     // warp_offer keeps k / 32 <= 8 entries per lane

__device__ __forceinline__ bool lex_less(float a, int sa, float b, int sb) {
  return a < b || (a == b && sa < sb);
}

// n lists of k entries: (+inf, SLOT_EMPTY) everywhere.
__device__ __forceinline__ void init(float* tv, int* ts, int n_entries, int tid, int n_threads) {
  for (int e = tid; e < n_entries; e += n_threads) {
    tv[e] = INFINITY;
    ts[e] = SLOT_EMPTY;
  }
}

// [v_lo, v_hi): the valid probe steps (counted in order) that split `split`
// of n_split scans in a tile whose probe_valid row is pv_row[0..P).
__device__ __forceinline__ void unit_share(const int* __restrict__ pv_row, int P, int split,
                                           int n_split, int* v_lo, int* v_hi) {
  int n_valid = 0;
  for (int j = 0; j < P; ++j) n_valid += pv_row[j] > 0 ? 1 : 0;
  *v_lo = (int)((long long)n_valid * split / n_split);
  *v_hi = (int)((long long)n_valid * (split + 1) / n_split);
}

// Offer one candidate per lane (slots ascending with the lane, all above any
// slot offered before) to the sorted list (tv, ts) of k entries. Called by
// all 32 lanes of one warp; +inf candidates never enter.
__device__ __forceinline__ void warp_offer(float* tv, int* ts, int k, float cand, int cslot,
                                           int lane) {
  const bool ok0 = cand < INFINITY && lex_less(cand, cslot, tv[k - 1], ts[k - 1]);
  unsigned mask = __ballot_sync(0xffffffffu, ok0);
  while (mask) {
    const int b = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(0xffffffffu, cand, b);
    const int cs = __shfl_sync(0xffffffffu, cslot, b);
    if (!lex_less(cv, cs, tv[k - 1], ts[k - 1])) continue;  // warp-uniform
    int cnt = 0;
    for (int e = lane; e < k; e += 32) cnt += lex_less(tv[e], ts[e], cv, cs) ? 1 : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    const int pos = cnt;  // entries strictly before the candidate
    float sv[MAX_K / 32];
    int ss[MAX_K / 32];
    int n_own = 0;
    for (int e = lane; e < k; e += 32) {
      if (e > pos) { sv[n_own] = tv[e - 1]; ss[n_own] = ts[e - 1]; }
      ++n_own;
    }
    __syncwarp();
    n_own = 0;
    for (int e = lane; e < k; e += 32) {
      if (e > pos) { tv[e] = sv[n_own]; ts[e] = ss[n_own]; }
      ++n_own;
    }
    if (lane == 0) { tv[pos] = cv; ts[pos] = cs; }
    __syncwarp();
  }
}

// Write the `live` lists of a CTA (queries qrow0 .. qrow0 + live - 1), one
// warp per query. With n_split > 1 the rows go to split's partial buffer and
// keep the empty sentinel for merge_kernel; otherwise empty entries become
// (+inf, -1).
__device__ __forceinline__ void write_out(const float* tv, const int* ts, int k, int live,
                                          long long qrow0, long long nq_pad, int split,
                                          int n_split, float* __restrict__ out_v,
                                          int* __restrict__ out_s, int warp, int n_warps,
                                          int lane) {
  for (int qq = warp; qq < live; qq += n_warps) {
    const long long orow = (n_split > 1 ? split * nq_pad : 0) + qrow0 + qq;
    for (int e = lane; e < k; e += 32) {
      const float v = tv[qq * k + e];
      const int s = ts[qq * k + e];
      out_v[orow * k + e] = v;
      out_s[orow * k + e] = n_split > 1 ? s : ((s == SLOT_EMPTY || !(v < INFINITY)) ? -1 : s);
    }
  }
}

// Folds n_split sorted partial top-k lists [n_split][rows][k] into the final
// [rows][k] (lexicographic (score, slot) order; splits hold disjoint slots).
// One warp per query row: lane s holds the head of split s's list, the warp
// takes the smallest head by a shuffle reduction and the winning lane
// advances. Empty entries are (+inf, -1).
__global__ void merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_s,
                             float* __restrict__ out_v, int* __restrict__ out_s,
                             int rows, int k, int n_split) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps
  int head = 0;
  float v = INFINITY;
  int s = SLOT_EMPTY;
  auto load = [&]() {
    v = INFINITY;
    s = SLOT_EMPTY;
    if (lane < n_split && head < k) {
      const long long at = ((long long)lane * rows + row) * k + head;
      if (part_v[at] < INFINITY) { v = part_v[at]; s = part_s[at]; }
    }
  };
  load();
  for (int e = 0; e < k; ++e) {
    float bv = v;
    int bs = s;
    int bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int os = __shfl_xor_sync(0xffffffffu, bs, off);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
      if (lex_less(ov, os, bv, bs) || (ov == bv && os == bs && ol < bl)) {
        bv = ov;
        bs = os;
        bl = ol;
      }
    }
    if (lane == 0) {
      out_v[(long long)row * k + e] = bv;
      out_s[(long long)row * k + e] = bv < INFINITY ? bs : -1;
    }
    if (lane == bl && bv < INFINITY) {
      ++head;
      load();
    }
  }
}

// Launch merge_kernel after a split scan; returns a cudaError_t.
inline int launch_merge(const float* part_v, const int* part_s, float* out_v, int* out_s,
                        int rows, int k, int n_split, cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 rows per block
  const long long warps = (long long)rows * 32;
  merge_kernel<<<(int)((warps + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      part_v, part_s, out_v, out_s, rows, k, n_split);
  return (int)cudaGetLastError();
}

}  // namespace topk
}  // namespace
