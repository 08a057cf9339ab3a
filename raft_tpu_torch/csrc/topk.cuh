// Exact running top-k shared by the fused scan kernels (ivf_scan.cu,
// pq_scan.cu, rabitq_scan.cu).
//
// Each query keeps a sorted list of its k best (score, slot) pairs in shared
// memory, in lexicographic order (ties go to the lower slot, as lax.top_k
// does); empty entries are (+inf, SLOT_EMPTY). B1 and B3 offer their slots
// 32 at a time to a query's list with warp_offer: one warp filters the batch
// against the list's k-th entry with a ballot and inserts the survivors one
// by one. B2 merges whole batches of filtered candidates with warp_merge.
// Every comparison is lexicographic, so the order of the offers never
// changes the list.
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

// Offer one candidate per lane to the sorted list (tv, ts) of k entries.
// Called by all 32 lanes of one warp; +inf candidates never enter. Every
// comparison is lexicographic on (score, slot), so the list is the exact
// top-k of everything offered, in whatever order it came.
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
    // shift the entries after pos up by one; static indices keep sv/ss in registers
    float sv[MAX_K / 32];
    int ss[MAX_K / 32];
#pragma unroll
    for (int i = 0; i < MAX_K / 32; ++i) {
      const int e = lane + 32 * i;
      if (e < k && e > pos) { sv[i] = tv[e - 1]; ss[i] = ts[e - 1]; }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MAX_K / 32; ++i) {
      const int e = lane + 32 * i;
      if (e < k && e > pos) { tv[e] = sv[i]; ts[e] = ss[i]; }
    }
    if (lane == 0) { tv[pos] = cv; ts[pos] = cs; }
    __syncwarp();
  }
}

// Merge one candidate per lane (`in`: the lane holds one; slots distinct
// from the list's) into the sorted list (tv, ts) of k entries, all at once.
// The batch is sorted by counting (a shuffle scan) into the warp's scratch
// (bv, bs: 32 entries, may alias the candidates' own buffer); a candidate's
// place is its rank in the batch plus the list entries before it, list
// entry e's is e plus the batch entries before it (binary searches), and
// whatever lands past k drops out. Exact whatever the order of the
// batches. Called by all 32 lanes of one warp.
__device__ __forceinline__ void warp_merge(float* tv, int* ts, int k, float cand, int cslot,
                                          bool in, float* bv, int* bs, int lane) {
  constexpr unsigned FULL = 0xffffffffu;
  in = in && lex_less(cand, cslot, tv[k - 1], ts[k - 1]);
  const unsigned who = __ballot_sync(FULL, in);
  if (!who) return;
  const int nb = __popc(who);
  int rb = 0;  // batch entries before this lane's
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float v = __shfl_sync(FULL, cand, j);
    const int s = __shfl_sync(FULL, cslot, j);
    rb += ((who >> j) & 1u) && lex_less(v, s, cand, cslot) ? 1 : 0;
  }
  __syncwarp();  // the scratch may hold this batch's own entries
  if (in) { bv[rb] = cand; bs[rb] = cslot; }
  int r = rb;  // + list entries before it
  if (in) {
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lex_less(tv[mid], ts[mid], cand, cslot)) lo = mid + 1; else hi = mid;
    }
    r += lo;
  }
  __syncwarp();
  float lv[MAX_K / 32];
  int ls[MAX_K / 32], lp[MAX_K / 32];
#pragma unroll
  for (int i = 0; i < MAX_K / 32; ++i) {
    lp[i] = k;
    const int e = lane + 32 * i;
    if (32 * i < k && e < k) {
      lv[i] = tv[e];
      ls[i] = ts[e];
      int lo = 0, hi = nb;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lex_less(bv[mid], bs[mid], lv[i], ls[i])) lo = mid + 1; else hi = mid;
      }
      lp[i] = e + lo;
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < MAX_K / 32; ++i) {
    if (lp[i] < k) { tv[lp[i]] = lv[i]; ts[lp[i]] = ls[i]; }
  }
  if (in && r < k) { tv[r] = cand; ts[r] = cslot; }
  __syncwarp();
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
