// Fused probed-list ADC scan with an exact running top-k, for IVF-PQ search.
//
// Replaces the Pallas TPU kernel raft_tpu/ops/pallas/pq_scan.py::fused_pq_topk
// (pallas_call at :395, body _make_pq_kernel at :221).
//
// What it computes. Queries arrive sorted into tiles of `qt` rows, with one
// bf16 lookup-table row W[q, 0..K) each (W[q, j * gw + c] = <q_sub[j], book[j, c]>).
// For query tile i and every probe step j < P with probe_valid[i, j] > 0,
// every code row of unit u = tile_probes[i, j] (gm rows of `bpr` code bytes,
// G lists of m = gm / G rows) is scored:
//   L2 (L2Expanded, L2SqrtExpanded): ln[slot] - 2 * (dot + qc)
//   IP (InnerProduct):               ln[slot] - dot - qc
// where dot is the f32 sum of the row's LUT entries, qc = q_rot . c_rot of the
// row's list (computed here per (query, list)), and ln is the per-slot term
// the wrapper prepares (+inf on empty or filtered slots, which never enter).
// Code layouts (mode): u8 = one code per byte (column j * ksub + byte);
// nib8 = byte j holds (hi, lo), columns j * 32 + hi then j * 32 + 16 + lo;
// p4 = byte b holds code 2b in the low and 2b + 1 in the high nibble, columns
// b * 32 + lo then b * 32 + 16 + hi; b3/b5/b6/b7 = little-endian bitstream,
// code j at bits [j * b, (j + 1) * b) peeled from its low and high byte
// (column j * ksub + code). Each query keeps the exact k smallest
// (score, slot) pairs, slot = u * gm + row (topk.cuh): the TPU kernel's
// bank merges are lossy approximations of the same top-k.
//
// Precision. The LUT entries are bf16 (rounded by the wrapper, as in the JAX
// package) and summed in f32 in lookup order; qc is summed in dimension order
// and the epilogue uses the rounded intrinsics (__fadd_rn, __fsub_rn), which
// the compiler never contracts into FMAs, so the plain PyTorch version with
// the same order gives the same bits. A bf16 entry widens to f32 exactly by
// a 16-bit shift (or a mask of the high half of a packed pair).
//
// Bound on the H100. The work is qt x (filled rows of each tile's valid units)
// x (lookups per row: 2 * pq_dim for nib8, pq_dim otherwise) f32 adds; the
// bytes are the code rows of the units read once (16-64 B a row) plus 8 B a
// row of ln and ids, and the LUT. At qt = 16 and nib8 codes a 64-byte row
// feeds 16 x 128 adds, 32 adds per byte; an FADD is one instruction a lane
// (33.5e12 a second, half the FMA-counted FP32 peak), so the ridge is 10
// adds per byte and the kernel is bound by operations. Its real limit is the
// shared-memory gather: every add reads one LUT entry at a data-dependent
// column.
//
// Design (chosen from the kernel's stage clock, chip_smoke.py's
// fused_pq_topk_split line). Every CTA holds the LUT rows of its QB queries
// (QB = 8, 4 or 1, a template parameter: as many as 227 KB of shared memory
// holds) and each of its 256 threads scores one code row against all of
// them, so the per-add query predicate and index arithmetic are
// compile-time. The LUT is interleaved by query: group g of four queries
// keeps, for every column c, their four bf16 entries side by side (8 bytes
// at (g * S + c) * 8, S = 2048 at QB = 8 so the groups sit at immediate
// offsets, else K), so one 64-bit shared load gives a lookup for four
// queries, and the sixteen columns a nibble can pick are sixteen distinct
// bank pairs: a half-warp's loads never conflict. Scores never go through
// shared memory: each thread filters its scores against each query's
// current k-th entry and appends the survivors to the query's candidate
// buffer (two chunks' capacity); only when a buffer could not take another
// chunk, and once at the end, does the CTA fold the buffers into the sorted
// lists, 32 candidates at a time (topk::warp_merge, exact whatever the
// order), one warp a query, so most chunks cost one barrier. Three CTAs of
// 256 threads an SM cover each other's barrier waits. Work is cut at chunks
// of 8 of a unit's 32-row groups that hold a valid slot (one a warp; the
// wrapper lists them, so list padding costs nothing and only a unit's last
// chunk runs short); the n_split CTAs of a (tile, query group) take the
// tile's chunks that hold work ITEM at a time from a shared counter, so a
// CTA that merges more takes fewer, and each keeps an exact partial top-k
// of what it took, which topk::merge_kernel folds. q.c is computed when a
// CTA enters a unit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "stage_clock.cuh"
#include "topk.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CTAS_PER_SM = 3;  // the launch bound; the wrapper's split fills as many an SM
constexpr int R = THREADS;      // code rows per chunk, one per thread
constexpr int CAP = 2 * R;      // candidates a query's buffer holds
constexpr int WARPS = THREADS / 32;
constexpr int QB_MAX = 8;       // most queries a CTA holds
constexpr int ITEM = 8;         // chunks a CTA takes from its work list at a time

// Columns between the LUT's query groups: fixed at QB_MAX (K <= 2048, as
// the wrapper checks), so the loads of a lookup take immediate offsets.
constexpr int STRIDE = 2048;

template <int QB>
__host__ __device__ __forceinline__ int lut_stride(int K) {
  return QB == QB_MAX ? STRIDE : K;
}

// Dynamic shared memory of one CTA of qb queries (the kernel's carve-up
// below); ops/pq_scan.py's cta_smem_bytes must agree, and checks that it
// does through pq_scan_smem_bytes.
size_t cta_smem_bytes(int qb, int K, int k, int G) {
  return (size_t)qb * (qb == QB_MAX ? STRIDE : K) * 2 +
         (sizeof(float) + sizeof(int)) * ((size_t)qb * CAP + (size_t)qb * k) +
         sizeof(float) * (size_t)qb * G + sizeof(int) * (qb + 1);
}

enum Metric { kL2 = 0, kIP = 1 };
enum Mode { kU8 = 0, kNib8 = 1, kP4 = 2, kBits = 3 };

// acc[q] += W[q, col] for the CTA's QB queries: QB / 4 64-bit loads of four
// interleaved bf16 entries (one 16-bit load when QB = 1).
template <int QB>
__device__ __forceinline__ void add_col(float (&acc)[QB], const unsigned char* lut, int K,
                                        int col) {
  if constexpr (QB == 1) {
    const unsigned x = reinterpret_cast<const unsigned short*>(lut)[col];
    acc[0] = __fadd_rn(acc[0], __uint_as_float(x << 16));
  } else {
    const uint2* l = reinterpret_cast<const uint2*>(lut) + col;
#pragma unroll
    for (int g = 0; g < QB / 4; ++g) {
      const uint2 x = l[g * lut_stride<QB>(K)];
      acc[4 * g + 0] = __fadd_rn(acc[4 * g + 0], __uint_as_float(x.x << 16));
      acc[4 * g + 1] = __fadd_rn(acc[4 * g + 1], __uint_as_float(x.x & 0xffff0000u));
      acc[4 * g + 2] = __fadd_rn(acc[4 * g + 2], __uint_as_float(x.y << 16));
      acc[4 * g + 3] = __fadd_rn(acc[4 * g + 3], __uint_as_float(x.y & 0xffff0000u));
    }
  }
}

// The lookups of byte j (value b) of a u8 / nib8 / p4 row.
template <int MODE, int QB>
__device__ __forceinline__ void add_byte(float (&acc)[QB], const unsigned char* lut, int K,
                                         int gw, int j, unsigned b) {
  if constexpr (MODE == kU8) {
    add_col<QB>(acc, lut, K, j * gw + (int)b);
  } else if constexpr (MODE == kNib8) {
    add_col<QB>(acc, lut, K, j * 32 + (int)(b >> 4));
    add_col<QB>(acc, lut, K, j * 32 + 16 + (int)(b & 15u));
  } else {
    add_col<QB>(acc, lut, K, j * 32 + (int)(b & 15u));
    add_col<QB>(acc, lut, K, j * 32 + 16 + (int)(b >> 4));
  }
}

// The ADC dot of one code row against the CTA's LUT rows, in lookup order.
template <int MODE, int BITS, int QB>
__device__ __forceinline__ void row_dot(float (&acc)[QB], const uint8_t* __restrict__ row,
                                        int bpr, int gw, const unsigned char* lut, int K) {
  if constexpr (MODE == kBits) {
    const int n_codes = bpr * 8 / BITS;
    for (int j = 0; j < n_codes; ++j) {
      const int jb = j * BITS;
      const int byte = jb >> 3;
      const int off = jb & 7;
      unsigned v = (unsigned)__ldg(row + byte) >> off;
      if (off + BITS > 8) v |= (unsigned)__ldg(row + byte + 1) << (8 - off);
      add_col<QB>(acc, lut, K, j * gw + (int)(v & ((1u << BITS) - 1u)));
    }
  } else if ((bpr & 15) == 0) {
    // 16 bytes at a time, the next 16 loading while these are looked up
    const uint4* row16 = reinterpret_cast<const uint4*>(row);
    uint4 next = __ldg(row16);
    for (int c0 = 0; c0 < bpr; c0 += 16) {
      const uint4 v = next;
      if (c0 + 16 < bpr) next = __ldg(row16 + (c0 >> 4) + 1);
      const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        add_byte<MODE, QB>(acc, lut, K, gw, c0 + t, (words[t >> 2] >> (8 * (t & 3))) & 0xffu);
      }
    }
  } else {
    for (int j = 0; j < bpr; ++j) add_byte<MODE, QB>(acc, lut, K, gw, j, __ldg(row + j));
  }
}

// The LUT rows of the live queries (zeros for the others) into the
// query-interleaved layout: per item, two columns of four queries, read as
// four packed bf16 pairs and written as two 8-byte records.
template <int QB>
__device__ __forceinline__ void fill_lut(unsigned char* lut, const __nv_bfloat16* __restrict__ w,
                                         long long qrow0, int live, int K, int tid) {
  if constexpr (QB == 1) {
    const uint4* src = reinterpret_cast<const uint4*>(w + qrow0 * K);
    uint4* dst = reinterpret_cast<uint4*>(lut);
    for (int e = tid; e < K / 8; e += THREADS) dst[e] = __ldg(src + e);
  } else {
    const int half = K / 2;
    const unsigned* wp = reinterpret_cast<const unsigned*>(w);
    uint2* dst = reinterpret_cast<uint2*>(lut);
    for (int e = tid; e < (QB / 4) * half; e += THREADS) {
      const int g = e / half;
      const int cp = e - g * half;
      unsigned a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * g + i;
        a[i] = q < live ? __ldg(wp + ((qrow0 + q) * K >> 1) + cp) : 0u;
      }
      uint2* d = dst + (long long)g * lut_stride<QB>(K) + 2 * cp;
      d[0] = make_uint2(__byte_perm(a[0], a[1], 0x5410), __byte_perm(a[2], a[3], 0x5410));
      d[1] = make_uint2(__byte_perm(a[0], a[1], 0x7632), __byte_perm(a[2], a[3], 0x7632));
    }
  }
}

// Fold every query's candidate buffer into its sorted list, 32 candidates
// at a time (topk::warp_merge), warp w taking queries w, w + WARPS, ...;
// ends on a barrier, after which the buffers are empty.
template <bool PROF>
__device__ __forceinline__ void flush(float* tk_v, int* tk_s, float* cand_v, int* cand_s,
                                      int* n_cand, int k, int live, int warp, int lane,
                                      prof::StageClock<PROF>& clk, long long* prof_rec) {
  for (int qq = warp; qq < live; qq += WARPS) {
    const int n = n_cand[qq];
    if (lane == 0 && n > 0) {
      clk.count(prof_rec, prof::kCandidates, n);
      clk.count(prof_rec, prof::kMerges, (n + 31) / 32);
    }
    for (int base = 0; base < n; base += 32) {
      const bool in = base + lane < n;
      topk::warp_merge(tk_v + qq * k, tk_s + qq * k, k,
                       in ? cand_v[qq * CAP + base + lane] : INFINITY,
                       in ? cand_s[qq * CAP + base + lane] : topk::SLOT_EMPTY, in,
                       cand_v + qq * CAP + base, cand_s + qq * CAP + base, lane);
    }
    __syncwarp();  // every lane has read the count
    if (lane == 0) n_cand[qq] = 0;
  }
  clk.lap(prof::kTopk);
  __syncthreads();
  clk.lap(prof::kBarrier);
}

template <int MODE, int BITS, int QB, bool PROF>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
pq_scan_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ ln,
               const __nv_bfloat16* __restrict__ w, const float* __restrict__ q_rot,
               const float* __restrict__ crot, const int* __restrict__ tile_probes,
               const int* __restrict__ groups, const int* __restrict__ chunk_w,
               const int* __restrict__ work, const int* __restrict__ n_work,
               int* __restrict__ counters, float* __restrict__ out_v, int* __restrict__ out_s,
               int gm, int G, int bpr, int K, int gw, int rot_dim, int qt, int P, int k,
               int metric, long long* __restrict__ prof_rec) {
  // blockIdx.z = split: the n_split CTAs of a (tile, query group) take its
  // tile's work list (chunk g = step g / n_chunks, the unit's valid 32-row
  // groups (g % n_chunks) * WARPS ..., one a warp) ITEM chunks at a time
  // from their counter; with more than one split, out_v/out_s are the
  // split's partial buffers [n_split][nq_pad][k].
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* lut = smem;                                            // [QB / 4][stride][4] bf16
  float* cand_v = reinterpret_cast<float*>(lut + (size_t)QB * lut_stride<QB>(K) * 2);  // [QB][CAP]
  int* cand_s = reinterpret_cast<int*>(cand_v + QB * CAP);               // [QB][CAP]
  float* tk_v = reinterpret_cast<float*>(cand_s + QB * CAP);             // [QB][k]
  int* tk_s = reinterpret_cast<int*>(tk_v + QB * k);                     // [QB][k]
  float* qdc = reinterpret_cast<float*>(tk_s + QB * k);                  // [QB][G]
  int* n_cand = reinterpret_cast<int*>(qdc + QB * G);                    // [QB]
  int* item = n_cand + QB;                                               // the next work item

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.y;
  const int q0 = blockIdx.x * QB;          // first query of this CTA within the tile
  const int live = min(QB, qt - q0);       // live queries of this CTA
  const long long qrow0 = (long long)tile * qt + q0;
  const int n_split = gridDim.z;
  const int split = blockIdx.z;
  const long long nq_pad = (long long)gridDim.y * qt;
  const int n_groups = (gm + 31) / 32;
  const int n_chunks = (n_groups + WARPS - 1) / WARPS;
  const int* tp = tile_probes + (long long)tile * P;
  const int* wl = work + (long long)tile * P * n_chunks;
  const int nw = n_work[tile];
  int* counter = counters + (long long)tile * gridDim.x + blockIdx.x;
  prof::StageClock<PROF> clk;
  clk.start();
  topk::init(tk_v, tk_s, QB * k, tid, THREADS);
  if (tid < QB) n_cand[tid] = 0;
  fill_lut<QB>(lut, w, qrow0, live, K, tid);
  clk.lap(prof::kLut);
  __syncthreads();
  clk.lap(prof::kBarrier);

  const int m = gm / G;
  int unit = -1;
  long long unit_row0 = 0;
  for (;;) {
    if (tid == 0) *item = atomicAdd(counter, ITEM);
    __syncthreads();  // written again only after the item's chunk barriers
    const int i0 = *item;
    if (i0 >= nw) break;
    for (int i = i0; i < min(i0 + ITEM, nw); ++i) {
      const int g = wl[i];
      const int j = g / n_chunks;
      const int u = tp[j];
      const int c = g - j * n_chunks;
      const int cw = chunk_w[(long long)u * n_chunks + c];  // valid groups in the chunk
      if (u != unit) {
        // q.c of each query with each of the unit's G lists, in dimension order
        unit = u;
        unit_row0 = (long long)u * gm;
        for (int e = tid; e < QB * G; e += THREADS) {
          const int q = e / G;
          float s = 0.f;
          if (q < live) {
            const float* qp = q_rot + (qrow0 + q) * rot_dim;
            const float* cp = crot + ((long long)u * G + e % G) * rot_dim;
            for (int t = 0; t < rot_dim; ++t) s = __fadd_rn(s, __fmul_rn(qp[t], cp[t]));
          }
          qdc[e] = s;
        }
        clk.lap(prof::kQc);
        __syncthreads();
        clk.lap(prof::kBarrier);
      }
      const int r = warp < cw ? groups[(long long)u * n_groups + c * WARPS + warp] * 32 + lane : gm;
      const float l = r < gm ? ln[unit_row0 + r] : INFINITY;
      bool filling = false;  // this thread took one of a buffer's last R places
      float acc[QB];
  #pragma unroll
      for (int q = 0; q < QB; ++q) acc[q] = 0.f;
      if (l < INFINITY) {
        row_dot<MODE, BITS, QB>(acc, codes + (unit_row0 + r) * bpr, bpr, gw, lut, K);
      }
      // every lane laps here and below (the clock reconverges the warp), so
      // lane 0's record books the lookups as lookups even when its row is empty
      clk.warp_lap(prof::kCodes);
      if (l < INFINITY) {
        const float* qc = qdc + r / m;
        const int slot = (int)(unit_row0 + r);
  #pragma unroll
        for (int q = 0; q < QB; ++q) {
          if (q < live) {
            const float cq = qc[q * G];
            const float s = metric == kL2 ? __fsub_rn(l, 2.0f * __fadd_rn(acc[q], cq))
                                          : __fsub_rn(__fsub_rn(l, acc[q]), cq);
            // the k-th entry only falls while the CTA runs: a stale one lets more through
            if (topk::lex_less(s, slot, tk_v[q * k + k - 1], tk_s[q * k + k - 1])) {
              const int at = atomicAdd(n_cand + q, 1);
              cand_v[q * CAP + at] = s;
              cand_s[q * CAP + at] = slot;
              filling |= at >= CAP - R;
            }
          }
        }
      }
      clk.warp_lap(prof::kScore);
      // fold the buffers into the lists once one could not take another chunk
      const bool full = __syncthreads_or(filling);
      clk.lap(prof::kBarrier);
      if (full) flush(tk_v, tk_s, cand_v, cand_s, n_cand, k, live, warp, lane, clk, prof_rec);
    }
  }
  flush(tk_v, tk_s, cand_v, cand_s, n_cand, k, live, warp, lane, clk, prof_rec);

  topk::write_out(tk_v, tk_s, k, live, qrow0, nq_pad, split, n_split, out_v, out_s, warp, WARPS,
                  lane);
  clk.flush(prof_rec);
}

template <int MODE, int BITS, int QB>
int launch(const uint8_t* codes, const float* ln, const __nv_bfloat16* w, const float* q_rot,
           const float* crot, const int* tile_probes, const int* groups,
           const int* chunk_w, const int* work, const int* n_work, int* counters,
           float* out_v, int* out_s, float* part_v,
           int* part_s, int n_split, int n_qt, int gm, int G, int bpr, int K, int gw,
           int rot_dim, int qt, int P, int k, int metric, long long* prof_rec,
           cudaStream_t stream) {
  if (QB == QB_MAX && K > STRIDE) return (int)cudaErrorInvalidValue;
  const size_t smem = cta_smem_bytes(QB, K, k, G);
  decltype(&pq_scan_kernel<MODE, BITS, QB, false>) kernel =
      prof_rec ? &pq_scan_kernel<MODE, BITS, QB, true> : &pq_scan_kernel<MODE, BITS, QB, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((qt + QB - 1) / QB, n_qt, n_split);
  kernel<<<grid, THREADS, smem, stream>>>(
      codes, ln, w, q_rot, crot, tile_probes, groups, chunk_w, work, n_work,
      counters,
      n_split > 1 ? part_v : out_v, n_split > 1 ? part_s : out_s, gm, G, bpr, K, gw, rot_dim,
      qt, P, k, metric, prof_rec);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return topk::launch_merge(part_v, part_s, out_v, out_s, n_qt * qt, k, n_split, stream);
}

template <int MODE, int BITS>
int launch_qb(int qb, const uint8_t* codes, const float* ln, const __nv_bfloat16* w,
              const float* q_rot, const float* crot, const int* tile_probes,
              const int* groups, const int* chunk_w,
              const int* work, const int* n_work, int* counters, float* out_v,
              int* out_s, float* part_v, int* part_s, int n_split, int n_qt, int gm, int G,
              int bpr, int K, int gw, int rot_dim, int qt, int P, int k, int metric,
              long long* prof_rec, cudaStream_t stream) {
#define PQ_LAUNCH(QB)                                                                          \
  launch<MODE, BITS, QB>(codes, ln, w, q_rot, crot, tile_probes, groups, chunk_w,              \
                         work, n_work, counters, out_v, out_s, part_v, part_s, n_split, n_qt,  \
                         gm, G, bpr, K,                                                        \
                         gw, rot_dim, qt, P, k, metric, prof_rec, stream)
  switch (qb) {
    case QB_MAX: return PQ_LAUNCH(QB_MAX);
    case 4: return PQ_LAUNCH(4);
    case 1: return PQ_LAUNCH(1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PQ_LAUNCH
}

}  // namespace

// mode: 0 = u8, 1 = nib8, 2 = p4, 3/5/6/7 = b3/b5/b6/b7. metric: 0 = L2, 1 = IP.
// codes [n_units][gm][bpr] u8, ln [n_units][gm] f32, w [n_qt * qt][K] bf16,
// q_rot [n_qt * qt][rot_dim] f32, crot [n_units][G][rot_dim] f32,
// tile_probes [n_qt][P] i32. qb (8, 4 or 1) queries share a CTA (their LUT
// rows must fit its shared memory). groups [n_units][n_groups] i32 lists
// each unit's 32-row groups that hold a valid slot first (n_groups =
// cdiv(gm, 32)), chunk_w [n_units][n_chunks] i32 counts them in each chunk
// of 8 (0 = past the last), work [n_qt][P * n_chunks] i32 lists each tile's
// n_work[tile] chunks that hold work first (step-major chunk indices of its
// valid steps), and counters [n_qt][cdiv(qt, qb)] i32, zeroed, hand them out
// to the n_split (1-32) CTAs of each (tile, query group); with n_split > 1
// part_v/part_s are scratch of [n_split][n_qt * qt][k]. prof_rec is null, or
// zeroed int64 [CTAs][prof::RECORD] for the stage clock (stage_clock.cuh).
// Returns a cudaError_t (0 = launched). k must be in [1, 256] and K a
// multiple of 8.
// The layout ops/pq_scan.py mirrors, which it checks once a build:
// out[0..7] = QB_MAX, STRIDE, CTAS_PER_SM, R, CAP, ITEM, WARPS (32-row groups
// a chunk), 32 (rows a group). Returns 0.
extern "C" int pq_scan_layout(int* out) {
  const int v[8] = {QB_MAX, STRIDE, CTAS_PER_SM, R, CAP, ITEM, WARPS, 32};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// cta_smem_bytes(qb, K, k, G): the shared memory the launch asks for.
extern "C" int pq_scan_smem_bytes(int qb, int K, int k, int G) {
  return (int)cta_smem_bytes(qb, K, k, G);
}

extern "C" int pq_scan_fused_pq_topk(const uint8_t* codes, const float* ln, const void* w,
                                     const float* q_rot, const float* crot,
                                     const int* tile_probes, const int* groups,
                                     const int* chunk_w, const int* work,
                                     const int* n_work, int* counters,
                                     float* out_v,
                                     int* out_s, float* part_v, int* part_s, long long* prof_rec,
                                     int n_split, int n_qt, int gm, int G, int bpr, int K,
                                     int rot_dim, int qt, int P, int k, int metric, int mode,
                                     int ksub, int qb, void* stream) {
  if (k < 1 || k > topk::MAX_K || n_split < 1 || n_split > topk::MAX_SPLIT || G < 1 ||
      gm % G != 0 || K % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const int gw = (mode == kNib8 || mode == kP4) ? 32 : ksub;
#define PQ_MODE(MODE, BITS)                                                                     \
  launch_qb<MODE, BITS>(qb, codes, ln, wb, q_rot, crot, tile_probes, groups,                    \
                        chunk_w, work, n_work, counters, out_v, out_s, part_v, part_s,         \
                        n_split, n_qt, gm, G,                                                  \
                        bpr, K, gw, rot_dim, qt, P, k, metric, prof_rec, s)
  switch (mode) {
    case 0: return PQ_MODE(kU8, 0);
    case 1: return PQ_MODE(kNib8, 0);
    case 2: return PQ_MODE(kP4, 0);
    case 3: return PQ_MODE(kBits, 3);
    case 5: return PQ_MODE(kBits, 5);
    case 6: return PQ_MODE(kBits, 6);
    case 7: return PQ_MODE(kBits, 7);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PQ_MODE
}
