// Fused probed-list scan with an exact running top-k, for IVF-Flat search.
//
// Replaces the Pallas TPU kernel raft_tpu/ops/pallas/ivf_scan.py::fused_list_topk
// (pallas_call at :399, body _make_kernel at :206).
//
// What it computes. Queries arrive sorted into tiles of `qt` rows. For query
// tile i and every probe step j < P with probe_valid[i, j] > 0, every slot of
// unit u = tile_probes[i, j] (gm rows of list_data) is scored:
//   L2  (L2Expanded, L2SqrtExpanded): ln[slot] - 2 * dot(q, y)
//   IP  (InnerProduct):               ln[slot] - dot(q, y)
//   cos (CosineExpanded):             li[slot] >= 0 ? -dot(q, y) * ln[slot] : +inf
// where ln/li are the per-slot epilogue terms the wrapper prepares (+inf folded
// into ln for invalid or filtered slots). Each query row keeps the exact k
// smallest (score, slot) pairs in lexicographic order, slot = u * gm + row; a
// slot whose score is +inf never enters; empty result entries are (+inf, -1).
// This is the TPU kernel's merge="exact" result. Its "bank*"/"seg*" merges are
// lossy lane-packing approximations of the same top-k; this kernel always
// computes the exact one.
//
// Precision. Every score that enters a list is the FP32 one: dot(q, y) summed
// with one __fmaf_rn a dimension in ascending order from 0.f, bf16, int8 and
// uint8 rows widened to f32 per element, then the epilogue above. These are
// the bits of the FMA kernel this one replaced.
//
// Bound on the H100. Per tile the work is qt x (filled slots of the valid
// units) x d multiply-adds, one dense TF32 pass on the tensor cores (495e12
// FLOP/s); the bytes are the filled rows of the distinct probed units, read
// once. At the serving shape (16-query tiles) the tiles of one batch probe
// largely the same units, so each row is read about 4.5 times: the rows the
// tiles read again, not the product, are the floor unless they hit L2.
//
// Design: a tensor-core filter, then an exact re-score. A CTA holds QB = 16
// queries (8 warps) or 32, 64 or 128 (16 warps): of one tile, or of a group of
// G tiles when the tiles are small (G = 8 at the serving shape's 16-query
// tiles), so that a chunk several of them probe is staged once; a per-unit
// bitmask says which of the group's tiles list a unit, and each query scores
// only its own tile's units. The CTA walks its share of the group's chunks of
// R = 64 rows that hold a filled slot (the wrapper lists them, so list padding
// costs nothing; the probe steps are dealt out to the n_split shares in turn).
// Each chunk is staged with cp.async, DS = 128 dimensions at a time (a depth
// slice; one slice up to d = 128), three slices in flight (two where three and
// the queries do not fit), in the list's own type. Warp w multiplies rows 16
// (w % 4) .. +15 (the m16 operand) with the CTA's queries 8 n .. 8 n + 7 for n
// = w / 4, w / 4 + warps / 4, ... (the n8 operand) with mma.sync.m16n8k8 in
// TF32, skipping the n8 tiles whose tiles do not list the unit; the operands
// are cut to TF32 by masking their low 13 bits (a truncation, counted in the
// bound), the queries once, in shared memory, with each k-step's dimensions t
// and t + 4 side by side (one 64-bit load a fragment); the sums carry over the
// depth slices. The lanes also sum the squares of their rows' cut values, so
// that after a quad shuffle each knows its rows' cut norms (the queries' are
// summed once a CTA), every rounding of both upward. Then |dot_tc - dot| <=
// kappa |q~| |y~| + eps (the wrapper's filter_error: the operands' cut, the
// tensor core's and the FMA sum's f32 rounding, with room to spare; eps for
// underflow and subnormal operands), so U = dot_tc + kappa |q~| |y~| + eps
// rounded up bounds dot from above and the epilogue at U is a lower bound lb
// of the exact score (round-to-nearest is monotone; cosine's ln >= 0). A row
// is a candidate of a query unless lb is strictly above the query's current
// k-th score: the smaller of its list's and the smallest any CTA has published
// for it (an atomicMin on an ordered int key after each merge: a list's k-th
// bounds the final one, and a stale one only lets more through). Candidates go
// to a per-query buffer in shared memory; after the chunk the warp that owns a
// query (w, w + warps, ...) re-scores its candidates exactly, one a lane, from the
// staged rows (from global memory when the chunk spans several depth slices)
// and the f32 queries (in L2), and merges them into the sorted list 32 at a
// time (topk::warp_merge). The lists only ever hold exact scores, so the
// result is the FMA kernel's bit for bit. Grid: (query group, tile group,
// chunk share), with topk::merge_kernel folding the shares' partial lists
// (past 32 shares, 32 at a time, then once more). Where the CTA's cut queries
// and the staged slices do not fit shared memory (d past about 2,500), the
// queries are read through the caches (qglobal). The PROF instantiation
// carries the stage clock (stage_clock.cuh); the CHECK instantiation turns the
// filter off (every filled row is a candidate), computes every exact score
// beside its lb and counts the rows whose exact score is below their lb (must
// be none).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "stage_clock.cuh"
#include "topk.cuh"

namespace {

constexpr int QB_MAX = 128;   // most queries a CTA holds
constexpr int MAX_SHARES = 1024;  // CTAs that share a (tile group, query group): two merge levels
constexpr int QW = 8;         // queries of one n8 tile of the product
constexpr int R = 64;         // rows a chunk: four m16 tiles
constexpr int DS = 128;       // dimensions of a staged depth slice
constexpr int NS = 3;         // depth slices staged at once (2 where 3 do not fit)
constexpr int WIDE_QB = 32;   // from this many queries a CTA runs 16 warps, below it 8

// Warps of a CTA of qb queries: 4 along the chunk's m16 row tiles times
// 2 or 4 along the queries' n8 tiles
__host__ __device__ constexpr int cta_warps(int qb) { return qb >= WIDE_QB ? 16 : 8; }
constexpr int ROW_PAD = 16;   // bytes after each staged row slice (alignment slack, banks)
constexpr int SPAN = R * 4 + 16;  // bytes of a staged ln or li span (16 of alignment slack)
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned TF32_MASK = 0xffffe000u;  // a float's sign, exponent and top 10 bits

enum Metric { kL2 = 0, kIP = 1, kCos = 2 };
// The stage clock's stages (stage_clock.cuh): staging global -> shared, the
// tensor-core product, the filter's lower bounds and candidates, the exact
// re-scores, the merges into the lists, barrier waits; and counters: chunks
// scanned, candidates that passed the filter
enum B1Stage { kB1Stage = 0, kB1Dot = 1, kB1Epilogue = 2, kB1Rescore = 3, kB1Topk = 4, kB1Barrier = 5 };
enum B1Count { kB1Chunks = 0, kB1Candidates = 1 };
// CHECK record, int64 per CTA: lb violations, rows the filter would pass,
// (query, filled row) pairs scored
enum CheckCount { kViolations = 0, kSurvivors = 1, kPairs = 2, CHECK_WORDS = 3 };

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Byte offsets of a CTA's dynamic shared memory; ops/ivf_scan.py's
// cta_smem_bytes mirrors the total and checks it through ivf_scan_smem_bytes.
struct Layout {
  int qs;    // floats between rows of the f32 queries
  int srow;  // bytes between staged row slices
  int q, rows, info, lnb, lib, tkv, tks, thr, cnt, qn, qbit, ntbit, buf, scratch, total;
};

__host__ __device__ __forceinline__ Layout layout(int qb, int d, int k, int isz, bool qglobal,
                                                  bool cosine, int ns) {
  Layout L;
  L.qs = round_up(d, 32) + 8;  // rows 8 banks apart: the n8 operand's 64-bit loads do not conflict
  L.srow = DS * isz + ROW_PAD;
  int o = 0;
  L.q = o;       o += qglobal ? 0 : qb * L.qs * 4;  // [qb][qs] TF32-cut queries, interleaved, zero past d
  L.rows = o;    o += ns * R * L.srow;              // [ns][R] staged row slices
  L.info = o;    o += ns * 16;                      // [ns] unit, first row, rows, tile mask
  L.lnb = o;     o += ns * SPAN;                    // [ns] staged ln spans
  L.lib = o;     o += cosine ? ns * SPAN : 0;       // [ns] staged li spans (cosine)
  L.tkv = o;     o += qb * k * 4;                   // [qb][k] list scores
  L.tks = o;     o += qb * k * 4;                   // [qb][k] list slots
  L.thr = o;     o += qb * 4;                       // [qb] k-th score bound (ordered key)
  L.cnt = o;     o += qb * 4;                       // [qb] candidates buffered
  L.qn = o;      o += qb * 4;                       // [qb] the cut query's norm, rounded up
  L.qbit = o;    o += qb * 4;                       // [qb] the query's tile's bit in a unit mask
  L.ntbit = o;   o += qb / QW * 4;                  // [qb / 8] the bits of an n8 tile's queries
  L.buf = o;     o += round_up(qb * R, 16);         // [qb][R] candidates' rows in the chunk
  L.scratch = o; o += cta_warps(qb) * 32 * 8;       // [warps][32] warp_merge's batch
  L.total = o;
  return L;
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) { return (float)x; }
template <> __device__ __forceinline__ float to_f32<uint8_t>(uint8_t x) { return (float)x; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` (1-16) are read and
// the rest zero-filled; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_last() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy `bytes` bytes from global `src` to shared `dst` as 16-byte pieces
// from src rounded down to 16 bytes (the tail zero-filled, nothing read past
// src + bytes); the data starts at dst + (src & 15).
__device__ __forceinline__ void copy_span(unsigned char* dst, const void* src, int bytes, int tid,
                                          int n_threads) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const unsigned char* a0 = reinterpret_cast<const unsigned char*>(a & ~uintptr_t(15));
  const int total = (int)(a & 15) + bytes;
  for (int i = tid; 16 * i < total; i += n_threads) {
    cp_async16(dst + 16 * i, a0 + 16 * i, min(16, total - 16 * i));
  }
}

template <typename U>
__device__ __forceinline__ const U* span_at(const unsigned char* dst, const void* src) {
  return reinterpret_cast<const U*>(dst + (reinterpret_cast<uintptr_t>(src) & 15));
}

// d += a . b, m16n8k8, TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dot(q, y) as the scores that enter a list have it: one FMA a dimension in
// ascending order from 0.f (y and q: shared or global memory). Out of line:
// it runs for candidates only, and the chunk loop's code stays small.
template <typename T>
__device__ __noinline__ float exact_dot(const T* y, const float* q, int d) {
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < d; ++c) acc = __fmaf_rn(q[c], to_f32<T>(y[c]), acc);
  return acc;
}

// The epilogue of a dot product (the exact one, or the filter's bound U)
__device__ __forceinline__ float epilogue(int metric, float l, float dot) {
  if (metric == kL2) return l - 2.0f * dot;
  if (metric == kIP) return l - dot;
  return -dot * l;
}

// A float as an int whose signed order is the float's (-0 below +0), for
// atomicMin on a k-th score; and back.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// The product of one staged depth slice (w dimensions, k-steps of 8) into
// the warp's sums, and this lane's share of its rows' squared norms (sq):
// rows ya / yb (this lane's m16 rows g and g + 8) against
// the queries' n8 tiles nt0, nt0 + NG, ... (rows qstride floats apart in qf:
// in shared memory cut to TF32 with each k-step's dimensions t and t + 4
// side by side; QG: the f32 queries in global memory from dimension 0, zero
// past d and past the live queries), skipping the n8 tiles j whose
// queries' tiles do not list the unit (bit j of act clear).
template <typename T, int NT, int NG, bool QG>
__device__ __forceinline__ void slice_product(float (&acc)[NT][4], float (&sq)[2],
                                              const T* ya, const T* yb, const float* qf,
                                              int qstride, int s0, int w, int d, int live,
                                              int nt0, int fg, int ft, int act) {
#pragma unroll 2
  for (int k0 = 0; k0 < w; k0 += 8) {
    unsigned a[4];
    a[0] = __float_as_uint(to_f32<T>(ya[k0 + ft])) & TF32_MASK;
    a[1] = __float_as_uint(to_f32<T>(yb[k0 + ft])) & TF32_MASK;
    a[2] = __float_as_uint(to_f32<T>(ya[k0 + ft + 4])) & TF32_MASK;
    a[3] = __float_as_uint(to_f32<T>(yb[k0 + ft + 4])) & TF32_MASK;
    // the rows' squared norms, of the cut values, this lane's dimensions,
    // every rounding upward (a bound, whatever the order)
    sq[0] = __fmaf_ru(__uint_as_float(a[0]), __uint_as_float(a[0]), sq[0]);
    sq[0] = __fmaf_ru(__uint_as_float(a[2]), __uint_as_float(a[2]), sq[0]);
    sq[1] = __fmaf_ru(__uint_as_float(a[1]), __uint_as_float(a[1]), sq[1]);
    sq[1] = __fmaf_ru(__uint_as_float(a[3]), __uint_as_float(a[3]), sq[1]);
    const int c0 = s0 + k0 + ft;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (!((act >> j) & 1)) continue;  // warp-uniform: no query of the n8 tile lists the unit
      const int q = 8 * (nt0 + NG * j) + fg;
      unsigned b0, b1;
      if (QG) {
        const bool ok = q < live;
        b0 = __float_as_uint(ok && c0 < d ? __ldg(qf + (long long)q * qstride + c0) : 0.f) &
             TF32_MASK;
        b1 = __float_as_uint(ok && c0 + 4 < d ? __ldg(qf + (long long)q * qstride + c0 + 4) : 0.f) &
             TF32_MASK;
      } else {  // dimensions t and t + 4 of the k-step side by side, already cut
        const float2 x = *reinterpret_cast<const float2*>(qf + q * qstride + s0 + k0 + 2 * ft);
        b0 = __float_as_uint(x.x);
        b1 = __float_as_uint(x.y);
      }
      mma_tf32(acc[j], a, b0, b1);
    }
  }
}

template <typename T, int QB, bool PROF, bool CHECK>
__global__ void __launch_bounds__(cta_warps(QB) * 32, 1)
ivf_filter_kernel(const T* __restrict__ list_data, const float* __restrict__ ln,
                  const int* __restrict__ li, const float* __restrict__ queries,
                  const int* __restrict__ work, const int* __restrict__ n_work,
                  const int* __restrict__ work_mask, int* __restrict__ kth_key,
                  float* __restrict__ out_v, int* __restrict__ out_s, int gm, int d, int qt,
                  int G, int n_qt, int W, int k, int metric, int qglobal, int ns,
                  float kappa, float eps, long long* __restrict__ prof_rec,
                  long long* __restrict__ check_rec) {
  constexpr int WARPS = cta_warps(QB);
  constexpr int THREADS = WARPS * 32;
  constexpr int NG = WARPS / 4;     // warp w takes the n8 tiles w / 4, w / 4 + NG, ...
  constexpr int NT = QB / 8 / NG;   // n8 query tiles a warp multiplies
  const Layout L = layout(QB, d, k, (int)sizeof(T), qglobal != 0, metric == kCos, ns);
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L.q);
  unsigned char* rows_s = smem + L.rows;
  int4* info = reinterpret_cast<int4*>(smem + L.info);
  float* tk_v = reinterpret_cast<float*>(smem + L.tkv);
  int* tk_s = reinterpret_cast<int*>(smem + L.tks);
  int* thr = reinterpret_cast<int*>(smem + L.thr);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  float* qn = reinterpret_cast<float*>(smem + L.qn);
  int* qbit = reinterpret_cast<int*>(smem + L.qbit);
  int* ntbit = reinterpret_cast<int*>(smem + L.ntbit);
  unsigned char* buf = smem + L.buf;
  float* sc_v = reinterpret_cast<float*>(smem + L.scratch);
  int* sc_s = reinterpret_cast<int*>(sc_v + WARPS * 32);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // a group of G tiles (G = 1: one tile) whose queries share the CTAs of
  // grid row blockIdx.y and the union of their chunks
  const int group = blockIdx.y;
  const int gq = min(G, n_qt - group * G) * qt;  // the group's queries
  const int q0 = blockIdx.x * QB;         // first query of this CTA within the group
  const int live = min(QB, gq - q0);      // live queries of this CTA
  const long long qrow0 = (long long)group * G * qt + q0;
  const int n_split = gridDim.z;
  const int split = blockIdx.z;
  const long long nq_pad = (long long)n_qt * qt;
  const int n_chunks = (gm + R - 1) / R;
  const int n_slices = (d + DS - 1) / DS;
  // the CTA's queries for the product: cut in shared memory, or (qglobal)
  // read through the caches; the exact scores read them from global memory
  const float* qf = qglobal ? queries + qrow0 * d : qs;
  const int qstride = qglobal ? d : L.qs;
  const float* qx = queries + qrow0 * d;
  prof::StageClock<PROF> clk;
  clk.start();

  topk::init(tk_v, tk_s, QB * k, tid, THREADS);
  for (int q = tid; q < QB; q += THREADS) {
    thr[q] = 0x7f800000;  // +inf
    cnt[q] = 0;
    qbit[q] = q < live ? 1 << ((q0 + q) / qt) : 0;
  }
  __syncthreads();
  for (int t = tid; t < QB / QW; t += THREADS) {
    int bits = 0;
    for (int i = 0; i < QW; ++i) bits |= qbit[QW * t + i];
    ntbit[t] = bits;
  }
  // each query's cut norm, every rounding upward (a bound of it)
  for (int q = warp; q < QB; q += WARPS) {
    float s2 = 0.f;
    if (q < live) {
      for (int c = lane; c < d; c += 32) {
        const float x = __uint_as_float(__float_as_uint(queries[(qrow0 + q) * d + c]) & TF32_MASK);
        s2 = __fmaf_ru(x, x, s2);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s2 = __fadd_ru(s2, __shfl_xor_sync(FULL, s2, off));
    if (lane == 0) qn[q] = __fsqrt_ru(s2);
  }
  if (!qglobal) {  // cut to TF32, each k-step's dimension t + 4 beside t
    for (int e = tid; e < QB * L.qs; e += THREADS) {
      const int q = e / L.qs, p = e - q * L.qs;
      const int c = (p & ~7) + ((p & 7) >> 1) + 4 * (p & 1);  // the dimension at place p
      const float x = q < live && c < d ? queries[(qrow0 + q) * d + c] : 0.f;
      qs[e] = __uint_as_float(__float_as_uint(x) & TF32_MASK);
    }
  }

  // the CTA's share of its tile's listed chunks (entry = unit * n_chunks + chunk),
  // each staged as n_slices depth slices in turn
  const int* wl = work + (long long)group * W;
  const int* wm = work_mask ? work_mask + (long long)group * W : nullptr;
  const int nw = n_work[group];
  const int lo = (int)((long long)nw * split / n_split);
  const int hi = (int)((long long)nw * (split + 1) / n_split);
  const int n_steps = (hi - lo) * n_slices;
  constexpr int BPR = (DS * (int)sizeof(T)) / 16 + 1;  // 16-byte blocks a row slice may span
  const uintptr_t base = reinterpret_cast<uintptr_t>(list_data);
  // where row `row` of the lists' slice from dimension s0 starts (global)
  auto row_addr = [&](long long row, int s0) -> uintptr_t {
    return base + ((uintptr_t)row * d + s0) * sizeof(T);
  };

  // stage step s (chunk s / n_slices, slice s % n_slices) into buffer s % ns:
  // each row's slice from its 16-byte floor, zero-filled past its end; with
  // a chunk's last slice its ln and li spans; and the chunk's unit, first
  // row, rows and tile mask in info. The chunks' entries and masks are
  // loaded one chunk ahead, so that no step waits on them.
  int pre_e = lo < hi ? __ldg(wl + lo) : 0, pre_m = lo < hi && wm ? __ldg(wm + lo) : -1;
  int cur_e = 0, cur_m = -1;
  auto stage = [&](int s) {
    if (s < n_steps) {
      const int slice = s % n_slices;
      if (slice == 0) {
        cur_e = pre_e;
        cur_m = pre_m;
        const int next = lo + s / n_slices + 1;
        if (next < hi) {
          pre_e = __ldg(wl + next);
          pre_m = wm ? __ldg(wm + next) : -1;
        }
      }
      const int u = cur_e / n_chunks;
      const int r0 = (cur_e - u * n_chunks) * R;
      const int n = min(R, gm - r0);
      const int s0 = slice * DS;
      const int wb = min(DS, d - s0) * (int)sizeof(T);
      unsigned char* dst = rows_s + (s % ns) * R * L.srow;
#pragma unroll 1
      for (int i = tid; i < n * BPR; i += THREADS) {
        const int r = i / BPR, b = i - r * BPR;
        const uintptr_t a = row_addr((long long)u * gm + r0 + r, s0);
        const int total = (int)(a & 15) + wb;
        if (16 * b < total) {
          cp_async16(dst + r * L.srow + 16 * b,
                     reinterpret_cast<const void*>((a & ~uintptr_t(15)) + 16 * b),
                     min(16, total - 16 * b));
        }
      }
      const long long row0 = (long long)u * gm + r0;
      if (slice == n_slices - 1) {
        if (tid < 32) copy_span(smem + L.lnb + (s % ns) * SPAN, ln + row0, 4 * n, tid, 32);
        if (metric == kCos && tid >= 32 && tid < 64) {
          copy_span(smem + L.lib + (s % ns) * SPAN, li + row0, 4 * n, tid - 32, 32);
        }
      }
      if (tid == 0) info[s % ns] = make_int4(u, r0, n, cur_m);
    }
    cp_async_commit();
  };
  for (int s = 0; s < ns - 1; ++s) stage(s);
  clk.lap(kB1Stage);

  // this lane's place in the fragments: rows g and g + 8 of the warp's m16
  // tile, dimensions t and t + 4 of a k-step, queries 2 t and 2 t + 1 of each
  // of its n8 tiles (nt0 + NG j)
  const int fg = lane >> 2;
  const int ft = lane & 3;
  const int mrow = 16 * (warp & 3);
  const int nt0 = warp >> 2;
  float acc[NT][4], sq[2];
  int n_chunk_prof = 0, n_surv = 0;              // PROF
  long long n_viol = 0, n_pass = 0, n_pair = 0;  // CHECK

#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) {
    const int b = s % ns;
    // this step's copies are done (with three buffers the next one may be in flight)
    if (ns == NS) cp_async_wait_prev(); else cp_async_wait_last();
    clk.lap(kB1Stage);
    __syncthreads();       // every thread's copies landed; the last step is done
    clk.lap(kB1Barrier);
    stage(s + ns - 1);
    clk.lap(kB1Stage);
    const int slice = s % n_slices;
    const int s0 = slice * DS;
    const int4 ci = info[b];
    const int u = ci.x, r0 = ci.y, n = ci.z;
    const long long row0 = (long long)u * gm + r0;
    // the group's tiles that list the unit (every tile when G = 1), and
    // this warp's n8 tiles (bit j: tile nt0 + NG j) with a query of one
    const int umask = ci.w;
    int act = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) act |= (ntbit[nt0 + NG * j] & umask) ? 1 << j : 0;
    const unsigned char* rb = rows_s + b * R * L.srow;
    // row r's staged slice (its data starts at its global address's offset in 16 bytes)
    auto staged = [&](int r) {
      return reinterpret_cast<const T*>(rb + r * L.srow + (row_addr(row0 + r, s0) & 15));
    };
    if (slice == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      }
      sq[0] = sq[1] = 0.f;
    }
    // the chunk's staged ln and li spans (with its last slice)
    const float* lnc = span_at<float>(smem + L.lnb + b * SPAN, ln + row0);
    const int* lic = span_at<int>(smem + L.lib + b * SPAN, li + row0);
    {
      const int w = min(DS, d - s0);
      const T* ya = staged(mrow + fg);
      const T* yb = staged(mrow + fg + 8);
      if (qglobal) {
        slice_product<T, NT, NG, true>(acc, sq, ya, yb, qf, qstride, s0, w, d, live, nt0, fg, ft,
                                   act);
      } else {
        slice_product<T, NT, NG, false>(acc, sq, ya, yb, qf, qstride, s0, w, d, live, nt0, fg, ft,
                                    act);
      }
    }
    clk.lap(kB1Dot);
    if (slice != n_slices - 1) continue;

    // ---- the chunk's product is complete: lower bounds, candidates ----
    // row r's exact dot with query row qq: from the staged chunk when it is
    // one slice deep, else from global memory (just read: in L2)
    auto exact = [&](int r, const float* qq) {
      return n_slices == 1 ? exact_dot(staged(r), qq, d)
                           : exact_dot(list_data + (row0 + r) * d, qq, d);
    };
    if (PROF && tid == 0) ++n_chunk_prof;
    // the filter's per-row terms of this lane's rows g and g + 8
    float lrow[2];
    bool vrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mrow + fg + 8 * h;
      const bool in = r < n;
      lrow[h] = in ? lnc[r] : INFINITY;
      vrow[h] = in && (metric == kCos ? lic[r] >= 0 : lrow[h] < INFINITY);
    }
    // the rows' cut norms: the four lanes of a row pair add their shares,
    // rounding upward
    float rown[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s2 = sq[h];
      s2 = __fadd_ru(s2, __shfl_xor_sync(FULL, s2, 1));
      s2 = __fadd_ru(s2, __shfl_xor_sync(FULL, s2, 2));
      rown[h] = __fsqrt_ru(s2);
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (!((act >> j) & 1)) continue;  // warp-uniform
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = 8 * (nt0 + NG * j) + 2 * ft + c;
        if (!(qbit[q] & umask)) continue;
        const float kth = key_value(thr[q]);
        const float qq_n = qn[q];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mrow + fg + 8 * h;
          const float l = lrow[h];
          if (!vrow[h]) continue;
          const float up = __fadd_ru(acc[j][2 * h + c],
                                     __fmaf_ru(kappa, __fmul_ru(qq_n, rown[h]), eps));
          const float lb = epilogue(metric, l, up);
          const bool pass = !(lb > kth);
          if (PROF) n_surv += pass;
          if (CHECK) {
            n_viol += epilogue(metric, l, exact(r, qx + q * d)) < lb;
            n_pass += pass;
            ++n_pair;
          }
          if (pass || CHECK) {
            buf[q * R + atomicAdd(cnt + q, 1)] = (unsigned char)r;
            any = true;
          }
        }
      }
    }
    clk.lap(kB1Epilogue);
    any = __syncthreads_or(any);
    clk.lap(kB1Barrier);
    // the smallest k-th score any CTA of the tile has published
    for (int q = tid; q < live; q += THREADS) atomicMin(thr + q, __ldcg(kth_key + qrow0 + q));
    if (!any) continue;
    // ---- the owners re-score their queries' candidates and merge them ----
#pragma unroll 1
    for (int q = warp; q < live; q += WARPS) {
      const int nc = cnt[q];
      if (nc == 0) continue;
      float* tv = tk_v + q * k;
      int* ts = tk_s + q * k;
#pragma unroll 1
      for (int c0 = 0; c0 < nc; c0 += 32) {
        const bool in = c0 + lane < nc;
        float sv = INFINITY;
        int slot = topk::SLOT_EMPTY;
        if (in) {
          const int r = buf[q * R + c0 + lane];
          const float dot = exact(r, qx + q * d);
          sv = metric == kCos && lic[r] < 0 ? INFINITY : epilogue(metric, lnc[r], dot);
          slot = (int)(row0 + r);
        }
        clk.warp_lap(kB1Rescore);
        topk::warp_merge(tv, ts, k, sv, slot, in && sv < INFINITY, sc_v + warp * 32,
                         sc_s + warp * 32, lane);
        clk.lap(kB1Topk);
      }
      if (lane == 0) {
        cnt[q] = 0;
        // the list's k-th score bounds the query's final k-th: share it with
        // the CTAs that scan the tile's other chunks
        if (tv[k - 1] < INFINITY) {
          const int key = order_key(tv[k - 1]);
          atomicMin(thr + q, min(key, atomicMin(kth_key + qrow0 + q, key)));
        }
      }
      __syncwarp();
    }
    clk.lap(kB1Topk);
  }
  cp_async_wait_all();
  __syncthreads();
  clk.lap(kB1Barrier);

  topk::write_out(tk_v, tk_s, k, live, qrow0, nq_pad, split, n_split, out_v, out_s, warp, WARPS,
                  lane);
  if (PROF) {
    const int surv = __reduce_add_sync(FULL, (unsigned)n_surv);
    if (lane == 0) clk.count(prof_rec, kB1Candidates, surv);
    if (tid == 0) clk.count(prof_rec, kB1Chunks, n_chunk_prof);
  }
  if (CHECK) {
    long long* row = check_rec +
                     (long long)(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) *
                         CHECK_WORDS;
    const long long v[CHECK_WORDS] = {n_viol, n_pass, n_pair};
#pragma unroll
    for (int i = 0; i < CHECK_WORDS; ++i) {
      long long x = v[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
      if (lane == 0 && x) atomicAdd(reinterpret_cast<unsigned long long*>(row + i), (unsigned long long)x);
    }
  }
  clk.flush(prof_rec);
}

struct Args {
  const void* list_data;
  const float* ln;
  const int* li;
  const float* queries;
  const int* work;
  const int* n_work;
  const int* work_mask;
  int* kth_key;
  float* out_v;
  int* out_s;
  int n_qt, gm, d, qt, G, W, k, metric, n_split, qglobal, ns;
  float kappa, eps;
  long long* prof_rec;
  long long* check_rec;
  cudaStream_t stream;
};

template <typename T, int QB, bool PROF, bool CHECK>
int launch(const Args& a) {
  auto kernel = ivf_filter_kernel<T, QB, PROF, CHECK>;
  const int smem =
      layout(QB, a.d, a.k, (int)sizeof(T), a.qglobal != 0, a.metric == kCos, a.ns).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.G * a.qt + QB - 1) / QB, (a.n_qt + a.G - 1) / a.G, a.n_split);
  kernel<<<grid, cta_warps(QB) * 32, smem, a.stream>>>(
      static_cast<const T*>(a.list_data), a.ln, a.li, a.queries, a.work, a.n_work, a.work_mask,
      a.kth_key, a.out_v, a.out_s, a.gm, a.d, a.qt, a.G, a.n_qt, a.W, a.k, a.metric,
      a.qglobal, a.ns, a.kappa, a.eps, a.prof_rec, a.check_rec);
  return (int)cudaGetLastError();
}

template <typename T, int QB>
int launch_qb(const Args& a) {
  if (a.prof_rec) return launch<T, QB, true, false>(a);
  if (a.check_rec) return launch<T, QB, false, true>(a);
  return launch<T, QB, false, false>(a);
}

template <typename T>
int launch_type(const Args& a, int qb) {
  switch (qb) {
    case 128: return launch_qb<T, 128>(a);
    case 64: return launch_qb<T, 64>(a);
    case 32: return launch_qb<T, 32>(a);
    case 16: return launch_qb<T, 16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The layout ops/ivf_scan.py mirrors, which it checks once a build:
// out[0..7] = QB_MAX, QW, R, DS, NS, WIDE_QB, ROW_PAD, TF32_MASK. Returns 0.
extern "C" int ivf_scan_layout(int* out) {
  const int v[8] = {QB_MAX, QW, R, DS, NS, WIDE_QB, ROW_PAD, (int)TF32_MASK};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// The dynamic shared memory a launch of qb queries a CTA asks for at
// dimension d, k and list items of isz bytes, with the cut queries in
// shared memory (qglobal 0) or read through the caches, for a metric
// (2 = cosine also stages li), staging ns (2 or 3) depth slices at once.
extern "C" int ivf_scan_smem_bytes(int qb, int d, int k, int isz, int qglobal, int metric,
                                   int ns) {
  return layout(qb, d, k, isz, qglobal != 0, metric == kCos, ns).total;
}

// dtype: 0 = f32, 1 = bf16, 2 = int8, 3 = uint8. metric: 0 = L2, 1 = IP,
// 2 = cosine. list_data [n_units][gm][d] (16-byte aligned), ln/li
// [n_units][gm], queries [n_qt * qt][d] f32. The tiles are taken G at a
// time: work [cdiv(n_qt, G)][W] i32 lists each group's n_work[group] chunks
// of 64 rows that hold a filled slot first (entry unit * cdiv(gm, 64) +
// chunk, the probe steps dealt out to the shares), and work_mask, beside
// it, bit j set where the group's tile j lists the entry's unit (null when
// G = 1: the one tile lists every unit of its work). ln and li are 16-byte
// aligned. kth_key [n_qt * qt] i32 set to 0x7f800000 (+inf): the smallest
// k-th score any CTA has reached for each query (order_key). The filter's
// error bound (the wrapper's filter_error): |dot_tc - dot| <= kappa T + eps
// with T >= |q~| |y~| the product of the cut query's and row's norms, both
// summed and rooted rounding upward here. qb (128, 64, 32 or 16)
// queries share a CTA, read through the caches when qglobal is 1; ns (3,
// or 2 where 3 do not fit) depth slices are staged at once; n_split in
// [1, 1024] CTAs share each (tile group, query group)'s listed chunks, and
// with n_split > 1 part_v/part_s are scratch of [n_split + cdiv(n_split,
// 32)][n_qt * qt][k] (past 32 shares the partial lists fold 32 at a time,
// then once more). prof_rec is
// null, or zeroed int64 [CTAs][prof::RECORD] for the stage clock; check_rec
// is null, or zeroed int64 [CTAs][3] for the checking instantiation
// (violations, survivors, pairs). Returns a cudaError_t (0 = launched). k
// must be in [1, 256], G in [1, 32].
extern "C" int ivf_scan_fused_list_topk(const void* list_data, int dtype, const float* ln,
                                        const int* li, const float* queries, const int* work,
                                        const int* n_work, const int* work_mask, int* kth_key,
                                        float* out_v, int* out_s, float* part_v, int* part_s,
                                        long long* prof_rec, long long* check_rec, int n_split,
                                        int n_qt, int gm, int d, int qt, int G,
                                        int W, int k, int metric, int qb, int qglobal, int ns,
                                        float kappa, float eps, void* stream) {
  if (k < 1 || k > topk::MAX_K || n_split < 1 || n_split > MAX_SHARES || d < 1 || G < 1 ||
      G > 32 || (G > 1 && !work_mask) || (prof_rec && check_rec) || metric < 0 || metric > 2 ||
      ns < 2 || ns > NS ||
      ((reinterpret_cast<uintptr_t>(list_data) | reinterpret_cast<uintptr_t>(ln) |
        reinterpret_cast<uintptr_t>(li)) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{list_data, ln, li, queries, work, n_work, work_mask, kth_key,
         n_split > 1 ? part_v : out_v, n_split > 1 ? part_s : out_s,
         n_qt, gm, d, qt, G, W, k, metric, n_split, qglobal, ns, kappa, eps, prof_rec,
         check_rec, static_cast<cudaStream_t>(stream)};
  int err;
  switch (dtype) {
    case 0: err = launch_type<float>(a, qb); break;
    case 1: err = launch_type<__nv_bfloat16>(a, qb); break;
    case 2: err = launch_type<int8_t>(a, qb); break;
    case 3: err = launch_type<uint8_t>(a, qb); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || n_split == 1) return err;
  const int rows = n_qt * qt;
  if (n_split <= topk::MAX_SPLIT) {
    return topk::launch_merge(part_v, part_s, out_v, out_s, rows, k, n_split, a.stream);
  }
  // fold the shares 32 at a time into the scratch behind them, then those
  const long long plane = (long long)rows * k;
  const int n_fold = (n_split + topk::MAX_SPLIT - 1) / topk::MAX_SPLIT;
  for (int f = 0; f < n_fold && err == 0; ++f) {
    const long long at = (long long)f * topk::MAX_SPLIT * plane;
    const long long to = (long long)(n_split + f) * plane;
    err = topk::launch_merge(part_v + at, part_s + at, part_v + to, part_s + to, rows, k,
                             min(topk::MAX_SPLIT, n_split - f * topk::MAX_SPLIT), a.stream);
  }
  if (err != 0) return err;
  const long long at = (long long)n_split * plane;
  return topk::launch_merge(part_v + at, part_s + at, out_v, out_s, rows, k, n_fold, a.stream);
}
