// Fused probed-list RaBitQ scan with an exact running top-k, for IVF-RaBitQ
// search.
//
// Replaces the Pallas TPU kernel
// raft_tpu/ops/pallas/rabitq_scan.py::fused_rabitq_topk (pallas_call at :314,
// body _make_rabitq_kernel at :152).
//
// What it computes. Queries arrive sorted into tiles of `qt` rows as rotated
// f32 vectors q_rot [D]. For query tile i and every probe step j < P with
// probe_valid[i, j] > 0, every row of unit u = tile_probes[i, j] (gm rows of
// D / 8 bytes of sign bits, bit t of byte s = dimension 8 s + t; G lists of
// m = gm / G rows) is scored with the unbiased RaBitQ estimator
//   score = ln[slot] - coef * qc - g[slot] * (b . q_rot - sum(q_rot) / 2)
// with coef = 2 for L2 (L2Expanded, L2SqrtExpanded) and 1 for IP, qc = q_rot .
// c_rot of the row's list (computed here per (query, list)), b . q_rot the sum
// of the query lanes whose bit is set, and ln (C1, +inf on empty or filtered
// slots) and g the per-slot channels the wrapper prepares. Each query keeps
// the exact k smallest (score, slot) pairs, slot = u * gm + row (topk.cuh).
//
// Precision. The scores that enter a list are all f32 and exact to the plain
// PyTorch version's bits: b . q_rot, sum(q_rot) and qc are summed in dimension
// order and the estimator uses the rounded intrinsics, which the compiler
// never contracts into FMAs.
//
// Bound on the H100. Per tile the work is a dense product of qt queries with
// the 0/1 plane of the filled rows of its valid units (qt x rows x D), then
// about four FP32 operations per (query, row) for the estimator; one bf16
// pass of the product on the tensor cores (989e12 FLOP/s) binds, the bytes
// (16 B of codes and 12 B of channels a row, read once) are far below.
//
// Design: a tensor-core filter, then an exact re-score. A CTA holds QB = 8-64
// queries, eight per warp; warp w owns queries 8w .. 8w + 7, their lists,
// candidate buffers and counts, so it buffers and merges without shared
// atomics or a CTA barrier. The chunks of R rows of a tile's units that hold
// a valid slot (the wrapper lists them, so list padding costs nothing; its
// probe steps dealt out in turn, so that the few units near the tile's
// queries, which hold most of the candidates, do not fall to one CTA) are
// shared out in equal counts to the n_split CTAs of a (tile, query group),
// staged three deep with cp.async (the chunk's code bytes, ln and g as three
// contiguous spans), unpacked once per CTA through a 256-entry byte table
// into a bf16 0/1 plane in shared memory, and multiplied by every warp with
// mma.sync.m16n8k16 (bits as A from ldmatrix.x4, the warp's bf16 queries
// hi = bf16_rn(q_rot) as B from ldmatrix.x2, f32 sums). Then
// |acc - b . q_rot| <= delta_q = sum |q - hi| + 8 D16 2^-23 sum |q| (the
// wrapper's filter_error: the bf16 rounding, the tensor core's and the plain
// sum's f32 rounding), and since round-to-nearest is monotone, the estimator
// evaluated at acc + delta (g >= 0) or acc - delta (g < 0) with the same
// intrinsics is a lower bound lb of the exact score. A row is a candidate of
// a query when lb <= the query's current k-th score: the smaller of its
// list's and the smallest any CTA of the tile has published for it (an
// atomicMin on an ordered int key after each merge: a list's k-th bounds the
// final one, and a stale one only lets more through). Candidates go to the
// query's buffer as (ln - coef qc, slot), placed by a ballot's prefix count;
// at the end of each 64-row round the warp re-scores that round's candidates
// exactly (dimension order, from the staged code rows and the f32 queries in
// shared memory, one a lane across its 8 queries), and when a buffer could
// not take another round, and at the end, folds it into the sorted list, 32
// at a time (topk::warp_merge, out of line). The lists only ever hold exact
// scores, so the result is the plain version's bit for bit. Grid: (query
// group, tile, chunk share), with topk::merge_kernel folding the shares'
// partial lists. The PROF instantiation carries the stage clock
// (stage_clock.cuh); the CHECK instantiation re-scores every candidate and
// counts those whose exact score is below their lb (must be none).
//
// Depth slices. Where the queries and a chunk do not fit shared memory
// whole (rot_dim past a few hundred), the SLICED instantiation keeps no f32
// queries there: 64-row chunks are unpacked DS dimensions at a time, each
// slice beside the same slice of the bf16 queries, and the product's sums
// are carried across slices (the same k-steps in the same order, so the
// same sums); q.c and sum(q_rot) read the f32 queries through the caches,
// and each chunk's candidates are re-scored by all warps at once, slice by
// slice, with the queries' f32 slice staged over the bf16 planes. Its code
// rows are staged as above while three chunks of them fit (mode 1), else
// read from global memory (mode 2), so that its shared memory need not
// grow with rot_dim.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "stage_clock.cuh"
#include "topk.cuh"

namespace {

constexpr int QB_MAX = 64;     // most queries a CTA holds
constexpr int QW = 8;          // queries a warp owns: the product's n8 tile
constexpr int ROUND = 64;      // rows a warp scores at a time: four m16 tiles
constexpr int MT = ROUND / 16;
constexpr int CAP = 128;       // candidates a query's buffer holds
constexpr int NS = 3;          // chunks staged at once
constexpr int ROW_PAD = 16;    // bytes after each bf16 row of the planes (ldmatrix banks)
constexpr int LUT_BYTES = 256 * 16;  // byte -> eight bf16 0/1 values
constexpr int DS = 256;        // dimensions of a depth slice (SLICED)
// the sliced re-score stages a slice of f32 queries over qh and a 64-row plane
static_assert(QB_MAX * (DS + 1) * 4 <= (QB_MAX + ROUND) * (2 * DS + ROW_PAD),
              "a slice of f32 queries must fit over the bf16 planes");
constexpr unsigned FULL = 0xffffffffu;

enum Metric { kL2 = 0, kIP = 1 };
// CHECK record, int64 per CTA: lb violations, survivors of the filter, candidates
enum CheckCount { kViolations = 0, kSurvivors = 1, kCandidates = 2, CHECK_WORDS = 3 };

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Byte offsets of a CTA's dynamic shared memory; ops/rabitq_scan.py's
// cta_smem_bytes mirrors the total and checks it through rabitq_scan_smem_bytes.
// Sliced (mode 1, 2): qh and the plane hold one depth slice of DS
// dimensions and qf is not kept; mode 2 keeps no code spans either.
struct Layout {
  int qs;     // bytes between rows of qh and of the plane
  int rawb;   // bytes of one staged chunk's code span
  int fb;     // bytes of one staged chunk's ln (or g) span
  int qfs;    // floats between rows of qf
  int lut, qh, qf, plane, raw, lnb, gcb, lsb, info, hs, dl, cq2, tkv, tks, cv, cs, total;
};

// mode: 0 whole, 1 sliced with staged code rows, 2 sliced without
__host__ __device__ __forceinline__ Layout layout(int qb, int D, int k, int G, int R, int mode) {
  const bool sliced = mode != 0;
  Layout L;
  L.qs = (sliced ? DS : round16(D)) * 2 + ROW_PAD;
  L.rawb = mode == 2 ? 0 : round16(R * (D / 8) + 16);
  L.fb = R * 4 + 16;
  L.qfs = D + 1;
  int o = 0;
  L.lut = o;   o += LUT_BYTES;
  L.qh = o;    o += qb * L.qs;          // [qb][D16 or DS] bf16 hi, padded rows
  L.qf = o;    o += sliced ? 0 : round16(qb * L.qfs * 4);  // [qb][D + 1] f32 q_rot (rows one bank apart)
  L.plane = o; o += R * L.qs;           // [R][D16 or DS] bf16 0/1, padded rows
  L.raw = o;   o += NS * L.rawb;        // [NS] code spans
  L.lnb = o;   o += NS * L.fb;          // [NS] ln spans
  L.gcb = o;   o += NS * L.fb;          // [NS] g spans
  L.lsb = o;   o += NS * R * 4;         // [NS][R] list of the row
  L.info = o;  o += NS * 16;            // [NS] unit, first row, rows of the staged chunk
  L.hs = o;    o += qb * 4;             // [qb] sum(q_rot) / 2
  L.dl = o;    o += qb * 4;             // [qb] delta
  L.cq2 = o;   o += G * qb * 4;         // [G][qb] coef * q.c
  L.tkv = o;   o += qb * k * 4;         // [qb][k] list scores
  L.tks = o;   o += qb * k * 4;         // [qb][k] list slots
  L.cv = o;    o += qb * CAP * 4;       // [qb][CAP] candidates' ln - coef q.c
  L.cs = o;    o += qb * CAP * 4;       // [qb][CAP] candidates' slots
  L.total = o;
  return L;
}

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a . b, m16n8k16, bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// b . q in dimension order, as the plain version adds it: row = bpr code
// bytes (shared or global; read 16 or 4 bytes at a time where aligned so),
// q = the query's f32 row in shared memory.
__device__ __forceinline__ void add_bits(float& acc, unsigned w, int nbits, const float* q) {
#pragma unroll 8
  for (int t = 0; t < nbits; ++t) acc = __fadd_rn(acc, ((w >> t) & 1u) ? q[t] : 0.f);
}

__device__ __forceinline__ float exact_dot(const uint8_t* row, const float* q, int bpr) {
  float acc = 0.f;
  const uintptr_t a = reinterpret_cast<uintptr_t>(row);
  if ((bpr & 15) == 0 && (a & 15) == 0) {
    for (int s = 0; s < bpr; s += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + s);
      add_bits(acc, v.x, 32, q + 8 * s);
      add_bits(acc, v.y, 32, q + 8 * s + 32);
      add_bits(acc, v.z, 32, q + 8 * s + 64);
      add_bits(acc, v.w, 32, q + 8 * s + 96);
    }
  } else if ((bpr & 3) == 0 && (a & 3) == 0) {
    for (int s = 0; s < bpr; s += 4) add_bits(acc, *reinterpret_cast<const unsigned*>(row + s), 32, q + 8 * s);
  } else {
    for (int s = 0; s < bpr; ++s) add_bits(acc, row[s], 8, q + 8 * s);
  }
  return acc;
}

// The same sum with q read through the caches (the sliced
// instantiation's checking launch): 64 bits at a time, their 64 values
// loaded before the first of their adds. row: shared or global.
__device__ __forceinline__ float exact_dot_far(const uint8_t* row, const float* q, int bpr) {
  float acc = 0.f;
  const int D = 8 * bpr;
#pragma unroll 1
  for (int s = 0; s < bpr; s += 8) {
    unsigned long long w = 0ull;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (s + i < bpr) w |= (unsigned long long)row[s + i] << (8 * i);
    }
    float v[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) v[i] = 8 * s + i < D ? q[8 * s + i] : 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (8 * s + i < D) acc = __fadd_rn(acc, ((w >> i) & 1ull) ? v[i] : 0.f);
    }
  }
  return acc;
}

// A float as an int whose signed order is the float's (-0 below +0), for
// atomicMin on a shared k-th score; and back.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// The estimator, with the plain version's roundings: t2 = ln - coef qc.
__device__ __forceinline__ float estimate(float t2, float g, float dot, float h) {
  return __fsub_rn(t2, __fmul_rn(g, __fsub_rn(dot, h)));
}

// Copy `bytes` bytes from global `src` to shared `dst` as 16-byte pieces
// from src rounded down to 16 bytes (the tail zero-filled, nothing read past
// src + bytes); the data starts at dst + (src & 15).
__device__ __forceinline__ void copy_span(unsigned char* dst, const void* src, int bytes, int tid,
                                          int n_threads) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const unsigned char* a0 = reinterpret_cast<const unsigned char*>(a & ~uintptr_t(15));
  const int total = (int)(a & 15) + bytes;
#pragma unroll 1
  for (int i = tid; 16 * i < total; i += n_threads) {
    cp_async16(dst + 16 * i, a0 + 16 * i, min(16, total - 16 * i));
  }
}

template <typename T>
__device__ __forceinline__ const T* span_at(const unsigned char* dst, const void* src) {
  return reinterpret_cast<const T*>(dst + (reinterpret_cast<uintptr_t>(src) & 15));
}

// coef * q.c of each of the CTA's qb queries (live of them; rows qfs floats
// apart in qf) with each of a unit's G list centers c [G][D], summed in
// dimension order, into cq2 [G][qb]. Out of line, as it runs once a unit:
// the chunk loop's code stays small enough for the instruction caches.
__device__ __noinline__ void qc_terms(float* cq2, const float* qf, const float* __restrict__ c,
                                      int qb, int live, int G, int D, int qfs, float coef, int tid,
                                      int n_threads) {
  for (int e = tid; e < qb * G; e += n_threads) {
    const int q = e % qb;
    const int li = e / qb;
    float s = 0.f;
    if (q < live) {  // a warp's lanes share a list: its center row loads once a warp
      const float* qp = qf + q * qfs;
      const float* cp = c + (long long)li * D;
      for (int t = 0; t < D; ++t) s = __fadd_rn(s, __fmul_rn(qp[t], __ldg(cp + t)));
    }
    cq2[li * qb + q] = coef * s;
  }
}

// Fold a query's n buffered candidates (cvq: exact scores, csq: slots) into
// its sorted list (tv, ts), 32 at a time. Called by a whole warp, out of
// line: it runs rarely, and the chunk loop's code stays small.
template <bool PROF>
__device__ __noinline__ void merge_buffer(float* tv, int* ts, float* cvq, int* csq, int n, int k,
                                          int lane, prof::StageClock<PROF>& clk, int& n_merge) {
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool in = i < n;
    const float s = in ? cvq[i] : INFINITY;
    const int slot = in ? csq[i] : topk::SLOT_EMPTY;
    topk::warp_merge(tv, ts, k, s, slot, in && s < INFINITY, cvq + base, csq + base, lane);
    if (PROF) ++n_merge;
  }
  __syncwarp();
  clk.lap(prof::kRqMerge);
}

template <int QB, bool PROF, bool CHECK, bool SLICED>
__global__ void __launch_bounds__(QB / QW * 32, 1)
rabitq_filter_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ ln,
                     const float* __restrict__ corr, const float* __restrict__ q_rot,
                     const __nv_bfloat16* __restrict__ q_hi, const float* __restrict__ delta,
                     const float* __restrict__ crot, const int* __restrict__ work,
                     const int* __restrict__ n_work, int* __restrict__ kth_key,
                     float* __restrict__ out_v,
                     int* __restrict__ out_s, int gm, int G, int bpr, int qt, int W, int k,
                     int metric, int R, int mode, long long* __restrict__ prof_rec,
                     long long* __restrict__ check_rec) {
  constexpr int WARPS = QB / QW;
  constexpr int THREADS = WARPS * 32;
  const int D = bpr * 8;
  const int D16 = round16(D);
  const Layout L = layout(QB, D, k, G, R, mode);
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* lut = reinterpret_cast<uint4*>(smem + L.lut);
  unsigned char* qh = smem + L.qh;
  unsigned char* plane = smem + L.plane;
  int* lsb = reinterpret_cast<int*>(smem + L.lsb);
  int4* info = reinterpret_cast<int4*>(smem + L.info);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* dl = reinterpret_cast<float*>(smem + L.dl);
  float* cq2 = reinterpret_cast<float*>(smem + L.cq2);
  float* tk_v = reinterpret_cast<float*>(smem + L.tkv);
  int* tk_s = reinterpret_cast<int*>(smem + L.tks);
  float* cv = reinterpret_cast<float*>(smem + L.cv);
  int* cs = reinterpret_cast<int*>(smem + L.cs);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.y;
  const int q0 = blockIdx.x * QB;           // first query of this CTA within the tile
  const int live = min(QB, qt - q0);        // live queries of this CTA
  const long long qrow0 = (long long)tile * qt + q0;
  const int n_split = gridDim.z;
  const int split = blockIdx.z;
  const long long nq_pad = (long long)gridDim.y * qt;
  const int m = gm / G;
  const int n_chunks = (gm + R - 1) / R;
  const float coef = metric == kIP ? 1.0f : 2.0f;
  // the CTA's f32 queries: in shared memory, or (SLICED) read through the caches
  float* qf_smem = reinterpret_cast<float*>(smem + L.qf);
  const float* qf = SLICED ? q_rot + qrow0 * D : qf_smem;
  const int qfs = SLICED ? D : L.qfs;
  prof::StageClock<PROF> clk;
  clk.start();

  // ---- the CTA's queries, lists and byte table ----
  topk::init(tk_v, tk_s, QB * k, tid, THREADS);
  for (int e = tid; e < 256; e += THREADS) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = (((e >> (2 * i)) & 1) ? 0x3F80u : 0u) | (((e >> (2 * i + 1)) & 1) ? 0x3F800000u : 0u);
    }
    lut[e] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  const int g16 = D16 / 8;  // 16-byte groups of a bf16 row
  // qh's [qb][16 g] slice from dimension 8 s0g (zero past D or the live
  // queries), eight loads a thread in flight at a time
  auto load_qh = [&](int s0g, int g) {
#pragma unroll 1
    for (int e0 = tid; e0 < QB * g; e0 += 8 * THREADS) {
      uint4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = e0 + i * THREADS;
        const int q = e / g;
        const int s = e - q * g;
        v[i] = make_uint4(0u, 0u, 0u, 0u);
        if (e < QB * g && q < live && 8 * (s0g + s) < D) {
          v[i] = __ldg(reinterpret_cast<const uint4*>(q_hi + (qrow0 + q) * D) + s0g + s);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = e0 + i * THREADS;
        const int q = e / g;
        if (e < QB * g) *reinterpret_cast<uint4*>(qh + q * L.qs + 16 * (e - q * g)) = v[i];
      }
    }
  };
  if (!SLICED) {
    load_qh(0, g16);
    for (int e = tid; e < QB * D; e += THREADS) {
      const int q = e / D;
      qf_smem[q * L.qfs + e - q * D] = q < live ? q_rot[qrow0 * D + e] : 0.f;
    }
  }
  __syncthreads();
  if (tid < QB) {  // sum(q_rot) / 2, the sum in dimension order
    float s = 0.f;
    if (tid < live) {
      for (int t = 0; t < D; ++t) s = __fadd_rn(s, qf[tid * qfs + t]);
    }
    hs[tid] = 0.5f * s;
    dl[tid] = tid < live ? delta[qrow0 + tid] : 0.f;
  }

  // the CTA's share of its tile's listed chunks (entry = unit * n_chunks + chunk)
  const int* wl = work + (long long)tile * W;
  const int nw = n_work[tile];
  const int lo = (int)((long long)nw * split / n_split);
  const int hi = (int)((long long)nw * (split + 1) / n_split);
  int s_idx = lo;                              // the next chunk to stage
  int s_next = lo < hi ? wl[lo] : 0;           // its entry, loaded a stage ahead

  // stage a chunk into slot `b`: its code, ln and g spans and each row's list
  auto stage = [&](int b) {
    if (s_idx < hi) {
      const int e = s_next;
      ++s_idx;
      if (s_idx < hi) s_next = wl[s_idx];
      const int u = e / n_chunks;
      const int r0 = (e - u * n_chunks) * R;
      const int n = min(R, gm - r0);
      const long long row0 = (long long)u * gm + r0;
      if (!SLICED || L.rawb) {
        copy_span(smem + L.raw + b * L.rawb, codes + row0 * bpr, n * bpr, tid, THREADS);
      }
      copy_span(smem + L.lnb + b * L.fb, ln + row0, n * 4, tid, THREADS);
      copy_span(smem + L.gcb + b * L.fb, corr + row0, n * 4, tid, THREADS);
#pragma unroll 1
      for (int i = tid; i < n; i += THREADS) lsb[b * R + i] = (r0 + i) / m;
      if (tid == 0) info[b] = make_int4(u, r0, n, 0);
    }
    cp_async_commit();
  };
  stage(0);
  stage(1);
  clk.lap(prof::kRqCodes);

  // this lane's place in the product's fragments: rows g and g + 8 of each
  // m16 tile, queries qa = 8 w + 2 t and qa + 1 of the warp's n8 tile
  const int fg = lane >> 2;
  const int ft = lane & 3;
  const int qw0 = warp * QW;
  const int qa = qw0 + 2 * ft;
  const bool warp_live = qw0 < live;
  const bool live_a = qa < live, live_b = qa + 1 < live;
  float kth_a = INFINITY, kth_b = INFINITY;
  int n_surv = 0, n_merge = 0;                  // PROF
  long long n_viol = 0, n_cand = 0, n_pass = 0;  // CHECK
  const float* qf_a = qf + qa * qfs;
  const float* qf_b = qf_a + qfs;
  const float inv_g16 = 1.0f / g16;

  // candidates buffered for queries qa and qa + 1, and how many of them are
  // re-scored: the same in the 8 lanes that share the pair (lanes ft,
  // ft + 4, ...), so appends need no atomics
  int cnt_a = 0, cnt_b = 0, done_a = 0, done_b = 0;
  const unsigned same = 0x11111111u << ft;
  const unsigned below = (1u << lane) - 1u;
  // lane j < 8: the count and the re-scored count of query qw0 + j
  auto counts = [&](int& n, int& d) {
    const int j = lane & 7;
    const int ca = __shfl_sync(FULL, cnt_a, j >> 1), cb = __shfl_sync(FULL, cnt_b, j >> 1);
    const int da = __shfl_sync(FULL, done_a, j >> 1), db = __shfl_sync(FULL, done_b, j >> 1);
    n = (j & 1) ? cb : ca;
    d = (j & 1) ? db : da;
  };
  // merge the buffers of the warp's queries that could not take another
  // round (``all``: every one that holds a candidate), then reread the
  // k-th scores; the buffers hold exact scores (rescore_round runs first)
  auto flush = [&](bool all) {
    int n, d;
    counts(n, d);
    unsigned need = __ballot_sync(FULL, lane < QW && qw0 + (lane & 7) < live &&
                                            (all ? n > 0 : n > CAP - ROUND));
    if (!need) return;
    while (need) {
      const int i = __ffs(need) - 1;
      need &= need - 1;
      const int q = qw0 + i;
      merge_buffer<PROF>(tk_v + q * k, tk_s + q * k, cv + q * CAP, cs + q * CAP,
                         __shfl_sync(FULL, n, i), k, lane, clk, n_merge);
      // the list's k-th score bounds the query's final k-th: share it with
      // the CTAs that scan the tile's other chunks
      if (lane == 0 && tk_v[q * k + k - 1] < INFINITY) {
        atomicMin(kth_key + qrow0 + q, order_key(tk_v[q * k + k - 1]));
      }
      if (ft == (i >> 1)) {
        if (i & 1) cnt_b = done_b = 0; else cnt_a = done_a = 0;
      }
    }
    kth_a = tk_v[qa * k + k - 1];
    kth_b = tk_v[(qa + 1) * k + k - 1];
  };
  // f(q, at) for each candidate the warp's queries appended since their
  // last re-score (q the CTA's query, at its place in cv / cs), dealt one
  // a lane in rounds of 32 across the warp's 8 queries; returns how many
  auto each_fresh = [&](auto&& f) {
    int n, d;
    counts(n, d);
    const int j = lane & 7;
    const int fresh = lane < QW && qw0 + j < live ? n - d : 0;
    int incl = fresh;  // inclusive prefix over lanes 0..7
#pragma unroll
    for (int off = 1; off < QW; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (j >= off) incl += v;
    }
    const int total = __shfl_sync(FULL, incl, QW - 1);
    const int excl = incl - fresh;
    for (int base = 0; base < total; base += 32) {
      const int idx = base + lane;
      int sel = 0;  // the last query whose run starts at or before idx
#pragma unroll
      for (int jj = 1; jj < QW; ++jj) sel = idx >= __shfl_sync(FULL, excl, jj) ? jj : sel;
      const int start = __shfl_sync(FULL, excl, sel);
      const int first = __shfl_sync(FULL, d, sel);
      if (idx < total) f(qw0 + sel, (qw0 + sel) * CAP + first + idx - start);
    }
    return total;
  };
  // re-score exactly the candidates this round appended (their rows are in
  // the staged chunk: bits from shared memory, g from the staged span) and
  // put the exact scores in place
  auto rescore_round = [&](const unsigned char* raw, const float* gcc, long long row0) {
    each_fresh([&](int q, int at) {
      const int r = (int)(cs[at] - row0);
      cv[at] = estimate(cv[at], gcc[r], exact_dot(raw + r * bpr, qf + q * qfs, bpr), hs[q]);
    });
    done_a = cnt_a;
    done_b = cnt_b;
    __syncwarp();  // the exact scores are in place before a flush reads them
    clk.warp_lap(prof::kRqRescore);
  };
  // SLICED: the same by every warp at once, a depth slice at a time: the
  // CTA's f32 queries of the slice staged over qh and the plane ([QB][DS +
  // 1], which fits them), each candidate's partial sum carried in cv in
  // dimension order, then the estimator with t2 formed again as the filter
  // formed it. Returns at once when no warp of the CTA has a candidate.
  auto rescore_sliced = [&](const unsigned char* raw, const float* lnc, const float* gcc,
                            const int* lsc, long long row0) {
    const int total = each_fresh([&](int, int at) { cv[at] = 0.f; });
    if (!__syncthreads_or(total > 0)) return;
    clk.lap(prof::kRqBarrier);
    float* qsl = reinterpret_cast<float*>(qh);
#pragma unroll 1
    for (int s0 = 0; s0 < D; s0 += DS) {
      const int w = min(DS, D - s0);  // dimensions of the slice, a multiple of 8
      if (s0 > 0) {
        __syncthreads();  // every warp is done with the last slice
        clk.lap(prof::kRqBarrier);
      }
      const int w4 = w / 4;
#pragma unroll 1
      for (int e0 = tid; e0 < QB * w4; e0 += 8 * THREADS) {  // eight loads a thread in flight
        float4 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = e0 + i * THREADS;
          const int q = e / w4;
          v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (e < QB * w4 && q < live) {
            v[i] = __ldg(reinterpret_cast<const float4*>(q_rot + (qrow0 + q) * D + s0) + e - q * w4);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = e0 + i * THREADS;
          const int q = e / w4;
          if (e < QB * w4) {
            float* dst = qsl + q * (DS + 1) + 4 * (e - q * w4);
            dst[0] = v[i].x;
            dst[1] = v[i].y;
            dst[2] = v[i].z;
            dst[3] = v[i].w;
          }
        }
      }
      clk.lap(prof::kRqCodes);
      __syncthreads();
      clk.lap(prof::kRqBarrier);
      each_fresh([&](int q, int at) {
        const uint8_t* row = raw + (cs[at] - row0) * bpr + s0 / 8;
        const float* qq = qsl + q * (DS + 1);
        float p = cv[at];
#pragma unroll 4
        for (int b = 0; b < w / 8; ++b) {
          const unsigned byte = row[b];
#pragma unroll
          for (int t = 0; t < 8; ++t) p = __fadd_rn(p, ((byte >> t) & 1u) ? qq[8 * b + t] : 0.f);
        }
        cv[at] = p;
      });
      clk.lap(prof::kRqRescore);
    }
    each_fresh([&](int q, int at) {
      const int r = (int)(cs[at] - row0);
      cv[at] = estimate(__fsub_rn(lnc[r], cq2[lsc[r] * QB + q]), gcc[r], cv[at], hs[q]);
    });
    done_a = cnt_a;
    done_b = cnt_b;
    __syncwarp();  // the exact scores are in place before a flush reads them
    clk.lap(prof::kRqRescore);
  };
  __syncthreads();
  clk.lap(prof::kRqBarrier);

  int unit = -1;
  for (int chunk = 0; lo + chunk < hi; ++chunk) {
    const int b = chunk % NS;
    cp_async_wait_prev();  // this chunk's copies are done (the next one may be in flight)
    clk.lap(prof::kRqCodes);
    __syncthreads();       // every thread's copies landed; the last chunk is scored
    clk.lap(prof::kRqBarrier);
    stage((chunk + 2) % NS);
    const int4 ci = info[b];
    const int u = ci.x, r0 = ci.y, n = ci.z;
    const long long row0 = (long long)u * gm + r0;
    // the chunk's code rows: staged, or (mode 2) read through the caches
    const unsigned char* raw =
        SLICED && !L.rawb ? codes + row0 * bpr
                          : span_at<unsigned char>(smem + L.raw + b * L.rawb, codes + row0 * bpr);
    if (u != unit) {
      unit = u;
      qc_terms(cq2, qf, crot + (long long)u * G * D, QB, live, G, D, qfs, coef, tid, THREADS);
    }
    float acc[MT][4];
    if (!SLICED) {
      // unpack the chunk's code bytes into the bf16 plane (zero past D), four
      // 16-byte groups a thread at a time
      const int n_e = n * g16;
#pragma unroll 1
      for (int e0 = tid; e0 < n_e; e0 += 4 * THREADS) {
        uint4 v[4];
        int at[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = e0 + i * THREADS;
          const int r = __float2int_rz((e + 0.5f) * inv_g16);
          const int s = e - r * g16;
          at[i] = e < n_e ? r * L.qs + 16 * s : -1;
          v[i] = lut[(e < n_e && s < bpr) ? raw[r * bpr + s] : 0];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (at[i] >= 0) *reinterpret_cast<uint4*>(plane + at[i]) = v[i];
        }
      }
      clk.lap(prof::kRqCodes);
      __syncthreads();
      clk.lap(prof::kRqBarrier);
    } else {
      // one round (R = ROUND) a chunk: its product summed over the depth
      // slices, each unpacked beside the queries' same slice
#pragma unroll
      for (int t = 0; t < MT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll 1
      for (int s0 = 0; s0 < D16; s0 += DS) {
        const int gs = min(DS, D16 - s0) / 8;  // 16-byte groups of the slice's bf16 rows
        if (s0 > 0) {
          __syncthreads();  // every warp is done with the last slice
          clk.lap(prof::kRqBarrier);
        }
        load_qh(s0 / 8, gs);
        const int n_e = n * gs;
#pragma unroll 1
        for (int e0 = tid; e0 < n_e; e0 += 4 * THREADS) {
          uint4 v[4];
          int at[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = e0 + i * THREADS;
            const int r = e / gs;
            const int s = s0 / 8 + e - r * gs;
            at[i] = e < n_e ? r * L.qs + 16 * (e - r * gs) : -1;
            v[i] = lut[(e < n_e && s < bpr) ? raw[r * bpr + s] : 0];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (at[i] >= 0) *reinterpret_cast<uint4*>(plane + at[i]) = v[i];
          }
        }
        clk.lap(prof::kRqCodes);
        __syncthreads();
        clk.lap(prof::kRqBarrier);
        if (warp_live) {
          const unsigned char* pa = plane + (lane & 15) * L.qs + (lane >> 4) * 16;
          const unsigned char* pb = qh + (qw0 + (lane & 7)) * L.qs + ((lane >> 3) & 1) * 16;
#pragma unroll 2
          for (int kb = 0; kb < gs / 2; ++kb) {
            unsigned bf[2];
            ldsm_x2(bf, pb + kb * 32);
#pragma unroll
            for (int t = 0; t < MT; ++t) {
              unsigned af[4];
              ldsm_x4(af, pa + t * 16 * L.qs + kb * 32);
              mma_bf16(acc[t], af, bf);
            }
          }
          clk.lap(prof::kRqMma);
        }
      }
    }

    const float* lnc = span_at<float>(smem + L.lnb + b * L.fb, ln + row0);
    const float* gcc = span_at<float>(smem + L.gcb + b * L.fb, corr + row0);
    const int* lsc = lsb + b * R;
    if (warp_live) {
#pragma unroll 1
      for (int rb = 0; rb < n; rb += ROUND) {
        flush(false);
        // the smallest k-th score any CTA of the tile has for these queries
        // (read now, used after the product; a stale one lets more through)
        const int key_a = live_a ? __ldcg(kth_key + qrow0 + qa) : 0x7f800000;
        const int key_b = live_b ? __ldcg(kth_key + qrow0 + qa + 1) : 0x7f800000;
        if (!SLICED) {
#pragma unroll
          for (int t = 0; t < MT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
          const unsigned char* pa = plane + (rb + (lane & 15)) * L.qs + (lane >> 4) * 16;
          const unsigned char* pb = qh + (qw0 + (lane & 7)) * L.qs + ((lane >> 3) & 1) * 16;
#pragma unroll 2
          for (int kb = 0; kb < D16 / 16; ++kb) {
            unsigned bf[2];
            ldsm_x2(bf, pb + kb * 32);
#pragma unroll
            for (int t = 0; t < MT; ++t) {
              unsigned af[4];
              ldsm_x4(af, pa + t * 16 * L.qs + kb * 32);
              mma_bf16(acc[t], af, bf);
            }
          }
          clk.lap(prof::kRqMma);
        }
        const float da = dl[qa], db = dl[qa + 1];
        const float ha = hs[qa], hb = hs[qa + 1];
        const float thr_a = fminf(kth_a, key_value(key_a));
        const float thr_b = fminf(kth_b, key_value(key_b));
#pragma unroll
        for (int t = 0; t < MT; ++t) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = rb + 16 * t + fg + 8 * half;  // < R: the reads stay in the buffers
            const bool valid = r < n && lnc[r] < INFINITY;
            const float l = lnc[r];
            const float g = gcc[r];
            const float2 cq = *reinterpret_cast<const float2*>(cq2 + (r < n ? lsc[r] : 0) * QB + qa);
            const int slot = (int)(row0 + r);
            const float t2a = __fsub_rn(l, cq.x);
            const float t2b = __fsub_rn(l, cq.y);
            // the estimator at the end of [acc - delta, acc + delta] that minimises it
            const float lba = estimate(t2a, g, __fadd_rn(acc[t][2 * half], copysignf(da, g)), ha);
            const float lbb = estimate(t2b, g, __fadd_rn(acc[t][2 * half + 1], copysignf(db, g)), hb);
            const bool pass_a = valid && live_a && !(lba > thr_a);
            const bool pass_b = valid && live_b && !(lbb > thr_b);
            const unsigned ma = __ballot_sync(FULL, pass_a) & same;
            const unsigned mb = __ballot_sync(FULL, pass_b) & same;
            if (pass_a) {
              const int at = cnt_a + __popc(ma & below);
              cv[qa * CAP + at] = t2a;
              cs[qa * CAP + at] = slot;
            }
            if (pass_b) {
              const int at = cnt_b + __popc(mb & below);
              cv[(qa + 1) * CAP + at] = t2b;
              cs[(qa + 1) * CAP + at] = slot;
            }
            cnt_a += __popc(ma);
            cnt_b += __popc(mb);
            if (PROF) n_surv += (int)pass_a + (int)pass_b;
            if (CHECK && valid) {
              const uint8_t* row = raw + r * bpr;
              if (live_a) {
                const float ex = estimate(
                    t2a, g, SLICED ? exact_dot_far(row, qf_a, bpr) : exact_dot(row, qf_a, bpr), ha);
                n_viol += ex < lba;
                n_pass += pass_a;
                ++n_cand;
              }
              if (live_b) {
                const float ex = estimate(
                    t2b, g, SLICED ? exact_dot_far(row, qf_b, bpr) : exact_dot(row, qf_b, bpr), hb);
                n_viol += ex < lbb;
                n_pass += pass_b;
                ++n_cand;
              }
            }
          }
        }
        __syncwarp();  // the appended candidates are in place before their re-score
        clk.warp_lap(prof::kRqFilter);
        if (!SLICED) rescore_round(raw, gcc, row0);
      }
    }
    if (SLICED) rescore_sliced(raw, lnc, gcc, lsc, row0);
  }
  cp_async_wait_all();
  if (warp_live) flush(true);
  __syncthreads();
  clk.lap(prof::kRqBarrier);

  topk::write_out(tk_v, tk_s, k, live, qrow0, nq_pad, split, n_split, out_v, out_s, warp, WARPS,
                  lane);
  if (PROF) {
    const int surv = __reduce_add_sync(FULL, (unsigned)n_surv);
    if (lane == 0) {
      clk.count(prof_rec, prof::kRqSurvivors, surv);
      clk.count(prof_rec, prof::kRqMerges, n_merge);
    }
  }
  if (CHECK) {
    long long* row = check_rec +
                     (long long)(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) *
                         CHECK_WORDS;
    const long long v[CHECK_WORDS] = {n_viol, n_pass, n_cand};
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

template <int QB, bool PROF, bool CHECK, bool SLICED>
int launch(const uint8_t* codes, const float* ln, const float* corr, const float* q_rot,
           const __nv_bfloat16* q_hi, const float* delta, const float* crot,
           const int* work, const int* n_work, int* kth_key, float* out_v,
           int* out_s, int n_split, int n_qt, int gm, int G, int bpr, int qt, int W, int k,
           int metric, int R, int mode, long long* prof_rec, long long* check_rec,
           cudaStream_t stream) {
  const int smem = layout(QB, bpr * 8, k, G, R, mode).total;
  cudaError_t err = cudaFuncSetAttribute(rabitq_filter_kernel<QB, PROF, CHECK, SLICED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((qt + QB - 1) / QB, n_qt, n_split);
  rabitq_filter_kernel<QB, PROF, CHECK, SLICED><<<grid, QB / QW * 32, smem, stream>>>(
      codes, ln, corr, q_rot, q_hi, delta, crot, work, n_work, kth_key, out_v, out_s, gm, G, bpr,
      qt, W, k, metric, R, mode, prof_rec, check_rec);
  return (int)cudaGetLastError();
}

template <int QB, bool SLICED>
int launch_mode(const uint8_t* codes, const float* ln, const float* corr, const float* q_rot,
                const __nv_bfloat16* q_hi, const float* delta, const float* crot,
                const int* work, const int* n_work, int* kth_key,
                float* out_v, int* out_s, int n_split, int n_qt, int gm, int G, int bpr, int qt,
                int W, int k, int metric, int R, int mode, long long* prof_rec, long long* check_rec,
                cudaStream_t stream) {
#define RQ_LAUNCH(PROF, CHECK)                                                                  \
  launch<QB, PROF, CHECK, SLICED>(codes, ln, corr, q_rot, q_hi, delta, crot, work, n_work,     \
                                  kth_key, out_v, out_s, n_split, n_qt, gm, G, bpr, qt, W, k,  \
                                  metric, R, mode, prof_rec, check_rec, stream)
  if (prof_rec) return RQ_LAUNCH(true, false);
  if (check_rec) return RQ_LAUNCH(false, true);
  return RQ_LAUNCH(false, false);
#undef RQ_LAUNCH
}

}  // namespace

// The layout ops/rabitq_scan.py mirrors, which it checks once a build:
// out[0..7] = QB_MAX, QW, ROUND, CAP, NS, ROW_PAD, LUT_BYTES, DS. Returns 0.
extern "C" int rabitq_scan_layout(int* out) {
  const int v[8] = {QB_MAX, QW, ROUND, CAP, NS, ROW_PAD, LUT_BYTES, DS};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// The dynamic shared memory a launch of qb queries a CTA and R rows a chunk
// asks for, at rot_dim D, k and G lists a unit, in layout mode 0, 1 or 2.
extern "C" int rabitq_scan_smem_bytes(int qb, int D, int k, int G, int R, int mode) {
  return layout(qb, D, k, G, R, mode).total;
}

// metric: 0 = L2, 1 = IP. codes [n_units][gm][bpr] u8 (D = 8 * bpr sign bits),
// ln/corr [n_units][gm] f32 (the three 16-byte aligned), q_rot [n_qt * qt][D]
// f32, q_hi [n_qt * qt][D] bf16 (bf16_rn of q_rot), delta [n_qt * qt] f32
// (the filter's error bound), crot [n_units][G][D] f32, work [n_qt][W] i32
// listing each tile's n_work[tile] chunks of R rows that hold a valid slot
// first (entry unit * cdiv(gm, R) + chunk, in probe-step order), kth_key
// [n_qt * qt] i32 set to 0x7f800000 (+inf): the smallest k-th score any CTA
// has reached for each query (order_key). qb (64, 32,
// 16 or 8) queries share a CTA, R (a multiple of 64; 64 when sliced) rows a
// chunk, mode 0 for the whole layout, 1 or 2 for the depth-sliced
// instantiation with or without staged code rows; n_split in
// [1, 32] CTAs share each (tile, query group)'s listed chunks, and with
// n_split > 1 part_v/part_s are scratch of [n_split][n_qt * qt][k]. prof_rec
// is null, or zeroed int64 [CTAs][prof::RECORD] for the stage clock;
// check_rec is null, or zeroed int64 [CTAs][3] for the checking
// instantiation (violations, survivors, candidates). Returns a cudaError_t
// (0 = launched). k must be in [1, 256].
extern "C" int rabitq_scan_fused_rabitq_topk(
    const uint8_t* codes, const float* ln, const float* corr, const float* q_rot,
    const void* q_hi, const float* delta, const float* crot, const int* work, const int* n_work,
    int* kth_key, float* out_v, int* out_s, float* part_v, int* part_s, long long* prof_rec,
    long long* check_rec, int n_split, int n_qt, int gm, int G, int bpr, int qt, int W, int k,
    int metric, int qb, int R, int mode, void* stream) {
  if (k < 1 || k > topk::MAX_K || n_split < 1 || n_split > topk::MAX_SPLIT || G < 1 ||
      gm % G != 0 || R < ROUND || R % ROUND != 0 || mode < 0 || mode > 2 || (mode && R != ROUND) ||
      (prof_rec && check_rec) ||
      ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(ln) |
        reinterpret_cast<uintptr_t>(corr)) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* hi = static_cast<const __nv_bfloat16*>(q_hi);
  float* ov = n_split > 1 ? part_v : out_v;
  int* os = n_split > 1 ? part_s : out_s;
#define RQ_QB(QB)                                                                               \
  (mode ? launch_mode<QB, true>(codes, ln, corr, q_rot, hi, delta, crot, work, n_work, kth_key, \
                                ov, os, n_split, n_qt, gm, G, bpr, qt, W, k, metric, R, mode,   \
                                prof_rec, check_rec, s)                                         \
        : launch_mode<QB, false>(codes, ln, corr, q_rot, hi, delta, crot, work, n_work, kth_key,\
                                 ov, os, n_split, n_qt, gm, G, bpr, qt, W, k, metric, R, mode,  \
                                 prof_rec, check_rec, s))
  int err;
  switch (qb) {
    case 64: err = RQ_QB(64); break;
    case 32: err = RQ_QB(32); break;
    case 16: err = RQ_QB(16); break;
    case 8: err = RQ_QB(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RQ_QB
  if (err != 0 || n_split == 1) return err;
  return topk::launch_merge(part_v, part_s, out_v, out_s, n_qt * qt, k, n_split, s);
}
