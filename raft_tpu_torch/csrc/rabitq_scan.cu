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
// Precision. All f32: b . q_rot, sum(q_rot) and qc are summed in dimension
// order and the estimator uses the rounded intrinsics, which the compiler
// never contracts into FMAs, so the plain PyTorch version with the same order
// gives the same bits. No TF32.
//
// Bound on the H100. The work is qt x (filled rows of each tile's valid units)
// x D f32 adds (one masked add per bit); the bytes are the code rows read once
// (D / 8 = 16 B at D = 128) plus 12 B a row of ln, g and ids. At qt = 16 a
// 16-byte row feeds 16 x 128 adds, 128 operations per byte: bound by
// operations.
//
// Design. The TPU kernel unpacks the bits to a 0/1 plane and runs a matmul.
// Here the rotated queries of a CTA (qb <= 16) live in shared memory as f32;
// each of the 256 threads takes one row, loads its bits in 16-byte loads and
// accumulates the masked sum into one register per query (every lane reads
// the same query lane at a time, a shared-memory broadcast). A 256-row chunk
// without a valid slot is skipped; scores go through shared memory to the
// per-query top-k (topk::warp_offer). Grid: (query group, tile, unit share),
// with topk::merge_kernel folding the partial lists. A byte-LUT or popcount
// form of the bit dot is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include "topk.cuh"

namespace {

constexpr int QB_MAX = 16;           // most queries per CTA
constexpr int THREADS = 256;
constexpr int R = THREADS;           // rows per chunk, one per thread
constexpr int WARPS = THREADS / 32;

enum Metric { kL2 = 0, kIP = 1 };

// acc[q] += q_rot[q, 8 s + t] for every set bit t of byte s.
__device__ __forceinline__ void add_byte(float (&acc)[QB_MAX], const float* qs, int D, int qb,
                                         int s, unsigned b) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const bool bit = (b >> t) & 1u;
#pragma unroll
    for (int q = 0; q < QB_MAX; ++q) {
      if (q < qb) acc[q] = __fadd_rn(acc[q], bit ? qs[q * D + 8 * s + t] : 0.f);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
rabitq_scan_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ ln,
                   const float* __restrict__ corr, const float* __restrict__ q_rot,
                   const float* __restrict__ crot, const int* __restrict__ tile_probes,
                   const int* __restrict__ probe_valid, float* __restrict__ out_v,
                   int* __restrict__ out_s, int gm, int G, int bpr, int qt, int P, int k,
                   int metric, int qb) {
  const int D = bpr * 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [qb][D]
  float* sq = qs + qb * D;        // [qb]
  float* qdc = sq + qb;           // [qb][G]
  float* sc = qdc + qb * G;       // [qb][R]
  float* tk_v = sc + qb * R;      // [qb][k]
  int* tk_s = reinterpret_cast<int*>(tk_v + qb * k);  // [qb][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.y;
  const int q0 = blockIdx.x * qb;          // first query of this CTA within the tile
  const int live = min(qb, qt - q0);       // live queries of this CTA
  const long long qrow0 = (long long)tile * qt + q0;
  const int n_split = gridDim.z;
  const int split = blockIdx.z;
  const long long nq_pad = (long long)gridDim.y * qt;
  int v_lo, v_hi;
  topk::unit_share(probe_valid + (long long)tile * P, P, split, n_split, &v_lo, &v_hi);
  topk::init(tk_v, tk_s, qb * k, tid, THREADS);

  for (int e = tid; e < qb * D; e += THREADS) {
    const int q = e / D;
    qs[e] = q < live ? q_rot[(qrow0 + q) * D + e % D] : 0.f;
  }
  __syncthreads();
  if (tid < qb) {  // sum(q_rot), in dimension order
    float s = 0.f;
    for (int t = 0; t < D; ++t) s = __fadd_rn(s, qs[tid * D + t]);
    sq[tid] = s;
  }
  const float coef = metric == kIP ? 1.0f : 2.0f;

  int v_ord = -1;
  const int m = gm / G;
  for (int j = 0; j < P; ++j) {
    if (probe_valid[(long long)tile * P + j] <= 0) continue;
    ++v_ord;
    if (v_ord < v_lo) continue;
    if (v_ord >= v_hi) break;
    const int unit = tile_probes[(long long)tile * P + j];
    const long long unit_row0 = (long long)unit * gm;
    // q.c of each query with each of the unit's G lists, in dimension order
    for (int e = tid; e < qb * G; e += THREADS) {
      const int q = e / G;
      const float* cp = crot + ((long long)unit * G + e % G) * D;
      float s = 0.f;
      for (int t = 0; t < D; ++t) s = __fadd_rn(s, __fmul_rn(qs[q * D + t], cp[t]));
      qdc[e] = s;
    }
    __syncthreads();
    for (int r0 = 0; r0 < gm; r0 += R) {
      const int r = r0 + tid;
      const float l = r < gm ? ln[unit_row0 + r] : INFINITY;
      // a chunk without a valid slot can only score +inf: skip it
      if (!__syncthreads_or(l < INFINITY)) continue;
      float acc[QB_MAX];
#pragma unroll
      for (int q = 0; q < QB_MAX; ++q) acc[q] = 0.f;
      float gc = 0.f;
      int g = 0;
      if (l < INFINITY) {
        const uint8_t* row = codes + (unit_row0 + r) * bpr;
        if ((bpr & 15) == 0) {
          for (int c0 = 0; c0 < bpr; c0 += 16) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + c0));
            const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int t = 0; t < 16; ++t) {
              add_byte(acc, qs, D, qb, c0 + t, (words[t >> 2] >> (8 * (t & 3))) & 0xffu);
            }
          }
        } else {
          for (int s = 0; s < bpr; ++s) add_byte(acc, qs, D, qb, s, __ldg(row + s));
        }
        gc = corr[unit_row0 + r];
        g = r / m;
      }
#pragma unroll
      for (int q = 0; q < QB_MAX; ++q) {
        if (q < qb) {
          float s = INFINITY;
          if (l < INFINITY) {
            const float t2 = __fsub_rn(l, coef * qdc[q * G + g]);
            const float t4 = __fsub_rn(acc[q], 0.5f * sq[q]);
            s = __fsub_rn(t2, __fmul_rn(gc, t4));
          }
          sc[q * R + tid] = s;
        }
      }
      __syncthreads();
      // merge: warp w owns queries w and w + WARPS
      for (int qq = warp; qq < live; qq += WARPS) {
        for (int base = 0; base < R; base += 32) {
          topk::warp_offer(tk_v + qq * k, tk_s + qq * k, k, sc[qq * R + base + lane],
                           (int)(unit_row0 + r0 + base + lane), lane);
        }
      }
      __syncthreads();
    }
  }

  topk::write_out(tk_v, tk_s, k, live, qrow0, nq_pad, split, n_split, out_v, out_s, warp, WARPS,
                  lane);
}

}  // namespace

// metric: 0 = L2, 1 = IP. codes [n_units][gm][bpr] u8 (D = 8 * bpr sign bits),
// ln/corr [n_units][gm] f32, q_rot [n_qt * qt][D] f32, crot [n_units][G][D] f32,
// tile_probes/probe_valid [n_qt][P] i32. qb in [1, 16] queries share a CTA;
// n_split in [1, 32] CTAs share each (tile, query group)'s valid units, and
// with n_split > 1 part_v/part_s are scratch of [n_split][n_qt * qt][k].
// Returns a cudaError_t (0 = launched). k must be in [1, 256].
extern "C" int rabitq_scan_fused_rabitq_topk(const uint8_t* codes, const float* ln,
                                             const float* corr, const float* q_rot,
                                             const float* crot, const int* tile_probes,
                                             const int* probe_valid, float* out_v, int* out_s,
                                             float* part_v, int* part_s, int n_split, int n_qt,
                                             int gm, int G, int bpr, int qt, int P, int k,
                                             int metric, int qb, void* stream) {
  if (k < 1 || k > topk::MAX_K || n_split < 1 || n_split > topk::MAX_SPLIT || qb < 1 ||
      qb > QB_MAX || G < 1 || gm % G != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)qb * bpr * 8 + qb + (size_t)qb * G +
                                       (size_t)qb * R) +
                      (sizeof(float) + sizeof(int)) * (size_t)qb * k;
  cudaError_t err = cudaFuncSetAttribute(rabitq_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((qt + qb - 1) / qb, n_qt, n_split);
  rabitq_scan_kernel<<<grid, THREADS, smem, s>>>(
      codes, ln, corr, q_rot, crot, tile_probes, probe_valid, n_split > 1 ? part_v : out_v,
      n_split > 1 ? part_s : out_s, gm, G, bpr, qt, P, k, metric, qb);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return topk::launch_merge(part_v, part_s, out_v, out_s, n_qt * qt, k, n_split, s);
}
