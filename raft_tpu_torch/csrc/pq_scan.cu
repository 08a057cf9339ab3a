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
// the same order gives the same bits.
//
// Bound on the H100. The work is qt x (filled rows of each tile's valid units)
// x (lookups per row: 2 * pq_dim for nib8, pq_dim otherwise) f32 adds; the
// bytes are the code rows of the units read once (16-64 B a row) plus 8 B a
// row of ln and ids, and the LUT. At qt = 16 and nib8 codes a 64-byte row
// feeds 16 x 128 adds, 32 operations per byte, above the card's FP32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20): the kernel is bound by operations. The
// real limit is the shared-memory gather: every add reads one bf16 LUT entry
// at a data-dependent column.
//
// Design. The TPU kernel decodes codes into a multi-hot matrix and runs a
// matmul, a workaround for the TPU's lack of a lane gather. Here the LUT rows
// of a CTA's queries (qb <= 16 of them, as many as 227 KB of shared memory
// holds, chosen by the wrapper) live in shared memory, and each of the 256
// threads scores one code row: it reads the row's bytes in 16-byte loads,
// decodes each code and adds the looked-up entry to one register accumulator
// per query. A 256-row chunk without a valid slot (the padded tail of each
// list) is skipped. Scores go to shared memory, then one warp per query offers
// them to the query's top-k (topk::warp_offer). Grid: (query group, tile,
// unit share) as in ivf_scan.cu; with more than one share, topk::merge_kernel
// folds the exact partial lists.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "topk.cuh"

namespace {

constexpr int QB_MAX = 16;           // most queries per CTA
constexpr int THREADS = 256;
constexpr int R = THREADS;           // code rows per chunk, one per thread
constexpr int WARPS = THREADS / 32;

enum Metric { kL2 = 0, kIP = 1 };
enum Mode { kU8 = 0, kNib8 = 1, kP4 = 2, kBits = 3 };

// acc[q] += W[q, col] for every query of the CTA.
__device__ __forceinline__ void add_col(float (&acc)[QB_MAX], const __nv_bfloat16* lut, int K,
                                        int qb, int col) {
#pragma unroll
  for (int q = 0; q < QB_MAX; ++q) {
    if (q < qb) acc[q] = __fadd_rn(acc[q], __bfloat162float(lut[q * K + col]));
  }
}

// The lookups of byte j (value b) of a u8 / nib8 / p4 row.
template <int MODE>
__device__ __forceinline__ void add_byte(float (&acc)[QB_MAX], const __nv_bfloat16* lut, int K,
                                         int qb, int gw, int j, unsigned b) {
  if constexpr (MODE == kU8) {
    add_col(acc, lut, K, qb, j * gw + (int)b);
  } else if constexpr (MODE == kNib8) {
    add_col(acc, lut, K, qb, j * 32 + (int)(b >> 4));
    add_col(acc, lut, K, qb, j * 32 + 16 + (int)(b & 15u));
  } else {
    add_col(acc, lut, K, qb, j * 32 + (int)(b & 15u));
    add_col(acc, lut, K, qb, j * 32 + 16 + (int)(b >> 4));
  }
}

// The ADC dot of one code row against the CTA's LUT rows, in lookup order.
template <int MODE, int BITS>
__device__ __forceinline__ void row_dot(float (&acc)[QB_MAX], const uint8_t* __restrict__ row,
                                        int bpr, int gw, const __nv_bfloat16* lut, int K, int qb) {
  if constexpr (MODE == kBits) {
    const int n_codes = bpr * 8 / BITS;
    for (int j = 0; j < n_codes; ++j) {
      const int jb = j * BITS;
      const int byte = jb >> 3;
      const int off = jb & 7;
      unsigned v = (unsigned)__ldg(row + byte) >> off;
      if (off + BITS > 8) v |= (unsigned)__ldg(row + byte + 1) << (8 - off);
      add_col(acc, lut, K, qb, j * gw + (int)(v & ((1u << BITS) - 1u)));
    }
  } else if ((bpr & 15) == 0) {
    for (int c0 = 0; c0 < bpr; c0 += 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + c0));
      const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        add_byte<MODE>(acc, lut, K, qb, gw, c0 + t, (words[t >> 2] >> (8 * (t & 3))) & 0xffu);
      }
    }
  } else {
    for (int j = 0; j < bpr; ++j) add_byte<MODE>(acc, lut, K, qb, gw, j, __ldg(row + j));
  }
}

template <int MODE, int BITS>
__global__ void __launch_bounds__(THREADS)
pq_scan_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ ln,
               const __nv_bfloat16* __restrict__ w, const float* __restrict__ q_rot,
               const float* __restrict__ crot, const int* __restrict__ tile_probes,
               const int* __restrict__ probe_valid, float* __restrict__ out_v,
               int* __restrict__ out_s, int gm, int G, int bpr, int K, int gw, int rot_dim,
               int qt, int P, int k, int metric, int qb) {
  // blockIdx.z = split: this CTA scans the split's share of the tile's valid
  // units; with more than one split, out_v/out_s are the split's partial
  // buffers [n_split][nq_pad][k].
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* lut = reinterpret_cast<__nv_bfloat16*>(smem);    // [qb][K]
  float* sc = reinterpret_cast<float*>(smem + (size_t)qb * K * 2);  // [qb][R]
  float* qdc = sc + qb * R;                                         // [qb][G]
  float* tk_v = qdc + qb * G;                                       // [qb][k]
  int* tk_s = reinterpret_cast<int*>(tk_v + qb * k);                // [qb][k]

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

  // the LUT rows of the live queries (zeros for the others), 16 bytes at a time
  {
    const int n16 = K / 8;
    uint4* dst = reinterpret_cast<uint4*>(lut);
    for (int e = tid; e < qb * n16; e += THREADS) {
      const int q = e / n16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q < live) v = __ldg(reinterpret_cast<const uint4*>(w + (qrow0 + q) * K) + e % n16);
      dst[e] = v;
    }
  }
  __syncthreads();

  const int m = gm / G;
  int v_ord = -1;
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
      float s = 0.f;
      if (q < live) {
        const float* qp = q_rot + (qrow0 + q) * rot_dim;
        const float* cp = crot + ((long long)unit * G + e % G) * rot_dim;
        for (int t = 0; t < rot_dim; ++t) s = __fadd_rn(s, __fmul_rn(qp[t], cp[t]));
      }
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
      if (l < INFINITY) row_dot<MODE, BITS>(acc, codes + (unit_row0 + r) * bpr, bpr, gw, lut, K, qb);
      const int g = l < INFINITY ? r / m : 0;
#pragma unroll
      for (int q = 0; q < QB_MAX; ++q) {
        if (q < qb) {
          float s = INFINITY;
          if (l < INFINITY) {
            const float c = qdc[q * G + g];
            s = metric == kL2 ? __fsub_rn(l, 2.0f * __fadd_rn(acc[q], c))
                              : __fsub_rn(__fsub_rn(l, acc[q]), c);
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

template <int MODE, int BITS>
int launch(const uint8_t* codes, const float* ln, const __nv_bfloat16* w, const float* q_rot,
           const float* crot, const int* tile_probes, const int* probe_valid, float* out_v,
           int* out_s, float* part_v, int* part_s, int n_split, int n_qt, int gm, int G, int bpr,
           int K, int gw, int rot_dim, int qt, int P, int k, int metric, int qb,
           cudaStream_t stream) {
  const size_t smem = (size_t)qb * K * 2 + sizeof(float) * ((size_t)qb * R + (size_t)qb * G) +
                      (sizeof(float) + sizeof(int)) * (size_t)qb * k;
  cudaError_t err = cudaFuncSetAttribute(pq_scan_kernel<MODE, BITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((qt + qb - 1) / qb, n_qt, n_split);
  pq_scan_kernel<MODE, BITS><<<grid, THREADS, smem, stream>>>(
      codes, ln, w, q_rot, crot, tile_probes, probe_valid, n_split > 1 ? part_v : out_v,
      n_split > 1 ? part_s : out_s, gm, G, bpr, K, gw, rot_dim, qt, P, k, metric, qb);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return topk::launch_merge(part_v, part_s, out_v, out_s, n_qt * qt, k, n_split, stream);
}

}  // namespace

// mode: 0 = u8, 1 = nib8, 2 = p4, 3/5/6/7 = b3/b5/b6/b7. metric: 0 = L2, 1 = IP.
// codes [n_units][gm][bpr] u8, ln [n_units][gm] f32, w [n_qt * qt][K] bf16,
// q_rot [n_qt * qt][rot_dim] f32, crot [n_units][G][rot_dim] f32,
// tile_probes/probe_valid [n_qt][P] i32. qb in [1, 16] queries share a CTA
// (their LUT rows must fit its shared memory); n_split in [1, 32] CTAs share
// each (tile, query group)'s valid units, and with n_split > 1
// part_v/part_s are scratch of [n_split][n_qt * qt][k]. Returns a
// cudaError_t (0 = launched). k must be in [1, 256] and K a multiple of 8.
extern "C" int pq_scan_fused_pq_topk(const uint8_t* codes, const float* ln, const void* w,
                                     const float* q_rot, const float* crot,
                                     const int* tile_probes, const int* probe_valid,
                                     float* out_v, int* out_s, float* part_v, int* part_s,
                                     int n_split, int n_qt, int gm, int G, int bpr, int K,
                                     int rot_dim, int qt, int P, int k, int metric, int mode,
                                     int ksub, int qb, void* stream) {
  if (k < 1 || k > topk::MAX_K || n_split < 1 || n_split > topk::MAX_SPLIT || qb < 1 ||
      qb > QB_MAX || G < 1 || gm % G != 0 || K % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const int gw = (mode == kNib8 || mode == kP4) ? 32 : ksub;
#define PQ_LAUNCH(MODE, BITS)                                                                   \
  launch<MODE, BITS>(codes, ln, wb, q_rot, crot, tile_probes, probe_valid, out_v, out_s, part_v, \
                     part_s, n_split, n_qt, gm, G, bpr, K, gw, rot_dim, qt, P, k, metric, qb, s)
  switch (mode) {
    case 0: return PQ_LAUNCH(kU8, 0);
    case 1: return PQ_LAUNCH(kNib8, 0);
    case 2: return PQ_LAUNCH(kP4, 0);
    case 3: return PQ_LAUNCH(kBits, 3);
    case 5: return PQ_LAUNCH(kBits, 5);
    case 6: return PQ_LAUNCH(kBits, 6);
    case 7: return PQ_LAUNCH(kBits, 7);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PQ_LAUNCH
}
