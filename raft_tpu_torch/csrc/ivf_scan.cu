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
// Precision. Dot products accumulate with FP32 FMAs (no TF32, no tensor cores);
// bf16, int8 and uint8 rows are converted to f32 per element.
//
// Bound on the H100. Per query tile the work is qt x (filled slots of the
// valid units) x d FMAs and the bytes are those slots' rows read once. Each row's bytes
// (d * itemsize) feed qt queries, i.e. 2 * qt / itemsize FLOP per byte: 64 for
// f32 rows at qt = 128, above the card's FP32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/B), so the kernel is bound by FP32 operations. At
// qt = 16 (a serving batch cut into small tiles) one tile's reads are 8
// FLOP/B, but the tiles of one batch probe largely the same units, so the
// bound, which counts each unit's bytes once per call, stays set by
// operations; how many of the repeated reads the 50 MB L2 absorbs is not
// measured.
//
// Design. One CTA per (query tile, group of QB = 16 of its queries): a tile's
// qt queries are split across CTAs (qt itself defines the candidate set and is
// never changed) and the CTAs of one tile are adjacent in the grid, so they
// read the same unit rows at about the same time and share them through L2.
// The CTA walks its tile's valid units in ascending order. Rows are staged in
// shared memory in chunks of R = 64 rows x DC = 128 features, converted to
// f32; a chunk without a valid slot (the padding behind each list's rows is
// about half of a unit) is skipped; each thread scores 2 rows x 2 queries from registers (4 FMAs per 4
// shared loads). Scores of a chunk go to shared memory; one warp per query
// then filters them against the query's current k-th entry with a ballot and
// inserts the survivors in slot order into the query's sorted top-k list
// (also in shared memory): topk::warp_offer in topk.cuh.
//
// Filling the card. A serving batch of 128 queries is one tile, i.e. only
// qt / QB = 8 CTAs for 132 SMs. So the wrapper also splits each tile's valid
// units into n_split contiguous shares (grid z, topk::unit_share), and
// topk::merge_kernel folds the exact partial lists into the same exact top-k.
// The FP32 rate is held back by shared-memory loads; wgmma/TMA staging is
// left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include "topk.cuh"

namespace {

constexpr int QB = 16;        // queries per CTA
constexpr int R = 64;         // rows per staged chunk
constexpr int DC = 128;       // features per staged chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;

enum Metric { kL2 = 0, kIP = 1, kCos = 2 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t x) { return (float)x; }
template <> __device__ __forceinline__ float to_f32<uint8_t>(uint8_t x) { return (float)x; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
ivf_scan_kernel(const T* __restrict__ list_data, const float* __restrict__ ln,
                const int* __restrict__ li, const float* __restrict__ queries,
                const int* __restrict__ tile_probes, const int* __restrict__ probe_valid,
                float* __restrict__ out_v, int* __restrict__ out_s,
                int gm, int d, int qt, int P, int k, int metric) {
  // blockIdx.z = split: this CTA scans the split's share of the tile's valid
  // units; with more than one split, out_v/out_s are the split's partial
  // buffers [n_split][nq_pad][k] and merge_kernel folds them.
  extern __shared__ float smem[];
  float* qs = smem;                        // [QB][DC]
  float* ys = qs + QB * DC;                // [R][DC + 1]
  float* sc = ys + R * (DC + 1);           // [QB][R]
  float* tk_v = sc + QB * R;               // [QB][k]
  int* tk_s = reinterpret_cast<int*>(tk_v + QB * k);  // [QB][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = blockIdx.x;
  const int tile = blockIdx.y;
  const int q0 = group * QB;                 // first query of this CTA within the tile
  const int live = min(QB, qt - q0);         // live queries of this CTA
  const long long qrow0 = (long long)tile * qt + q0;
  const int n_split = gridDim.z;
  const int split = blockIdx.z;
  const long long nq_pad = (long long)gridDim.y * qt;
  int v_lo, v_hi;
  topk::unit_share(probe_valid + (long long)tile * P, P, split, n_split, &v_lo, &v_hi);
  topk::init(tk_v, tk_s, QB * k, tid, THREADS);

  // scoring map: rows r_a = lane, r_b = lane + 32; queries qa = warp, qb = warp + 8
  const int ra = lane, rb = lane + 32;
  const int qa = warp, qb = warp + WARPS;
  const int n_dc = (d + DC - 1) / DC;

  auto stage_queries = [&](int c0) {
    for (int e = tid; e < QB * DC; e += THREADS) {
      int q = e / DC, c = e % DC;
      float v = 0.f;
      if (q < live && c0 + c < d) v = queries[(qrow0 + q) * d + c0 + c];
      qs[e] = v;
    }
  };
  if (n_dc == 1) stage_queries(0);
  __syncthreads();

  int v_ord = -1;
  for (int j = 0; j < P; ++j) {
    if (probe_valid[(long long)tile * P + j] <= 0) continue;
    ++v_ord;
    if (v_ord < v_lo) continue;
    if (v_ord >= v_hi) break;
    const int unit = tile_probes[(long long)tile * P + j];
    const long long unit_row0 = (long long)unit * gm;
    for (int r0 = 0; r0 < gm; r0 += R) {
      // a chunk with no valid slot (list padding, or all filtered out) can
      // only score +inf, which never enters the top-k: skip it
      if (!__syncthreads_or(tid < R && r0 + tid < gm && li[unit_row0 + r0 + tid] >= 0)) continue;
      float acc_aa = 0.f, acc_ab = 0.f, acc_ba = 0.f, acc_bb = 0.f;
      for (int dci = 0; dci < n_dc; ++dci) {
        const int c0 = dci * DC;
        if (n_dc > 1) stage_queries(c0);
        for (int e = tid; e < R * DC; e += THREADS) {
          int r = e / DC, c = e % DC;
          float v = 0.f;
          if (r0 + r < gm && c0 + c < d) v = to_f32<T>(list_data[(unit_row0 + r0 + r) * d + c0 + c]);
          ys[r * (DC + 1) + c] = v;
        }
        __syncthreads();
        const float* ya = ys + ra * (DC + 1);
        const float* yb = ys + rb * (DC + 1);
        const float* qa_p = qs + qa * DC;
        const float* qb_p = qs + qb * DC;
        const int cmax = min(DC, d - c0);
#pragma unroll 8
        for (int c = 0; c < cmax; ++c) {
          const float y_a = ya[c], y_b = yb[c];
          const float x_a = qa_p[c], x_b = qb_p[c];
          acc_aa = __fmaf_rn(x_a, y_a, acc_aa);
          acc_ab = __fmaf_rn(x_a, y_b, acc_ab);
          acc_ba = __fmaf_rn(x_b, y_a, acc_ba);
          acc_bb = __fmaf_rn(x_b, y_b, acc_bb);
        }
        __syncthreads();
      }
      // epilogue -> shared score tile
      {
        const float acc[2][2] = {{acc_aa, acc_ab}, {acc_ba, acc_bb}};
        const int qidx[2] = {qa, qb};
        const int ridx[2] = {ra, rb};
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int r = ridx[b];
            float s = INFINITY;
            if (r0 + r < gm) {
              const long long slot = unit_row0 + r0 + r;
              const float l = ln[slot];
              const float dot = acc[a][b];
              if (metric == kL2) {
                s = l - 2.0f * dot;
              } else if (metric == kIP) {
                s = l - dot;
              } else {
                s = li[slot] >= 0 ? -dot * l : INFINITY;
              }
            }
            sc[qidx[a] * R + r] = s;
          }
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

template <typename T>
int launch(const void* list_data, const float* ln, const int* li, const float* queries,
           const int* tile_probes, const int* probe_valid, float* out_v, int* out_s,
           float* part_v, int* part_s, int n_split,
           int n_qt, int gm, int d, int qt, int P, int k, int metric, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (QB * DC + R * (DC + 1) + QB * R) +
                      (sizeof(float) + sizeof(int)) * (size_t)QB * k;
  cudaError_t err = cudaFuncSetAttribute(ivf_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((qt + QB - 1) / QB, n_qt, n_split);
  ivf_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(list_data), ln, li, queries, tile_probes, probe_valid,
      n_split > 1 ? part_v : out_v, n_split > 1 ? part_s : out_s, gm, d, qt, P, k, metric);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  return topk::launch_merge(part_v, part_s, out_v, out_s, n_qt * qt, k, n_split, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = int8, 3 = uint8. metric: 0 = L2, 1 = IP, 2 = cosine.
// n_split in [1, 32] CTAs share each (tile, query group)'s valid units; with
// n_split > 1, part_v/part_s are scratch of [n_split][n_qt * qt][k].
// Returns a cudaError_t (0 = launched). k must be in [1, 256].
extern "C" int ivf_scan_fused_list_topk(const void* list_data, int dtype, const float* ln,
                                        const int* li, const float* queries,
                                        const int* tile_probes, const int* probe_valid,
                                        float* out_v, int* out_s, float* part_v, int* part_s,
                                        int n_split, int n_qt, int gm, int d,
                                        int qt, int P, int k, int metric, void* stream) {
  if (k < 1 || k > topk::MAX_K || n_split < 1 || n_split > topk::MAX_SPLIT) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(list_data, ln, li, queries, tile_probes, probe_valid, out_v, out_s, part_v, part_s, n_split, n_qt, gm, d, qt, P, k, metric, s);
    case 1: return launch<__nv_bfloat16>(list_data, ln, li, queries, tile_probes, probe_valid, out_v, out_s, part_v, part_s, n_split, n_qt, gm, d, qt, P, k, metric, s);
    case 2: return launch<int8_t>(list_data, ln, li, queries, tile_probes, probe_valid, out_v, out_s, part_v, part_s, n_split, n_qt, gm, d, qt, P, k, metric, s);
    case 3: return launch<uint8_t>(list_data, ln, li, queries, tile_probes, probe_valid, out_v, out_s, part_v, part_s, n_split, n_qt, gm, d, qt, P, k, metric, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
