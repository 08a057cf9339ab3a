// Fused CAGRA beam search: `iters` greedy steps over a fixed-degree graph per
// query, the beam resident in shared memory throughout.
//
// Replaces the Pallas TPU kernel
// raft_tpu/ops/pallas/cagra_search.py::cagra_fused_search (def at :272,
// pallas_call at :328, body _beam_kernel at :148).
//
// What it computes. Per query a beam of `itopk` slots: a min-ordered f32 value
// (L2: sum (q - v)^2; inner product: -q . v) and an int32 id * 2 + visited
// (-1 = empty). Each step
//   1. picks `width` parents by rounds of min-extract over the beam, visited
//      and empty slots masked to WORST (ties to the lowest slot; a pick is
//      valid only below WORST), and marks them visited;
//   2. scores the parents' width * deg neighbours from the table [n, deg, d]
//      (f32 or bf16; row (p, j) holds the vector of graph[p, j]); an invalid
//      parent or a -1 graph entry gives id -1 and value WORST;
//   3. sorts the union (beam slots first, then candidates with flag 0) stably
//      by value, keeps the first itopk, turns slots of value >= WORST into id
//      -1, and kills an id equal to its left neighbour's to (WORST, -1) (the
//      JAX package's dedup="post").
// There is no early stop: exactly `iters` steps, as in the JAX package.
//
// Precision. Scores are f32 with the rounded intrinsics, which nvcc never
// contracts into FMAs: lane l adds the terms of dimensions l, l + 32, ... in
// turn, then the 32 lane sums fold as a shuffle tree (offsets 16 .. 1). One
// code path scores every candidate, so an id gets the same bits whichever
// parent proposes it (the post dedup relies on that), and the plain PyTorch
// version (cagra_beam_reference) adds in the same order and gives the same
// bits.
//
// Bound on the H100. Per query and step width * deg table rows of d elements
// (4 KB at bf16, d = 128, deg = 16) plus their ids, against 3 flops an
// element: bound by bytes.
//
// Design. The TPU kernel works around the lack of sorts and gathers: a rank
// merge by one-hot sums, ids as base-256 bf16 digit rows of the table, parent
// ids staged through SMEM. On Hopper it is the reference's single-CTA search
// (search_single_cta_kernel-inl.cuh:467): one CTA of 256 threads per query;
// warp 0 picks the parents with shuffle arg-min reductions; each warp scores
// one candidate at a time with coalesced reads of its table row; the merge is
// a bitonic sort of 64-bit keys (order-preserving float bits, -0 folded onto
// +0, over the union position) in shared memory, padded to a power of two.
// The visited hashmap, multi-CTA search for small batches, and TMA/cp.async
// prefetch of the next parents' rows are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float WORST = 3.0e38f;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB

__device__ __forceinline__ float load_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_elem(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Ascending in the float order (-0 and +0 equal), then in the union position.
__device__ __forceinline__ unsigned long long sort_key(float v, int pos) {
  unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(pos);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cagra_beam_kernel(const T* __restrict__ table, const int* __restrict__ graph,
                  const float* __restrict__ queries, const float* __restrict__ init_v,
                  const int* __restrict__ init_idf, float* __restrict__ out_v,
                  int* __restrict__ out_idf, int d, int deg, int itopk, int width, int iters,
                  int ip, int M) {
  const int W = width * deg;   // candidates per step
  const int m = itopk + W;     // union size
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem_raw);  // [M]
  float* qs = reinterpret_cast<float*>(keys + M);  // [d] the query
  float* bv = qs + d;                              // [itopk] beam values
  float* tv = bv + itopk;                          // [itopk] merged values before the dedup
  float* cv = tv + itopk;                          // [W] candidate values
  int* bi = reinterpret_cast<int*>(cv + W);        // [itopk] beam id * 2 + visited
  int* ti = bi + itopk;                            // [itopk] merged ids before the dedup
  int* ci = ti + itopk;                            // [W] candidate ids
  int* par = ci + W;                               // [width] parent ids

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long q = blockIdx.x;
  for (int t = tid; t < d; t += THREADS) qs[t] = queries[q * d + t];
  for (int s = tid; s < itopk; s += THREADS) {
    bv[s] = init_v[q * itopk + s];
    bi[s] = init_idf[q * itopk + s];
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // 1. parents: warp 0, one min-extract round per parent. A picked slot is
    // marked visited at once, which also masks it from the later rounds.
    if (warp == 0) {
      for (int w = 0; w < width; ++w) {
        float best = WORST;
        int sel = itopk;  // a lane without an unmasked slot offers (WORST, itopk)
        for (int s = lane; s < itopk; s += 32) {
          const int idf = bi[s];
          const float v = ((idf & 1) || idf < 0) ? WORST : bv[s];
          if (v < best || (v == best && s < sel)) {
            best = v;
            sel = s;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, best, off);
          const int os = __shfl_down_sync(0xffffffffu, sel, off);
          if (ov < best || (ov == best && os < sel)) {
            best = ov;
            sel = os;
          }
        }
        if (lane == 0) {
          if (best < WORST) {
            par[w] = bi[sel] >> 1;
            bi[sel] |= 1;
          } else {
            par[w] = -1;
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // 2. score the candidates, one warp per candidate
    for (int c = warp; c < W; c += WARPS) {
      const int w = c / deg;
      const int j = c - w * deg;
      const int p = par[w];
      const int id = p >= 0 ? __ldg(graph + static_cast<long long>(p) * deg + j) : -1;
      float val = WORST;
      if (id >= 0) {  // warp-uniform
        const T* row = table + (static_cast<long long>(p) * deg + j) * d;
        float acc = 0.f;
        for (int t = lane; t < d; t += 32) {
          const float x = load_elem(row + t);
          float e;
          if (ip) {
            e = __fmul_rn(qs[t], x);
          } else {
            const float df = __fsub_rn(qs[t], x);
            e = __fmul_rn(df, df);
          }
          acc = __fadd_rn(acc, e);
        }
        for (int off = 16; off > 0; off >>= 1) {
          acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
        }
        val = ip ? -acc : acc;
      }
      if (lane == 0) {
        cv[c] = val;
        ci[c] = id;
      }
    }
    __syncthreads();

    // 3. merge: bitonic sort of (value, union position), padding last
    for (int p = tid; p < M; p += THREADS) {
      keys[p] = p < m ? sort_key(p < itopk ? bv[p] : cv[p - itopk], p) : ~0ull;
    }
    __syncthreads();
    for (int k = 2; k <= M; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < M; i += THREADS) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long a = keys[i];
            const unsigned long long b = keys[ixj];
            if ((a > b) == ((i & k) == 0)) {
              keys[i] = b;
              keys[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int s = tid; s < itopk; s += THREADS) {
      const int p = static_cast<int>(keys[s] & 0xffffffffu);
      const float v = p < itopk ? bv[p] : cv[p - itopk];
      const int idf = p < itopk ? bi[p] : ci[p - itopk] * 2;
      tv[s] = v;
      ti[s] = v >= WORST ? -1 : idf;
    }
    __syncthreads();
    // adjacent-id kill
    for (int s = tid; s < itopk; s += THREADS) {
      const int id = ti[s] >> 1;
      const int prev = s > 0 ? (ti[s - 1] >> 1) : -2;
      const bool dup = id == prev && id >= 0;
      bv[s] = dup ? WORST : tv[s];
      bi[s] = dup ? -1 : ti[s];
    }
    __syncthreads();
  }

  for (int s = tid; s < itopk; s += THREADS) {
    out_v[q * itopk + s] = bv[s];
    out_idf[q * itopk + s] = bi[s];
  }
}

template <typename T>
int launch(const T* table, const int* graph, const float* queries, const float* init_v,
           const int* init_idf, float* out_v, int* out_idf, int nq, int d, int deg, int itopk,
           int width, int iters, int ip, cudaStream_t stream) {
  const int W = width * deg;
  int M = 1;
  while (M < itopk + W) M <<= 1;
  const size_t smem = 8 * static_cast<size_t>(M) +
                      4 * (static_cast<size_t>(d) + 4 * static_cast<size_t>(itopk) +
                           2 * static_cast<size_t>(W) + width);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(cagra_beam_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cagra_beam_kernel<T><<<nq, THREADS, smem, stream>>>(table, graph, queries, init_v, init_idf,
                                                      out_v, out_idf, d, deg, itopk, width,
                                                      iters, ip, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [n][deg][d] f32 (table_bf16 = 0) or bf16 (1), graph [n][deg] i32,
// queries [nq][d] f32, init_v/out_v [nq][itopk] f32, init_idf/out_idf
// [nq][itopk] i32; ip: 0 = L2, 1 = inner product. One CTA per query; the
// union's shared memory (8 B a key, padded to a power of two, plus the beams,
// candidates and the query) must fit 227 KB. Returns a cudaError_t (0 =
// launched).
extern "C" int cagra_search_beam(const void* table, int table_bf16, const int* graph,
                                 const float* queries, const float* init_v, const int* init_idf,
                                 float* out_v, int* out_idf, int nq, int d, int deg, int itopk,
                                 int width, int iters, int ip, void* stream) {
  if (nq < 1 || d < 1 || deg < 1 || itopk < 1 || width < 1 || width > itopk || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16) {
    return launch(static_cast<const __nv_bfloat16*>(table), graph, queries, init_v, init_idf,
                  out_v, out_idf, nq, d, deg, itopk, width, iters, ip, s);
  }
  return launch(static_cast<const float*>(table), graph, queries, init_v, init_idf, out_v,
                out_idf, nq, d, deg, itopk, width, iters, ip, s);
}
