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
//   1. picks `width` parents: the unmasked slots (not visited, not empty,
//      value below WORST; NaN never) of rank 0 .. width - 1 in the (value,
//      slot) order, -0 tied to +0 (the reference's rounds of min-extract,
//      ties to the lowest slot), and marks them visited; parents beyond the
//      unmasked slots are -1;
//   2. scores the parents' width * deg neighbours from the table [n, deg, d]
//      (f32 or bf16; row (p, j) holds the vector of graph[p, j]); an invalid
//      parent or a -1 graph entry gives id -1 and value WORST;
//   3. sorts the union (beam slots first, then candidates with flag 0) stably
//      by value, keeps the first itopk, turns slots of value >= WORST into id
//      -1, and kills an id equal to its left neighbour's to (WORST, -1) (the
//      JAX package's dedup="post").
// There is no early stop: exactly `iters` steps, as in the JAX package (a
// step without a valid parent still moves killed slots to the end).
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
// (4 KB a parent at bf16, d = 128, deg = 16) plus their ids, against 3 flops
// an element: bound by bytes. At a serving batch (one CTA an SM) the floor
// is each query's chain of steps: a step cannot fetch before the previous
// step's merge has named its parents.
//
// Design (one CTA of 256 threads per query; each choice timed with the
// stage clock of stage_clock.cuh):
//   - pick in one parallel pass: each thread counts, for its slot, the
//     unmasked slots before it in the (value, slot) order over 32-bit
//     order-preserving keys (masked slots hold ~0, above every unmasked key);
//     rank r < width makes the slot parent r. One barrier. A merged beam
//     is sorted but for its killed slots, which are masked, so after the
//     first step the count is of the unmasked slots before it in slot
//     order: a warp ballot a 32 slots, written by the merge's kill pass.
//   - one fetch a step, issued at once: the valid parents are a prefix of
//     the picks and their rows a prefix of the candidates; each parent's
//     [deg, d] block is one contiguous span of the table, and its row
//     addresses do not depend on the graph ids, so every row and every id
//     of the step is copied to shared memory with cp.async as soon as the
//     parents are known. Where the rows do not all fit (large d, f32,
//     degree 32, or a large batch whose CTAs would take another wave), they
//     are staged `group_rows` at a time in a ring of two buffers, group g + 1
//     copied while group g is scored; where not even that fits, rows are
//     read from global memory (the DIRECT instantiation), id and row loads
//     issued together.
//   - scores from shared memory in the order above, four candidates a warp
//     at once, eight lanes a candidate, each keeping four of the order's
//     lane sums, so the tree's first two levels fold in registers; staged
//     rows are padded so the four rows sit on other banks.
//   - a rank merge: each union element counts the keys below its own
//     (32-bit key, then the union position); rank r < itopk goes to slot r.
//     That is the stable sort's order, in one barrier. Past RANK_MAX union
//     entries a bitonic sort of 64-bit keys takes over (faster there).
// The visited hashmap and multi-CTA search for small batches are left for
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_clock.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_CTAS = 5;         // __launch_bounds__: at most 48 registers a thread
constexpr int BATCH = 4;            // candidates a warp scores at once
constexpr int RANK_MAX = 512;       // largest union merged by rank
constexpr int ROW_PAD = 8;          // elements after each staged row: a quad's rows on other banks
constexpr float WORST = 3.0e38f;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB

__device__ __forceinline__ float load_elem(const float* p) { return *p; }
__device__ __forceinline__ float load_elem(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The float order as unsigned order, -0 folded onto +0.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Ascending in the float order (-0 and +0 equal), then in the union position.
__device__ __forceinline__ unsigned long long sort_key(float v, int pos) {
  return (static_cast<unsigned long long>(order_key(v)) << 32) | static_cast<unsigned>(pos);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
template <int CH>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (CH == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(CH));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_last() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Position of element e (key ke) among n keys, 16-byte aligned and padded
// with ~0 to a multiple of 4: the keys below ke, and the keys equal to ke at
// a lower position. e - lane is the warp's first element, so the three
// ranges below are the same for every lane of the warp.
__device__ __forceinline__ int rank_of(const unsigned* __restrict__ keys, int n, unsigned ke,
                                       int e, int lane) {
  const int base = e - lane;
  const uint4* k4 = reinterpret_cast<const uint4*>(keys);
  int r = 0;
#pragma unroll 4
  for (int f = 0; f < base; f += 4) {
    const uint4 x = k4[f >> 2];
    r += (x.x <= ke) + (x.y <= ke) + (x.z <= ke) + (x.w <= ke);
  }
  const int mid = min(base + 32, n);
#pragma unroll 4
  for (int f = base; f < mid; ++f) {
    const unsigned x = keys[f];
    r += (x < ke) | ((x == ke) & (f < e));
  }
#pragma unroll 4
  for (int f = base + 32; f < n; f += 4) {
    const uint4 x = k4[f >> 2];
    r += (x.x < ke) + (x.y < ke) + (x.z < ke) + (x.w < ke);
  }
  return r;
}

// Byte offsets of the shared-memory arrays. bitonic: the 64-bit sort keys
// (M of them, a power of two >= itopk + W), the pick's keys aliased onto
// them (the sort overwrites them after the pick has read them); else the
// union's keys and the pick's keys, each padded to a multiple of 4. Then
// the staged rows (buffers x group_rows rows of d + ROW_PAD elements,
// 16-byte aligned; none when group_rows is 0), the query, the beams and
// candidates, and the parents. Unstaged, the bitonic layout takes the
// kernel's first layout's bytes, so every shape that fitted it still fits.
struct Layout {
  int keys, stage, u, pk, qs, bv, tv, cv, bi, ti, ci, par, total;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ inline Layout layout(int itopk, int width, int deg, int d, int esize,
                                         int group_rows, int buffers, int bitonic) {
  const int W = width * deg;
  const int m = itopk + W;
  int M = 1;
  while (M < m) M <<= 1;
  Layout L;
  int off = 0;
  L.keys = off;
  if (bitonic) off += 8 * M;
  L.stage = off;
  off += round_up(buffers * group_rows * (d + ROW_PAD) * esize, 16);
  L.u = off;
  L.pk = off;
  if (bitonic) {
    L.pk = L.keys;
  } else {
    off += 4 * round_up(m, 4);
    L.pk = off;
    off += 4 * round_up(itopk, 4);
  }
  L.qs = off;
  off += 4 * d;
  L.bv = off;
  off += 4 * itopk;
  L.tv = off;
  off += 4 * itopk;
  L.cv = off;
  off += 4 * W;
  L.bi = off;
  off += 4 * itopk;
  L.ti = off;
  off += 4 * itopk;
  L.ci = off;
  off += 4 * W;
  L.par = off;
  off += 4 * width;
  L.total = off;
  return L;
}

struct Params {
  const void* table;
  const int* graph;
  const float* queries;
  const float* init_v;
  const int* init_idf;
  float* out_v;
  int* out_idf;
  long long* prof_rec;
  int d, deg, itopk, width, iters, ip, group_rows, buffers, bitonic;
};

// Score candidates [c_begin, c_end) of the step, four a warp at once: lanes
// 8g .. 8g + 7 take candidate c0 + g of a quad. Sub-lane l keeps the sums
// of the kernel's lanes l, l + 8, l + 16 and l + 24 (dimensions l + 8a,
// l + 8a + 32, ... in turn), folds them as the shuffle tree's first two
// levels do (16, then 8), and the last three (4, 2, 1) run as shuffles
// inside the group: the same operations in the same order as one warp a
// candidate. Returns how many had a graph id (counted in sub-lane 0).
// Candidate c's row starts at staged + (c - c_first) * stride bytes (the
// staged group, its id in ci) or, DIRECT, at its parent's table row (its
// id read beside the row).
template <typename T, bool DIRECT>
__device__ __forceinline__ int score_rows(const Params& P, const unsigned char* __restrict__ staged,
                                          int stride, int c_first, int c_begin, int c_end,
                                          const float* __restrict__ qs,
                                          const int* __restrict__ par, float* __restrict__ cv,
                                          int* __restrict__ ci, unsigned* __restrict__ u,
                                          int warp, int lane) {
  const int d = P.d, deg = P.deg;
  const int g = lane >> 3;
  const int l = lane & 7;
  int scored = 0;
  for (int c0 = c_begin + BATCH * warp; c0 < c_end; c0 += BATCH * WARPS) {
    const int c = min(c0 + g, c_end - 1);  // past the end: a copy of the last, not written
    const T* row;
    int id;
    if constexpr (DIRECT) {
      const int w = c / deg;
      const long long pr = static_cast<long long>(par[w]) * deg + (c - w * deg);
      row = static_cast<const T*>(P.table) + pr * d;
      id = __ldg(P.graph + pr);
    } else {
      row = reinterpret_cast<const T*>(staged + (c - c_first) * stride);
      id = ci[c];
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t0 = l; t0 < d; t0 += 32) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = t0 + 8 * a;
        if (t < d) {
          const float x = load_elem(row + t);
          float e;
          if (P.ip) {
            e = __fmul_rn(qs[t], x);
          } else {
            const float df = __fsub_rn(qs[t], x);
            e = __fmul_rn(df, df);
          }
          acc[a] = __fadd_rn(acc[a], e);
        }
      }
    }
    float sum = __fadd_rn(__fadd_rn(acc[0], acc[2]), __fadd_rn(acc[1], acc[3]));
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, off, 8));
    }
    if (l == 0 && c0 + g < c_end) {
      const float val = id >= 0 ? (P.ip ? -sum : sum) : WORST;
      cv[c] = val;
      if constexpr (DIRECT) ci[c] = id;
      if (!P.bitonic) u[P.itopk + c] = order_key(val);
      scored += id >= 0;
    }
  }
  return scored;
}

// Copy rows [c_begin, c_end) of the step's candidates into dst, one every
// stride bytes, CH bytes a cp.async (CH 0: two bytes at a time through
// registers).
template <int CH>
__device__ __forceinline__ void stage_rows(const Params& P, unsigned char* __restrict__ dst,
                                           int c_begin, int c_end, const int* __restrict__ par,
                                           int row_bytes, int stride, int tid) {
  const unsigned char* table = static_cast<const unsigned char*>(P.table);
  const int deg = P.deg;
  constexpr int B = CH == 0 ? 2 : CH;
  const int per_row = row_bytes / B;
  for (int i = tid; i < (c_end - c_begin) * per_row; i += THREADS) {
    const int r = i / per_row;
    const int k = i - r * per_row;
    const int c = c_begin + r;
    const int w = c / deg;
    const long long pr = static_cast<long long>(par[w]) * deg + (c - w * deg);
    unsigned char* to = dst + r * stride + k * B;
    const unsigned char* from = table + pr * row_bytes + k * B;
    if constexpr (CH == 0) {
      *reinterpret_cast<unsigned short*>(to) = *reinterpret_cast<const unsigned short*>(from);
    } else {
      cp_async<CH>(to, from);
    }
  }
}

template <typename T, bool DIRECT, bool PROF, int CH>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) cagra_beam_kernel(const Params P) {
  const int d = P.d, deg = P.deg, itopk = P.itopk, width = P.width;
  const int W = width * deg;  // candidates per step
  const int m = itopk + W;    // union size
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int stride = row_bytes + ROW_PAD * static_cast<int>(sizeof(T));  // a staged row's bytes
  int M = 1;
  while (M < m) M <<= 1;
  const Layout L = layout(itopk, width, deg, d, static_cast<int>(sizeof(T)),
                          DIRECT ? 0 : P.group_rows, DIRECT ? 0 : P.buffers, P.bitonic);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem_raw + L.keys);
  unsigned char* stage = smem_raw + L.stage;
  unsigned* u = reinterpret_cast<unsigned*>(smem_raw + L.u);    // union keys (rank merge)
  unsigned* pk = reinterpret_cast<unsigned*>(smem_raw + L.pk);  // pick keys, ~0 masked
  float* qs = reinterpret_cast<float*>(smem_raw + L.qs);
  float* bv = reinterpret_cast<float*>(smem_raw + L.bv);  // beam values
  float* tv = reinterpret_cast<float*>(smem_raw + L.tv);  // merged values before the dedup
  float* cv = reinterpret_cast<float*>(smem_raw + L.cv);  // candidate values
  int* bi = reinterpret_cast<int*>(smem_raw + L.bi);      // beam id * 2 + visited
  int* ti = reinterpret_cast<int*>(smem_raw + L.ti);      // merged ids before the dedup
  int* ci = reinterpret_cast<int*>(smem_raw + L.ci);      // candidate ids
  int* par = reinterpret_cast<int*>(smem_raw + L.par);    // parent ids, -1 invalid
  const int m_pad = round_up(m, 4);
  const int k_pad = round_up(itopk, 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long q = blockIdx.x;
  prof::StageClock<PROF> clk;
  clk.start();
  int n_parents = 0, n_rows = 0;  // PROF

  // A slot the pick may take: not visited, not empty, value below WORST.
  auto unmasked = [](float v, int idf) { return !((idf & 1) || idf < 0 || !(v < WORST)); };

  for (int t = tid; t < d; t += THREADS) qs[t] = P.queries[q * d + t];
  for (int s = tid; s < itopk; s += THREADS) {
    const float v = P.init_v[q * itopk + s];
    const int idf = P.init_idf[q * itopk + s];
    bv[s] = v;
    bi[s] = idf;
    if (!P.bitonic) u[s] = order_key(v);
    pk[s] = unmasked(v, idf) ? order_key(v) : ~0u;
  }
  for (int s = itopk + tid; s < k_pad; s += THREADS) pk[s] = ~0u;
  if (!P.bitonic) {
    for (int e = m + tid; e < m_pad; e += THREADS) u[e] = ~0u;
  }
  for (int w = tid; w < width; w += THREADS) par[w] = -1;
  __syncthreads();

  for (int it = 0; it < P.iters; ++it) {
    // 1. parents: the unmasked slots of rank < width, marked visited. The
    // first step ranks the input beam's keys (pk); a merged beam is sorted
    // by (key, slot) but for its killed slots, which are masked, so later
    // steps count the unmasked slots before each (pk holds a mask of them
    // per 32 slots).
    for (int s = tid; s < itopk; s += THREADS) {
      int r = width;
      if (it == 0) {
        const unsigned ks = pk[s];
        if (ks != ~0u) r = rank_of(pk, itopk, ks, s, lane);
      } else {
        const unsigned mk = pk[s >> 5];
        if ((mk >> lane) & 1) {
          r = __popc(mk & ((1u << lane) - 1u));
          for (int c = 0; c < (s >> 5) && r < width; ++c) r += __popc(pk[c]);
        }
      }
      if (r < width) {
        par[r] = bi[s] >> 1;
        bi[s] |= 1;
      }
    }
    clk.lap(prof::kCgPick);
    __syncthreads();
    clk.lap(prof::kCgBarrier);
    // the valid parents are a prefix of par, their rows of the candidates
    int n_valid = 0;
    for (int hi = width; n_valid < hi;) {
      const int mid = (n_valid + hi) >> 1;
      if (par[mid] >= 0) {
        n_valid = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int rows = n_valid * deg;
    if (PROF && tid == 0) n_parents += n_valid;
    for (int c = rows + tid; c < W; c += THREADS) {
      cv[c] = WORST;
      ci[c] = -1;
      if (!P.bitonic) u[itopk + c] = order_key(WORST);
    }

    // 2. fetch and score, one group of rows at a time
    if constexpr (DIRECT) {
      n_rows += score_rows<T, true>(P, nullptr, 0, 0, 0, rows, qs, par, cv, ci, u, warp, lane);
      clk.lap(prof::kCgScore);
    } else {
      const int gr = P.group_rows;
      const int n_groups = (rows + gr - 1) / gr;
      if (n_groups > 0) {
        for (int c = tid; c < rows; c += THREADS) {  // the ids, with the first group
          const int w = c / deg;
          cp_async<4>(ci + c, P.graph + static_cast<long long>(par[w]) * deg + (c - w * deg));
        }
        stage_rows<CH>(P, stage, 0, min(gr, rows), par, row_bytes, stride, tid);
        cp_async_commit();
      }
      for (int g = 0; g < n_groups; ++g) {
        const int c0 = g * gr;
        const int c1 = min(rows, c0 + gr);
        const unsigned char* buf = stage + (P.buffers > 1 ? (g & 1) : 0) * gr * stride;
        if (g + 1 < n_groups) {
          stage_rows<CH>(P, stage + ((g + 1) & 1) * gr * stride, c1, min(rows, c1 + gr), par,
                         row_bytes, stride, tid);
          cp_async_commit();
          cp_async_wait_prev();
        } else {
          cp_async_wait_last();
        }
        clk.lap(prof::kCgFetch);
        __syncthreads();
        clk.lap(prof::kCgFetch);
        n_rows += score_rows<T, false>(P, buf, stride, c0, c0, c1, qs, par, cv, ci, u, warp, lane);
        clk.lap(prof::kCgScore);
        if (g + 1 < n_groups) {
          __syncthreads();  // buf is free for group g + 2
          clk.lap(prof::kCgBarrier);
        }
      }
    }
    __syncthreads();
    clk.lap(prof::kCgBarrier);

    // 3. merge into tv/ti: the union element of rank r < itopk goes to slot r
    if (!P.bitonic) {
      for (int e = tid; e < m; e += THREADS) {
        const int r = rank_of(u, m, u[e], e, lane);
        if (r < itopk) {
          const float v = e < itopk ? bv[e] : cv[e - itopk];
          const int idf = e < itopk ? bi[e] : ci[e - itopk] * 2;
          tv[r] = v;
          ti[r] = v >= WORST ? -1 : idf;
        }
      }
    } else {  // the bitonic sort of (value, union position), padding last
      for (int p = tid; p < M; p += THREADS) {
        keys[p] = p < m ? sort_key(p < itopk ? bv[p] : cv[p - itopk], p) : ~0ull;
      }
      clk.lap(prof::kCgMerge);
      __syncthreads();
      clk.lap(prof::kCgBarrier);
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
          clk.lap(prof::kCgMerge);
          __syncthreads();
          clk.lap(prof::kCgBarrier);
        }
      }
      for (int s = tid; s < itopk; s += THREADS) {
        const int p = static_cast<int>(keys[s] & 0xffffffffu);
        const float v = p < itopk ? bv[p] : cv[p - itopk];
        const int idf = p < itopk ? bi[p] : ci[p - itopk] * 2;
        tv[s] = v;
        ti[s] = v >= WORST ? -1 : idf;
      }
    }
    clk.lap(prof::kCgMerge);
    __syncthreads();
    clk.lap(prof::kCgBarrier);

    // 4. adjacent-id kill into the beam, and the next pick's masks
    for (int base = 0; base < itopk; base += THREADS) {
      const int s = base + tid;
      bool open = false;
      if (s < itopk) {
        const int id = ti[s] >> 1;
        const int prev = s > 0 ? (ti[s - 1] >> 1) : -2;
        const bool dup = id == prev && id >= 0;
        const float v = dup ? WORST : tv[s];
        const int idf = dup ? -1 : ti[s];
        bv[s] = v;
        bi[s] = idf;
        if (!P.bitonic) u[s] = order_key(v);
        open = unmasked(v, idf);
      }
      const unsigned mk = __ballot_sync(0xffffffffu, open);
      if (lane == 0 && s < itopk) pk[s >> 5] = mk;
    }
    for (int w = tid; w < width; w += THREADS) par[w] = -1;
    clk.lap(prof::kCgDedup);
    __syncthreads();
    clk.lap(prof::kCgBarrier);
  }

  for (int s = tid; s < itopk; s += THREADS) {
    P.out_v[q * itopk + s] = bv[s];
    P.out_idf[q * itopk + s] = bi[s];
  }
  if constexpr (PROF) {
    if (tid == 0) clk.count(P.prof_rec, prof::kCgParents, n_parents);
    if ((lane & 7) == 0) clk.count(P.prof_rec, prof::kCgRows, n_rows);
    clk.flush(P.prof_rec);
  }
}

template <typename T, bool DIRECT, bool PROF, int CH>
int launch(const Params& P, int nq, int smem, cudaStream_t stream) {
  auto kernel = cagra_beam_kernel<T, DIRECT, PROF, CH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nq, THREADS, smem, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The copy size a staged launch takes: the largest of 16, 8 and 4 bytes
// that divides a row, else 0 (two bytes through registers).
inline int chunk_bytes(int row_bytes) {
  return row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : 0;
}

template <typename T, bool PROF>
int launch_staged(const Params& P, int nq, int smem, cudaStream_t stream) {
  if (P.group_rows == 0) return launch<T, true, PROF, 16>(P, nq, smem, stream);
  switch (chunk_bytes(P.d * static_cast<int>(sizeof(T)))) {
    case 16: return launch<T, false, PROF, 16>(P, nq, smem, stream);
    case 8: return launch<T, false, PROF, 8>(P, nq, smem, stream);
    case 4: return launch<T, false, PROF, 4>(P, nq, smem, stream);
    default: return launch<T, false, PROF, 0>(P, nq, smem, stream);
  }
}

template <typename T>
int launch_type(const Params& P, int nq, int smem, cudaStream_t stream) {
  return P.prof_rec ? launch_staged<T, true>(P, nq, smem, stream)
                    : launch_staged<T, false>(P, nq, smem, stream);
}

}  // namespace

// The constants ops/cagra_search.py mirrors, which it checks once a build:
// out[0..4] = THREADS, BATCH, RANK_MAX, MIN_CTAS, ROW_PAD. Returns 0.
extern "C" int cagra_search_layout(int* out) {
  const int v[5] = {THREADS, BATCH, RANK_MAX, MIN_CTAS, ROW_PAD};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// The dynamic shared memory of one CTA: the layout above for esize-byte
// table elements, group_rows rows staged in `buffers` buffers (group_rows 0:
// rows read from global memory), bitonic 1 for the bitonic merge.
extern "C" int cagra_search_smem_bytes(int itopk, int width, int deg, int d, int esize,
                                       int group_rows, int buffers, int bitonic) {
  return layout(itopk, width, deg, d, esize, group_rows, buffers, bitonic).total;
}

// CTAs of a launch that fit on one SM with smem bytes of shared memory (the
// occupancy calculator, registers included) into *out. direct: the DIRECT
// instantiation. Returns a cudaError_t.
extern "C" int cagra_search_ctas_per_sm(int table_bf16, int direct, int smem, int* out) {
  const void* k = table_bf16 ? (direct ? (const void*)cagra_beam_kernel<__nv_bfloat16, true, false, 16>
                                       : (const void*)cagra_beam_kernel<__nv_bfloat16, false, false, 16>)
                             : (direct ? (const void*)cagra_beam_kernel<float, true, false, 16>
                                       : (const void*)cagra_beam_kernel<float, false, false, 16>);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_LIMIT));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, THREADS, smem));
}

// table [n][deg][d] f32 (table_bf16 = 0) or bf16 (1), 16-byte aligned;
// graph [n][deg] i32, queries [nq][d] f32, init_v/out_v [nq][itopk] f32,
// init_idf/out_idf [nq][itopk] i32; ip: 0 = L2, 1 = inner product. One CTA
// per query. group_rows: rows staged at once in `buffers` (1 or 2) buffers,
// 0 to read rows from global memory; bitonic: 1 for the bitonic merge;
// smem: cagra_search_smem_bytes of these, at most 227 KB. prof_rec: null,
// or int64 [nq][prof::RECORD] zeroed, for the stage clock's instantiation.
// Returns a cudaError_t (0 = launched).
extern "C" int cagra_search_beam(const void* table, int table_bf16, const int* graph,
                                 const float* queries, const float* init_v, const int* init_idf,
                                 float* out_v, int* out_idf, int nq, int d, int deg, int itopk,
                                 int width, int iters, int ip, int group_rows, int buffers,
                                 int bitonic, long long* prof_rec, void* stream) {
  const int W = width * deg;
  if (nq < 1 || d < 1 || deg < 1 || itopk < 1 || width < 1 || width > itopk || iters < 0 ||
      group_rows < 0 || group_rows > W || buffers < 0 || buffers > 2 ||
      (group_rows > 0) != (buffers > 0) || (buffers == 1 && group_rows < W) ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int esize = table_bf16 ? 2 : 4;
  const int smem = layout(itopk, width, deg, d, esize, group_rows, buffers, bitonic).total;
  if (smem > static_cast<int>(SMEM_LIMIT)) return static_cast<int>(cudaErrorInvalidValue);
  const Params P{table, graph, queries, init_v, init_idf, out_v, out_idf, prof_rec, d, deg, itopk,
                 width, iters, ip, group_rows, buffers, bitonic};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return table_bf16 ? launch_type<__nv_bfloat16>(P, nq, smem, s)
                    : launch_type<float>(P, nq, smem, s);
}
