// Ring top-k merge of sharded search: the fold (B5) and the staging fold of
// the scan ring (B7), the two kernels of the ring engine (B6).
//
// Replaces the Pallas TPU kernels of raft_tpu/ops/pallas/ring_topk.py:
//   B5 hop_merge            (def :328, pallas_call :339; body _hop_merge_kernel
//                            :313, _rank_merge_pos :285)
//   B6 fused_ring_topk      (def :505, pallas_call :517; bodies _ring_kernel
//                            :453, _ring_body :349)
//   B7 fused_scan_ring_topk (def :530, pallas_call :564; body _scan_ring_kernel
//                            :470)
//
// What they compute. A candidate is (key f32, pos i32, val f32, id i32); key is
// val for a min-select and -val for a max-select, pos its position in the
// shard-major concatenation of the shards' tiles (rank * kc + column), padding
// (key +inf, pos INT32_MAX, val +-inf, id -1). The ring merges under the total
// order (key, pos): the key canonicalised as lax.sort compares it (-0 ties +0,
// every NaN is one value after +inf), then pos as a signed int; entries equal
// in both (only padding, which is identical in every lane) keep their column
// order. Under a total order every fold schedule gives the gather merge.
//
// ring_fold (B5, and every hop of B6/B7): per row, the w first of the 2w
// entries of two [rows][w] tiles, in order. The tiles need not be sorted. A
// null key pointer means key = val (key_sign 1) or -val (key_sign -1): the
// ring's state carries (pos, val, id) only, so a reduce-scatter hop ships 12 B
// a candidate. Output may alias input a (the ring folds in place).
//
// ring_stage (B6's and B7's staging): shard `rank`'s [nq][kc] (val, id) tile
// into the ring state, int32 blocks [n][3][B][w] of (pos, val bits, id): rows
// past nq and columns past kc are padding; a tile wider than w is folded w
// columns at a time, each step one ring_fold of the running top-w with the next
// slice (raft_tpu's _scan_fold; equal to a sort and truncate).
//
// Bound on the H100. A fold reads 2w entries and writes w per row: 12 B read
// and 12 B written a candidate at most, bytes-bound (a few ns per row at HBM
// rate). The hops' copies are the transport, not these kernels.
//
// Design. The TPU kernel ranks by pairwise compares and places by one-hot sums
// over [rows, 2w, w] (with a finite WORST, since inf * 0 is NaN). Here one CTA
// takes one row: the union is loaded to shared memory as 64-bit composite keys
// (order-preserving key bits over the pos bits), each thread counts, for its
// entries, the union entries before it (smaller composite, or equal at a lower
// column), and an entry whose rank is below w is written to slot rank. The
// rank count is O((2w)^2) compares per row; all threads read one composite at a
// time (a shared-memory broadcast). Inputs are read into shared memory before
// any output is written, so a fold can run in place. Values are carried, never
// recomputed: +-inf and NaN pass through as they came.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PAD_POS = 0x7fffffff;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB

// (key, pos) as one unsigned 64-bit key in the ring's order.
__device__ __forceinline__ unsigned long long composite(float key, int pos) {
  unsigned u = __float_as_uint(key);
  if (isnan(key)) {
    u = 0x7fc00000u;
  } else if (u == 0x80000000u) {
    u = 0u;
  }
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         (static_cast<unsigned>(pos) ^ 0x80000000u);
}

// One union entry in shared memory (structure of arrays of length m).
struct Union {
  unsigned long long* comp;
  float* key;
  int* pos;
  float* val;
  int* id;

  __device__ static Union carve(unsigned char* base, int m) {
    Union u;
    u.comp = reinterpret_cast<unsigned long long*>(base);
    u.key = reinterpret_cast<float*>(u.comp + m);
    u.pos = reinterpret_cast<int*>(u.key + m);
    u.val = reinterpret_cast<float*>(u.pos + m);
    u.id = u.pos + 2 * m;
    return u;
  }

  __device__ void put(int e, float k, int p, float v, int i) {
    comp[e] = composite(k, p);
    key[e] = k;
    pos[e] = p;
    val[e] = v;
    id[e] = i;
  }
};

constexpr size_t UNION_BYTES_PER_ENTRY = 8 + 4 * 4;

// Rank of entry e among the m union entries: entries with a smaller composite,
// or an equal one at a lower position, come first.
__device__ __forceinline__ int rank_of(const unsigned long long* comp, int m, int e) {
  const unsigned long long c = comp[e];
  int r = 0;
  for (int j = 0; j < m; ++j) {
    const unsigned long long cj = comp[j];
    r += (cj < c) | ((cj == c) & (j < e));
  }
  return r;
}

// Not __restrict__: the output may alias input a.
__global__ void fold_kernel(const float* ak, const int* ap, const float* av, const int* ai,
                            const float* bk, const int* bp, const float* bv, const int* bi,
                            float* ok, int* op, float* ov, int* oi, int w, int key_sign) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = 2 * w;
  Union u = Union::carve(smem_raw, m);
  const long long row = blockIdx.x;
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    const bool from_a = e < w;
    const long long off = row * w + (from_a ? e : e - w);
    const float v = from_a ? av[off] : bv[off];
    const float* kp = from_a ? ak : bk;
    const float k = kp != nullptr ? kp[off] : (key_sign > 0 ? v : -v);
    u.put(e, k, from_a ? ap[off] : bp[off], v, from_a ? ai[off] : bi[off]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    const int r = rank_of(u.comp, m, e);
    if (r < w) {
      const long long o = row * w + r;
      if (ok != nullptr) ok[o] = u.key[e];
      op[o] = u.pos[e];
      ov[o] = u.val[e];
      oi[o] = u.id[e];
    }
  }
}

__global__ void stage_kernel(const float* __restrict__ v, const int* __restrict__ ids, int nq,
                             int kc, int rank, int B, int w, int select_min,
                             int* __restrict__ state) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row = blockIdx.x;
  const int blk = row / B;
  const long long bw = static_cast<long long>(B) * w;
  int* sp = state + blk * 3 * bw + static_cast<long long>(row - blk * B) * w;
  float* sv = reinterpret_cast<float*>(sp + bw);
  int* si = sp + 2 * bw;
  const float pad_v = select_min ? INFINITY : -INFINITY;
  const bool real_row = row < nq;

  if (kc <= w) {  // nothing to fold: the tile, padded to w columns
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
      const bool real = real_row && c < kc;
      const long long off = static_cast<long long>(row) * kc + c;
      sp[c] = real ? rank * kc + c : PAD_POS;
      sv[c] = real ? v[off] : pad_v;
      si[c] = real ? ids[off] : -1;
    }
    return;
  }

  const int m = 2 * w;
  Union cur = Union::carve(smem_raw, m);
  Union nxt = Union::carve(smem_raw + m * UNION_BYTES_PER_ENTRY, m);
  // entry e of the union <- column c of the tile (padding past kc)
  auto load = [&](Union& u, int e, int c) {
    const bool real = real_row && c < kc;
    const long long off = static_cast<long long>(row) * kc + c;
    const float x = real ? v[off] : pad_v;
    u.put(e, select_min ? x : -x, real ? rank * kc + c : PAD_POS, x, real ? ids[off] : -1);
  };
  for (int e = threadIdx.x; e < w; e += blockDim.x) load(cur, e, e);
  for (int c0 = w; c0 < kc; c0 += w) {
    for (int e = threadIdx.x; e < w; e += blockDim.x) load(cur, w + e, c0 + e);
    __syncthreads();
    for (int e = threadIdx.x; e < m; e += blockDim.x) {
      const int r = rank_of(cur.comp, m, e);
      if (r < w) {
        nxt.comp[r] = cur.comp[e];
        nxt.key[r] = cur.key[e];
        nxt.pos[r] = cur.pos[e];
        nxt.val[r] = cur.val[e];
        nxt.id[r] = cur.id[e];
      }
    }
    __syncthreads();
    const Union t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    sp[c] = cur.pos[c];
    sv[c] = cur.val[c];
    si[c] = cur.id[c];
  }
}

int threads_for(int entries) {
  int t = 32;
  while (t < entries && t < 256) t <<= 1;
  return t;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

}  // namespace

// B5 (and each hop of B6/B7): o = the w first of rows of [a | b] under (key,
// pos). Every lane is [rows][w]; ak/bk/ok may be null (key = key_sign * val;
// the output key is then not written); o may alias a. One CTA per row.
// Returns a cudaError_t (0 = launched).
extern "C" int ring_fold(const float* ak, const int* ap, const float* av, const int* ai,
                         const float* bk, const int* bp, const float* bv, const int* bi,
                         float* ok, int* op, float* ov, int* oi, int rows, int w, int key_sign,
                         void* stream) {
  if (rows < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(w) * UNION_BYTES_PER_ENTRY;
  cudaError_t err = set_smem(fold_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_kernel<<<rows, threads_for(2 * w), smem, static_cast<cudaStream_t>(stream)>>>(
      ak, ap, av, ai, bk, bp, bv, bi, ok, op, ov, oi, w, key_sign);
  return static_cast<int>(cudaGetLastError());
}

// Staging of B6 and B7: shard `rank`'s tile v/ids [nq][kc] into state
// [n_rows / B][3][B][w] int32 (pos, val bits, id per block); rows >= nq and
// columns >= kc are padding; kc > w folds the tile to its top w per row.
// One CTA per state row. Returns a cudaError_t (0 = launched).
extern "C" int ring_stage(const float* v, const int* ids, int nq, int kc, int rank, int n_rows,
                          int B, int w, int select_min, int* state, void* stream) {
  if (nq < 0 || kc < 1 || rank < 0 || B < 1 || w < 1 || n_rows < nq || n_rows % B != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = kc > w ? 4 * static_cast<size_t>(w) * UNION_BYTES_PER_ENTRY : 0;
  cudaError_t err = set_smem(stage_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  stage_kernel<<<n_rows, threads_for(kc > w ? 2 * w : w), smem,
                 static_cast<cudaStream_t>(stream)>>>(v, ids, nq, kc, rank, B, w, select_min,
                                                      state);
  return static_cast<int>(cudaGetLastError());
}
