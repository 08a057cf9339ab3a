// Ring top-k merge of sharded search: the fold (B5), the ring (B6) and the
// scan ring (B7).
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
// ring_fold (B5): per row, the w first of the 2w entries of two [rows][w]
// tiles, in order. The tiles need not be sorted. A null key pointer means key
// = val (key_sign 1) or -val (key_sign -1): the ring's state carries (pos,
// val, id) only, so a reduce-scatter hop ships 12 B a candidate. Output may
// alias input a (the ring folds in place).
//
// ring_stage (staging of the host-scheduled ring, which runs when the shards
// sit on distinct cards): shard `rank`'s [nq][kc] (val, id) tile into the ring
// state, int32 blocks [n][3][B][w] of (pos, val bits, id); rows past nq and
// columns past kc are padding; a tile wider than w is folded w columns at a
// time (raft_tpu's _scan_fold; equal to a sort and truncate). The schedule's
// hops are peer copies and ring_fold launches (ops/ring_topk.py).
//
// ring_onecard (B6 and B7 when every shard sits on one card): the whole ring
// in one cooperative launch, as the TPU kernel is one pallas_call. CTA (g, r)
// plays rank r (blockIdx.y) for row group g: rows g*warps .. g*warps+warps-1
// of each of the rank's n query blocks (B = ceil(nq / n) rows a block), one
// warp a row. Row j of block b at rank r depends only on row j of block b at
// rank r - 1, so a CTA talks only to (g, r +- 1). The CTA keeps its rows'
// state for all n blocks in shared memory (the TPU kernel's VMEM scratch):
//   stage   rank r's [nq][kc] tile read straight from the caller's tensor,
//           pos = r * kc + c; kc <= w pads, kc > w folds the row w columns at
//           a time (B7's scan fold, raft_tpu's _scan_fold);
//   reduce-scatter, hops s = 0 .. n-2: write block (r - s) mod n's rows as
//           (pos, val bits, id) into slot s of the right neighbour's receive
//           buffer, __syncthreads, one thread fences and release-stores
//           flag[right][g][s] = epoch (remote DMA + semaphore on the TPU);
//           acquire-wait on the own flag[r][g][s], fold the slot's rows into
//           block (r - s - 1) mod n. One slot a hop: no back-pressure;
//   all-gather: the finished block (r + 1) mod n goes as (val, id) into the
//           rank's own [nq][w] output and the right neighbour's (rows >= nq
//           skipped); at each later hop the block that arrived from the left
//           is forwarded, after a wait on flag[r][g][n-1+s-1].
// Flags are never reset between calls: each call has its own epoch (the
// wrapper re-zeroes them only when the epoch would wrap). Every CTA must be
// resident at once, so the launch is cooperative and the grid at most the
// co-resident CTAs (a CTA loops over row groups beyond it). A wait that
// outlasts SPIN_BUDGET cycles (about one second) traps, so a broken hand-off
// fails at the next synchronise instead of hanging.
//
// Bound on the H100. A ring reads every shard's tile once and writes every
// shard's [nq][w] output once: bytes-bound at a few microseconds for the
// served 128-query batch; what a call costs is the chain of 2n - 3 flag
// hand-offs through L2 and the launch, not the folds.
//
// The fold. The TPU kernel ranks by pairwise compares and places by one-hot
// sums over [rows, 2w, w] (with a finite WORST, since inf * 0 is NaN). Here
// the union is written to shared memory as 64-bit composite keys
// (order-preserving key bits over the pos bits); each thread counts, for its
// entries, the union entries before it (smaller composite, or equal at a lower
// column), and an entry whose rank is below w is written to slot rank. All
// threads read one composite at a time (a shared-memory broadcast). Values are
// carried, never recomputed: +-inf and NaN pass through as they came.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "stage_clock.cuh"

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


// ---- ring_onecard ------------------------------------------------------------

constexpr int MAX_RANKS = 16;
constexpr int MAX_WARPS = 8;
constexpr long long SPIN_BUDGET = 2000000000LL;  // clock64() cycles, ~1 s

struct RingArgs {
  const float* v[MAX_RANKS];  // rank r's [nq][kc] values
  const int* id[MAX_RANKS];   // rank r's [nq][kc] ids
  float* out_v;               // [n][nq][w]
  int* out_i;                 // [n][nq][w]
  int* recv;                  // [n][n - 1][3][Bs][w]: reduce-scatter slots (pos, val bits, id)
  int* flags;                 // [n][Gs][2n - 3]: reduce-scatter hops, then all-gather hops
  long long* prof;            // stage clock record, or null
  int n, nq, kc, w, B, Bs, G, Gs, warps, epoch, select_min;
};

// Shared memory of one CTA: the union scratch of each warp (composites, pos,
// val, id of 2w entries), then the state of its rows in every block.
__host__ __device__ constexpr size_t onecard_smem(int n, int w, int warps) {
  return static_cast<size_t>(warps) * w * (12 * static_cast<size_t>(n) + 2 * UNION_BYTES_PER_ENTRY);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Every thread's writes of this hop are done; then one thread publishes them.
__device__ __forceinline__ void signal(int* flag, int epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, epoch);
  }
}

// One thread polls the flag (acquire), the CTA waits for it. Traps past
// SPIN_BUDGET cycles.
template <bool PROF>
__device__ __forceinline__ void wait_flag(const int* flag, int epoch, prof::StageClock<PROF>& clk,
                                          long long* rec) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    unsigned ns = 0;
    int spins = 0;
    while (ld_acquire(flag) != epoch) {
      ++spins;
      if (clock64() - t0 > SPIN_BUDGET) __trap();
      __nanosleep(ns);
      ns = ns < 128 ? 2 * ns + 16 : 256;
    }
    clk.count(rec, prof::kSpins, spins);
    clk.count(rec, prof::kWaits, 1);
  }
  __syncthreads();
}

// One warp's fold of a state row (sp/sv/si, w entries) with w incoming
// entries load(e, pos, val, id) through the warp's union scratch u.
template <typename Load>
__device__ __forceinline__ void warp_fold(int* sp, float* sv, int* si, Union u, int w,
                                          int key_sign, int lane, Load load) {
  const int m = 2 * w;
  for (int e = lane; e < m; e += 32) {
    int p, i;
    float v;
    if (e < w) {
      p = sp[e];
      v = sv[e];
      i = si[e];
    } else {
      load(e - w, p, v, i);
    }
    u.put(e, key_sign > 0 ? v : -v, p, v, i);
  }
  __syncwarp();
  for (int e = lane; e < m; e += 32) {
    const int r = rank_of(u.comp, m, e);
    if (r < w) {
      sp[r] = u.pos[e];
      sv[r] = u.val[e];
      si[r] = u.id[e];
    }
  }
  __syncwarp();
}

template <bool PROF>
__global__ void __launch_bounds__(MAX_WARPS * 32) onecard_kernel(const RingArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, w = a.w, R = a.warps, kc = a.kc, m = 2 * w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.y, right = (r + 1) % n;
  const int key_sign = a.select_min ? 1 : -1;
  const float pad_v = a.select_min ? INFINITY : -INFINITY;
  const int n_flags = 2 * n - 3 > 0 ? 2 * n - 3 : 1;
  const long long bsw = static_cast<long long>(a.Bs) * w;  // one lane of one slot
  Union u = Union::carve(smem_raw + static_cast<size_t>(warp) * m * UNION_BYTES_PER_ENTRY, m);
  int* s_pos = reinterpret_cast<int*>(smem_raw + static_cast<size_t>(R) * m * UNION_BYTES_PER_ENTRY);
  float* s_val = reinterpret_cast<float*>(s_pos + n * R * w);
  int* s_id = reinterpret_cast<int*>(s_val + n * R * w);
  const float* v = a.v[r];
  const int* ids = a.id[r];
  prof::StageClock<PROF> clk;
  clk.start();

  for (int g = blockIdx.x; g < a.G; g += gridDim.x) {
    const int j = g * R + warp;  // this warp's row in every block
    const bool live = j < a.B;
    auto row = [&](int b) { return (b * R + warp) * w; };
    int* my_flags = a.flags + (static_cast<long long>(r) * a.Gs + g) * n_flags;
    int* right_flags = a.flags + (static_cast<long long>(right) * a.Gs + g) * n_flags;

    // ---- stage: the rank's tile, padded or folded to w columns
    if (live) {
      for (int b = 0; b < n; ++b) {
        const int q = b * a.B + j;
        const bool real_row = q < a.nq;
        const long long base = static_cast<long long>(q) * kc;
        auto col = [&](int c, int& p, float& x, int& i) {
          const bool real = real_row && c < kc;
          p = real ? r * kc + c : PAD_POS;
          x = real ? v[base + c] : pad_v;
          i = real ? ids[base + c] : -1;
        };
        int* sp = s_pos + row(b);
        float* sv = s_val + row(b);
        int* si = s_id + row(b);
        for (int e = lane; e < w; e += 32) col(e, sp[e], sv[e], si[e]);
        __syncwarp();
        for (int c0 = w; c0 < kc; c0 += w) {
          warp_fold(sp, sv, si, u, w, key_sign, lane,
                    [&](int e, int& p, float& x, int& i) { col(c0 + e, p, x, i); });
        }
      }
    }
    clk.lap(prof::kStage);

    // ---- reduce-scatter: after hop s, block (r - s - 1) mod n holds the
    // candidates of ranks r - s - 1 .. r; after n - 1 hops block (r + 1) mod n
    // is finished
    for (int s = 0; s < n - 1; ++s) {
      if (live) {
        const int sb = ((r - s) % n + n) % n;
        int* dst = a.recv + ((static_cast<long long>(right) * (n - 1) + s) * 3) * bsw +
                   static_cast<long long>(j) * w;
        for (int e = lane; e < w; e += 32) {
          __stcg(dst + e, s_pos[row(sb) + e]);
          __stcg(dst + bsw + e, __float_as_int(s_val[row(sb) + e]));
          __stcg(dst + 2 * bsw + e, s_id[row(sb) + e]);
        }
      }
      clk.lap(prof::kSend);
      signal(right_flags + s, a.epoch);
      wait_flag(my_flags + s, a.epoch, clk, a.prof);
      clk.lap(prof::kWait);
      if (live) {
        const int fb = ((r - s - 1) % n + n) % n;
        const int* got = a.recv + ((static_cast<long long>(r) * (n - 1) + s) * 3) * bsw +
                         static_cast<long long>(j) * w;
        warp_fold(s_pos + row(fb), s_val + row(fb), s_id + row(fb), u, w, key_sign, lane,
                  [&](int e, int& p, float& x, int& i) {
                    p = __ldcg(got + e);
                    x = __int_as_float(__ldcg(got + bsw + e));
                    i = __ldcg(got + 2 * bsw + e);
                  });
      }
      clk.lap(prof::kFold);
    }

    // ---- all-gather: the finished blocks as (val, id), straight into each
    // rank's [nq][w] output
    const int own = (r + 1) % n;
    float* my_v = a.out_v + static_cast<long long>(r) * a.nq * w;
    int* my_i = a.out_i + static_cast<long long>(r) * a.nq * w;
    float* right_v = a.out_v + static_cast<long long>(right) * a.nq * w;
    int* right_i = a.out_i + static_cast<long long>(right) * a.nq * w;
    if (live && own * a.B + j < a.nq) {
      const long long o = static_cast<long long>(own * a.B + j) * w;
      for (int e = lane; e < w; e += 32) {
        my_v[o + e] = s_val[row(own) + e];
        my_i[o + e] = s_id[row(own) + e];
      }
    }
    for (int s = 0; s < n - 1; ++s) {
      if (s > 0) {
        wait_flag(my_flags + (n - 1) + (s - 1), a.epoch, clk, a.prof);
        clk.lap(prof::kWait);
      }
      const int blk = ((r + 1 - s) % n + n) % n;
      if (live && blk * a.B + j < a.nq) {
        const long long o = static_cast<long long>(blk * a.B + j) * w;
        for (int e = lane; e < w; e += 32) {
          const float x = s == 0 ? s_val[row(own) + e] : __ldcg(my_v + o + e);
          const int i = s == 0 ? s_id[row(own) + e] : __ldcg(my_i + o + e);
          __stcg(right_v + o + e, x);
          __stcg(right_i + o + e, i);
        }
      }
      clk.lap(prof::kSend);
      // the last hop's block is read by no one before the kernel ends
      if (s < n - 2) signal(right_flags + (n - 1) + s, a.epoch);
    }
  }
  clk.flush(a.prof);
}

template <bool PROF>
cudaError_t onecard_occupancy(int n, int w, int warps, int* ctas) {
  const size_t smem = onecard_smem(n, w, warps);
  cudaError_t err = set_smem(onecard_kernel<PROF>, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, onecard_kernel<PROF>, warps * 32, smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *ctas = per_sm * sms;
  return err;
}

}  // namespace

// B5 (and each hop of the host-scheduled B6/B7): o = the w first of rows of [a | b] under (key,
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

// Bytes of dynamic shared memory a CTA of ring_onecard takes.
extern "C" int ring_onecard_smem_bytes(int n, int w, int warps) {
  return static_cast<int>(onecard_smem(n, w, warps));
}

// The CTAs of ring_onecard (prof: its stage-clock instantiation) that card
// `device` holds at once at this shape, into *ctas. Returns a cudaError_t.
extern "C" int ring_onecard_capacity(int device, int n, int w, int warps, int prof, int* ctas) {
  if (n < 1 || n > MAX_RANKS || w < 1 || warps < 1 || warps > MAX_WARPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prof ? onecard_occupancy<true>(n, w, warps, ctas) : onecard_occupancy<false>(n, w, warps, ctas);
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

namespace {

constexpr int MAX_DEVICES = 64;
std::mutex g_events_mu;
cudaEvent_t g_events[MAX_DEVICES][MAX_RANKS + 2] = {};

// Order `launch` on streams[0] after the work queued on streams[1..n_streams)
// and those streams after it, through events of the card's own pool (the
// caller holds g_events_mu and has made `device` current).
template <typename Launch>
cudaError_t with_stream_order(int device, void* const* streams, int n_streams, Launch launch) {
  cudaEvent_t* ev = g_events[device];
  cudaError_t err = cudaSuccess;
  for (int i = 0; i <= n_streams && err == cudaSuccess; ++i) {
    if (ev[i] == nullptr) err = cudaEventCreateWithFlags(&ev[i], cudaEventDisableTiming);
  }
  const cudaStream_t s0 = static_cast<cudaStream_t>(streams[0]);
  for (int i = 1; i < n_streams && err == cudaSuccess; ++i) {
    const cudaStream_t si = static_cast<cudaStream_t>(streams[i]);
    if (si == s0) continue;
    err = cudaEventRecord(ev[i], si);
    if (err == cudaSuccess) err = cudaStreamWaitEvent(s0, ev[i], 0);
  }
  if (err != cudaSuccess) return err;
  err = launch(s0);
  if (err != cudaSuccess) return err;
  err = cudaEventRecord(ev[0], s0);
  for (int i = 1; i < n_streams && err == cudaSuccess; ++i) {
    const cudaStream_t si = static_cast<cudaStream_t>(streams[i]);
    if (si != s0) err = cudaStreamWaitEvent(si, ev[0], 0);
  }
  return err;
}

}  // namespace

// B6/B7 on one card: the ring over n ranks in one cooperative launch of a
// (grid_x, n) grid of warps-warp CTAs on card `device`. ptrs (host memory)
// holds the n value pointers then the n id pointers of the ranks' [nq][kc]
// tiles; out_v/out_i [n][nq][w]; recv [n][n-1][3][Bs][w] and flags
// [n][Gs][max(2n-3, 1)] int32, the flags holding no value equal to epoch.
// prof (null for the normal launch) takes the stage clock's record,
// [grid_x * n][prof::RECORD] int64, zeroed. streams (host memory) holds the
// launch stream, then n_streams - 1 streams the launch waits for and that
// wait for it (the caller's and the other shards'); nothing waits on the
// host. Returns a cudaError_t (0 = launched).
extern "C" int ring_onecard(const long long* ptrs, int n, int nq, int kc, int w, int select_min,
                            float* out_v, int* out_i, int* recv, int* flags, int B, int Bs,
                            int G, int Gs, int grid_x, int warps, int epoch, long long* prof,
                            int device, void* const* streams, int n_streams) {
  if (n < 1 || n > MAX_RANKS || nq < 1 || kc < 1 || w < 1 || warps < 1 || warps > MAX_WARPS ||
      B != (nq + n - 1) / n || Bs < B || G != (B + warps - 1) / warps || Gs < G || grid_x < 1 ||
      grid_x > G || epoch < 1 || device < 0 || device >= MAX_DEVICES || n_streams < 1 ||
      n_streams > MAX_RANKS + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs a{};
  for (int r = 0; r < n; ++r) {
    a.v[r] = reinterpret_cast<const float*>(ptrs[r]);
    a.id[r] = reinterpret_cast<const int*>(ptrs[n + r]);
  }
  a.out_v = out_v;
  a.out_i = out_i;
  a.recv = recv;
  a.flags = flags;
  a.prof = prof;
  a.n = n;
  a.nq = nq;
  a.kc = kc;
  a.w = w;
  a.B = B;
  a.Bs = Bs;
  a.G = G;
  a.Gs = Gs;
  a.warps = warps;
  a.epoch = epoch;
  a.select_min = select_min;
  const size_t smem = onecard_smem(n, w, warps);
  void* kernel = prof ? reinterpret_cast<void*>(onecard_kernel<true>)
                      : reinterpret_cast<void*>(onecard_kernel<false>);
  std::lock_guard<std::mutex> lock(g_events_mu);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = prof ? set_smem(onecard_kernel<true>, smem) : set_smem(onecard_kernel<false>, smem);
  if (err == cudaSuccess) {
    err = with_stream_order(device, streams, n_streams, [&](cudaStream_t s0) {
      void* args[] = {&a};
      cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid_x, n), dim3(warps * 32), args,
                                                  smem, s0);
      return e != cudaSuccess ? e : cudaGetLastError();
    });
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}
