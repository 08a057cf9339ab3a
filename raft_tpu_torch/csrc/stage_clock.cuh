// In-kernel stage clock for the fused kernels: where a CTA's cycles go.
//
// A kernel templated on PROF keeps one StageClock per thread. lap(s) adds
// the clock64() cycles since the previous lap to stage s (warp_lap(s) once
// the warp has reconverged, where lanes may skip the stage); flush() has lane
// 0 of every warp add its warp's per-stage cycles and its total into the
// CTA's record, and thread 0 write the CTA's own cycles (first lap to
// flush). With PROF false every call compiles to nothing, so the normal
// instantiation carries no cost.
//
// count(c, n) adds n to event counter c of the CTA's record (any thread,
// a global atomic: it too runs only with the clock on).
//
// Record layout (int64, one row per CTA, CTA = linear block index):
//   [0, N_STAGES)  cycles per stage, summed over the CTA's warps
//   N_STAGES       cycles of the warps from start() to flush(), summed
//   N_STAGES + 1   the CTA's cycles (thread 0, start() to flush())
//   N_STAGES + 2 + c  event counter c (N_COUNTS of them)
// Stage s's share of the warps' time is rec[s] / rec[N_STAGES]; the rest
// is loop control and whatever a kernel does outside its laps.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace prof {

constexpr int N_STAGES = 6;
constexpr int N_COUNTS = 2;
constexpr int RECORD = N_STAGES + 2 + N_COUNTS;  // int64 words per CTA
enum Stage { kLut = 0, kQc = 1, kCodes = 2, kScore = 3, kTopk = 4, kBarrier = 5 };
// B2's counters: candidates that passed the filter, batches merged into a list
enum Count { kCandidates = 0, kMerges = 1 };
// The one-launch ring's stages (B6/B7 on one card) and counters: polls of a
// flag that was not yet set, and flag waits
enum RingStage { kStage = 0, kWait = 1, kFold = 2, kSend = 3 };
enum RingCount { kSpins = 0, kWaits = 1 };
// B3's stages (codes: staging, unpack and q.c, and, as measured, most of
// the wait at a chunk's first barrier; mma: the bit product; filter: lower
// bounds and buffering; rescore: exact
// scores of the candidates; merge: folding them into the lists) and
// counters: candidates that passed the filter, 32-wide batches merged
enum RqStage { kRqCodes = 0, kRqMma = 1, kRqFilter = 2, kRqRescore = 3, kRqMerge = 4, kRqBarrier = 5 };
enum RqCount { kRqSurvivors = 0, kRqMerges = 1 };
// B4's stages (pick: the parents; fetch: graph ids and table rows, their
// wait included; score; merge: the union's order; dedup: the adjacent kill
// and what the next pick reads) and counters: valid parents, rows scored
enum CgStage { kCgPick = 0, kCgFetch = 1, kCgScore = 2, kCgMerge = 3, kCgDedup = 4, kCgBarrier = 5 };
enum CgCount { kCgParents = 0, kCgRows = 1 };

__device__ __forceinline__ long long* cta_record(long long* rec) {
  return rec + (long long)(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) * RECORD;
}

template <bool PROF>
struct StageClock {
  long long t0 = 0, t = 0;
  long long acc[N_STAGES] = {};

  __device__ __forceinline__ void start() {
    if constexpr (PROF) t0 = t = clock64();
  }
  __device__ __forceinline__ void lap(int stage) {
    if constexpr (PROF) {
      const long long now = clock64();
      acc[stage] += now - t;
      t = now;
    }
  }
  // lap(stage) after a __syncwarp(), for a point every lane of the warp
  // reaches after a branch some lanes skip: lane 0 then books the others'
  // time in the branch to `stage`, not to the stage that laps next.
  __device__ __forceinline__ void warp_lap(int stage) {
    if constexpr (PROF) {
      __syncwarp();
      lap(stage);
    }
  }
  __device__ __forceinline__ void count(long long* __restrict__ rec, int counter, int n) {
    if constexpr (PROF) {
      atomicAdd(reinterpret_cast<unsigned long long*>(cta_record(rec) + N_STAGES + 2 + counter),
                (unsigned long long)n);
    }
  }
  __device__ __forceinline__ void flush(long long* __restrict__ rec) {
    if constexpr (PROF) {
      const long long now = clock64();
      long long* row = cta_record(rec);
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int s = 0; s < N_STAGES; ++s) {
          atomicAdd(reinterpret_cast<unsigned long long*>(row + s), (unsigned long long)acc[s]);
        }
        atomicAdd(reinterpret_cast<unsigned long long*>(row + N_STAGES),
                  (unsigned long long)(now - t0));
      }
      if (threadIdx.x == 0) row[N_STAGES + 1] = now - t0;
    }
  }
};

}  // namespace prof
}  // namespace
