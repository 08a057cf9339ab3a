"""Chip smoke test of the raft_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--quick] [--profile]
    python3 chip_smoke.py --phases paths,serve,ring,b1,b3,rabitq,b4,mutable,robust,tiered,multi,replica,prims,geo,data,graph,procs,bench [--tree DIR] [--seed 0]

Phases, in order; any failure exits non-zero:

1. device and build: the card's name and power limit, torch/CUDA versions,
   and the build of every kernel of the port from ``raft_tpu_torch/csrc``
   (one nvcc per source, all started together), with ``-Xptxas -v``;
2. kernel vs plain, each kernel on the card against its plain PyTorch
   version on the card, on mid-size indexes (65,536 x 128): B1
   ``fused_list_topk`` for the four metrics and int8 and bf16 lists at
   k = 10 and 100; B2 ``fused_pq_topk`` for nib8, u8 (ksub 16 and 256),
   p4 and b5 codes under L2 and IP at k = 10 and 80; B3
   ``fused_rabitq_topk`` on RaBitQ indexes at d = 128, 136 (an odd byte
   count a row), 1,544 and 3,072 (the depth-sliced instantiation, with and
   without staged code rows), with tiles of 128, 32, 16 and 8 queries,
   with and without a filter bitset, under L2 and IP at k = 10, 80 and
   256, equal to the plain version bit for bit (``torch.equal`` of values
   and slots), per shape one launch of its checking instantiation
   (``fused_rabitq_topk_filter``: the filter's lower bound never above an
   exact score), and timed at d = 1,544 and 3,072
   (``fused_rabitq_topk_sliced_ms``); each with one
   CTA per tile share and with the default split; B4 ``cagra_fused_search``
   on CAGRA graphs of degree 16 and 32 built through the ``ivf_pq`` route,
   under L2 and IP, with f32 and bf16 tables, at (itopk, width) of (64, 1),
   (64, 4) and (128, 8), at (256, 16) on degree 32, at d = 100 and 960,
   and on a random graph at d = 101, each bit-equal to its plain version
   with a digest (:func:`cagra_checks`); then the build's determinism: the same IVF-Flat
   and IVF-PQ index built twice from one seed must be equal, and one build
   with the float-atomic sums the port used before is timed beside them;
3. IVF-Flat at full width: a 1,000,000 x 128 f32 clustered dataset (the
   SIFT-1M shape) and 10,000 queries made with numpy from ``--seed``;
   ``ivf_flat.build(n_lists=1024)``; served through
   ``ServingEngine(max_batch=128)`` with requests of 1-128 rows, first one
   request at a time (buckets 1-128: the probe path and the fused scan),
   then as one backlog (full 128-row batches); served recall@10 against
   exact ``brute_force.knn``; fused against probe recall on all 10,000
   queries in one batch; ``select_k`` timed on a dense scan's
   ``[128, 524288]`` block and a 16-row probe-path search; B1 held
   against its plain version at the main path's shapes and timed beside
   its bound;
4. IVF-PQ at full width, on the same data: ``ivf_pq.build(n_lists=1024)``
   with the defaults (nibble codes, pq_dim 64), served with
   ``IvfPqSearchParams(n_probes=30)`` and ``dataset=`` (8x exact refine)
   in both serving modes; fused against probe recall without refine; a
   sweep of the fused tile size over unsorted 128-row batches; B2 at the
   serving shape (k = 80) against its plain version and its bound (timed
   with the group tables the index keeps, and once building them), and
   where its cycles go there (``fused_pq_topk_split``: each stage's share
   of the warps' cycles and the min / median / max cycles of a CTA, from
   the kernel's stage clock);
5. RaBitQ: ``ivf_pq.build(n_lists=1024, pq_bits=1)``, ``search`` in auto
   mode with ``dataset=`` on the 10,000 queries (recall with and without
   refine, digests of the ids); B3 at that path's shape (1,024 queries,
   k = 80) against its plain version and its bound (the largest of the
   bytes, one bf16 pass of the bit product and the estimator's FP32
   operations; ``fadd_bound_ms`` the masked-add form's), its CTA plan and
   grid, where its cycles go (``fused_rabitq_topk_split``) and its filter
   check (``fused_rabitq_topk_filter``);
6. CAGRA at full width: ``cagra.build(intermediate_graph_degree=32,
   graph_degree=16, build_algo="ivf_pq")`` on phase 4's IVF-PQ index (its
   self-search runs B2), search with ``CagraSearchParams(itopk_size=128,
   search_width=8, dedup="post")`` and the bf16 table in fused and xla mode
   on all 10,000 queries, an itopk sweep of 96/160 (and the seed rows'
   sweep of 4,096/16,384), batch-1 and
   batch-10 latency through ``plan_search_params``, served through
   ``ServingEngine`` both ways; B4 at the serving shape, batch 1 and 10 and
   a 1,024-query batch against its plain version and its bound, with its
   stage split, its staging options timed, and the call profile of
   ``cagra.search`` (:func:`b4_main`);
7. sharded search at full width over ``make_mesh(["cuda:0"] * 4)``, four
   virtual shards on one card (a peer copy between them stays inside device
   memory): ``sharded_ivf_flat_search`` on phase 3's index (256 lists a
   shard, ``n_probes=20``) over the 10,000 queries in 1,024-row batches with
   the ring (B6), the scan ring (B7) and the gather merge, bit-equal, with
   recall against exact and against the single-device ``search(mode=
   "scan")``; served as ``sharded_ivf_flat`` through ``ServingEngine`` both
   ways; the per-shard scan at 80 candidates into ``scan_ring_topk(k=10)``
   (B7) against the gather of the same tiles; ``sharded_ivf_pq_lists_search``
   on phase 4's index and ``sharded_knn`` on the 1M rows, ring against
   gather; B5-B7 timed at the served (128-row) shape (checked at 1,024 rows too), B6
   and B7 beside the gather merge and the host schedule. On one card the
   rings launch no B5: its folds run inside B6's and B7's launches
   (``fused_ring_topk.folds``).

8. the mutable index at full width (:func:`mutable_phase`): phase 3's
   rows inserted into ``MutableIndex.open(ivf_flat, n_lists=1024)`` in
   65,536-row chunks and compacted to generation 1 (equal to phase 3's
   build), then churn (31,744 inserts, 10,000 deletes and 1,024 upserts of
   main rows) filling the delta to 32,768 rows, 32 banks of B1: B1's delta
   launch bit-equal to its plain version at k = 10 and 100, the fused
   delta route against the exact one, no deleted id, the upserts found,
   recall within 0.005 of generation 1's; served through
   ``register_mutable`` while a writer thread inserts and the compactor
   flips to generation 2 in the background (QPS, flips, compaction
   seconds, B1's launches on the main and delta scans, the device busy
   share of a backlog); a cold reopen with equal rows and answers; a
   compaction equal to a fresh build at 65,536 rows.
9. robustness in serving (:func:`robust_phase`): phase 7's sharded
   IVF-Flat served with ``merge_mode="ring"`` through the degraded path
   (a timed health probe a batch): all healthy, bit-equal to the plain
   sharded search; shard 2 down through the ``sharded_ann.shard_scan``
   fault seam, coverage 0.75, bit-equal to the search with that shard
   masked, none of its ids; a slow shard left out; a ``min_coverage``
   floor failing its futures typed; the ``pallas.pq_scan`` and
   ``pallas.cagra_search`` seams on phase 4's and 6's served indexes
   failing one batch typed and the next served; B6 once a batch; obs off
   against on (QPS of the IVF-Flat and sharded backlogs, the span tree of
   one dispatch); ``health()``.
10. placement and planning (:func:`tiered_phase`) on phases 3, 4 and 6's
   indexes: ``residency_for_index`` of each against the sum of its CUDA
   tensors' bytes (CAGRA's neighbour table included) and
   ``torch.cuda.memory_allocated()``; phase 4's IVF-PQ registered under an
   ``hbm_budget_bytes`` that spills its raw rows to a ``HostVectorStore``,
   served one request at a time and as a backlog, each batch bit-equal to
   the resident search, B2 launched, the tiered and resident backlogs'
   QPS in turns, the fetch counters and the busy share; a ``TieredIndex``
   over a mapped snapshot of the rows for IVF-PQ (B2) and IVF-Flat (B1),
   bit-equal, and over the rows without read-ahead and in host RAM; the
   ``host.fetch`` seam (latency, a failed batch typed, the next served);
   ``plan_explain``, the planner's choice for buckets 1-128 against the
   inline rule beside each engine's time, serving bit-equal with
   ``RAFT_TPU_PLAN`` 0 and 1; ``smem_model`` against each kernel's
   ``*_smem_bytes`` export with its ``ptxas`` lines.
11. the rest of the multi-device layer (:func:`multi_phase`) over
   ``make_mesh(["cuda:0"] * 4)``: ``sharded_ivf_pq_build`` of the 1M rows
   with the full and the communication-avoiding exchange (the build's comms
   counters beside the wire model, build seconds, peak memory, a rebuild
   equal in every field, recall within 0.05 of the single-device build),
   the built index served lists-sharded (B6, B7 and gather bit-equal);
   ``sharded_ivf_pq_search`` and ``sharded_cagra_search`` on phases 4's and
   6's indexes, each shard's rows equal to the single-device search of the
   same slice; RaBitQ's dense scan on phase 5's index beside B3; phase 4's
   index registered sharded with ``dataset=`` under a per-shard budget that
   converts it to ``tiered_sharded``, served bit-equal to the resident
   sharded search plus refine batch by batch, with shard 2's host tier
   lost (coverage 0.75) and a ``min_coverage`` floor; the comms verbs added
   with it against numpy.
12. replicated serving and the rest of obs (:func:`replica_phase`) on
   phase 3's IVF-Flat index: (a) a one-replica ``ReplicaGroup`` bit-equal
   to a bare ``ServingEngine`` over the 10,000-query backlog of 1-128-row
   requests; 1, 2 and 4 replicas with threaded pumps on one shared index,
   a backlog of 65-128-row requests (each a micro-batch of its own)
   bit-equal to the bare engine's, QPS, p50/p99, B1 launches and the
   device busy share of each; (b) replica 1 of two killed through the
   ``replica.dispatch`` seam a third into the stream while it holds
   queued work: every future completes without error, bit-equal to the
   run without the kill, ``serve.failovers`` > 0; (c) a 1M-row mutable
   leader and two followers behind ``register_mutable_replicated``,
   phase 8's churn sealed and shipped each maintenance tick, each
   follower at the leader's record count bit-equal to the leader, the
   staleness floor keeping reads on the leader, both following a
   compaction flip, B1's delta launch on a follower equal to its plain
   version; (d) a ``ControlPlane``: the leader killed with one follower's
   wire down, the higher cursor promoted (the election's seconds), no
   caller error, the deposed epoch fenced (``FencedError``); (e) a flight
   recorder and an SLO the backlog breaches: exactly one CRC-valid
   bundle that round-trips through ``load_bundle``, and with obs off the
   backlog bit-equal to (a)'s.
13. the search path's primitives (:func:`prims_phase`), plain PyTorch on
   the card: ``pairwise_distance`` under each of the 20 computable metrics
   on the card against the CPU at 256 x 4,096 x 128 (inputs fit to the
   metric; largest difference and tolerance printed), each timed at the
   bench's 2,048 x 16,384 x 128; exact ``brute_force.search`` of one
   128-query batch over the 1M rows under each accumulation metric against
   ``select_k`` of the whole ``pairwise_distance`` matrix; ``mode="approx"``
   over the 10,000 queries equal to the exact mode, recall against exact
   kNN; ``BatchKQuery`` pages 0-4 equal to one k = 160 search;
   ``masked_l2_nn`` at 16,384 x 16,384 x 64 (32 groups) against a masked
   whole-matrix argmin, and on integer rows (exact distances, many ties)
   the lowest of the tied ids exactly; ``approx_select_k`` (512 x 65,536, k = 64) and
   ``rbf_kernel`` (4,096 x 4,096 x 128) timed. No hand kernel runs here.
14. k-means' remaining entry points, the epsilon neighbourhood, ball cover
   and hnsw at full width (:func:`geo_phase`): ``fit_predict``,
   ``transform``, ``inertia``, ``find_k`` (2-64), ``fit_minibatch`` and
   balanced ``fit_predict`` at k = 1,024 on the 1M rows; ``eps_neighbors``
   of 4,096 queries against the 1M rows held against brute force; ball
   cover over 1M clustered (lat, lon) points, dense and pruned, ids equal
   to an exact tiled Haversine search; phase 6's index through an hnswlib
   file and back, searched on B4 and ``torch.equal`` to ``cagra.search``.
15. the data and statistics primitives (:func:`data_phase`), plain
   PyTorch on the card: each against the CPU at a check shape (random ones
   by their moments), then timed at a user's shape. No hand kernel runs.
16. sparse containers and linalg, sparse distances and kNN (native CSR at
   2^20 columns and densified), the kNN graph, MST, Lanczos, single
   linkage, spectral partitioning and the LAP solver (:func:`graph_phase`):
   each on the card against the CPU at a check shape, then timed at a
   user's shape. Plain PyTorch (the LAP a C solver on the host); no hand
   kernel runs.
17. multi-process meshes (:func:`procs_phase`): phase 3's IVF-Flat and
   phase 4's IVF-PQ index saved through the port's serializer, with the
   1M rows and the queries, and read by worlds of processes started
   together (``python3 -c``, a coordinator on ``127.0.0.1`` at a free
   port, a join that kills them past its timeout): (a) gloo worlds of 2
   and 4 processes whose shards all sit on ``cuda:0``: ``init_distributed``,
   the comms self test, every verb against numpy, then in every process
   ``sharded_ivf_flat_search`` (``n_probes=20``, the 10,000 queries in
   1,024-row batches), ``sharded_ivf_pq_lists_search`` (2,048 queries) and
   ``sharded_knn`` (1,024 queries over the 1M rows) under ring,
   ``fused_ring`` and gather, and phase 7's scan ring of 80-wide tiles
   (B7), each equal in ids and value bits to the single-process search over
   ``make_mesh(["cuda:0"] * n)``; every process's ``ring_stage`` launches
   (those that fold 80-wide tiles, B7's scan fold, apart) and B5
   ``ring_fold`` launches, each above 0, and its ``ring_onecard`` launches,
   which must be 0 (the process engine: ``ring_onecard`` never runs across
   processes), seconds a batch with the hops' host seconds apart, and each
   B5 fold of one served batch against ``hop_merge_reference`` on the card;
   then in every process the other sharded entry points
   (:func:`entry_cases`, on phase 6's CAGRA index too): the 1M
   ``sharded_ivf_pq_build`` with phase 11's params, full and CA (every
   field's digest equal across processes and to the single-process
   build; build seconds and the host seconds of its exchanges),
   ``sharded_ivf_pq_search`` and ``sharded_cagra_search`` of 4,096
   queries (``init_sample=16384``), phase 11 (f)'s ``tiered_sharded``
   registration served over 2,048 queries under ring, ``fused_ring`` and
   gather, and a ``sharded_ivf_flat`` registration served over 1,024
   queries with shard 1's probe failing in one process only (coverage
   ``1 - 1/n`` and ``failed_shards (1,)`` in every process), each equal in
   ids and value bits to ``make_mesh(["cuda:0"] * n)``, with their
   ``ring_stage`` and B5 launches counted apart (0 ``ring_onecard``);
   (b) NCCL at world size 1: init, the self test, the verbs and
   ``sharded_knn`` against single-device brute force, the build against
   the mesh of one shard and the query-sharded searches against the
   single-device searches; (c) NCCL across cards, one a process, with
   (a)'s checks, when several cards are visible (else a line says it
   waits for such a machine); (d) in the parent, the same entry points on
   ``make_mesh(["cuda:0"] * 4, shape=(2, 2), axis_names=("rows",
   "cols"))`` along ``cols`` (the build CA only), each equal to
   ``make_mesh(["cuda:0"] * 2)``'s, with its ``ring_onecard`` launches
   (one a group a ring).
18. the bench (:func:`bench_phase`, ``raft_tpu_torch.bench``) in a
   temporary directory: (a) ``python -m raft_tpu_torch.bench``'s ``main``
   over the ``smoke`` group on ``smoke-10k``, one algorithm a call, each
   report and CSV held against the grid, B1, B2 and B4 launched under
   IVF-Flat, IVF-PQ and CAGRA; (b) ``run_case`` on the 1M x 128
   ``sift-128-euclidean`` registry set (:data:`BENCH_FULL`), each
   algorithm's first point equal in ids to a direct search of its index,
   the rows and the operating point at recall 0.95; (c) closed- and
   open-loop load (:data:`BENCH_LOAD`) on a ``ServingEngine(max_batch=128)``
   serving (b)'s IVF-Flat index through B1, each request's ids equal to a
   direct search; (d) ``bench.prims.run`` over its eight cases.

Every kernel build starts at once. While the others compile, phase 2 runs
the ring's parts (the ring builds first: B5-B7's checks and timed lines),
then phase 16's card-vs-CPU part (no kernel), then B2's checks, then B1's
and B4's once they are built. Phases 3, 4, 6, 7, 9 and 17, which launch no
B3, run while B3 (the longest build) compiles; phase 2's B3 checks, then
phases 5, 8, 10-16 and 18, follow. Every phase prints its ``phase_s`` and the
caching allocator's state (reserved and allocated GB, ``alloc_retries``).

Phase 2 also holds B5 ``hop_merge`` (rows 32 and 2,560, widths 10, 80 and
256, with ties, signed zeros, padding and ``inf``) against its plain
version, and B6 ``fused_ring_topk`` and B7 ``fused_scan_ring_topk`` (on one
card: one ``ring_onecard`` launch a ring) over virtual meshes of 2, 3, 4
and 8 shards, 1, 37, 128 and 1,024 queries, tiles of 6, 10, 23, 80 and 83
columns, one shard demoted, against the gather merge, the kernel's plain
mirror and the host schedule (the engine of distinct cards) run on the
same mesh: same ids, same value bits. Then it splits a ring call of each
engine and of the gather merge into host and device time
(``ring_host_device``: device operations, host µs, device µs busy,
``cuda_ms``) at 128 queries over four shards, and reads the kernel's
stage clock (``fused_ring_topk_split``).

Each kernel's launch count is zeroed just before its path runs (phases
3-12, 14 and 18) and read just after (phases 13, 15 and 16 launch none). ``--quick`` runs phases 1-2 only; ``--profile``
adds torch.profiler traces of the IVF-Flat, IVF-PQ, CAGRA and sharded
IVF-Flat serving backlogs. ``--phases`` runs only the parts it names
(:func:`run_phases`): ``paths`` times the IVF-Flat search paths per call
(:func:`paths_ms`), ``serve`` phase 3's IVF-Flat serving QPS
(:func:`serve_qps`), ``ring`` phase 2's ring checks and lines, ``b3``
phase 2's B3 checks, ``rabitq`` phase 5, ``b1`` and ``b4`` phase 2's B1
or B4 checks and then that kernel at the main path's shapes on the 1M
index, ``mutable`` phase 8, ``robust`` phase 9 (with ``--tree`` only the
sharded backlog's QPS, :func:`sharded_serve_qps`), ``tiered`` phase 10,
``multi`` phase 11, ``replica`` phase 12, ``prims`` phase 13, ``geo``
phase 14 (after B2, B4 and phase 6's CAGRA build), ``data`` phase 15,
``graph`` phase 16, ``procs`` phase 17 (after the ring and B2 builds and
the 1M IVF-Flat, IVF-PQ and CAGRA indexes), ``bench`` phase 18 (after the
B1, B2 and B4 builds);
with ``--tree`` they import
``raft_tpu_torch`` from that tree (default: this file's directory), so
that two trees unpacked with ``git archive`` can be compared in turns on
one card, old / new / new / old, the lines an older kernel cannot give
skipped.
The last line is ``{"ok": true, "device": {...}}``, after the
``{"kernels": [...]}`` line and the card's name and power limit. Other
numbers print one JSON object per line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# fp32 peak outside the tensor cores and HBM rate of an H100 SXM (NVIDIA data sheet)
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_S = 3.35e12
# FP32 adds a second on an H100 SXM. The 67e12 peak counts an FMA as two
# operations (132 SMs x 128 lanes x 2 x 1.98 GHz); an FADD is one
# instruction a lane, so a sum of looked-up LUT entries (B2) or of masked
# values (B3) runs at half that rate.
H100_FADD_RATE = 33.5e12
# Dense bf16 tensor-core rate of an H100 SXM with an f32 sum (NVIDIA data
# sheet, without sparsity): B3's bit product runs at it.
H100_BF16_FLOPS = 989e12
# Dense TF32 tensor-core rate of an H100 SXM with an f32 sum (NVIDIA data
# sheet, without sparsity): B1's filter product runs at it.
H100_TF32_FLOPS = 494.7e12
# Query tile of the served IVF-Flat index. A 128-row serving batch holds
# unrelated queries, so with the default 128-row tile its probe union
# overflows the tile's table of fused_probe_factor * n_probes / group units
# and each query loses some of its own lists; 16-row tiles keep the union
# inside the table (phase 3 prints recall and time per batch for tiles of
# 128, 32 and 16).
SERVE_QT = 16
# Query tile of the served IVF-PQ index (phase 4's sweep over 128, 32, 16).
SERVE_QT_PQ = 16
# Strided seed rows of the served CAGRA index. The corpus is 4096
# well-separated blobs and the degree-16 graph has few edges between them,
# so a beam finds a query's neighbours only when a seed row lies in the
# query's blob: with the default 4096 seeds about 1 - 1/e of the queries
# (recall@10 0.70), with 16384 about 1 - 1/e^4 (phase 6 prints the sweep).
SERVE_INIT_SAMPLE = 16384


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def emit(card: str, **kv) -> None:
    print(json.dumps(dict(kv, card=card)), flush=True)


def memory() -> dict:
    """The caching allocator's state: GB reserved and allocated, and its
    retries (a ``cudaMalloc`` that failed until the cache was freed)."""
    st = torch.cuda.memory_stats()
    return {"reserved_gb": st.get("reserved_bytes.all.current", 0) / 2 ** 30,
            "allocated_gb": st.get("allocated_bytes.all.current", 0) / 2 ** 30,
            "alloc_retries": st.get("num_alloc_retries", 0)}


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Clustered:
    """SIFT-shaped synthetic vectors: a mixture of ``n_clusters`` Gaussian
    blobs on a ``latent``-dimensional subspace of R^d plus small isotropic
    noise. Descriptor sets such as SIFT have a low intrinsic dimension
    (about 10-20), which is what makes spatially ordered lists and
    probe-coherent query tiles work; isotropic blobs in all 128 dimensions
    have none of that structure."""

    def __init__(self, rng: np.random.Generator, d: int, n_clusters: int, latent: int = 16):
        self.rng = rng
        self.basis = rng.standard_normal((latent, d), dtype=np.float32) / np.float32(np.sqrt(latent))
        self.centers = 4.0 * rng.standard_normal((n_clusters, latent), dtype=np.float32)

    def sample(self, n: int) -> np.ndarray:
        out = np.empty((n, self.basis.shape[1]), np.float32)
        for s in range(0, n, 1 << 18):
            m = min(1 << 18, n - s)
            lab = self.rng.integers(0, self.centers.shape[0], m)
            z = self.centers[lab] + self.rng.standard_normal((m, self.basis.shape[0]), dtype=np.float32)
            out[s : s + m] = z @ self.basis + 0.1 * self.rng.standard_normal(
                (m, self.basis.shape[1]), dtype=np.float32)
        return out


def compare_topk(kv, ks, rv, rs) -> float:
    """Slots equal except at score ties within 1e-6 relative; scores
    allclose(rtol=1e-5, atol=1e-4). Returns the max abs score error."""
    kv, ks, rv, rs = (t.cpu().numpy() for t in (kv, ks, rv, rs))
    fin = np.isfinite(rv)
    if not np.array_equal(fin, np.isfinite(kv)):
        raise AssertionError("kernel and plain version disagree on which entries are empty")
    if not np.allclose(kv[fin], rv[fin], rtol=1e-5, atol=1e-4):
        raise AssertionError(f"scores differ: max abs err {np.abs(kv[fin] - rv[fin]).max()}")
    scale = np.maximum(np.abs(rv).max(axis=1, keepdims=True), 1.0)
    diff = ks != rs
    tie = np.abs(kv - rv) <= 1e-6 * scale
    bad = diff & ~tie
    # a slot that moved by a tie must still be one the reference keeps or ties
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise AssertionError(f"slot mismatch at row {i} col {j}: {ks[i, j]} vs {rs[i, j]} "
                             f"(scores {kv[i, j]} vs {rv[i, j]})")
    if diff.mean() > 0.01:
        raise AssertionError(f"{diff.mean():.4f} of slots differ (ties allowed, but not this many)")
    return float(np.abs(kv[fin] - rv[fin]).max()) if fin.any() else 0.0


def request_sizes(rng, nq: int) -> list:
    """Phase 3's requests: 1-128 rows each until ``nq`` rows."""
    sizes = []
    while sum(sizes) < nq:
        sizes.append(int(min(rng.integers(1, 129), nq - sum(sizes))))
    return sizes


def served(results, n: int):
    """Ids, latencies and latencies per bucket of served requests; fails
    unless every row holds k finite, valid, ascending neighbors."""
    ids = np.concatenate([r.indices for r in results])
    dist = np.concatenate([r.distances for r in results])
    if not (np.isfinite(dist).all() and (ids >= 0).all() and (ids < n).all()
            and (np.diff(dist, axis=1) >= 0).all()):
        raise AssertionError("served results are not k finite, valid, ascending neighbors per query")
    buckets = {}
    for r in results:
        buckets.setdefault(r.bucket, []).append(r.latency_ms)
    return ids, np.array([r.latency_ms for r in results]), buckets


def serve_both_ways(card, eng, index_id, Q, sizes, starts, k, n, gt, kernel, phase,
                    min_recall=0.90, **extra):
    """Serve every request as one client, then as one backlog; gate recall
    (``min_recall``) and the one-client buckets. ``kernel.launches`` is
    zeroed just before each serving run and read just after it. Returns the
    launches of both runs."""
    from raft_tpu_torch.stats.recall import neighborhood_recall

    runs = []
    for name in ("one_client", "backlog"):
        kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "one_client":
            # each request is submitted and served alone, so its bucket is
            # its own size (128 -> fused scan, smaller -> probe path)
            results = []
            for s, m in zip(starts, sizes):
                fut = eng.submit(index_id, Q[s : s + m], k)
                eng.step(force=True)
                results.append(fut.result())
        else:
            # every request queued first, then drained in 128-row micro-batches
            futs = [eng.submit(index_id, Q[s : s + m], k) for s, m in zip(starts, sizes)]
            eng.run_until_idle()
            results = [f.result() for f in futs]
        secs = time.perf_counter() - t0
        runs.append((name, results, secs, kernel.launches))
    total = 0
    for name, results, secs, launches in runs:
        ids, lat, buckets = served(results, n)
        recall = neighborhood_recall(torch.from_numpy(ids), gt)
        by_bucket = {str(b): [len(v), float(np.mean(v))] for b, v in sorted(buckets.items())}
        emit(card, phase=phase, serving=name, metric="serve_qps", value=Q.shape[0] / secs,
             requests=len(sizes), **extra)
        emit(card, phase=phase, serving=name, metric="request_latency_ms",
             p50=float(np.percentile(lat, 50)), p99=float(np.percentile(lat, 99)),
             requests_and_mean_ms_by_bucket=by_bucket)
        emit(card, phase=phase, serving=name, metric="serve_recall@10", value=recall,
             launches=launches)
        if recall < min_recall:
            raise AssertionError(f"{phase} {name} served recall@10 {recall} < {min_recall}")
        if launches <= 0:
            raise AssertionError(f"{phase} {name} serving never launched its kernel")
        if name == "one_client" and not ({"128"} < set(by_bucket)):
            raise AssertionError(f"one-client serving did not run both paths: buckets {sorted(by_bucket)}")
        total += launches
    return total


def profile_backlog(card, eng, index_id, Q, starts, sizes, k, trace, n_req: int = 64,
                    phase: str = "profile") -> float:
    """Device busy share and kernel time by name over a backlog of
    ``n_req`` requests (torch.profiler); the trace goes to chiprun_out/
    unless ``trace`` is None. Returns the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [eng.submit(index_id, Q[s : s + m], k) for s, m in zip(starts[:n_req], sizes[:n_req])]
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for f in futs:
        f.result()
    if trace is not None:
        prof.export_chrome_trace(f"chiprun_out/{trace}")
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    emit(card, phase=phase, index_id=index_id, metric="backlog_device_busy_share",
         value=busy_us / wall_us, wall_ms=wall_us / 1e3, requests=n_req,
         rows=int(sum(sizes[:n_req])),
         kernels_ms={e.key[:80]: [e.count, e.self_device_time_total / 1e3] for e in top})
    return busy_us / wall_us


def bound_ms(flops: float, bytes_: float, rate: float = H100_FP32_FLOPS) -> tuple:
    """The larger of operations over their peak ``rate`` (FP32 by default)
    and bytes over the HBM rate, in ms, and which one it is."""
    t_ops = flops / rate * 1e3
    t_bytes = bytes_ / H100_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _filled_work(tile_probes, probe_valid, filled):
    """(rows scanned summed over tiles, filled rows of the distinct units)
    for the valid probe steps; ``filled [n_units]`` f64."""
    valid = probe_valid > 0
    per_tile = float(filled[tile_probes[valid].to(torch.int64)].sum())
    distinct = float(filled[torch.unique(tile_probes[valid]).to(torch.int64)].sum())
    return per_tile, distinct


def flat_bound_ms(fi, k: int) -> dict:
    """Least time for one fused_list_topk call on these inputs, the larger
    of two: one dense TF32 pass of the ``qt x filled rows x d`` product on
    the tensor cores (2·qt·d operations per filled slot of each tile's
    valid units; empty slots need none), and the filled rows of the
    distinct probed units (their ``d`` elements, norm and id), the
    queries, probe tables and outputs moved once. ``bound_term`` names
    which; ``fp32_bound_ms`` is the same product on the FP32 pipes, the
    form the FMA kernel had; ``reread_ms`` the filled rows summed over the
    tiles at the HBM rate (what the call pays if no tile's rows hit L2)."""
    n_units, gm, d = fi.list_data.shape
    n_qt = fi.tile_probes.shape[0]
    qt = fi.queries_sorted.shape[0] // n_qt
    filled = (fi.list_indices >= 0).sum(dim=1).to(torch.float64)
    rows, distinct = _filled_work(fi.tile_probes, fi.probe_valid, filled)
    item = fi.list_data.element_size()
    flops = 2.0 * qt * d * rows
    terms = {
        "bytes": (distinct * (d * item + 8) + fi.queries_sorted.numel() * 4
                  + fi.tile_probes.numel() * 8 + fi.queries_sorted.shape[0] * k * 8)
        / H100_HBM_BYTES_S * 1e3,
        "tf32_product": flops / H100_TF32_FLOPS * 1e3,
    }
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term], bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, bound_terms_ms=terms,
                fp32_bound_ms=flops / H100_FP32_FLOPS * 1e3,
                reread_ms=rows * (d * item + 8) / H100_HBM_BYTES_S * 1e3)


def pq_bound_ms(a, k: int) -> tuple:
    """Least time for one fused_pq_topk call: one FP32 add per LUT lookup
    (qt x filled rows of each tile's valid units x lookups per row) at the
    FADD rate vs the filled code rows of the distinct units plus 8 B a row
    (ln, id), the LUT, the rotated queries, the tables and the outputs
    moved once."""
    from raft_tpu_torch.ops import pq_scan

    codes, ln, w, q_rot, _, tp, pv = a["args"]
    n_qt = tp.shape[0]
    qt = q_rot.shape[0] // n_qt
    bpr = codes.shape[2]
    n_groups, _ = pq_scan.code_groups(a["code_mode"], a["ksub"], bpr)
    lookups = 2 * bpr if a["code_mode"] in ("nib8", "p4") else n_groups
    filled = torch.isfinite(ln.reshape(codes.shape[0], -1)).sum(dim=1).to(torch.float64)
    rows, distinct = _filled_work(tp, pv, filled)
    return bound_ms(float(qt) * rows * lookups,
                    distinct * (bpr + 8) + w.numel() * 2 + q_rot.numel() * 4 + tp.numel() * 8
                    + q_rot.shape[0] * k * 8, H100_FADD_RATE)


def stage_split(rec, stages, counts=(), slots=None) -> dict:
    """A stage clock record (``csrc/stage_clock.cuh``, int64 ``[CTAs,
    slots + 2 + len(counts)]``, ``slots`` the stage words, ``len(stages)``
    by default) as each stage's share of the warps' cycles (the rest, loop
    control and the final write, as ``other``), the min, median and max of
    the CTAs' own cycles, and each counter's mean over the CTAs."""
    r = rec.cpu().numpy().astype(np.float64)
    n = slots or len(stages)
    share = {name: float(r[:, i].sum() / r[:, n].sum()) for i, name in enumerate(stages)}
    share["other"] = 1.0 - sum(share.values())
    cta = r[:, n + 1]
    return dict(stage_share=share, cta_cycles_min=float(cta.min()),
                cta_cycles_median=float(np.median(cta)), cta_cycles_max=float(cta.max()),
                ctas=int(r.shape[0]),
                per_cta_mean={name: float(r[:, n + 2 + i].mean()) for i, name in enumerate(counts)})


def rabitq_bound_ms(a, k: int) -> dict:
    """Least time for one fused_rabitq_topk call on these inputs, the
    largest of three: the filled code rows of the distinct units plus 12 B
    a row (ln, g, id), the rotated queries, the tables and the outputs
    moved once; one dense bf16 pass of the ``qt x filled rows x D`` bit
    product on the tensor cores; the estimator's 4 FP32 operations per
    (query, filled row) at the FADD rate. ``bound_by`` is ``bytes`` or
    ``operations``, ``bound_term`` which of the three binds, and
    ``fadd_bound_ms`` the masked-add form's figure (one FP32 add per
    (query, row, dimension))."""
    codes, ln, _, q_rot, _, tp, pv = a["args"]
    n_qt = tp.shape[0]
    qt = q_rot.shape[0] // n_qt
    bpr = codes.shape[2]
    filled = torch.isfinite(ln.reshape(codes.shape[0], -1)).sum(dim=1).to(torch.float64)
    rows, distinct = _filled_work(tp, pv, filled)
    terms = {
        "bytes": (distinct * (bpr + 12) + q_rot.numel() * 4 + tp.numel() * 8
                  + q_rot.shape[0] * k * 8) / H100_HBM_BYTES_S * 1e3,
        "bf16_product": 2.0 * qt * rows * 8 * bpr / H100_BF16_FLOPS * 1e3,
        "estimator": 4.0 * qt * rows / H100_FADD_RATE * 1e3,
    }
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term], bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term, bound_terms_ms=terms,
                fadd_bound_ms=float(qt) * rows * 8 * bpr / H100_FADD_RATE * 1e3)


#: queries a phase 2 B3 shape searches, by dimension
B3_CHECK_QUERIES = {128: 256, 136: 256, 1544: 128, 3072: 512}


def rabitq_checks(card, seed: int, index, Q_mid, max_err, this_tree: bool = True) -> None:
    """Phase 2's B3 checks: on ``index`` (d = 128), on a second RaBitQ
    index at d = 136 (17 code bytes a row, the last k-step of the bit
    product half padding), on a third at d = 1,544 (past the layout that
    holds the queries and a chunk whole: the depth-sliced instantiation,
    layout mode 1, its last slice half padding) and on a fourth of 16,384
    rows at d = 3,072 (mode 2 at k = 80: code rows read from global memory;
    mode 1 at k = 10): at d = 128 and 136 tiles of 128, 32, 16 and 8
    queries (64, 32, 16 and 8 queries a CTA), with and without a filter
    bitset (70 % of the ids kept), L2 and IP, k = 10 and 80, and k = 256 at
    d = 136 with tiles of 128 and 8; at d = 1,544 the same tiles at k = 10
    and 80 (L2 unfiltered and IP filtered) and one at k = 256; at d = 3,072
    tiles of 128 at k = 80 (L2) and 10 (IP, filtered). Each with one CTA
    per tile share and with the default split: every result equal to the
    plain version's bit for bit (``rabitq_equal``). Then, per shape, one
    launch that re-scores every candidate exactly
    (``fused_rabitq_topk_filter`` line: the lower bound's violations,
    asserted 0, survivors and the share re-scored), and B3 at d = 1,544 and
    3,072, 128-query tiles and k = 80 timed beside its plain version and
    its bound (``fused_rabitq_topk_sliced_ms``). The shapes search the
    first :data:`B3_CHECK_QUERIES` queries of their dimension's 512 (the
    plain version's cost grows with the tiles times the dimensions). The
    other indexes and the filters draw from their own seeds, so the later
    phases see the data and indexes they saw before. ``this_tree``: False for an older tree's
    package, whose kernel has no checking launch and no CTA plan."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_pq

    rng = np.random.default_rng([seed, 8])
    l2, ip = "L2Expanded", "InnerProduct"
    shapes = [(dim, qt, filtered, metric, k) for dim in (128, 136) for qt in (128, 32, 16, 8)
              for filtered in (False, True) for metric in (l2, ip) for k in (10, 80)]
    shapes += [(136, qt, False, l2, 256) for qt in (128, 8)]
    shapes += [(1544, qt, filtered, metric, k) for qt in (128, 32, 16, 8)
               for filtered, metric in ((False, l2), (True, ip)) for k in (10, 80)]
    shapes += [(1544, 128, False, ip, 256), (3072, 128, False, l2, 80), (3072, 128, True, ip, 10)]
    t0 = time.perf_counter()
    indexes = {128: (index, Q_mid[:B3_CHECK_QUERIES[128]])}
    for dim, rows in ((136, 65536), (1544, 65536), (3072, 16384)):
        gen = Clustered(np.random.default_rng([seed, 8, dim]), dim, 512)
        indexes[dim] = (ivf_pq.build(gen.sample(rows), ivf_pq.IvfPqIndexParams(n_lists=64, pq_bits=1),
                                     res=Resources(device="cuda", seed=seed)),
                        torch.from_numpy(gen.sample(512)[:B3_CHECK_QUERIES[dim]]).cuda())
    bits = {}
    for dim, (idx, _) in indexes.items():
        keep = np.packbits(rng.random(-(-idx.size // 32) * 32) < 0.7, bitorder="little")
        bits[dim] = torch.from_numpy(keep.view(np.int32).copy()).cuda()
    split = {"index_builds": time.perf_counter() - t0}
    for dim, qt, filtered, metric, k in shapes:
        t0 = time.perf_counter()
        idx, Qs = indexes[dim]
        params = ivf_pq.IvfPqSearchParams(n_probes=8, fused_qt=qt)
        a = rabitq_args(idx, Qs, params, ivf_pq.DistanceType[metric],
                        bits[dim] if filtered else None)
        tags = dict(d=dim, fused_qt=qt, filtered=filtered, distance=metric, k=k)
        rv, rs = run_rabitq(a, k, reference=True)
        for n_split in (1, None):
            kv, ks = run_rabitq(a, k, n_split=n_split)
            torch.cuda.synchronize()
            err = rabitq_equal(f"{tags} n_split {n_split}", kv, ks, rv, rs)
            max_err["fused_rabitq_topk"] = max(max_err["fused_rabitq_topk"], err)
            emit(card, phase="kernel_vs_plain", kernel="fused_rabitq_topk",
                 n_split=n_split or "auto", max_abs_err=err, **tags,
                 **(rabitq_plan(a, k) if this_tree else {}))
        if this_tree:
            rabitq_filter_line(card, "kernel_vs_plain", a, rv, rs, **tags)
        if dim > 1000 and (qt, filtered, k) == (128, False, 80):
            emit(card, phase="kernel_vs_plain", metric="fused_rabitq_topk_sliced_ms", **tags,
                 ms=cuda_ms(lambda: run_rabitq(a, k), reps=5),
                 plain_ms=cuda_ms(lambda: run_rabitq(a, k, reference=True), reps=1),
                 **rabitq_bound_ms(a, k), **(rabitq_plan(a, k) if this_tree else {}))
            if this_tree:
                rabitq_split_line(card, "kernel_vs_plain", a, **tags)
        split[f"d{dim}"] = split.get(f"d{dim}", 0.0) + time.perf_counter() - t0
    emit(card, phase="kernel_vs_plain", metric="fused_rabitq_topk_checks_s", value=split,
         shapes=len(shapes), queries=B3_CHECK_QUERIES)
    del indexes


def rabitq_split_line(card, phase: str, a, **tags) -> None:
    """One launch of B3 with its stage clock on: the
    ``fused_rabitq_topk_split`` line (each stage's share of the warps'
    cycles, the CTAs' cycles, survivors and merges a CTA)."""
    from raft_tpu_torch.ops import rabitq_scan

    rec = rabitq_scan.fused_rabitq_topk_stages(*a["args"], k=tags["k"], metric=a["metric"],
                                               qt=a["qt"])
    emit(card, phase=phase, metric="fused_rabitq_topk_split",
         **stage_split(rec, rabitq_scan.STAGES, rabitq_scan.COUNTS), **tags)


def rabitq_filter_line(card, phase: str, a, rv, rs, **tags) -> None:
    """One launch of B3's checking instantiation, which re-scores every
    candidate exactly: its result equal to the plain version's, and the
    ``fused_rabitq_topk_filter`` line (violations of the lower bound,
    asserted 0; survivors of the filter per query and tile; the share of
    the candidates re-scored)."""
    from raft_tpu_torch.ops import rabitq_scan

    kv, ks, counts = rabitq_scan.fused_rabitq_topk_check(*a["args"], k=tags["k"],
                                                         metric=a["metric"], qt=a["qt"])
    rabitq_equal(f"checking launch {tags}", kv, ks, rv, rs)
    n_qt = a["args"][5].shape[0]
    emit(card, phase=phase, metric="fused_rabitq_topk_filter", violations=counts["violations"],
         survivors_per_query_tile=counts["survivors"] / (n_qt * a["qt"]),
         rescored_share=counts["survivors"] / max(1, counts["candidates"]),
         candidates=counts["candidates"], **tags)
    if counts["violations"] != 0:
        raise AssertionError(f"B3's filter bound failed {counts['violations']} times at {tags}")


def ids_digest(ids) -> str:
    """A short digest of an id tensor, to compare two trees' results."""
    return hashlib.sha1(ids.cpu().numpy().astype(np.int32).tobytes()).hexdigest()[:16]


def rabitq_phase(card, res, X, X_card, Qt, gt_i, k: int, kk: int, max_err,
                 this_tree: bool = True) -> tuple:
    """Phase 5: a 1M RaBitQ index (``pq_bits=1``), ``search(mode="auto")``
    of every query with ``dataset=`` (8x refine), recall with and without
    refine (and the ids' digests, to compare trees), then B3 at that
    path's shape (one 1,024-query batch, ``kk`` = 80) against its plain
    version and its bound, its CTA plan, stage split and filter check
    (not for an older tree's package: ``this_tree`` False).
    ``fused_rabitq_topk.launches`` is zeroed just before the search and
    read just after. Returns ``(launches, B3's times, the index)``."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import rabitq_scan
    from raft_tpu_torch.stats.recall import neighborhood_recall

    nq = Qt.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rq_index = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024, pq_bits=1), res=res)
    torch.cuda.synchronize()
    emit(card, phase="rabitq", metric="build_s", value=time.perf_counter() - t0,
         max_list=rq_index.max_list, code_bytes_per_row=int(rq_index.codes.shape[2]))
    rq_params = ivf_pq.IvfPqSearchParams()
    rabitq_scan.fused_rabitq_topk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, r_ids = ivf_pq.search(rq_index, Qt, k, rq_params, mode="auto", dataset=X_card)
    torch.cuda.synchronize()
    rq_secs = time.perf_counter() - t0
    rq_launches = rabitq_scan.fused_rabitq_topk.launches
    rq_recall = neighborhood_recall(r_ids, gt_i)
    _, r_nr = ivf_pq.search(rq_index, Qt, k, dataclasses.replace(rq_params, refine_ratio=1),
                            mode="fused")
    emit(card, phase="rabitq", metric="search_recall@10", value=rq_recall,
         recall_no_refine=neighborhood_recall(r_nr, gt_i), qps=nq / rq_secs,
         launches=rq_launches, n_probes=rq_params.n_probes, refine_ratio=rq_params.refine_ratio,
         ids_digest=ids_digest(r_ids), ids_no_refine_digest=ids_digest(r_nr))
    if rq_launches <= 0:
        raise AssertionError("RaBitQ search(mode='auto') never launched fused_rabitq_topk")
    if rq_recall < 0.90:
        raise AssertionError(f"RaBitQ recall@10 with refine {rq_recall} < 0.90")
    # B3 at that path's shapes: one 1,024-query batch, k * refine_ratio = 80
    a = rabitq_args(rq_index, Qt[:1024], rq_params)
    kv, ks = run_rabitq(a, kk)
    rv, rs = run_rabitq(a, kk, reference=True)
    max_err["fused_rabitq_topk"] = max(max_err["fused_rabitq_topk"],
                                       rabitq_equal("phase 5 batch", kv, ks, rv, rs))
    b3 = time_kernel(run_rabitq, a, kk, reps=10)
    bound = rabitq_bound_ms(a, kk)
    b3.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
    emit(card, phase="rabitq", metric="fused_rabitq_topk_ms_1024_query_batch", value=b3["ms"],
         plain_ms=b3["plain_ms"], n_split_ms=b3["n_split_ms"], k=kk,
         n_qt=int(a["args"][5].shape[0]), valid_units=int((a["args"][6] > 0).sum()),
         unit_rows=int(a["args"][0].shape[1]), **bound,
         **(rabitq_plan(a, kk) if this_tree else {}))
    if this_tree:
        # where B3's cycles go at that shape: one launch with the stage clock on
        rabitq_split_line(card, "rabitq", a, k=kk, queries=1024)
        rabitq_filter_line(card, "rabitq", a, rv, rs, k=kk, queries=1024)
    return rq_launches, b3, rq_index


def rabitq_plan(a, k: int) -> dict:
    """B3's CTA plan at these inputs and the grid of its last launch."""
    from raft_tpu_torch.ops import rabitq_scan

    _, _, _, q_rot, crot, tp, _ = a["args"]
    plan = rabitq_scan.cta_plan(q_rot.shape[1], k, crot.shape[1], a["qt"])
    return dict(queries_per_cta=plan.queries, rows_per_chunk=plan.rows, layout_mode=plan.mode,
                smem_bytes=plan.smem_bytes, ctas_per_sm=plan.ctas_per_sm,
                grid=list(rabitq_scan.fused_rabitq_topk.last_grid))


def rabitq_equal(what: str, kv, ks, rv, rs) -> float:
    """B3 against its plain version: ``compare_topk``, then the same
    values and slots bit for bit (``torch.equal``)."""
    err = compare_topk(kv, ks, rv, rs)
    if not (torch.equal(kv.view(torch.int32), rv.view(torch.int32)) and torch.equal(ks, rs)):
        raise AssertionError(f"B3 {what}: values or slots differ from the plain version's "
                             f"({int((ks != rs).sum())} slots, max abs err {err})")
    return err


def topk_digest(vals, slots) -> str:
    """A short digest of a top-k result's value bits and slots, to compare
    two trees' kernels."""
    h = hashlib.sha1(vals.contiguous().view(torch.int32).cpu().numpy().tobytes())
    h.update(slots.to(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def flat_split_line(card, phase: str, fi, metric, k: int, **tags) -> None:
    """One launch of B1 with its stage clock on: the
    ``fused_list_topk_split`` line (each stage's share of the warps'
    cycles, the CTAs' cycles, chunks and candidates a CTA; ``filled_pairs``
    the (query, filled row) pairs the call scores, from the tables)."""
    from raft_tpu_torch.ops import ivf_scan

    qt = fi.queries_sorted.shape[0] // fi.tile_probes.shape[0]
    rec = ivf_scan.fused_list_topk_stages(
        fi.list_data, fi.list_norms, fi.list_indices, fi.queries_sorted, fi.tile_probes,
        fi.probe_valid, k=k, metric=metric, qt=qt)
    rows, _ = _filled_work(fi.tile_probes, fi.probe_valid,
                           (fi.list_indices >= 0).sum(dim=1).to(torch.float64))
    emit(card, phase=phase, metric="fused_list_topk_split", k=k, filled_pairs=qt * rows,
         **stage_split(rec, ivf_scan.STAGES, ivf_scan.COUNTS), **tags)


def call_ops_line(card, phase: str, run, reps: int = 10,
                  metric: str = "fused_list_topk_call_ops", **tags) -> int:
    """One call's device operations (torch.profiler over ``reps`` calls):
    device µs a call by operation and in all, and the host µs a call takes
    to return (enqueue only, the card idle before it; median); the
    ``metric`` line. One call runs under PyTorch's sync debug mode, which
    warns where the call waits on the card: the line counts the warnings
    (``sync_warnings``, also returned) and quotes the first."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")  # a call that waits on the card says so
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    emit(card, phase=phase, metric=metric, reps=reps,
         device_us_per_call=sum(e.self_device_time_total for e in dev) / reps,
         device_ops_per_call=sum(e.count for e in dev) / reps,
         host_us_per_call=float(np.median(host)) * 1e6,
         ops={e.key[:70]: [e.count / reps, e.self_device_time_total / reps] for e in dev[:12]},
         sync_warnings=len(syncs), first_sync_warning=syncs[0][:200] if syncs else None, **tags)
    return len(syncs)


def flat_filter_line(card, phase: str, fi, metric, k: int, kv, ks, **tags) -> None:
    """One launch of B1's checking instantiation, whose filter lets every
    filled row through and which computes every exact score beside its
    lower bound: its result ``torch.equal`` to the filtered launch's
    (``kv``, ``ks``), and the ``fused_list_topk_filter`` line (violations
    of the lower bound, asserted 0; survivors of the filter a query next to
    the chunks a tile scans; the share of the pairs re-scored), with the
    CTA plan and grid."""
    from raft_tpu_torch.ops import ivf_scan

    qt = fi.queries_sorted.shape[0] // fi.tile_probes.shape[0]
    cv, cs, counts = ivf_scan.fused_list_topk_check(
        fi.list_data, fi.list_norms, fi.list_indices, fi.queries_sorted, fi.tile_probes,
        fi.probe_valid, k=k, metric=metric, qt=qt)
    if not (torch.equal(cv.view(torch.int32), kv.view(torch.int32)) and torch.equal(cs, ks)):
        raise AssertionError(f"B1 at {tags}: the filtered launch differs from the checking one "
                             f"({int((cs != ks).sum())} slots)")
    _, n_work = ivf_scan.work_list(fi.tile_probes, fi.probe_valid,
                                   ivf_scan.chunk_table(fi.list_indices))
    plan, tiles = ivf_scan.launch_plan(fi.list_data.shape[2], k, fi.list_data.element_size(), qt,
                                       fi.tile_probes.shape[0],
                                       metric == ivf_scan.DistanceType.CosineExpanded)
    n_qt = fi.tile_probes.shape[0]
    emit(card, phase=phase, metric="fused_list_topk_filter", violations=counts["violations"],
         survivors_per_query=counts["survivors"] / (n_qt * qt),
         chunks_per_tile=float(n_work.to(torch.float64).mean()),
         rescored_share=counts["survivors"] / max(1, counts["pairs"]), pairs=counts["pairs"],
         queries_per_cta=plan.queries, tiles_per_cta=tiles, qglobal=plan.qglobal,
         smem_bytes=plan.smem_bytes, grid=list(ivf_scan.fused_list_topk.last_grid), k=k, **tags)
    if counts["violations"] != 0:
        raise AssertionError(f"B1's filter bound failed {counts['violations']} times at {tags}")


def flat_checks(card, seed: int, res, X_mid, Q_mid, max_err, this_tree: bool = True) -> None:
    """Phase 2's B1 checks, each against its plain version (``compare_topk``)
    with one CTA per tile share and with the default split: IVF-Flat
    indexes of 65,536 rows (64 lists, ``n_probes=8``, 512 queries) at d =
    128 for the four metrics and int8 and bf16 lists at k = 10 and 100
    (128-query tiles), with k = 256 and tiles of 16 and 24 queries; at d =
    100 (not a multiple of the product's k-step; f32 under L2, IP and
    cosine, bf16 and uint8 lists) and d = 960 (several 128-wide depth
    slices; two staged a block) with a filter bitset (70 % of the ids
    kept), tiles of 128, 24 and 16 queries, k = 10, 100 and 256; and on
    16,384 rows at d = 3,072 (the queries read through the caches). Each
    line carries a digest of the values and slots, to hold two trees'
    kernels to the same bits. Per
    shape one launch of the checking build, equal to the filtered one with
    no violation of the filter's bound (:func:`flat_filter_line`; this tree
    only). B1 at d = 960 (128-query tiles, k = 10, no filter) is timed
    beside its plain version (``fused_list_topk_ms_d960``) with its stage
    split. The other data and filters draw from
    their own seeds and build with their own ``Resources`` (whose generator
    the d = 128 builds share with the later phases, as before), so the
    later phases see the data and indexes they saw before."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_flat

    rng = np.random.default_rng([seed, 9])
    own_res = Resources(device="cuda", seed=seed)
    data = {(128, "float32"): X_mid,
            (128, "int8"): np.clip(np.round(X_mid * 12), -127, 127).astype(np.int8),
            (128, "bfloat16"): torch.from_numpy(X_mid).to(torch.bfloat16)}
    queries = {128: Q_mid}
    for dim in (100, 960, 3072):
        gen = Clustered(np.random.default_rng([seed, 9, dim]), dim, 512)
        x = gen.sample(16384 if dim == 3072 else 65536)
        queries[dim] = torch.from_numpy(gen.sample(512)).cuda()
        data[(dim, "float32")] = x
        if dim == 100:
            data[(dim, "bfloat16")] = torch.from_numpy(x).to(torch.bfloat16)
            data[(dim, "uint8")] = np.clip(np.round(x * 12) + 128, 0, 255).astype(np.uint8)
    l2, ip, cos = "sqeuclidean", "inner_product", "cosine"
    # (d, dtype, metric, fused_qt, filtered, k)
    shapes = [(128, "float32", m, 128, False, k) for m in (l2, "euclidean", ip, cos)
              for k in (10, 100)]
    shapes += [(128, dt, l2, 128, False, k) for dt in ("int8", "bfloat16") for k in (10, 100)]
    shapes += [(128, "float32", l2, 128, False, 256), (128, "float32", l2, 16, False, 256),
               (128, "float32", l2, 16, True, 10), (128, "float32", l2, 24, True, 10),
               (128, "float32", ip, 24, True, 100)]
    shapes += [(100, "float32", l2, 128, True, 10), (100, "float32", ip, 24, True, 100),
               (100, "float32", cos, 16, True, 10), (100, "bfloat16", l2, 128, True, 10),
               (100, "uint8", l2, 24, True, 256)]
    shapes += [(960, "float32", l2, 128, False, 10), (960, "float32", l2, 128, True, 10),
               (960, "float32", ip, 16, True, 100), (960, "float32", l2, 24, True, 256)]
    shapes += [(3072, "float32", l2, 128, False, 10)]
    indexes = {}
    for dim, dtype, metric, qt, filtered, k in shapes:
        key = (dim, dtype, metric)
        if key not in indexes:
            indexes[key] = ivf_flat.build(data[(dim, dtype)],
                                          ivf_flat.IvfFlatIndexParams(n_lists=64, metric=metric),
                                          res=res if dim == 128 else own_res)
        index = indexes[key]
        bits = None
        if filtered:
            keep = np.packbits(rng.random(-(-index.size // 32) * 32) < 0.7, bitorder="little")
            bits = torch.from_numpy(keep.view(np.int32).copy()).cuda()
        params = dataclasses.replace(ivf_flat.IvfFlatSearchParams(n_probes=8), fused_qt=qt)
        fi = flat_args(index, queries[dim], params, bits)
        tags = dict(d=dim, dtype=dtype, fused_qt=qt, filtered=filtered, k=k)
        run = lambda a, kk, **kw: run_flat(a, kk, index.metric, **kw)
        rv, rs = run(fi, k, reference=True)
        for n_split in (1, None):  # one CTA per tile share, and the default split
            kv, ks = run(fi, k, n_split=n_split)
            torch.cuda.synchronize()
            err = compare_topk(kv, ks, rv, rs)
            max_err["fused_list_topk"] = max(max_err["fused_list_topk"], err)
            emit(card, phase="kernel_vs_plain", kernel="fused_list_topk", metric=metric, k=k,
                 n_split=n_split or "auto", max_abs_err=err, digest=topk_digest(kv, ks),
                 **{x: v for x, v in tags.items() if x != "k"})
        if this_tree:
            flat_filter_line(card, "kernel_vs_plain", fi, index.metric, k, kv, ks, distance=metric,
                             **{x: v for x, v in tags.items() if x != "k"})
        if dim == 960 and (qt, filtered, k) == (128, False, 10):
            emit(card, phase="kernel_vs_plain", metric="fused_list_topk_ms_d960", **tags,
                 distance=metric, ms=cuda_ms(lambda: run(fi, k), reps=5),
                 plain_ms=cuda_ms(lambda: run(fi, k, reference=True), reps=1),
                 **flat_bound_ms(fi, k))
            if this_tree:
                flat_split_line(card, "kernel_vs_plain", fi, index.metric, k,
                                **{x: v for x, v in tags.items() if x != "k"})
    del indexes


def b1_main(card, index, Qt, params, k: int, max_err, this_tree: bool = True,
            phase: str = "main") -> dict:
    """B1 at the main path's shapes on the 1M index: one 128-row serving
    batch at ``fused_qt=SERVE_QT``, and the 10,000-query batch at
    ``params.fused_qt`` (79 sorted 128-query tiles). Each against its plain
    version (``compare_topk``), timed beside its bounds
    (:func:`flat_bound_ms`), with a digest of its values and slots (to
    compare trees) and its stage split (this tree only). Returns the
    serving batch's times and bounds."""
    serve_params = dataclasses.replace(params, fused_qt=SERVE_QT)
    run_b1 = lambda a, kk, **kw: run_flat(a, kk, index.metric, **kw)
    fi = flat_args(index, Qt[:128], serve_params)
    kv, ks = run_b1(fi, k)
    rv, rs = run_b1(fi, k, reference=True)
    max_err["fused_list_topk"] = max(max_err["fused_list_topk"], compare_topk(kv, ks, rv, rs))
    b1 = time_kernel(run_b1, fi, k, reps=20)
    b1.update(flat_bound_ms(fi, k))
    emit(card, phase=phase, metric="fused_list_topk_ms_serving_batch", value=b1["ms"],
         **{x: v for x, v in b1.items() if x != "ms"}, fused_qt=SERVE_QT,
         n_qt=int(fi.tile_probes.shape[0]), valid_units=int((fi.probe_valid > 0).sum()),
         unit_rows=int(fi.list_data.shape[1]),
         filled_slot_share=float((fi.list_indices >= 0).to(torch.float32).mean()),
         digest=topk_digest(kv, ks))
    if this_tree:
        flat_split_line(card, phase, fi, index.metric, k, queries=128, fused_qt=SERVE_QT)
        flat_filter_line(card, phase, fi, index.metric, k, kv, ks, queries=128, fused_qt=SERVE_QT)
    call_ops_line(card, phase, lambda: run_b1(fi, k), queries=128, fused_qt=SERVE_QT)
    # and at the 10,000-query batch's shapes (79 sorted 128-query tiles)
    fi_all = flat_args(index, Qt, params)
    n_qt = fi_all.tile_probes.shape[0]
    kv, ks = run_b1(fi_all, k)
    rv, rs = run_b1(fi_all, k, reference=True)
    max_err["fused_list_topk"] = max(max_err["fused_list_topk"], compare_topk(kv, ks, rv, rs))
    bound = flat_bound_ms(fi_all, k)
    emit(card, phase=phase, metric="fused_list_topk_ms_per_tile_10k_batch",
         value=cuda_ms(lambda: run_b1(fi_all, k), reps=3) / n_qt,
         **{x: (v / n_qt if x.endswith("_ms") else v) for x, v in bound.items()
            if x != "bound_terms_ms"},
         n_qt=n_qt, fused_qt=params.fused_qt,
         valid_units_per_tile=float((fi_all.probe_valid > 0).sum()) / n_qt,
         digest=topk_digest(kv, ks))
    if this_tree:
        flat_split_line(card, phase, fi_all, index.metric, k, queries=Qt.shape[0],
                        fused_qt=params.fused_qt)
        flat_filter_line(card, phase, fi_all, index.metric, k, kv, ks, queries=Qt.shape[0],
                         fused_qt=params.fused_qt)
    return b1


def flat_args(index, queries, params, filter_bits=None):
    """B1's inputs on the search path's shapes (``filter_bits``: an int32
    bitset over the index's ids, folded into the list ids as the search
    does)."""
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import ivf_scan

    return ivf_scan.fused_search_inputs(
        index.centers, index.center_rank, index.list_data, index.list_indices,
        index.list_norms, queries, filter_bits, n_probes=params.n_probes, metric=index.metric,
        qt=params.fused_qt, probe_factor=params.fused_probe_factor,
        group=ivf_flat.fused_group(index, params),
    )


def run_flat(fi, k, metric, reference=False, **kw):
    from raft_tpu_torch.ops import ivf_scan

    fn = ivf_scan.fused_list_topk_reference if reference else ivf_scan.fused_list_topk
    qt = fi.queries_sorted.shape[0] // fi.tile_probes.shape[0]
    return fn(fi.list_data, fi.list_norms, fi.list_indices, fi.queries_sorted,
              fi.tile_probes, fi.probe_valid, k=k, metric=metric, qt=qt, **kw)


def code_inputs(index, queries, params, metric, codes, filter_bits=None):
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import pq_scan

    rank, group = ivf_pq.fused_rank_group(index, params)
    return pq_scan.code_scan_inputs(
        index.centers, index.centers_rot, rank, index.rotation, codes, index.list_indices,
        queries, filter_bits, n_probes=min(params.n_probes, index.n_lists), metric=metric,
        qt=params.fused_qt, probe_factor=params.fused_probe_factor, group=group,
    )


def pq_args(index, queries, params, metric=None, as_u8=False):
    """B2's inputs on the search path's shapes (``as_u8``: the codes
    unpacked to one byte each and read in u8 mode)."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import pq_scan

    metric = metric or index.metric
    ci = code_inputs(index, queries, params, metric, index.codes_unpacked() if as_u8 else index.codes)
    code_mode, ksub = ("u8", index.ksub) if as_u8 else ivf_pq.fused_code_layout(index)
    books = ivf_pq.nibble_books(index.pq_centers) if index.additive else index.pq_centers
    return dict(args=(ci.codes, pq_scan.pq_epilogue(ci.valid, index.rot_sqnorms, metric),
                      pq_scan.pq_lut(ci.q_rot, books), ci.q_rot, ci.centers_rot,
                      ci.tile_probes, ci.probe_valid),
                metric=metric, qt=params.fused_qt, code_mode=code_mode, ksub=ksub)


def run_pq(a, k, reference=False, **kw):
    from raft_tpu_torch.ops import pq_scan

    fn = pq_scan.fused_pq_topk_reference if reference else pq_scan.fused_pq_topk
    return fn(*a["args"], k=k, metric=a["metric"], qt=a["qt"], code_mode=a["code_mode"],
              ksub=a["ksub"], **kw)


def rabitq_args(index, queries, params, metric=None, filter_bits=None):
    """B3's inputs on the search path's shapes (``filter_bits``: an int32
    bitset over the index's ids, folded into ``ln`` as the search does)."""
    from raft_tpu_torch.ops import rabitq_scan

    metric = metric or index.metric
    ci = code_inputs(index, queries, params, metric, index.codes, filter_bits)
    ln, corr = rabitq_scan.rabitq_channels(ci.valid, index.rot_sqnorms, index.corrections)
    return dict(args=(ci.codes, ln, corr, ci.q_rot, ci.centers_rot, ci.tile_probes, ci.probe_valid),
                metric=metric, qt=params.fused_qt)


def run_rabitq(a, k, reference=False, **kw):
    from raft_tpu_torch.ops import rabitq_scan

    fn = rabitq_scan.fused_rabitq_topk_reference if reference else rabitq_scan.fused_rabitq_topk
    return fn(*a["args"], k=k, metric=a["metric"], qt=a["qt"], **kw)


def time_kernel(run, a, k, reps: int) -> dict:
    """Kernel ms, plain ms (one rep) and n_split 1 against the default
    split in turns, on the same inputs."""
    split_ms = {"1": [], "auto": []}
    for n_split in (1, None, None, 1):
        split_ms[str(n_split or "auto")].append(cuda_ms(lambda: run(a, k, n_split=n_split), reps=3))
    return dict(ms=cuda_ms(lambda: run(a, k), reps=reps),
                plain_ms=cuda_ms(lambda: run(a, k, reference=True), reps=1), n_split_ms=split_ms)


def b4_args(index, queries, itopk: int, width: int, ip: bool, table_dtype: str, k: int = 10,
            init_sample: int = 4096):
    """B4's inputs as the fused search makes them: the neighbour table, the
    graph and the strided seed beam in the kernel's min-ordered form."""
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops.cagra_search import WORST

    sp = cagra.CagraSearchParams(itopk_size=itopk, search_width=width, init_sample=init_sample)
    _, _, iters, _ = cagra.derive_search_config(sp, k, index.size)
    qf = queries.to(torch.float32)
    seed = cagra.strided_seed_ids(index.size, sp.init_sample, qf.device)
    rows = seed.to(torch.int64)
    v0, i0 = cagra._seed_select(qf, torch.sum(qf * qf, dim=1), index.dataset[rows].to(torch.float32),
                                index.sqnorms[rows], seed, itopk=itopk, select_min=not ip,
                                worst=float("-inf") if ip else float("inf"))
    kv0 = torch.where(i0 < 0, WORST, -v0 if ip else v0)
    kidf0 = torch.where(i0 < 0, -1, i0 * 2).to(torch.int32)
    return dict(args=(cagra._fused_table(index, table_dtype), index.graph, qf, kv0, kidf0),
                kw=dict(itopk=itopk, width=width, iters=iters, ip=ip))


def run_b4(a, reference=False, work=None):
    from raft_tpu_torch.ops import cagra_search

    if reference:
        return cagra_search.cagra_beam_reference(*a["args"], **a["kw"], work=work)
    return cagra_search.cagra_fused_search(*a["args"], **a["kw"])


def compare_beam(kv, ki, rv, ri) -> float:
    """B4 against its plain version: the same ids and visited flags in every
    slot, and the values' max abs error (both add in one order: 0.0)."""
    if not torch.equal(ki, ri):
        bad = (ki != ri).nonzero()[0].tolist()
        raise AssertionError(f"B4 beam ids differ from the plain version's ({(ki != ri).sum()} "
                             f"slots), first at {bad}: {ki[bad[0]].tolist()} vs {ri[bad[0]].tolist()}")
    err = float((kv - rv).abs().max())
    if err != 0.0:
        raise AssertionError(f"B4 beam values differ from the plain version's: max abs err {err}")
    return err


def b4_bound_ms(a, work) -> tuple:
    """Least time for one B4 call on these inputs: the table rows it scores
    (``work["rows"]``, d elements each) and the graph ids of its valid
    parents (``work["ids"]``, 4 B each), the queries and the seed and final
    beams moved once, against 3 FP32 operations per scored element."""
    table, _, qf, kv0, _ = a["args"]
    d = qf.shape[1]
    beams = 2 * kv0.numel() * 8
    return bound_ms(3.0 * work["rows"] * d,
                    work["rows"] * d * table.element_size() + work["ids"] * 4 + qf.numel() * 4 + beams)


def b4_check(card, cg, queries, itopk: int, width: int, ip: bool, table_dtype: str, max_err,
             this_tree: bool = True, **tags) -> None:
    """B4 at one shape against its plain version (:func:`compare_beam`), with
    a digest of the beam's value bits and ids (to hold two trees' kernels
    to the same bits), and, for this tree's kernel, the plan it took."""
    from raft_tpu_torch.ops import cagra_search

    a = b4_args(cg, queries, itopk, width, ip, table_dtype)
    rv, ri = run_b4(a, reference=True)
    kv, ki = run_b4(a)
    torch.cuda.synchronize()
    err = compare_beam(kv, ki, rv, ri)
    max_err["cagra_fused_search"] = max(max_err["cagra_fused_search"], err)
    emit(card, phase="kernel_vs_plain", kernel="cagra_fused_search", graph_degree=cg.graph_degree,
         d=cg.dim, metric="InnerProduct" if ip else "L2Expanded", table=table_dtype,
         itopk=itopk, width=width, iters=a["kw"]["iters"], queries=queries.shape[0],
         max_abs_err=err, live_slots=float((ki >= 0).to(torch.float32).mean()),
         digest=topk_digest(kv, ki),
         plan=dataclasses.asdict(cagra_search.cagra_fused_search.last_plan) if this_tree else None,
         **tags)
    return a, rv, ri


def b4_plan_times(card, phase: str, a, rv, ri, plans, reps: int = 10, **tags) -> None:
    """B4 launched with each of ``plans`` (``(group_rows, buffers,
    bitonic)``; this tree's kernel) on the inputs ``a``: each bit-equal to
    the plain version's beam ``rv``/``ri``, timed (ms a call); the
    ``cagra_fused_search_plans`` line, beside the plan the wrapper takes."""
    from raft_tpu_torch.ops import cagra_search as cs

    table, _, qf, _, _ = a["args"]
    kw = a["kw"]
    chosen = None
    times = {}
    for rows, bufs, bitonic in plans:
        smem = cs.smem_bytes(kw["itopk"], kw["width"], table.shape[1], qf.shape[1],
                             table.element_size(), rows, bufs, bitonic)
        if smem > cs.SMEM_LIMIT_BYTES:
            continue
        plan = cs.BeamPlan(rows, bufs, bitonic, smem, 0)
        kv, ki, _ = cs._launch(*a["args"], **kw, plan=plan)
        compare_beam(kv, ki, rv, ri)
        times[f"{rows}x{bufs}{'_bitonic' if bitonic else '_rank'}"] = cuda_ms(
            lambda: cs._launch(*a["args"], **kw, plan=plan), reps=reps)
    run_b4(a)
    chosen = cs.cagra_fused_search.last_plan
    emit(card, phase=phase, metric="cagra_fused_search_plans", ms=times,
         chosen=dataclasses.asdict(chosen), queries=qf.shape[0], itopk=kw["itopk"],
         width=kw["width"], graph_degree=table.shape[1], d=qf.shape[1], **tags)


def cagra_checks(card, seed: int, res, X_mid, Q_mid, max_err, this_tree: bool = True) -> None:
    """Phase 2's B4 checks, each against its plain version with a digest
    (:func:`b4_check`): CAGRA graphs of degree 16 and 32 built through the
    ``ivf_pq`` route on the 65,536 x 128 set, under L2 and IP, with f32
    and bf16 tables, at (itopk, width) of (64, 1), (64, 4) and (128, 8),
    and at degree 32 (256, 16) with an f32 table (a union of 768); then
    degree-16 graphs at d = 100 (65,536 rows) and d = 960 (16,384 rows,
    whose rows do not all fit in shared memory at once) at (128, 8) in both
    dtypes and metrics, and (64, 1) at d = 100; and on a random degree-16
    graph over 4,096 rows at d = 101, whose rows copy 4 bytes (f32) and 2
    bytes (bf16) at a time, (64, 4) in both dtypes. For this tree's kernel,
    the degree-32 shapes at (128, 8) and (256, 16) are timed with the rank
    merge and with the bitonic sort (:func:`b4_plan_times`). The d = 128
    graphs build with ``res`` (whose generator the later phases share, as
    before); the others draw their data from their own seeds and build with
    their own ``Resources``."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import cagra

    for deg in (16, 32):
        cg = cagra.build(X_mid, cagra.CagraIndexParams(intermediate_graph_degree=2 * deg,
                                                       graph_degree=deg, build_algo="ivf_pq"), res=res)
        for table_dtype in ("float32", "bfloat16"):
            for ip in (False, True):
                for itopk, width in ((64, 1), (64, 4), (128, 8)):
                    got = b4_check(card, cg, Q_mid, itopk, width, ip, table_dtype, max_err, this_tree)
                    if this_tree and deg == 32 and (itopk, ip, table_dtype) == (128, False, "float32"):
                        b4_plan_times(card, "kernel_vs_plain", *got,
                                      [(256, 1, False), (256, 1, True)], reps=5)
        if deg == 32:
            for ip in (False, True):
                got = b4_check(card, cg, Q_mid, 256, 16, ip, "float32", max_err, this_tree)
                if this_tree and not ip:
                    b4_plan_times(card, "kernel_vs_plain", *got,
                                  [(128, 2, False), (128, 2, True)], reps=5)
        del cg
    own_res = Resources(device="cuda", seed=seed)
    for dim, rows in ((100, 65536), (960, 16384)):
        gen = Clustered(np.random.default_rng([seed, 10, dim]), dim, 512)
        x = gen.sample(rows)
        q = torch.from_numpy(gen.sample(512)).cuda()
        cg = cagra.build(x, cagra.CagraIndexParams(intermediate_graph_degree=32, graph_degree=16,
                                                   build_algo="ivf_pq"), res=own_res)
        for table_dtype in ("float32", "bfloat16"):
            for ip in (False, True):
                b4_check(card, cg, q, 128, 8, ip, table_dtype, max_err, this_tree)
        if dim == 100:
            b4_check(card, cg, q, 64, 1, False, "float32", max_err, this_tree)
        del cg
    rng = np.random.default_rng([seed, 10, 101])
    x = torch.from_numpy(rng.standard_normal((4096, 101), dtype=np.float32)).cuda()
    graph = torch.from_numpy(rng.integers(-1, 4096, (4096, 16)).astype(np.int32)).cuda()
    cg = cagra.from_graph(x, graph, "sqeuclidean", device="cuda")
    q = torch.from_numpy(rng.standard_normal((256, 101), dtype=np.float32)).cuda()
    for table_dtype in ("float32", "bfloat16"):
        b4_check(card, cg, q, 64, 4, False, table_dtype, max_err, this_tree, graph="random")


def b4_main(card, cg, Qt, k: int, max_err, this_tree: bool = True, phase: str = "cagra") -> dict:
    """B4 at the main path's shapes on the 1M CAGRA index (itopk 128, the
    bf16 table): the 128-row serving batch (``width`` 8, 16,384 seeds),
    batch 1 and batch 10 as ``plan_search_params`` plans them, and the
    first 1,024-query batch of the 10,000-query search. Each against its
    plain version (:func:`compare_beam`, a digest of its bits), timed beside
    its bound and plain time, with µs a step (``per_step_us``) and, for
    this tree's kernel, its stage split (``cagra_fused_search_split``).
    ``chain_floor_ms`` is the fetch stage's share of the warps' cycles at
    batch 1 times the batch-1 kernel time: the time one query's chain of
    fetches takes when nothing competes, this design's measured floor, not
    a bound. Then the call profile of ``cagra.search`` at 128 rows and at
    batch 1 (``cagra_search_call_ops``). Returns the serving batch's
    numbers."""
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import cagra_search

    n = cg.size
    cp = cagra.CagraSearchParams(itopk_size=128, search_width=8, dedup="post",
                                 init_sample=SERVE_INIT_SAMPLE)
    small = {bq: cagra.plan_search_params(bq, k, n, cagra.CagraSearchParams(itopk_size=128,
                                                                            dedup="post"))
             for bq in (1, 10)}
    shapes = [("serving_batch", Qt[:128], cp), ("batch_1", Qt[:1], small[1]),
              ("batch_10", Qt[:10], small[10]), ("10k_search_batch", Qt[:1024], cp)]
    staged = this_tree and hasattr(cagra_search, "cagra_fused_search_stages")
    out = {}
    inputs = {}
    for name, qs, sp in shapes:
        a = b4_args(cg, qs, sp.itopk_size, sp.search_width, False, sp.fused_table_dtype, k=k,
                    init_sample=sp.init_sample)
        work = {}
        rv, ri = run_b4(a, reference=True, work=work)
        kv, ki = run_b4(a)
        max_err["cagra_fused_search"] = max(max_err["cagra_fused_search"],
                                            compare_beam(kv, ki, rv, ri))
        inputs[name] = (a, rv, ri)
        iters = a["kw"]["iters"]
        row = dict(ms=cuda_ms(lambda: run_b4(a), reps=20),
                   plain_ms=cuda_ms(lambda: run_b4(a, reference=True), reps=1))
        row["bound_ms"], row["bound_by"] = b4_bound_ms(a, work)
        row["per_step_us"] = row["ms"] * 1e3 / iters
        full = qs.shape[0] * iters * sp.search_width * cg.graph_degree
        emit(card, phase=phase, metric=f"cagra_fused_search_ms_{name}", value=row["ms"],
             **{x: v for x, v in row.items() if x != "ms"}, queries=qs.shape[0], iters=iters,
             width=sp.search_width, init_sample=sp.init_sample, rows_scored=work["rows"],
             rows_at_most=full, formula_bound_ms=bound_ms(3.0 * full * cg.dim,
                                                          full * (cg.dim * 2 + 4))[0],
             digest=topk_digest(kv, ki))
        if staged:
            rec = cagra_search.cagra_fused_search_stages(*a["args"], **a["kw"])
            row["split"] = stage_split(rec, cagra_search.STAGES, cagra_search.COUNTS)
            emit(card, phase=phase, metric="cagra_fused_search_split", shape=name,
                 queries=qs.shape[0], iters=iters, per_step_us=row["per_step_us"], **row["split"])
        out[name] = row
    if this_tree and hasattr(cagra_search, "launch_plan"):
        # the staging options at the serving batch and the 1,024-query batch
        w = 8 * cg.graph_degree
        for name in ("serving_batch", "10k_search_batch"):
            b4_plan_times(card, phase, *inputs[name],
                          [(w, 1, False), (w // 4, 2, False), (w // 8, 2, False), (1, 2, False),
                           (0, 0, False), (w, 1, True)], shape=name)
    if staged:
        floor = out["batch_1"]["split"]["stage_share"]["fetch"] * out["batch_1"]["ms"]
        out["serving_batch"]["chain_floor_ms"] = floor
        emit(card, phase=phase, metric="cagra_fused_search_chain_floor_ms", value=floor,
             note="fetch share x batch-1 kernel ms: this design's measured floor, not a bound")
    call_ops_line(card, phase, lambda: cagra.search(cg, Qt[:128], k, cp), metric="cagra_search_call_ops",
                  queries=128)
    call_ops_line(card, phase, lambda: cagra.search(cg, Qt[:1], k, small[1]),
                  metric="cagra_search_call_ops", queries=1)
    return out["serving_batch"]


def fold_tiles(rng, rows: int, w: int, select_min: bool, parity: int):
    """A B5 input tile ``(key, pos, val, id)`` of ``[rows, w]`` on the card,
    unsorted: integer values (ties), signed zeros, ``±inf`` with real ids,
    padding entries; positions of one ``parity`` (unique across two tiles)."""
    v = rng.integers(-3, 4, (rows, w)).astype(np.float32)
    z = rng.random((rows, w)) < 0.2
    v[z] = np.where(rng.random(z.sum()) < 0.5, np.float32(-0.0), np.float32(0.0))
    v[rng.random((rows, w)) < 0.05] = np.inf
    v[rng.random((rows, w)) < 0.05] = -np.inf
    pos = (2 * rng.permutation(rows * w * 2)[: rows * w] + parity).reshape(rows, w).astype(np.int32)
    ids = pos + 7
    pad = rng.random((rows, w)) < 0.1
    v[pad] = np.inf if select_min else -np.inf
    pos[pad] = 2 ** 31 - 1
    ids[pad] = -1
    key = v if select_min else -v
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in (key, pos, v, ids))


def shard_tiles(rng, n: int, nq: int, kc: int, select_min: bool, demote=(), sort=True):
    """Per-shard candidate tiles on the card, as a local top-k gives them
    (sorted best first unless ``sort=False``): integer values (cross-shard
    ties), ``±inf`` with real ids; ``demote``d shards are ``(worst, -1)``."""
    v = rng.integers(-6, 7, (n, nq, kc)).astype(np.float32)
    v[rng.random((n, nq, kc)) < 0.03] = np.inf
    v[rng.random((n, nq, kc)) < 0.03] = -np.inf
    if sort:
        v = np.sort(v, axis=2)
        if not select_min:
            v = v[..., ::-1]
    i = (np.arange(n)[:, None, None] * 1_000_000 + np.arange(nq * kc).reshape(1, nq, kc)).astype(np.int32)
    for s in demote:
        v[s] = np.inf if select_min else -np.inf
        i[s] = -1
    return ([torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in v],
            [torch.from_numpy(np.ascontiguousarray(x)).cuda() for x in i])


def exact_err(what: str, got, ref) -> float:
    """Every lane of ``got`` equal to ``ref``'s bit for bit (ids, positions,
    value bits); returns the values' max abs error (0.0)."""
    err = 0.0
    for g, r in zip(got, ref):
        same = torch.equal(g.view(torch.int32), r.view(torch.int32)) if g.is_floating_point() \
            else torch.equal(g, r)
        if not same:
            raise AssertionError(f"{what}: {(g != r).sum()} of {g.numel()} entries differ")
        if g.is_floating_point():
            fin = torch.isfinite(r)
            if fin.any():
                err = max(err, float((g[fin] - r[fin]).abs().max()))
    return err


def ring_err(what: str, got, ref) -> float:
    """Every shard's ``(vals, ids)`` of ``got`` equal to ``ref``'s."""
    return max(exact_err(f"{what} shard {r}", (gv, gi), (rv, ri))
               for r, (gv, gi, rv, ri) in enumerate(zip(*got, *ref)))


def ring_bound_ms(n: int, nq: int, kc: int, k: int) -> tuple:
    """Least time for one ring merge: every shard's ``[nq, kc]`` (val, id)
    inputs read once and its replicated ``[nq, k]`` output written once;
    bound by bytes (the folds' compares are a few per byte)."""
    return bound_ms(0.0, n * nq * (kc + k) * 8.0)


def ring_host_device(card, phase: str, engine: str, fn, nq: int, shards: int, reps: int = 20) -> dict:
    """One ring engine's call split into host and device time: the device
    operations a call (kernels and memcpys, from torch.profiler over
    ``reps`` calls), the host µs a call takes to return (enqueue only, the
    card idle before each call; median, and mean), the device µs busy a
    call, and ``cuda_ms`` (events around ``reps`` calls: the time a caller
    sees)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copies = [e for e in dev if "emcpy" in e.key or "emset" in e.key]
    row = dict(engine=engine, queries=nq, shards=shards, reps=reps,
               device_ops_per_call=sum(e.count for e in dev) / reps,
               memcpys_per_call=sum(e.count for e in copies) / reps,
               kernels_per_call=sum(e.count for e in dev if e not in copies) / reps,
               host_us_per_call=float(np.median(host)) * 1e6,
               host_us_mean=float(np.mean(host)) * 1e6,
               device_us_busy_per_call=sum(e.self_device_time_total for e in dev) / reps,
               cuda_ms=cuda_ms(fn, reps),
               kernels={e.key[:60]: e.count / reps for e in dev})
    emit(card, phase=phase, metric="ring_host_device", **row)
    return row


def atomic_segment_sum(values, labels, k: int, batched: bool = False) -> torch.Tensor:
    """The build's label sums as the port added them before: ``index_add_``
    (the batched form: over labels offset by ``k`` per batch, as
    ``scatter_add_`` did), float atomics in a varying order on the card.
    Timed against ``kmeans.segment_sum`` only."""
    if batched:
        B, n = labels.shape
        flat = (labels.to(torch.int64) + k * torch.arange(B, device=labels.device)[:, None]).reshape(-1)
        out = atomic_segment_sum(values.reshape((B * n,) + tuple(values.shape[2:])), flat, B * k)
        return out.reshape((B, k) + tuple(values.shape[2:]))
    out = torch.zeros((k,) + tuple(values.shape[1:]), dtype=torch.float32, device=values.device)
    return out.index_add_(0, labels.to(torch.int64), values.to(torch.float32))


def timed_build(build, sums=None):
    """``(index, seconds)`` of ``build()``; with ``sums`` the three k-means
    update sites (kmeans, kmeans_balanced, ivf_pq) use it for this build."""
    from raft_tpu_torch.cluster import kmeans, kmeans_balanced
    from raft_tpu_torch.neighbors import ivf_pq

    mods = (kmeans, kmeans_balanced, ivf_pq)
    saved = [m.segment_sum for m in mods]
    if sums is not None:
        for m in mods:
            m.segment_sum = sums
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = build()
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0
    finally:
        for m, f in zip(mods, saved):
            m.segment_sum = f


def differing_fields(a, b, fields) -> list:
    return [f for f in fields if not torch.equal(getattr(a, f), getattr(b, f))]


def check_deterministic(card, phase, name, build, fields) -> None:
    """Build twice with the fixed-order sums and once with the atomic ones;
    the two fixed-order builds must be equal in every field. Prints the
    build seconds of both kinds."""
    det = [timed_build(build), timed_build(build)]
    _, atomic_s = timed_build(build, atomic_segment_sum)
    diff = differing_fields(det[0][0], det[1][0], fields)
    emit(card, phase=phase, metric="build_determinism", index=name,
         fixed_order_build_s=[t for _, t in det], atomic_build_s=atomic_s,
         slower_by=float(np.mean([t for _, t in det]) / atomic_s - 1.0),
         fields_differing_between_fixed_order_builds=diff, max_list=[i.max_list for i, _ in det])
    if diff:
        raise AssertionError(f"{name} built twice from one seed differs in {diff}")


def paths_ms(card: str, tree: str, seed: int, reps: int = 50) -> None:
    """Per-call ms (CUDA events around ``reps`` calls, host time included)
    of ``ivf_flat.search`` at ``n_probes=20``, k = 10 on a 1,000,000 x 128
    index (``n_lists=1024``, phase 3's data distribution from ``seed``):
    one 128-row batch in fused mode (the served bucket of 128), 16 rows in
    probe mode (the one-client buckets), 128 rows in scan mode (the dense
    scan), and ``select_k`` on those 128 rows' coarse scores."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_common, ivf_flat
    from raft_tpu_torch.ops.select_k import select_k

    gen = Clustered(np.random.default_rng(seed), 128, 4096)
    X, Q = gen.sample(1_000_000), gen.sample(128)
    index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024),
                           res=Resources(device="cuda", seed=seed))
    q = torch.from_numpy(Q).cuda()
    params = dataclasses.replace(ivf_flat.IvfFlatSearchParams(n_probes=20), fused_qt=SERVE_QT)
    coarse = ivf_common.coarse_scores(index.centers, q, index.metric)
    emit(card, phase="paths", metric="path_ms", tree=os.path.basename(os.path.abspath(tree)),
         reps=reps,
         fused_128=cuda_ms(lambda: ivf_flat.search(index, q, 10, params, mode="fused"), reps),
         probe_16=cuda_ms(lambda: ivf_flat.search(index, q[:16], 10, params, mode="probe"), reps),
         scan_128=cuda_ms(lambda: ivf_flat.search(index, q, 10, params, mode="scan"), reps // 5),
         select_k_coarse=cuda_ms(lambda: select_k(coarse, 20, select_min=True), reps))


def serve_qps(card: str, tree: str, seed: int, rounds: int = 3, n: int = 1_000_000,
              nq: int = 10_000) -> None:
    """QPS of phase 3's IVF-Flat serving on one tree: a 1,000,000 x 128
    index (``n_lists=1024``, phase 3's data distribution from ``seed``)
    registered at ``n_probes=20``, ``fused_qt=16``, 10,000 queries in
    requests of 1-128 rows, served as one client once and as a backlog
    ``rounds`` times (host clock, ending on the host's copy of the
    results)."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.serve import ServingEngine

    rng = np.random.default_rng(seed)
    gen = Clustered(rng, 128, 4096)
    X, Q = gen.sample(n), gen.sample(nq)
    res = Resources(device="cuda", seed=seed)
    index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024), res=res)
    eng = ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=nq, res=res)
    eng.register("sift1m", "ivf_flat", index,
                 params=ivf_flat.IvfFlatSearchParams(n_probes=20, fused_qt=SERVE_QT))
    eng.warmup("sift1m", 10)
    sizes = request_sizes(rng, nq)
    starts = np.cumsum([0] + sizes[:-1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s, m in zip(starts, sizes):
        fut = eng.submit("sift1m", Q[s : s + m], 10)
        eng.step(force=True)
        fut.result()
    one_client = nq / (time.perf_counter() - t0)
    backlog = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        futs = [eng.submit("sift1m", Q[s : s + m], 10) for s, m in zip(starts, sizes)]
        eng.run_until_idle()
        for f in futs:
            f.result()
        backlog.append(nq / (time.perf_counter() - t0))
    emit(card, phase="serve", metric="serve_qps", tree=os.path.basename(os.path.abspath(tree)),
         one_client=one_client, backlog=backlog, requests=len(sizes), n_probes=20,
         fused_qt=SERVE_QT)


def sharded_serve_qps(card: str, tree: str, seed: int, rounds: int = 3, n: int = 1_000_000,
                      nq: int = 10_000) -> None:
    """QPS of phase 7's sharded serving on one tree, obs off: :func:`serve_qps`'s
    index and requests, registered as ``sharded_ivf_flat`` over
    ``make_mesh(["cuda:0"] * 4)`` (``n_probes=20``, ``merge_mode="ring"``),
    served as a backlog ``rounds`` times (host clock)."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.parallel import make_mesh
    from raft_tpu_torch.serve import ServingEngine

    rng = np.random.default_rng(seed)
    gen = Clustered(rng, 128, 4096)
    X, Q = gen.sample(n), gen.sample(nq)
    res = Resources(device="cuda", seed=seed)
    index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024), res=res)
    eng = ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=nq, res=res)
    eng.register("sharded", "sharded_ivf_flat", index,
                 params=ivf_flat.IvfFlatSearchParams(n_probes=20),
                 mesh=make_mesh(["cuda:0"] * 4), merge_mode="ring")
    eng.warmup("sharded", 10)
    sizes = request_sizes(rng, nq)
    qps = []
    for _ in range(rounds):
        futs, secs = backlog(eng, "sharded", Q, sizes, 10)
        for f in futs:
            f.result()
        qps.append(nq / secs)
    emit(card, phase="robust", metric="sharded_serve_qps",
         tree=os.path.basename(os.path.abspath(tree)), backlog=qps, requests=len(sizes),
         n_probes=20, shards=4, merge_mode="ring")


def ring_checks(card: str, rng, max_err: dict) -> None:
    """B6 (tiles of at most k = 10 columns) and B7 (wider tiles) over
    virtual meshes of 2, 3, 4 and 8 shards of the card, 1, 37, 128 and 1,024
    queries, tiles of 6, 10, 23, 80 and 83 columns, one shard demoted,
    min- and max-select in turns: each bit-equal to the gather merge, to
    the kernel's plain mirror and to the host schedule (the engine of
    shards on distinct cards) on the same mesh. Times nothing
    (:func:`ring_lines` does)."""
    from raft_tpu_torch.ops import ring_topk as rt
    from raft_tpu_torch.parallel import make_mesh

    shapes = [(n, nq, kc) for n in (2, 3, 4, 8) for nq in (1, 37, 128, 1024)
              for kc in (6, 10, 23, 80, 83)]
    for idx, (n, nq, kc) in enumerate(shapes):
        select_min = idx % 2 == 0
        mesh = make_mesh(["cuda:0"] * n)
        vs, is_ = shard_tiles(rng, n, nq, kc, select_min, demote=(n // 2,), sort=kc <= 10)
        name = "fused_ring_topk" if kc <= 10 else "fused_scan_ring_topk"
        got = getattr(rt, name)(mesh, vs, is_, 10, select_min)
        torch.cuda.synchronize()
        what = f"{name} n {n} nq {nq} kc {kc} select_min {select_min}"
        err = max(ring_err(what + " vs gather", got, rt.gather_merge(mesh, vs, is_, 10, select_min)),
                  ring_err(what + " vs plain mirror", got,
                           rt.ring_kernel_reference(vs, is_, 10, select_min)),
                  ring_err(what + " vs host schedule", got,
                           rt._run_ring(mesh, vs, is_, 10, select_min)[0]))
        max_err[name] = max(max_err[name], err)
        sent = (rt.fused_ring_topk.last_bytes if name == "fused_ring_topk" else None) or {}
        emit(card, phase="kernel_vs_plain", kernel=name, n_shards=n, nq=nq, kc=kc, k=10,
             select_min=select_min, demoted=[n // 2], max_abs_err=err, grid=rt.fused_ring_topk.last_grid,
             bytes_per_query=sent.get("per_query"),
             wire_model_bytes_per_query=sent.get("model_per_query"))


def ring_lines(card: str, rng) -> None:
    """Over four shards at 128 queries, each ring engine's
    ``ring_host_device`` line and the kernel's stage split
    (``fused_ring_topk_split``)."""
    from raft_tpu_torch.ops import ring_topk as rt
    from raft_tpu_torch.parallel import make_mesh

    mesh = make_mesh(["cuda:0"] * 4)
    for nq in (128,):
        vs, is_ = shard_tiles(rng, mesh.size, nq, 10, True)
        for engine, fn in (("kernel", lambda: rt.fused_ring_topk(mesh, vs, is_, 10)),
                           ("schedule", lambda: rt._run_ring(mesh, vs, is_, 10, True)),
                           ("gather", lambda: rt.gather_merge(mesh, vs, is_, 10, True))):
            ring_host_device(card, "kernel_vs_plain", engine, fn, nq, mesh.size)
        rec = rt.fused_ring_topk_stages(mesh, vs, is_, 10)
        emit(card, phase="kernel_vs_plain", metric="fused_ring_topk_split", queries=nq,
             shards=mesh.size, k=10, grid=rt.fused_ring_topk.last_grid,
             **stage_split(rec, rt.STAGES, rt.COUNTS, slots=rt.STAGE_SLOTS))


def delta_args(snap, queries):
    """B1's inputs for a snapshot's delta scan, named as :func:`run_flat`
    and :func:`flat_bound_ms` read them."""
    from types import SimpleNamespace

    from raft_tpu_torch.mutable import segments as seg

    a = seg.delta_scan_inputs(snap.delta_bf, snap.delta_live, queries)
    return SimpleNamespace(list_data=a.list_data, list_norms=a.list_norms,
                           list_indices=a.list_indices, queries_sorted=a.queries,
                           tile_probes=a.tile_probes, probe_valid=a.probe_valid)


def served_mutable(eng, index_id, Q, sizes, k):
    """Queue every request of ``sizes`` rows of ``Q``, drain, and return
    the results and the seconds."""
    starts = np.cumsum([0] + list(sizes[:-1]))
    t0 = time.perf_counter()
    futs = [eng.submit(index_id, Q[s : s + m], k) for s, m in zip(starts, sizes)]
    eng.run_until_idle()
    results = [f.result() for f in futs]
    return results, time.perf_counter() - t0


def mutable_phase(card, res, X, Q, gt_i, gen, k: int, seed: int, immutable=None) -> dict:
    """Phase 8: the mutable index at full width (:func:`run_phases`'s
    ``mutable`` part). ``X`` (1M x 128) goes through
    ``MutableIndex.open(ivf_flat, n_lists=1024)`` in 65,536-row inserts and
    ``compact()`` builds generation 1 (equal, field for field, to
    ``immutable`` when given: phase 3's build over the same rows). Churn
    (31,744 inserts, 10,000 deletes and 1,024 upserts of main rows) fills
    the delta to 32,768 rows, 32 banks of B1. Checks, each raising: B1's
    delta launch ``torch.equal`` to its plain version at k = 10 and 100;
    the fused delta route against ``delta_mode="exact"`` on the 10,000
    queries (ids equal at >= 0.999 of the slots, distances allclose); no
    deleted id returned; each upserted vector first for itself at distance
    ~0; recall@10 against exact kNN over ``live_rows()`` at most 0.005 below
    generation 1's (the immutable index's) recall. Then served through
    ``register_mutable`` (``fused_qt=16``, ``n_probes=20``,
    ``CompactionPolicy(delta_rows=32_768)``): 10,000-query backlogs while a
    writer thread inserts, until the compactor's background flip to
    generation 2 and one backlog after it; sampled batches equal
    ``snapshot().search`` at generations 1 and 2. Then a cold reopen must
    give ``torch.equal`` live rows and search output, and at 65,536 rows a
    compaction must equal a fresh build from the same seed, bit for bit.
    Returns B1's serving launches and the phase's numbers."""
    import shutil
    import tempfile
    import threading

    from raft_tpu_torch import obs
    from raft_tpu_torch.mutable import CompactionPolicy, MutableIndex
    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.ops import ivf_scan
    from raft_tpu_torch.serve import ServingEngine
    from raft_tpu_torch.stats.recall import neighborhood_recall

    t_phase = time.perf_counter()
    n, d = X.shape
    nq = Q.shape[0]
    Qt = torch.from_numpy(Q).cuda()
    rng = np.random.default_rng([seed, 8])
    ivf_fields = ("centers", "list_sizes", "list_indices", "list_data", "list_norms", "center_rank")
    params = ivf_flat.IvfFlatIndexParams(n_lists=1024)
    serve_params = ivf_flat.IvfFlatSearchParams(n_probes=20, fused_qt=SERVE_QT)
    tmp = tempfile.mkdtemp(prefix="mutable_")
    obs.registry().reset()
    obs.enable()
    try:
        def open_index():
            return MutableIndex.open(tmp, "ivf_flat", d, index_params=params,
                                     search_params=serve_params, name="mutable", res=res)

        mut = open_index()
        t0 = time.perf_counter()
        for s in range(0, n, 65536):
            mut.insert(X[s : s + 65536])
        insert_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mut.compact() != 1:
            raise AssertionError("the first compaction did not publish generation 1")
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        same_as_phase3 = None
        if immutable is not None:
            same_as_phase3 = differing_fields(mut.main_index, immutable, ivf_fields)
            if same_as_phase3:
                raise AssertionError(f"generation 1 differs from phase 3's build in {same_as_phase3}")
        emit(card, phase="mutable", metric="mutable_load", rows=n, insert_s=insert_s,
             insert_chunk=65536, compact_s=compact_s, generation=mut.generation,
             wal_bytes_before_compaction=n * (d * 4 + 8), fields_differing_from_phase3=same_as_phase3)
        _, imm_ids = ivf_flat.search(mut.main_index, Qt, k, serve_params)
        imm_recall = neighborhood_recall(imm_ids, gt_i)

        # churn: the delta fills to 32,768 rows, the fused route's largest
        picks = rng.choice(n, 11_024, replace=False)
        del_ids, up_ids = picks[:10_000], picks[10_000:]
        new_rows = gen.sample(31_744)
        up_rows = gen.sample(1_024)
        t0 = time.perf_counter()
        for s in range(0, len(new_rows), 1024):
            mut.insert(new_rows[s : s + 1024])
        mut.delete(del_ids)
        mut.upsert(up_ids, up_rows)
        churn_s = time.perf_counter() - t0
        snap = mut.snapshot()
        if int(snap.delta_bf.size) != 32_768 or mut.delta_rows != 32_768:
            raise AssertionError(f"delta holds {mut.delta_rows} rows, {snap.delta_bf.size} padded")

        # 1. B1's delta launch against its plain version, bit for bit
        da = delta_args(snap, Qt)
        b1_delta = {}
        for kk in (10, 100):
            kv, ks = run_flat(da, kk, snap.metric)
            rv, rs = run_flat(da, kk, snap.metric, reference=True)
            torch.cuda.synchronize()
            if not (torch.equal(kv, rv) and torch.equal(ks, rs)):
                raise AssertionError(f"B1's delta launch at k={kk} is not its plain version's bits")
            b1_delta[kk] = dict(ms=cuda_ms(lambda: run_flat(da, kk, snap.metric), reps=10),
                                plain_ms=cuda_ms(lambda: run_flat(da, kk, snap.metric,
                                                                  reference=True), reps=1),
                                **{x: v for x, v in flat_bound_ms(da, kk).items()
                                   if x != "bound_terms_ms"})
        emit(card, phase="mutable", metric="fused_list_topk_delta", banks=int(da.list_data.shape[0]),
             bank_rows=int(da.list_data.shape[1]), queries=nq, qt=128, torch_equal=True,
             by_k={str(kk): v for kk, v in b1_delta.items()})

        # 2. the fused route against the exact one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fu_d, fu_i = snap.search(Qt, k)
        fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex_d, ex_i = dataclasses.replace(snap, delta_mode="exact").search(Qt, k)
        exact_s = time.perf_counter() - t0
        share = float((fu_i == ex_i).mean())
        gap = float(np.abs(fu_d - ex_d).max())
        emit(card, phase="mutable", metric="delta_fused_vs_exact", ids_equal_share=share,
             max_distance_gap=gap, queries=nq, fused_search_s=fused_s, exact_search_s=exact_s)
        if share < 0.999 or not np.allclose(fu_d, ex_d, rtol=1e-5, atol=1e-3):
            raise AssertionError(f"fused and exact delta routes: ids equal at {share}, "
                                 f"largest distance gap {gap}")

        # 3. deletes never surface; upserts are found at their own place
        if np.isin(fu_i, del_ids).any():
            raise AssertionError("a deleted id was returned")
        ud, ui = snap.search(torch.from_numpy(up_rows).cuda(), k)
        scale = np.maximum(1.0, (up_rows.astype(np.float64) ** 2).sum(axis=1))
        self_err = float((ud[:, 0] / scale).max())
        emit(card, phase="mutable", metric="upserts_found", upserts=len(up_ids),
             first_is_itself=float((ui[:, 0] == up_ids).mean()), max_self_distance=float(ud[:, 0].max()),
             max_self_distance_over_norm2=self_err)
        if not (ui[:, 0] == up_ids).all() or self_err > 1e-5:
            raise AssertionError(f"an upserted vector is not first for itself at distance ~0 "
                                 f"({self_err} of its squared norm)")

        # 4. recall against exact kNN over the live rows
        live_ids, live_vecs = mut.live_rows()
        _, pos = brute_force.knn(live_vecs, Q, k, metric="sqeuclidean", res=res)
        gt_live = torch.from_numpy(live_ids[pos.cpu().numpy()])
        mut_recall = neighborhood_recall(torch.from_numpy(fu_i), gt_live)
        emit(card, phase="mutable", metric="mutable_recall@10", value=mut_recall,
             immutable_recall=imm_recall, live_rows=len(live_ids), delta_rows=mut.delta_rows,
             tombstones=10_000 + 1_024, churn_s=churn_s)
        if mut_recall < imm_recall - 0.005:
            raise AssertionError(f"mutable recall {mut_recall} < immutable {imm_recall} - 0.005")

        # served: a backlog at a time while a writer inserts, across the flip
        eng = ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=nq, res=res)
        eng.register_mutable("mutable", mut, params=serve_params,
                             policy=CompactionPolicy(delta_rows=32_768))
        comp = eng._reg("mutable").compactor
        sample = [Q[:128], Q[128:256]]

        def check_sample(expect_gen):
            futs = [eng.submit("mutable", q, k) for q in sample]
            eng.run_until_idle()
            snap_now = mut.snapshot()
            for q, f in zip(sample, futs):
                r = f.result()
                want = snap_now.search(torch.from_numpy(q).cuda(), k)
                if r.generation != expect_gen or snap_now.generation != expect_gen or not (
                        np.array_equal(r.indices, want[1]) and np.array_equal(r.distances, want[0])):
                    raise AssertionError(f"a served batch at generation {r.generation} is not "
                                         f"snapshot().search at generation {expect_gen}")

        check_sample(1)
        sizes = request_sizes(rng, nq)
        # 800 rows a second, at most 16,384: the delta after the flip (the
        # rows written since the pin) stays inside B1's window
        writer_rows = gen.sample(16_384)
        stop = threading.Event()
        written = [0]

        def writer():
            while not stop.is_set() and written[0] < len(writer_rows):
                mut.insert(writer_rows[written[0] : written[0] + 16])
                written[0] += 16
                time.sleep(0.02)

        wt = threading.Thread(target=writer, name="mutable-writer")
        ivf_scan.fused_list_topk.launches = 0
        scans0 = dict(obs.registry().as_dict()["counters"])
        compact_key = 'mutable.compact.duration_ms{index="mutable"}'
        compact_ms0 = obs.registry().as_dict()["histograms"][compact_key]["sum"]
        wt.start()
        generations, qps, rounds, served_s = set(), [], 0, 0.0
        after_flip = False
        deadline = time.monotonic() + 300.0
        try:
            while not after_flip:
                if time.monotonic() > deadline:
                    raise AssertionError("the compactor did not flip within 300 s of serving")
                began_after = comp.completed >= 1
                results, secs = served_mutable(eng, "mutable", Q, sizes, k)
                rounds += 1
                served_s += secs
                qps.append(nq / secs)
                generations |= {r.generation for r in results}
                ids = np.concatenate([r.indices for r in results])
                if (ids < 0).any() or np.isin(ids, del_ids).any():
                    raise AssertionError("a served result holds an empty slot or a deleted id")
                after_flip = began_after
        finally:
            stop.set()
            wt.join()
        launches = ivf_scan.fused_list_topk.launches
        counters = obs.registry().as_dict()["counters"]
        delta_scans = {mode: counters.get(f'mutable.delta.scans{{mode="{mode}"}}', 0.0)
                       - scans0.get(f'mutable.delta.scans{{mode="{mode}"}}', 0.0)
                       for mode in ("fused", "exact")}
        flips = counters.get('serve.generation_flips{index_id="mutable"}', 0.0)
        comp_ms = obs.registry().as_dict()["histograms"][compact_key]["sum"] - compact_ms0
        if not comp.wait_idle(timeout_s=120.0) or comp.completed != 1 or comp.failed:
            raise AssertionError(f"compactor: {comp.completed} completed, {comp.failed} failed "
                                 f"({comp.last_error!r})")
        if not generations <= {1, 2} or 2 not in generations or mut.generation != 2 or flips != 1:
            raise AssertionError(f"served generations {sorted(generations)}, {flips} flips, "
                                 f"index at generation {mut.generation}")
        if launches <= 0 or delta_scans["fused"] <= 0:
            raise AssertionError(f"B1 launched {launches} times, {delta_scans['fused']} of them "
                                 "for the delta")
        check_sample(2)
        busy = profile_backlog(card, eng, "mutable", Q, np.cumsum([0] + sizes[:-1]), sizes, k,
                               None, n_req=len(sizes), phase="mutable")
        serve = dict(qps=nq * rounds / served_s, qps_per_round=qps, rounds=rounds,
                     generation_flips=flips, generations=sorted(generations),
                     compaction_s=comp_ms / 1e3,
                     b1_launches=launches, b1_launches_delta=delta_scans["fused"],
                     b1_launches_main=launches - delta_scans["fused"],
                     delta_scans_exact=delta_scans["exact"], writer_rows=written[0],
                     busy_share=busy)
        emit(card, phase="mutable", metric="mutable_serve", max_batch=128, fused_qt=SERVE_QT,
             n_probes=20, **serve)
        eng.shutdown()

        # durability: close, reopen cold, the same rows and answers
        ids0, vecs0 = mut.live_rows()
        d0, i0 = mut.search(Qt[:1024], k)
        mut.close()
        del mut, snap, eng
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mut = open_index()
        torch.cuda.synchronize()
        reopen_s = time.perf_counter() - t0
        ids1, vecs1 = mut.live_rows()
        d1, i1 = mut.search(Qt[:1024], k)
        equal = all(torch.equal(torch.from_numpy(a), torch.from_numpy(b))
                    for a, b in ((ids0, ids1), (vecs0, vecs1), (d0, d1), (i0, i1)))
        emit(card, phase="mutable", metric="mutable_reopen", reopen_s=reopen_s,
             live_rows=len(ids1), generation=mut.generation, equal=equal)
        if not equal or mut.generation != 2:
            raise AssertionError("the cold reopen does not give the live rows and answers of before")
        mut.close()
        del mut

        # a compaction equals a fresh build over the same rows, at 65,536
        small = ivf_flat.IvfFlatIndexParams(n_lists=256)
        m = MutableIndex("ivf_flat", d, index_params=small, search_params=serve_params, res=res)
        ids = m.insert(X[:65536])
        m.compact()
        m.insert(gen.sample(2048))
        m.delete(ids[::100])
        m.upsert(ids[1::97][:64], gen.sample(64))
        m.compact()
        live_ids, live_vecs = m.live_rows()
        fresh = MutableIndex("ivf_flat", d, index_params=small, search_params=serve_params, res=res)
        fresh.insert(live_vecs, ids=live_ids)
        fresh.compact()
        diff = differing_fields(m.main_index, fresh.main_index, ivf_fields)
        a, b = m.search(Qt[:1024], k), fresh.search(Qt[:1024], k)
        same = np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        emit(card, phase="mutable", metric="mutable_fresh_rebuild", rows=len(live_ids),
             fields_differing=diff, search_equal=same)
        if diff or not same:
            raise AssertionError(f"compaction differs from a fresh build: fields {diff}, "
                                 f"search equal {same}")
    finally:
        obs.disable()
        obs.registry().reset()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(card, phase="mutable", metric="mutable_phase_s", value=time.perf_counter() - t_phase)
    return dict(launches=serve["b1_launches"], delta=b1_delta[k], serve=serve)


def replica_sizes(rng, nq: int) -> list:
    """Requests of 65-128 rows up to ``nq`` rows (the remainder dropped): no
    two fit one 128-row micro-batch, so each request is a batch of its own
    in every engine, whichever replica serves it."""
    sizes = []
    while True:
        m = int(rng.integers(65, 129))
        if sum(sizes) + m > nq:
            return sizes
        sizes.append(m)


def replica_backlog(grp, index_id, Q, sizes, k, on_submit=None):
    """:func:`backlog` through ``grp`` (an engine or a replica group);
    returns each request's outcome (its result or its exception) and the
    seconds."""
    futs, secs = backlog(grp, index_id, Q, sizes, k, on_submit)
    return [f.exception(timeout=0) or f.result(timeout=0) for f in futs], secs


def same_served(what: str, got, want) -> None:
    """Every outcome a result, bit-equal to ``want``'s, request by request."""
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(a, BaseException):
            raise AssertionError(f"{what}: request {i} failed: {a!r}")
        if not (np.array_equal(a.indices, b.indices) and np.array_equal(a.distances, b.distances)):
            raise AssertionError(f"{what}: request {i} is not the bare engine's answer")


def replica_phase(card, res, index, X, Q, gt_i, gen, k: int, seed: int, sizes) -> dict:
    """Phase 12: replicated serving and the rest of obs (:func:`run_phases`'s
    ``replica`` part) on phase 3's IVF-Flat index (``n_probes=20``,
    ``fused_qt=16``, B1 at bucket 128). Checks, each raising:

    (a) a one-replica ``ReplicaGroup`` serves the 10,000-query backlog of
    phase 3's 1-128-row requests bit-equal to a bare ``ServingEngine``; at
    1, 2 and 4 replicas with threaded pumps (one shared index, warmed
    first) a backlog of 65-128-row requests (each a batch of its own) is
    bit-equal to the bare engine's, with QPS, p50/p99, B1 launches and the
    device busy share of each;
    (b) at 2 threaded replicas, replica 1 killed through ``replica.dispatch``
    once a third of the stream is in and it holds queued work: every
    future completes without error, bit-equal to the run without the kill,
    ``serve.failovers`` > 0;
    (c) a leader (``MutableIndex.open``, the 1M rows, compacted to
    generation 1) and two followers (``Follower``, on the card) behind
    ``register_mutable_replicated``: phase 8's churn sealed and shipped on
    the maintenance tick, each follower at the leader's record count
    answering bit-equal to the leader, the staleness floor keeping reads
    off a lagging follower, both following a compaction flip to
    generation 2, B1's delta launch on a follower ``torch.equal`` to its
    plain version, the served backlog launching B1;
    (d) a ``ControlPlane`` over that pipeline: the leader killed while one
    follower's wire is down and a stream is served; its lease runs out;
    the follower with the higher cursor is promoted (the election's
    seconds: a leader rebuilt from 1M live rows), no caller sees an error,
    the followers converge bit-equal, the deposed leader's frames raise
    ``FencedError``;
    (e) a flight recorder and an SLO (1 ms at 0.9) the backlog breaches:
    exactly one bundle, CRC-valid, equal through ``load_bundle`` (size and
    write time); with obs off and a recorder installed the backlog is
    bit-equal to (a)'s.
    Returns B1's launches in (a)-(c) and the phase's numbers."""
    import shutil
    import tempfile

    from raft_tpu_torch import obs
    from raft_tpu_torch.mutable import MutableIndex
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import recorder
    from raft_tpu_torch.ops import ivf_scan
    from raft_tpu_torch.replica import (ControlPlane, FencedError, Follower, LeaseStore,
                                        ReplicaGroup, Replication)
    from raft_tpu_torch.replica.shipping import _read_file_chunk
    from raft_tpu_torch.robust import faults
    from raft_tpu_torch.serve import ServingEngine
    from raft_tpu_torch.stats.recall import neighborhood_recall

    t_phase = time.perf_counter()
    n, d = X.shape
    nq = Q.shape[0]
    rng = np.random.default_rng([seed, 12])
    params = ivf_flat.IvfFlatSearchParams(n_probes=20, fused_qt=SERVE_QT)
    b1 = ivf_scan.fused_list_topk
    out = {"launches": {}}

    def engine():
        return ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=nq, res=res)

    def lat(results):
        ms = np.array([r.latency_ms for r in results])
        return dict(p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)))

    # ---- (a) groups against the bare engine -------------------------------
    bare = engine()
    bare.register("flat", "ivf_flat", index, params=params)
    bare.warmup("flat", k)
    base, base_s = replica_backlog(bare, "flat", Q, sizes, k)
    ids = np.concatenate([r.indices for r in base])
    recall = neighborhood_recall(torch.from_numpy(ids), gt_i)
    one = ReplicaGroup(n_replicas=1, engine_factory=lambda r: engine(), res=res)
    one.register("flat", "ivf_flat", index, params=params)
    one.warmup("flat", k)
    b1.launches = 0
    got, secs = replica_backlog(one, "flat", Q, sizes, k)
    same_served("one-replica group (1-128-row requests)", got, base)
    if b1.launches <= 0:
        raise AssertionError("the one-replica group never launched B1")
    emit(card, phase="replica", metric="one_replica_vs_bare", requests=len(sizes), rows=nq,
         bit_equal=True, qps=nq / secs, bare_qps=nq / base_s, b1_launches=b1.launches,
         recall=recall)
    out["launches"]["one_replica"] = b1.launches
    one.shutdown()

    rsizes = replica_sizes(rng, nq)
    rows = int(sum(rsizes))
    Qr = Q[:rows]
    want, bare_s = replica_backlog(bare, "flat", Qr, rsizes, k)
    emit(card, phase="replica", metric="bare_engine_backlog", requests=len(rsizes), rows=rows,
         qps=rows / bare_s, **lat(want))
    scaling = {}
    for n_rep in (1, 2, 4):
        grp = ReplicaGroup(n_replicas=n_rep, engine_factory=lambda r: engine(), res=res,
                           name=f"flat{n_rep}")
        grp.register("flat", "ivf_flat", index, params=params)
        grp.warmup("flat", k)
        grp.start()
        try:
            b1.launches = 0
            torch.cuda.synchronize()
            got, secs = replica_backlog(grp, "flat", Qr, rsizes, k)
            same_served(f"{n_rep} threaded replicas", got, want)
            qps = [rows / secs]
            launches = b1.launches
            if launches <= 0:
                raise AssertionError(f"{n_rep} threaded replicas never launched B1")
            busy = profile_backlog(card, grp, "flat", Qr, np.cumsum([0] + rsizes[:-1]), rsizes, k,
                                   None, n_req=len(rsizes), phase="replica")
        finally:
            grp.stop()
            grp.shutdown()
        scaling[n_rep] = dict(qps=qps, b1_launches=launches, busy_share=busy, **lat(got))
        emit(card, phase="replica", metric="replicated_serve", replicas=n_rep, threaded=True,
             requests=len(rsizes), rows=rows, bit_equal_to_bare=True, **scaling[n_rep])
        out["launches"][f"threaded_{n_rep}"] = launches
    out["scaling"] = scaling

    # ---- (b) failover: replica 1 killed mid-stream ------------------------
    obs.registry().reset()
    obs.enable()
    faults.enable()
    grp = ReplicaGroup(n_replicas=2, failure_threshold=2, reset_timeout_s=30.0,
                       engine_factory=lambda r: engine(), res=res, name="failover")
    grp.register("flat", "ivf_flat", index, params=params)
    grp.warmup("flat", k)
    killed = []

    def kill(i):
        if not killed and i >= len(rsizes) // 3 and grp.engines[1].queue_depth() > 0:
            killed.append(i)
            faults.install("replica.dispatch", error=RuntimeError("chaos kill"),
                           match={"replica": 1})

    grp.start()
    try:
        b1.launches = 0
        got, secs = replica_backlog(grp, "flat", Qr, rsizes, k, on_submit=kill)
    finally:
        grp.stop()
        faults.clear()
        faults.disable()
    counters = obs.registry().as_dict()["counters"]
    failovers = sum(v for key, v in counters.items() if key.startswith("serve.failovers"))
    pump_failures = sum(v for key, v in counters.items()
                        if key.startswith("replica.pump_failures"))
    obs.disable()
    same_served("failover run", got, want)
    fo = dict(killed_at_request=killed[0] if killed else None, qps=rows / secs,
              failovers=failovers, pump_failures=pump_failures, breakers=grp.router.states(),
              b1_launches=b1.launches, **lat(got))
    emit(card, phase="replica", metric="failover", replicas=2, requests=len(rsizes), **fo)
    if not killed or failovers <= 0 or grp.router.states()[1] != "open":
        raise AssertionError(f"the kill did not fail over: {fo}")
    grp.shutdown()
    out["failover"] = fo
    out["launches"]["failover"] = fo["b1_launches"]

    # ---- (c) replicated mutable serving -----------------------------------
    tmp = tempfile.mkdtemp(prefix="replica_")
    try:
        t0 = time.perf_counter()
        leader = MutableIndex.open(os.path.join(tmp, "leader"), "ivf_flat", d,
                                   index_params=ivf_flat.IvfFlatIndexParams(n_lists=1024),
                                   search_params=params, name="leader", res=res)
        for s in range(0, n, 65536):
            leader.insert(X[s : s + 65536])
        if leader.compact() != 1:
            raise AssertionError("the leader's first compaction did not publish generation 1")
        load_s = time.perf_counter() - t0
        wire = {"down": False}

        def f0_wire(path, offset, nbytes):
            if wire["down"]:
                raise OSError("f0's wire is down")
            return _read_file_chunk(path, offset, nbytes)

        t0 = time.perf_counter()
        followers = [Follower(leader.directory, os.path.join(tmp, f"f{j}"), algo="ivf_flat",
                              dim=d, index_params=leader.index_params, search_params=params,
                              name=f"f{j}", res=res) for j in range(2)]
        follower_load_s = time.perf_counter() - t0
        rep = Replication(leader, followers, seal_bytes=1, transports=[f0_wire, None])
        grp = ReplicaGroup(n_replicas=3, max_staleness_records=0,
                           engine_factory=lambda r: engine(), res=res, name="mutable")
        grp.register_mutable_replicated("m", rep, params=params)
        picks = rng.choice(n, 11_024, replace=False)
        del_ids, up_ids = picks[:10_000], picks[10_000:]
        # phase 8's churn, 16 inserts short: the floor's 16 rows below fill
        # the delta to 32,768 rows, 32 banks of B1
        new_rows, up_rows = gen.sample(31_728), gen.sample(1_024)
        for s in range(0, len(new_rows), 1024):
            leader.insert(new_rows[s : s + 1024])
        leader.delete(del_ids)
        leader.upsert(up_ids, up_rows)
        t0 = time.perf_counter()
        grp.maintenance_tick()
        ship_s = time.perf_counter() - t0
        Qc = torch.from_numpy(Q[:1024]).cuda()

        def converged(what):
            ld, li = rep.leader.snapshot().search(Qc, k)
            for j, f in enumerate(rep.followers):
                if rep.staleness(j) != 0:
                    raise AssertionError(f"{what}: follower {f.name} lags {rep.staleness(j)}")
                fd, fi = f.index.snapshot().search(Qc, k)
                if not (np.array_equal(ld, fd) and np.array_equal(li, fi)):
                    raise AssertionError(f"{what}: follower {f.name} at the leader's record "
                                         "count does not answer as the leader")

        converged("after the churn")
        # the floor: a record the followers lack keeps reads on the leader
        rep.seal_bytes = 1 << 40
        leader.insert(gen.sample(16))
        grp.maintenance_tick()
        lag = [grp.router.staleness(r) for r in range(3)]
        landed = []
        for s in range(0, 1024, 128):
            grp.submit("m", Q[s : s + 128], k)
            landed.append(grp._flights[-1].replica)
        grp.run_until_idle()
        if lag[1:] != [1, 1] or set(landed) != {0}:
            raise AssertionError(f"staleness {lag}, requests landed on {landed}")
        rep.seal_bytes = 1
        grp.maintenance_tick()
        converged("after the floor")
        snap = rep.followers[0].index.snapshot()
        if int(snap.delta_bf.size) != 32_768:
            raise AssertionError(f"the followers' delta holds {snap.delta_bf.size} rows")
        da = delta_args(snap, Qc)
        kv, ks = run_flat(da, k, snap.metric)
        rv, rs = run_flat(da, k, snap.metric, reference=True)
        if not (torch.equal(kv, rv) and torch.equal(ks, rs)):
            raise AssertionError("B1's delta launch on a follower is not its plain version's bits")
        # served: the backlog over leader and followers
        b1.launches = 0
        scans0 = dict(obs.registry().as_dict()["counters"])
        obs.enable()
        got, secs = replica_backlog(grp, "m", Q, sizes, k)
        counters = obs.registry().as_dict()["counters"]
        obs.disable()
        delta_scans = counters.get('mutable.delta.scans{mode="fused"}', 0.0) - scans0.get(
            'mutable.delta.scans{mode="fused"}', 0.0)
        bad = [r for r in got if isinstance(r, BaseException)]
        ids = np.concatenate([r.indices for r in got if not isinstance(r, BaseException)])
        if (bad or (ids < 0).any() or np.isin(ids, del_ids).any() or b1.launches <= 0
                or delta_scans <= 0):
            raise AssertionError(f"replicated mutable backlog: {len(bad)} errors, B1 "
                                 f"{b1.launches} launches")
        mutable_serve = dict(qps=nq / secs, b1_launches=b1.launches,
                             b1_launches_delta=delta_scans, **lat(got))
        out["launches"]["mutable"] = b1.launches
        # a compaction flip on the leader: the followers rebase on it
        t0 = time.perf_counter()
        leader.compact()
        flip_compact_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        grp.maintenance_tick()
        sync_s = time.perf_counter() - t0
        gens = [f.index.generation for f in rep.followers]
        if gens != [2, 2] or leader.generation != 2:
            raise AssertionError(f"followers at generations {gens}, leader {leader.generation}")
        converged("after the flip")
        emit(card, phase="replica", metric="replicated_mutable", rows=n, followers=2,
             leader_load_s=load_s, follower_load_s=follower_load_s, churn_ship_s=ship_s,
             staleness_floor=lag, floor_landed=sorted(set(landed)),
             delta_launch_torch_equal=True, flip_compact_s=flip_compact_s,
             follower_sync_s=sync_s, generations=gens, **mutable_serve)
        out["mutable"] = dict(mutable_serve, follower_sync_s=sync_s, staleness_floor=lag)

        # ---- (d) election -------------------------------------------------
        clk = [0.0]
        store = LeaseStore(os.path.join(tmp, "lease"), ttl_s=1.0, clock=lambda: clk[0])
        cp = ControlPlane(rep, store, root_dir=os.path.join(tmp, "cp"), clock=lambda: clk[0])
        grp.maintenance_tick()
        old = rep.leader
        old.insert(gen.sample(256))
        wire["down"] = True  # f0 misses the tail: f1's cursor is ahead
        grp.maintenance_tick()
        cursors = [f.position.as_dict() for f in rep.followers]
        election = {}

        def kill_leader(i):
            if i == len(sizes) // 3:
                cp.kill_leader()
                clk[0] += 2.0  # the dead leader's lease runs out
                t0 = time.perf_counter()
                grp.maintenance_tick()  # the election and the promotion
                election["elect_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                grp.maintenance_tick()  # the rebased followers catch up
                election["converge_s"] = time.perf_counter() - t0
            grp.step()

        got, secs = replica_backlog(grp, "m", Q, sizes, k, on_submit=kill_leader)
        bad = [r for r in got if isinstance(r, BaseException)]
        if bad or cp.elections != 1 or cp.leader_name != "f1" or cp.epoch != 2:
            raise AssertionError(f"election: {len(bad)} caller errors, {cp.elections} elections, "
                                 f"leader {cp.leader_name}, epoch {cp.epoch}")
        wire["down"] = False
        grp.maintenance_tick()
        converged("after the election")
        f = rep.followers[0]
        try:
            f.apply(f.position.segment, f.position.offset, b"stale", epoch=1)
            raise AssertionError("a frame of the deposed leader's epoch was accepted")
        except FencedError:
            pass
        election.update(leader_rows=int(rep.leader.size), cursors=cursors,
                        followers=[x.name for x in rep.followers], qps=nq / secs)
        emit(card, phase="replica", metric="election", **election)
        out["election"] = election
        grp.shutdown()
        for x in [rep.leader, old]:
            x.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- (e) the flight recorder --------------------------------------------
    bdir = tempfile.mkdtemp(prefix="bundles_")
    try:
        obs.registry().reset()
        obs.enable()
        r = recorder.install(bdir, triggers=("slo",), min_dump_interval_s=300.0)
        eng = engine()
        eng.register("flat", "ivf_flat", index, params=params)
        r.attach_engine(eng)
        eng.set_slo("flat", latency_ms=1.0, target=0.9, burn_threshold=2.0)
        got, _ = replica_backlog(eng, "flat", Q, sizes, k)
        bundles = recorder.list_bundles(bdir)
        if len(bundles) != 1:
            raise AssertionError(f"the SLO drill wrote {len(bundles)} bundles, not one")
        bundle = recorder.load_bundle(bundles[0])
        if bundle["trigger"]["cause"] != "slo" or not eng.health()["indexes"]["flat"]["slo"][
                "alerting"]:
            raise AssertionError(f"bundle trigger {bundle['trigger']}")
        size = os.path.getsize(bundles[0])
        r.out_dir = os.path.join(bdir, "timed")
        t0 = time.perf_counter()
        timed = r.dump()
        write_s = time.perf_counter() - t0
        obs.disable()
        got_off, _ = replica_backlog(eng, "flat", Q, sizes, k)
        same_served("obs off with a recorder installed", got_off, base)
        rec = dict(bundles=1, bundle_bytes=size, cause="slo", events=len(bundle["events"]),
                   series=len(bundle["series"]["series"]), manual_dump_bytes=os.path.getsize(timed),
                   manual_dump_s=write_s, obs_off_bit_equal=True)
        emit(card, phase="replica", metric="flight_recorder", **rec)
        out["recorder"] = rec
    finally:
        recorder.uninstall()
        obs.disable()
        obs.registry().reset()
        shutil.rmtree(bdir, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(card, phase="replica", metric="replica_phase_s", value=out["phase_s"])
    return out


def backlog(eng, index_id, Q, sizes, k, on_submit=None):
    """Queue every request of ``sizes`` rows of ``Q``, drain, and return
    the futures and the seconds (host clock, ending when every future is
    done). ``on_submit(i)`` runs after the i-th submission."""
    starts = np.cumsum([0] + list(sizes[:-1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = []
    for i, (s, m) in enumerate(zip(starts, sizes)):
        futs.append(eng.submit(index_id, Q[s : s + m], k))
        if on_submit is not None:
            on_submit(i)
    eng.run_until_idle()
    for f in futs:
        f.exception()
    return futs, time.perf_counter() - t0


def backlog_batches(sizes, max_batch: int = 128) -> list:
    """The micro-batches ``MicroBatcher`` forms from a backlog of one group
    (every request queued before the first batch): the oldest request,
    then every later one that still fits, up to ``max_batch`` rows. Lists
    of request positions."""
    queue, out = list(range(len(sizes))), []
    while queue:
        batch, rows = [], 0
        for r in queue:
            if rows + sizes[r] <= max_batch:
                batch.append(r)
                rows += sizes[r]
        queue = [r for r in queue if r not in set(batch)]
        out.append(batch)
    return out


def check_served_batches(what: str, Q, sizes, results, search, device="cuda") -> int:
    """Hold each micro-batch of a served backlog (:func:`backlog_batches`)
    ``torch.equal`` (ids and distance bits) to ``search`` of the same
    zero-padded batch. Returns the number of batches."""
    starts = np.cumsum([0] + list(sizes[:-1]))
    batches = backlog_batches(sizes)
    for b, batch in enumerate(batches):
        q = np.concatenate([Q[starts[r] : starts[r] + sizes[r]] for r in batch])
        rows = q.shape[0]
        if any(results[r].batch_rows != rows for r in batch):
            raise AssertionError(f"{what}: the engine formed other batches than the batcher's")
        padded = torch.zeros((results[batch[0]].bucket, q.shape[1]), device=device)
        padded[:rows] = torch.from_numpy(q).to(device)
        d, ids = search(padded)
        got_i = np.concatenate([results[r].indices for r in batch])
        got_d = np.concatenate([results[r].distances for r in batch])
        if not (np.array_equal(got_i, ids[:rows].cpu().numpy())
                and np.array_equal(got_d.view(np.int32), d[:rows].cpu().numpy().view(np.int32))):
            raise AssertionError(f"{what}: served batch {b} is not bit-equal to the search of "
                                 "the same padded batch")
    return len(batches)


def served_degraded(results, n: int):
    """Ids and the share of empty slots of served results that may hold
    fewer than k neighbours (a shard left out): fails unless every slot is
    a valid id at a finite distance or ``-1`` at ``inf``, ascending, the
    empty slots last."""
    ids = np.concatenate([r.indices for r in results])
    dist = np.concatenate([r.distances for r in results])
    empty = ids < 0
    if not ((ids < n).all() and np.isfinite(dist[~empty]).all() and np.isinf(dist[empty]).all()
            and (dist[:, 1:] >= dist[:, :-1]).all()):
        raise AssertionError("served results are not valid ascending neighbours and empty slots")
    return ids, float(empty.mean())


def span_tree(spans) -> list:
    """``[name, depth, count]`` of each distinct span of one dispatch."""
    tree = {}
    for sp in spans:
        key = (sp["name"], sp["depth"])
        tree[key] = tree.get(key, 0) + 1
    return [[name, depth, count] for (name, depth), count in
            sorted(tree.items(), key=lambda kv: (kv[0][1], kv[0][0]))]


def robust_phase(card, res, index, pq_index, cg, X_card, Q, gt_i, k: int, sizes) -> dict:
    """Phase 9: robustness in serving at full width (:func:`run_phases`'s
    ``robust`` part). Phase 7's lists-sharded IVF-Flat (``index``, 1M x
    128, over ``make_mesh(["cuda:0"] * 4)``, ``n_probes=20``) served as
    ``sharded_ivf_flat`` with ``merge_mode="ring"`` (B6 a batch), the
    request backlog of phase 3 (``sizes``):

    (a) all healthy: coverage 1.0, not degraded, every batch bit-equal to
        ``sharded_ivf_flat_search(merge_mode="ring")`` of the same padded
        batch, B6 launched once a batch;
    (b) shard 2 down (``sharded_ann.shard_scan`` raises ``ShardFailure``
        for it): coverage 0.75, degraded, ``failed_shards == (2,)``, every
        batch bit-equal to the search with ``health=(T, T, F, T)``, no id
        of shard 2's lists, B6 once a batch, recall@10 reported;
    (c) shard 1 slow (a 0.3 s latency spec against ``slow_shard_s`` 0.25):
        shard 1 left out, ``serve.slow_shards`` counts it;
    (d) a registration with ``min_coverage=0.9`` under (b)'s spec: every
        future fails with ``ShardFailure``, the next registration's batch
        is served;
    (e) ``pallas.pq_scan`` on phase 4's IVF-PQ (``pq_index``, 8x refine)
        and ``pallas.cagra_search`` on phase 6's CAGRA (``cg``) with
        ``KernelFailure``: the batch's futures fail typed with no launch,
        ``serve.dispatch_errors`` counts them, the next batch is served
        ``torch.equal`` to an uninjected search, and an explicit
        ``mode="fused"`` search raises;
    (f) obs off against on: the IVF-Flat and sharded backlogs' QPS, in
        turns, and the span tree of one 128-row dispatch of each;
    (g) ``health()`` as one JSON line.

    Returns the B6 launches of the degraded backlogs."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.core.errors import KernelFailure, ShardFailure
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import cagra_search, pq_scan
    from raft_tpu_torch.ops import ring_topk as rt
    from raft_tpu_torch.parallel import make_mesh, sharded_ivf_flat_search
    from raft_tpu_torch.robust import faults
    from raft_tpu_torch.serve import ServingEngine
    from raft_tpu_torch.stats.recall import neighborhood_recall

    mesh = make_mesh(["cuda:0"] * 4)
    dev = X_card.device
    nq, n = Q.shape[0], index.size
    params = ivf_flat.IvfFlatSearchParams(n_probes=20)
    serve_pq = dataclasses.replace(ivf_pq.IvfPqSearchParams(n_probes=30), fused_qt=SERVE_QT_PQ)
    cp = cagra.CagraSearchParams(itopk_size=128, search_width=8, dedup="post",
                                 init_sample=SERVE_INIT_SAMPLE)
    eng = ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=nq, res=res)
    eng.register("sharded", "sharded_ivf_flat", index, params=params, mesh=mesh,
                 merge_mode="ring")
    eng.register("floor", "sharded_ivf_flat", index, params=params, mesh=mesh,
                 merge_mode="ring", min_coverage=0.9)
    eng.register("flat", "ivf_flat", index, params=dataclasses.replace(params,
                                                                       fused_qt=SERVE_QT))
    eng.register("pq", "ivf_pq", pq_index, params=serve_pq, dataset=X_card)
    eng.register("cagra", "cagra", cg, params=cp)
    for index_id in ("sharded", "flat", "pq", "cagra"):
        eng.warmup(index_id, k)
    out = {}

    def sharded_backlog(step: str, health=None):
        rt.fused_ring_topk.launches = 0
        futs, secs = backlog(eng, "sharded", Q, sizes, k)
        launches = rt.fused_ring_topk.launches
        results = [f.result() for f in futs]
        ids, empty = served_degraded(results, n)
        n_batches = check_served_batches(
            f"robust ({step})", Q, sizes, results,
            lambda q: sharded_ivf_flat_search(mesh, index, q, k, params, merge_mode="ring",
                                              health=health), dev)
        recall = neighborhood_recall(torch.from_numpy(ids), gt_i)
        emit(card, phase="robust", step=step, metric="sharded_backlog", qps=nq / secs,
             recall=recall, empty_slots=empty, batches=n_batches, b6_launches=launches,
             coverage=sorted({r.coverage for r in results}),
             degraded=sorted({r.degraded for r in results}),
             failed_shards=sorted({r.failed_shards for r in results}))
        if launches != n_batches:
            raise AssertionError(f"robust ({step}): B6 launched {launches} times over "
                                 f"{n_batches} batches")
        return results, ids, recall, launches

    # (a) all healthy
    results, _, healthy_recall, _ = sharded_backlog("a_all_healthy")
    served(results, n)  # all healthy: k valid neighbours a row
    if any(r.coverage != 1.0 or r.degraded or r.failed_shards for r in results):
        raise AssertionError("robust (a): an all-healthy batch reported degraded coverage")

    # (b) shard 2 down
    l_local = index.n_lists // mesh.size
    shard2 = index.list_indices[2 * l_local:3 * l_local].reshape(-1)
    shard2 = shard2[shard2 >= 0]
    with faults.injected("sharded_ann.shard_scan", error=ShardFailure("chaos", shard=2),
                         match={"shard": 2}):
        results, ids, recall, out["b6_launches"] = sharded_backlog(
            "b_shard_2_down", health=(True, True, False, True))
    if any(r.coverage != 0.75 or not r.degraded or r.failed_shards != (2,) for r in results):
        raise AssertionError("robust (b): a batch without shard 2 did not report coverage "
                             "0.75, degraded, failed_shards (2,)")
    lost = int(torch.isin(torch.from_numpy(ids).to(dev).long(), shard2.long()).sum())
    emit(card, phase="robust", step="b_shard_2_down", metric="recall@10", value=recall,
         all_healthy=healthy_recall, ids_of_shard_2=lost, shard_2_rows=int(shard2.numel()),
         queries_without_a_neighbour=float((ids < 0).all(axis=1).mean()))
    if lost:
        raise AssertionError(f"robust (b): {lost} ids of shard 2's lists were served")

    # (c) shard 1 slow; (d) a coverage floor; (e) kernel seams: read from obs
    obs.registry().reset()
    obs.enable()
    try:
        slow = sizes[:8]
        with faults.injected("sharded_ann.shard_scan", latency_s=0.3, match={"shard": 1}):
            futs, secs = backlog(eng, "sharded", Q, slow, k)
        results = [f.result() for f in futs]
        counters = obs.registry().as_dict()["counters"]
        slow_count = counters.get('serve.slow_shards{index_id="sharded",shard="1"}', 0.0)
        emit(card, phase="robust", step="c_shard_1_slow", metric="slow_shard",
             requests=len(slow), seconds=secs, slow_shard_s=eng.slow_shard_s,
             failed_shards=sorted({r.failed_shards for r in results}), slow_shards=slow_count)
        if any(r.failed_shards != (1,) or r.coverage != 0.75 for r in results) or not slow_count:
            raise AssertionError("robust (c): the slow shard 1 was not left out and counted")

        with faults.injected("sharded_ann.shard_scan", error=ShardFailure("chaos", shard=2),
                             match={"shard": 2}):
            floor_futs, _ = backlog(eng, "floor", Q, sizes[:6], k)
            next_futs, _ = backlog(eng, "sharded", Q, sizes[6:8], k)
        errors = [type(f.exception()).__name__ for f in floor_futs]
        nxt = [f.result() for f in next_futs]
        emit(card, phase="robust", step="d_below_the_floor", metric="min_coverage",
             min_coverage=0.9, errors=errors, next_registration_coverage=[r.coverage for r in nxt])
        if (any(not isinstance(f.exception(), ShardFailure) for f in floor_futs)
                or any(r.coverage != 0.75 for r in nxt)):
            raise AssertionError(f"robust (d): futures under the floor ended {errors}, the "
                                 f"next registration's coverage {[r.coverage for r in nxt]}")

        seams = (("pq", "pallas.pq_scan", pq_scan.fused_pq_topk, 128,
                  lambda q, mode, qb: ivf_pq.search(pq_index, q, k, serve_pq, query_batch=qb,
                                                    mode=mode, dataset=X_card)),
                 ("cagra", "pallas.cagra_search", cagra_search.cagra_fused_search, 37,
                  lambda q, mode, qb: cagra.search(cg, q, k, cp, query_batch=qb, mode=mode)))
        for index_id, point, kernel, rows, search in seams:
            q = Q[:rows]
            kernel.launches = 0
            with faults.injected(point, error=KernelFailure("chaos")):
                failed, _ = backlog(eng, index_id, q, [rows], k)
                failed_launches = kernel.launches
                try:
                    search(torch.from_numpy(q).to(dev), "fused", rows)
                    explicit = "served"
                except KernelFailure:
                    explicit = "KernelFailure"
            kernel.launches = 0
            ok, _ = backlog(eng, index_id, q, [rows], k)
            ok_launches = kernel.launches
            res_ok = ok[0].result()
            bucket = res_ok.bucket
            padded = torch.zeros((bucket, q.shape[1]), device=dev)
            padded[:rows] = torch.from_numpy(q).to(dev)
            d, ids = search(padded, "auto", bucket)
            equal = (np.array_equal(res_ok.indices, ids[:rows].cpu().numpy())
                     and np.array_equal(res_ok.distances.view(np.int32),
                                        d[:rows].cpu().numpy().view(np.int32)))
            counters = obs.registry().as_dict()["counters"]
            errs = counters.get(f'serve.dispatch_errors{{index_id="{index_id}",'
                                f'kind="KernelFailure"}}', 0.0)
            emit(card, phase="robust", step="e_kernel_seam", point=point, index_id=index_id,
                 rows=rows, error=type(failed[0].exception()).__name__,
                 launches_while_failing=failed_launches, dispatch_errors=errs,
                 next_batch_launches=ok_launches, next_batch_equal=equal,
                 explicit_fused=explicit)
            if not (isinstance(failed[0].exception(), KernelFailure) and failed_launches == 0
                    and errs == 1.0 and ok_launches > 0 and equal
                    and explicit == "KernelFailure"):
                raise AssertionError(f"robust (e) at {point}: the failed batch, its count, the "
                                     "next batch or the explicit fused search is wrong")
    finally:
        obs.disable()
        obs.registry().reset()

    # (f) obs off against on, in turns: off / on / on / off
    qps = {("flat", False): [], ("flat", True): [], ("sharded", False): [],
           ("sharded", True): []}
    for on in (False, True, True, False):
        obs.enable(on)
        for index_id in ("flat", "sharded"):
            futs, secs = backlog(eng, index_id, Q, sizes, k)
            for f in futs:
                f.result()
            qps[index_id, on].append(nq / secs)
        obs.registry().reset()
    trees = {}
    obs.enable()
    try:
        for index_id in ("flat", "sharded"):
            obs.registry().reset()
            futs, _ = backlog(eng, index_id, Q, [128], k)
            futs[0].result()
            trees[index_id] = span_tree(obs.registry().spans())
    finally:
        obs.disable()
        obs.registry().reset()
    for index_id in ("flat", "sharded"):
        emit(card, phase="robust", step="f_overhead", metric="backlog_qps", index_id=index_id,
             obs_off=qps[index_id, False], obs_on=qps[index_id, True],
             on_over_off=float(np.mean(qps[index_id, True]) / np.mean(qps[index_id, False])),
             dispatch_span_tree=trees[index_id])

    # (g) health
    emit(card, phase="robust", step="g_health", metric="health", value=eng.health())
    return out


def device_nbytes(index, device_type: str = "cuda") -> int:
    """Sum of ``nbytes`` over the tensors on ``device_type`` reachable from ``index``'s
    attributes (dicts, lists and objects followed), each allocation counted
    once (a view of an allocation already seen adds nothing), leaving out
    the per-shard copies a sharded search keeps (``_shard_cache``, phase 7's
    mesh): what ``hbm_model.residency_for_index`` must equal less its
    ``shard_copies``."""
    seen, total = set(), 0

    def walk(obj):
        nonlocal total
        if isinstance(obj, torch.Tensor):
            key = (obj.device, obj.untyped_storage().data_ptr())
            if obj.device.type == device_type and key not in seen:
                seen.add(key)
                total += obj.nbytes
            return
        if id(obj) in seen or isinstance(obj, (str, bytes, int, float, bool, type(None))):
            return
        seen.add(id(obj))
        if isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)
        elif hasattr(obj, "__dict__"):
            for name, v in vars(obj).items():
                if name != "_shard_cache":
                    walk(v)

    walk(index)
    return total


def fetch_stats(snap) -> dict:
    """The host tier's counters and fetch-time histogram (mean, and the
    upper bound of the bucket holding the median) from an obs snapshot."""
    c = snap["counters"]
    out = {name: c.get(f"tiered.fetch.{name}", 0.0)
           for name in ("rows", "bytes", "dedup_rows", "readahead_ranges")}
    h = snap["histograms"].get("tiered.fetch_ms")
    if h and h["count"]:
        cum, half = np.cumsum(h["counts"]), h["count"] / 2.0
        i = int(np.searchsorted(cum, half))
        out.update(fetch_ms_mean=h["sum"] / h["count"], fetches=h["count"],
                   fetch_ms_median_bucket=(h["buckets"] + [float("inf")])[i])
    out["overlap_efficiency"] = snap["gauges"].get("tiered.overlap_efficiency")
    return out


def with_obs(fn):
    """``fn()`` with obs on and an empty registry; returns ``(result, the
    registry's snapshot)`` and leaves obs off."""
    from raft_tpu_torch import obs

    obs.registry().reset()
    obs.enable()
    try:
        out = fn()
        return out, obs.registry().as_dict()
    finally:
        obs.disable()
        obs.registry().reset()


def tiered_phase(card, res, index, pq_index, cg, X, X_card, Q, gt_i, k: int, sizes,
                 mem: dict, ptxas: dict) -> dict:
    """Phase 10: placement and planning at full width (:func:`run_phases`'s
    ``tiered``), on phase 3's IVF-Flat, phase 4's IVF-PQ and phase 6's
    CAGRA indexes and the 10,000 queries; builds nothing new.

    (a) The device-memory model: ``residency_for_index`` of each index (the
    CAGRA one after a fused search, with its table and seeds) equal to the
    sum of ``nbytes`` of its CUDA tensors, printed beside
    ``torch.cuda.memory_allocated()`` around its build (``mem``) and the
    card's memory beside ``HBM_DEFAULT_BUDGET_BYTES``.
    (b) IVF-PQ spilled: registered under an ``hbm_budget_bytes`` between its
    scan components plus a staging slab and that plus the 1M raw rows
    (from ``residency_for_index``), so ``raw_vectors`` goes to the host
    (``serve.tiered_degrades`` 1); served one request at a time and as a
    backlog, each batch ``torch.equal`` to the resident ``ivf_pq.search(...,
    dataset=X_card)`` of the same padded batch, B2 launched; the tiered and
    resident backlogs' QPS in turns, recall@10, the fetch counters and time,
    the tiered backlog's device busy share.
    (c) The mmap tier: the raw rows saved with ``HostVectorStore.save`` and
    mapped; a ``TieredIndex`` over IVF-PQ (B2) and one over IVF-Flat (B1)
    equal to the resident search of the same micro-batches, read-ahead
    ranges, fetch time and overlap efficiency; the IVF-PQ one again over the
    mapped file without read-ahead and over the rows in host RAM.
    (d) The ``host.fetch`` seam: injected latency leaves the results alone;
    a permanent failure fails the served batch's futures with
    ``HostFetchError`` and the next batch is served.
    (e) The planner: ``plan_explain`` of each served registration; for
    buckets 1-128 its IVF-Flat and IVF-PQ choice against the inline rule,
    each engine (probe, fused) timed at each bucket beside the choice;
    serving with ``RAFT_TPU_PLAN=0`` and ``1`` bit-equal.
    (f) The shared-memory model: each kernel's ``smem_model`` total at the
    main path's shapes equal to its ``*_smem_bytes`` export, printed with
    the ``ptxas`` register lines of its build.

    Returns B1's and B2's launches in this phase."""
    import tempfile

    from raft_tpu_torch import plan
    from raft_tpu_torch.core.errors import HostFetchError
    from raft_tpu_torch.neighbors import ivf_common, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import hbm_model, ivf_scan, pq_scan, smem_model
    from raft_tpu_torch.ops import ring_topk as rt
    from raft_tpu_torch.robust import faults
    from raft_tpu_torch.serve import ServingEngine
    from raft_tpu_torch.stats.recall import neighborhood_recall
    from raft_tpu_torch.tiered import HostVectorStore, TieredIndex

    t_phase = time.perf_counter()
    n, d = X.shape
    dev = X_card.device
    Qt = torch.from_numpy(Q).to(dev)
    starts = np.cumsum([0] + list(sizes[:-1]))
    b1, b2 = ivf_scan.fused_list_topk, pq_scan.fused_pq_topk
    b1.launches = b2.launches = 0
    launches = {}

    # (a) the device-memory model against the card
    total = torch.cuda.get_device_properties(0).total_memory
    emit(card, phase="tiered", metric="device_memory", total_memory=total,
         hbm_default_budget_bytes=hbm_model.HBM_DEFAULT_BUDGET_BYTES,
         allocated=torch.cuda.memory_allocated())
    for name, algo, idx in (("ivf_flat", "ivf_flat", index), ("ivf_pq", "ivf_pq", pq_index),
                            ("cagra", "cagra", cg)):
        r = hbm_model.residency_for_index(name, algo, idx)
        walked = device_nbytes(idx, dev.type)
        copies = sum(c.nbytes for c in r.components if c.name == "shard_copies")
        emit(card, phase="tiered", metric="residency", index=name, model_bytes=r.total_bytes,
             tensor_nbytes=walked, shard_copies=copies, required_bytes=r.required_bytes,
             components={c.name: c.nbytes for c in r.components},
             allocated_before_build=mem.get(name, (None, None))[0],
             allocated_after_build=mem.get(name, (None, None))[1])
        if r.total_bytes - copies != walked:
            raise AssertionError(f"residency_for_index({name}) {r.total_bytes - copies} B != "
                                 f"the index's CUDA tensors' {walked} B")
    if "neighbor_table" not in {c.name for c in hbm_model.residency_for_index(
            "cagra", "cagra", cg).components}:
        raise AssertionError("the CAGRA index holds no neighbour table: no fused search ran")

    # (b) IVF-PQ spilled to the host tier, served both ways
    pq_params = ivf_pq.IvfPqSearchParams(n_probes=30, fused_qt=SERVE_QT_PQ)
    r = hbm_model.residency_for_index("sift1m_pq_tiered", "ivf_pq", pq_index, refine_rows=n)
    _, stage_dev = hbm_model.staging_footprint(d)
    budget = int((r.required_bytes + stage_dev + r.optional_bytes // 2) / hbm_model.HBM_HEADROOM)

    def resident_search(q):
        return ivf_pq.search(pq_index, q, k, pq_params, query_batch=q.shape[0], dataset=X_card)

    res_eng = ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=len(Q), res=res)
    res_eng.register("pq", "ivf_pq", pq_index, params=pq_params, dataset=X_card)
    res_eng.warmup("pq", k)
    t_eng = ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=len(Q), res=res,
                          hbm_budget_bytes=budget)
    _, snap = with_obs(lambda: t_eng.register("pq", "ivf_pq", pq_index, params=pq_params,
                                              dataset=X_card))
    degrades = snap["counters"].get('serve.tiered_degrades{algo="ivf_pq",index_id="pq"}', 0.0)
    placement = t_eng.placement
    emit(card, phase="tiered", metric="placement", hbm_budget_bytes=budget,
         required_bytes=r.required_bytes, raw_vectors_bytes=r.optional_bytes,
         staging_device_bytes=placement.staging_device_bytes,
         staging_host_bytes=placement.staging_host_bytes,
         raw_vectors_tier=placement.tier("pq", "raw_vectors"), tiered_degrades=degrades,
         table=placement.table().splitlines())
    if placement.tier("pq", "raw_vectors") != "host" or degrades != 1.0:
        raise AssertionError(f"the budget {budget} B did not spill raw_vectors to the host "
                             f"({placement.tier('pq', 'raw_vectors')}, degrades {degrades})")
    t_eng.warmup("pq", k)
    b2.launches = 0
    one = []
    t0 = time.perf_counter()
    for s, m in zip(starts, sizes):
        fut = t_eng.submit("pq", Q[s : s + m], k)
        t_eng.step(force=True)
        one.append(fut.result())
    one_s = time.perf_counter() - t0
    for r_, s, m in zip(one, starts, sizes):
        padded = torch.zeros((r_.bucket, d), device=dev)
        padded[:m] = Qt[s : s + m]
        dv, iv = resident_search(padded)
        if not (np.array_equal(r_.indices, iv[:m].cpu().numpy())
                and np.array_equal(r_.distances.view(np.int32),
                                   dv[:m].cpu().numpy().view(np.int32))):
            raise AssertionError("a tiered request served alone is not bit-equal to the "
                                 "resident search of its padded batch")
    qps = {"tiered_one_client": len(Q) / one_s}
    b2_tiered = b2.launches
    runs = {}
    for which, eng in (("resident", res_eng), ("tiered", t_eng), ("tiered", t_eng),
                       ("resident", res_eng)):
        before = b2.launches
        futs, secs = backlog(eng, "pq", Q, sizes, k)
        runs.setdefault(which, []).append(len(Q) / secs)
        if which == "tiered":
            b2_tiered += b2.launches - before
            results = [f.result() for f in futs]
    batches = check_served_batches("tiered IVF-PQ backlog", Q, sizes, results, resident_search,
                                   dev)
    (futs, _), snap = with_obs(lambda: backlog(t_eng, "pq", Q, sizes, k))
    tiered_results = [f.result() for f in futs]
    check_served_batches("tiered IVF-PQ backlog (obs on)", Q, sizes, tiered_results,
                         resident_search, dev)
    ids, _, _ = served(tiered_results, n)
    busy = profile_backlog(card, t_eng, "pq", Q, starts, sizes, k, None, phase="tiered")
    emit(card, phase="tiered", metric="tiered_serve", one_client_qps=qps["tiered_one_client"],
         backlog_qps_resident=runs["resident"], backlog_qps_tiered=runs["tiered"],
         tiered_over_resident=float(np.median(runs["tiered"]) / np.median(runs["resident"])),
         recall=neighborhood_recall(torch.from_numpy(ids), gt_i),
         batches_bit_equal=batches, requests_bit_equal=len(one), b2_launches=b2_tiered,
         busy_share=busy, **fetch_stats(snap))
    if b2_tiered <= 0:
        raise AssertionError("tiered IVF-PQ serving never launched fused_pq_topk")
    launches["fused_pq_topk"] = b2_tiered

    # (c) the mmap tier under a TieredIndex, IVF-PQ (B2) and IVF-Flat (B1)
    mb = 1024
    flat_params = ivf_flat.IvfFlatSearchParams(n_probes=20, fused_qt=SERVE_QT, refine_ratio=8)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sift1m_vectors.bin")
        t0 = time.perf_counter()
        HostVectorStore.save(path, X)
        save_s = time.perf_counter() - t0
        store = HostVectorStore.open(path, mmap=True)
        for name, algo, idx, sp, search, kernel in (
                ("ivf_pq", "ivf_pq", pq_index, pq_params, ivf_pq.search, b2),
                ("ivf_flat", "ivf_flat", index, flat_params, ivf_flat.search, b1)):
            ti = TieredIndex(algo, idx, store, refine_ratio=8, micro_batch=mb, search_params=sp)
            kernel.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (got, snap) = with_obs(lambda: ti.search(Qt, k))
            torch.cuda.synchronize()
            tiered_s = time.perf_counter() - t0
            kl = kernel.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = [search(idx, Qt[s : s + mb], k, sp, query_batch=mb, dataset=X_card)
                    for s in range(0, len(Q), mb)]
            torch.cuda.synchronize()
            resident_s = time.perf_counter() - t0
            want = (torch.cat([w[0] for w in want]), torch.cat([w[1] for w in want]))
            if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
                raise AssertionError(f"the mmap TieredIndex over {name} is not bit-equal to the "
                                     "resident search of the same micro-batches")
            if kl <= 0:
                raise AssertionError(f"the TieredIndex over {name} never launched its kernel")
            launches[kernel.__name__] = launches.get(kernel.__name__, 0) + kl
            emit(card, phase="tiered", metric="tiered_index_mmap", index=name, micro_batch=mb,
                 queries=len(Q), seconds=tiered_s, resident_seconds=resident_s,
                 qps=len(Q) / tiered_s, resident_qps=len(Q) / resident_s, launches=kl,
                 recall=neighborhood_recall(got[1], gt_i), bit_equal=True, save_s=save_s,
                 file_bytes=os.path.getsize(path), **fetch_stats(snap))
            if name == "ivf_pq":
                want_pq = want
        # the same IVF-PQ search over the mapped file without read-ahead
        # hints, and over the rows in host RAM
        counts = (b1.launches, b2.launches)
        for label, other in (("mmap_no_readahead", HostVectorStore.open(path, readahead=False)),
                             ("host_ram", HostVectorStore(X))):
            ti = TieredIndex("ivf_pq", pq_index, other, refine_ratio=8, micro_batch=mb,
                             search_params=pq_params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, snap = with_obs(lambda: ti.search(Qt, k))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if not (torch.equal(got[1], want_pq[1]) and torch.equal(got[0], want_pq[0])):
                raise AssertionError(f"the TieredIndex over IVF-PQ ({label}) is not bit-equal to "
                                     "the resident search")
            emit(card, phase="tiered", metric="tiered_index_store", index="ivf_pq", store=label,
                 micro_batch=mb, queries=len(Q), seconds=secs, qps=len(Q) / secs,
                 bit_equal=True, **fetch_stats(snap))
        b1.launches, b2.launches = counts
        del store, other, ti

    # (d) the host.fetch seam: latency, then a permanent failure in serving
    ti = TieredIndex("ivf_pq", pq_index, HostVectorStore(X), refine_ratio=8, micro_batch=mb,
                     search_params=pq_params)
    want = ti.search(Qt[:2048], k)
    with faults.injected("host.fetch", latency_s=0.005):
        got = ti.search(Qt[:2048], k)
    if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
        raise AssertionError("injected host.fetch latency changed the tiered results")
    with faults.injected("host.fetch", error=OSError("host tier lost")):
        futs = [t_eng.submit("pq", Q[s : s + m], k) for s, m in zip(starts[:4], sizes[:4])]
        t_eng.step(force=True)
    failed = [f for f in futs if f.done() and isinstance(f.exception(), HostFetchError)]
    t_eng.run_until_idle()
    after = [f.result() for f in futs if f not in failed]
    fut = t_eng.submit("pq", Q[:37], k)
    t_eng.run_until_idle()
    nxt = fut.result()
    padded = torch.zeros((nxt.bucket, d), device=dev)
    padded[:37] = Qt[:37]
    dv, iv = resident_search(padded)
    emit(card, phase="tiered", metric="host_fetch_seam", latency_results_equal=True,
         failed_futures=len(failed), served_after=len(after) + 1)
    if not failed or not np.array_equal(nxt.indices, iv[:37].cpu().numpy()):
        raise AssertionError("a permanent host.fetch failure did not fail its batch with "
                             "HostFetchError, or the next batch was not served")

    # (e) the planner: explain, the inline rule, each engine's time a bucket
    for label, eng in (("resident", res_eng), ("tiered", t_eng)):
        emit(card, phase="tiered", metric="plan_explain", registration=label,
             bucket_modes=dict(eng._indexes["pq"].plan.bucket_modes),
             explain=eng.plan_explain("pq").splitlines())
    flat_serve = dataclasses.replace(flat_params, refine_ratio=1)
    per_bucket = []
    for algo, idx, sp, search, fused_ok in (
            ("ivf_flat", index, flat_serve, ivf_flat.search, True),
            ("ivf_pq", pq_index, pq_params, ivf_pq.search, True)):
        for b in bucket_sizes_to(128):
            os.environ["RAFT_TPU_PLAN"] = "1"
            planned = ivf_common.auto_search_mode(idx.device, b, fused_ok, algo=algo)
            os.environ["RAFT_TPU_PLAN"] = "0"
            inline = ivf_common.auto_search_mode(idx.device, b, fused_ok, algo=algo)
            os.environ.pop("RAFT_TPU_PLAN")
            if planned != inline:
                raise AssertionError(f"{algo} at {b} queries: the planner chose {planned}, the "
                                     f"inline rule {inline}")
            dataset = X_card if algo == "ivf_pq" else None
            counts = (b1.launches, b2.launches)
            ms = {m: cuda_ms(lambda: search(idx, Qt[:b], k, sp, query_batch=b, mode=m,
                                            dataset=dataset), reps=5) for m in ("probe", "fused")}
            b1.launches, b2.launches = counts
            p = plan.plan_search_mode(algo, b, on_cuda=plan.on_cuda(idx.device), fused_ok=True,
                                      scan_ok=False)
            per_bucket.append(dict(algo=algo, bucket=b, choice=planned, probe_ms=ms["probe"],
                                   fused_ms=ms["fused"],
                                   cost_cu={c.name: c.cost for c in p.candidates if c.eligible}))
    emit(card, phase="tiered", metric="plan_bucket_times", rows=per_bucket)
    gate = {}
    for g in ("1", "0"):
        os.environ["RAFT_TPU_PLAN"] = g
        outs = []
        for algo, idx, sp, ds in (("ivf_flat", index, flat_serve, None),
                                  ("ivf_pq", pq_index, pq_params, X_card)):
            eng = ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=len(Q), res=res)
            eng.register("g", algo, idx, params=sp, dataset=ds)
            for s, m in zip(starts[:40], sizes[:40]):  # requests served alone: every bucket
                fut = eng.submit("g", Q[s : s + m], k)
                eng.step(force=True)
                outs.append(fut.result())
            futs, _ = backlog(eng, "g", Q[:2048], sizes_to(sizes, 2048), k)
            outs += [f.result() for f in futs]
        gate[g] = outs
    os.environ.pop("RAFT_TPU_PLAN")
    same = all(np.array_equal(a.indices, b.indices)
               and np.array_equal(a.distances.view(np.int32), b.distances.view(np.int32))
               for a, b in zip(gate["1"], gate["0"]))
    emit(card, phase="tiered", metric="plan_gate_bit_equal", value=same, requests=len(gate["1"]))
    if not same or len(gate["1"]) != len(gate["0"]):
        raise AssertionError("serving with RAFT_TPU_PLAN=1 and =0 is not bit-equal")

    # (f) the shared-memory model against each kernel's export
    libs = {"ivf_scan_smem_bytes": ivf_scan, "pq_scan_smem_bytes": pq_scan,
            "ring_onecard_smem_bytes": rt}
    from raft_tpu_torch.ops import cagra_search, rabitq_scan

    libs.update(rabitq_scan_smem_bytes=rabitq_scan, cagra_search_smem_bytes=cagra_search)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    source = {"fused_list_topk": "fused_list_topk", "fused_pq_topk": "fused_pq_topk",
              "fused_rabitq_topk": "fused_rabitq_topk", "cagra_fused_search": "cagra_fused_search",
              "hop_merge": "ring_topk", "fused_ring_topk": "ring_topk",
              "fused_scan_ring_topk": "ring_topk"}
    for model, export in smem_model.main_path_residencies(sms=sms):
        lib = libs[export[0]].build_kernel()[0]
        got = getattr(lib, export[0])(*export[1:])
        emit(card, phase="tiered", metric="smem_model", kernel=model.kernel,
             model_bytes=model.total_bytes, export_bytes=got, export=list(export),
             ctas_per_sm_by_smem=model.ctas_per_sm,
             buffers={r.name: r.nbytes for r in model.residents},
             ptxas=ptxas.get(source[model.kernel], []))
        if got != model.total_bytes:
            raise AssertionError(f"{model.kernel}: smem_model counts {model.total_bytes} B, the "
                                 f"kernel's {export[0]} {got}")
    emit(card, phase="tiered", metric="phase_s", value=time.perf_counter() - t_phase,
         launches=launches)
    return launches


def multi_phase(card, res, X, X_card, Q, gt_i, k: int, sizes, pq_index, cg, rq_index,
                ca_digest=None) -> dict:
    """Phase 11: the rest of the multi-device layer at full width over
    ``make_mesh(["cuda:0"] * 4)`` (:func:`run_phases`'s ``multi``), on phases
    3-7's data and indexes (1,000,000 x 128, phase 4's IVF-PQ ``pq_index``,
    phase 5's RaBitQ ``rq_index``, phase 6's CAGRA ``cg``). Each part prints
    JSON lines with the card's name and power limit.

    (a) ``sharded_ivf_pq_build`` of the 1M rows (``n_lists=1024``,
        ``pq_dim=64``, ``pq_bits=8``) with ``comm_mode="full"`` and ``"ca"``
        (obs on: ``comms.build.bytes`` and ``.launches`` by phase beside the
        wire model's bytes an iteration), then ``"ca"`` again with obs off,
        equal in every field (in the whole run phase 17's single-controller
        CA build of four shards, made before, stands in for that rebuild:
        every field's digest equal); build seconds and peak
        ``torch.cuda.max_memory_allocated()``; recall@10 of ``search(mode=
        "scan", n_probes=30)`` over 2,048 queries of each build at least
        that of a single-device ``ivf_pq.build(pq_kind="kmeans")`` of the
        same params less 0.05.
    (b) The CA build served lists-sharded (2,048 queries in 1,024-row
        batches): ``ring`` (B6), ``fused_ring`` (B7) and ``gather`` bit-equal;
        recall.
    (c) ``sharded_ivf_pq_search`` of 4,096 queries on ``pq_index``: each
        shard's 1,024 rows ``torch.equal`` to the single-device ``search(mode=
        "scan")`` of the same slice; QPS of both.
    (d) ``sharded_cagra_search`` of 4,096 queries on ``cg`` (itopk 128, width
        8, ``init_sample=16384``): each shard's rows equal ``cagra.search(mode=
        "xla")`` of the same slice; with ``init_sample=0`` recall within 0.1
        of the single-device search's; QPS.
    (e) RaBitQ's dense scan on ``rq_index``: the 10,000 queries in 1,024-row
        batches with and without 8x refine, recall, the share of ids equal to
        the fused path's (B3), ms a batch; ``auto`` on the CUDA index still
        takes B3 from 128 queries.
    (f) ``pq_index`` registered as ``sharded_ivf_pq_lists`` with ``dataset=``
        (8x refine) under a per-shard ``hbm_budget_bytes`` that spills the raw
        rows and keeps the codes: ``tiered_sharded``, ``serve.tiered_degrades``
        1; the first 2,048 rows' requests served one at a time and every
        request as a backlog, each batch bit-equal to the resident sharded
        search (``merge_mode="ring"``, B6) plus the device refine of the same
        padded batch; the tiered and resident backlogs' QPS in turns, B6's
        launches, the busy share; shard 2's host tier killed through
        ``host.fetch`` (``match={"shard": 2}``): coverage 0.75,
        ``failed_shards == (2,)``, no id of its lists; a ``min_coverage`` of
        0.9 fails the futures typed.
    (g) The comms verbs added in this slice over the four shards, each rank
        against its numpy expectation.

    Each kernel's launch count is zeroed before (b)-(f) and read after;
    launches made only to compare are left out. Returns the launches."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.core.errors import ShardFailure
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import cagra, ivf_common, ivf_pq
    from raft_tpu_torch.neighbors.refine import refine
    from raft_tpu_torch.ops import hbm_model, pq_scan, rabitq_scan
    from raft_tpu_torch.ops import ring_topk as rt
    from raft_tpu_torch.parallel import (comms, make_mesh, sharded_cagra_search,
                                         sharded_ivf_pq_build, sharded_ivf_pq_lists_search,
                                         sharded_ivf_pq_search, wire_model)
    from raft_tpu_torch.robust import faults
    from raft_tpu_torch.serve import ServingEngine
    from raft_tpu_torch.serve.bucketing import bucket_for
    from raft_tpu_torch.stats.recall import neighborhood_recall

    t_phase = time.perf_counter()
    mesh = make_mesh(["cuda:0"] * 4)
    n, d = X.shape
    dev = X_card.device
    nq = Q.shape[0]
    Qt = torch.from_numpy(Q).to(dev)
    starts = np.cumsum([0] + list(sizes[:-1]))
    b2, b3 = pq_scan.fused_pq_topk, rabitq_scan.fused_rabitq_topk
    b6, b7 = rt.fused_ring_topk, rt.fused_scan_ring_topk
    kernels = (b2, b3, b6, b7)

    def uncounted(fn):
        """``fn()`` for a comparison: its launches leave the counts alone."""
        before = [f.launches for f in kernels]
        out = fn()
        for f, c in zip(kernels, before):
            f.launches = c
        return out

    # (a) the distributed build, full and CA exchange
    qr = 2048
    bp = ivf_pq.IvfPqIndexParams(n_lists=1024, pq_dim=64, pq_bits=8)
    sp = ivf_pq.IvfPqSearchParams(n_probes=30, refine_ratio=1)

    def scan_recall(index):
        _, ids = ivf_pq.search(index, Qt[:qr], k, sp, mode="scan")
        return neighborhood_recall(ids, gt_i[:qr])

    built = {}
    fields = ("centers", "rotation", "pq_centers", "codes", "list_indices", "list_sizes",
              "rot_sqnorms")
    for mode in ("full", "ca"):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (index, secs), snap = with_obs(lambda: timed_build(
            lambda: sharded_ivf_pq_build(mesh, X_card, bp, comm_mode=mode)))
        c = snap["counters"]
        by_phase = {p: {"launches": c.get(f'comms.build.launches{{phase="{p}"}}', 0.0),
                        "bytes": c.get(f'comms.build.bytes{{phase="{p}"}}', 0.0)}
                    for p in ("kmeans_full", "kmeans_ca", "pq_codebook_full", "pq_codebook_ca",
                              "seed")}
        built[mode] = index
        emit(card, phase="multi", metric="sharded_ivf_pq_build", comm_mode=mode,
             build_s_obs_on=secs, shards=mesh.size, n_lists=bp.n_lists, pq_dim=bp.pq_dim,
             kmeans_n_iters=bp.kmeans_n_iters, comms_build=by_phase,
             allreduce_calls=c.get('comms.allreduce.calls{axis="data"}', 0.0),
             lloyd_wire_bytes_per_iter=wire_model.lloyd_wire_bytes_per_iter(
                 bp.n_lists, d, mesh.size, comm_mode=mode),
             codebook_wire_bytes_per_iter=wire_model.codebook_wire_bytes_per_iter(
                 bp.pq_dim, 1 << bp.pq_bits, d // bp.pq_dim, mesh.size, comm_mode=mode),
             peak_allocated_bytes=torch.cuda.max_memory_allocated() - base,
             max_list=index.max_list)
    if ca_digest is None:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        again, again_s = timed_build(lambda: sharded_ivf_pq_build(mesh, X_card, bp,
                                                                  comm_mode="ca"))
        diff = differing_fields(built["ca"], again, fields)
        emit(card, phase="multi", metric="sharded_ivf_pq_build_determinism", comm_mode="ca",
             build_s_obs_off=again_s,
             peak_allocated_bytes=torch.cuda.max_memory_allocated() - base, fields_differing=diff)
        del again
    else:  # phase 17 built the same index on the same layout before
        digest = index_digest(built["ca"])
        diff = [f for f in PQ_FIELDS if digest[f] != ca_digest[f]]
        emit(card, phase="multi", metric="sharded_ivf_pq_build_determinism", comm_mode="ca",
             against="phase 17's build on make_mesh(['cuda:0'] * 4)", fields_differing=diff)
    if diff:
        raise AssertionError(f"the sharded IVF-PQ build built twice from one seed differs in {diff}")
    single, single_s = timed_build(lambda: ivf_pq.build(
        X_card, dataclasses.replace(bp, pq_kind="kmeans"), res=res))
    rec = {"single_device": scan_recall(single)}
    rec.update({mode: scan_recall(idx) for mode, idx in built.items()})
    emit(card, phase="multi", metric="sharded_build_recall@10", queries=qr, n_probes=30,
         mode="scan", single_device_build_s=single_s, **rec)
    del single
    for mode in ("full", "ca"):
        if rec[mode] < rec["single_device"] - 0.05:
            raise AssertionError(f"the {mode} sharded build's recall {rec[mode]} is more than "
                                 f"0.05 below the single-device build's {rec['single_device']}")

    # (b) the CA build served lists-sharded: ring, fused_ring and gather
    for f in kernels:  # (b)-(f) are the path: its launches from here
        f.launches = 0
    qb = 1024
    lists_sp = ivf_pq.IvfPqSearchParams(n_probes=30)
    out, secs = {}, {}
    for mode in ("ring", "fused_ring", "gather"):
        res_, secs[mode] = timed_build(lambda: [
            sharded_ivf_pq_lists_search(mesh, built["ca"], Qt[s:s + qb], k, lists_sp,
                                        merge_mode=mode) for s in range(0, qr, qb)])
        out[mode] = (torch.cat([o[0] for o in res_]), torch.cat([o[1] for o in res_]))
    for mode in ("fused_ring", "gather"):
        exact_err(f"lists-sharded search of the sharded build: {mode} vs ring", out[mode],
                  out["ring"])
    emit(card, phase="multi", metric="sharded_build_served_lists_sharded", queries=qr,
         query_batch=qb, qps={m: qr / s for m, s in secs.items()}, bit_equal=True,
         recall=neighborhood_recall(out["ring"][1], gt_i[:qr]),
         launches={f.__name__: f.launches for f in (b6, b7)})
    del built

    # (c) query-sharded IVF-PQ on phase 4's index, 1,024 rows a shard
    qs = 4096
    per = qs // mesh.size
    (sv, si), sharded_s = timed_build(lambda: sharded_ivf_pq_search(mesh, pq_index, Qt[:qs], k,
                                                               lists_sp))
    single_s = 0.0
    for r in range(mesh.size):
        (dv, iv), s_ = timed_build(lambda: uncounted(lambda: ivf_pq.search(
            pq_index, Qt[r * per:(r + 1) * per], k, lists_sp, mode="scan")))
        single_s += s_
        exact_err(f"query-sharded IVF-PQ shard {r} vs the single-device scan",
                  (sv[r * per:(r + 1) * per], si[r * per:(r + 1) * per]), (dv, iv))
    emit(card, phase="multi", metric="sharded_ivf_pq_search", queries=qs, shards=mesh.size,
         qps=qs / sharded_s, single_device_scan_qps=qs / single_s, bit_equal_per_shard=True,
         recall_no_refine=neighborhood_recall(si, gt_i[:qs]))

    # (d) query-sharded CAGRA on phase 6's index (the xla beam loop)
    cp = cagra.CagraSearchParams(itopk_size=128, search_width=8, dedup="post",
                                 init_sample=SERVE_INIT_SAMPLE)
    (cv, ci), cagra_s = timed_build(lambda: sharded_cagra_search(mesh, cg, Qt[:qs], k, cp))
    for r in range(mesh.size):
        want = uncounted(lambda: cagra.search(cg, Qt[r * per:(r + 1) * per], k, cp, mode="xla"))
        exact_err(f"query-sharded CAGRA shard {r} vs the single-device xla search",
                  (cv[r * per:(r + 1) * per], ci[r * per:(r + 1) * per]), want)
    rnd = dataclasses.replace(cp, init_sample=0)
    (_, ri), rnd_s = timed_build(lambda: sharded_cagra_search(mesh, cg, Qt[:qs], k, rnd))
    _, si1 = uncounted(lambda: cagra.search(cg, Qt[:qs], k, rnd, mode="xla"))
    rec_rnd, rec_single = neighborhood_recall(ri, gt_i[:qs]), neighborhood_recall(si1, gt_i[:qs])
    emit(card, phase="multi", metric="sharded_cagra_search", queries=qs, shards=mesh.size,
         qps=qs / cagra_s, bit_equal_per_shard=True, recall=neighborhood_recall(ci, gt_i[:qs]),
         init_sample=cp.init_sample, random_seeds_qps=qs / rnd_s, random_seeds_recall=rec_rnd,
         random_seeds_single_device_recall=rec_single)
    if abs(rec_rnd - rec_single) > 0.1:
        raise AssertionError(f"sharded CAGRA with random seeds: recall {rec_rnd} more than 0.1 "
                             f"from the single-device search's {rec_single}")

    # (e) RaBitQ's dense scan on phase 5's index, against the fused path (B3)
    rq = ivf_pq.IvfPqSearchParams()
    for refine_ratio in (1, 8):
        p = dataclasses.replace(rq, refine_ratio=refine_ratio)
        ds = X_card if refine_ratio > 1 else None
        (_, s_ids), scan_s = timed_build(lambda: ivf_pq.search(
            rq_index, Qt, k, p, mode="scan", query_batch=1024, dataset=ds))
        _, f_ids = uncounted(lambda: ivf_pq.search(rq_index, Qt, k, p, mode="fused",
                                                   query_batch=1024, dataset=ds))
        emit(card, phase="multi", metric="rabitq_dense_scan", refine_ratio=refine_ratio,
             queries=nq, query_batch=1024, ms_per_batch=scan_s * 1e3 / -(-nq // 1024),
             recall=neighborhood_recall(s_ids, gt_i),
             fused_recall=neighborhood_recall(f_ids, gt_i),
             ids_equal_to_fused=float((s_ids == f_ids).to(torch.float32).mean()),
             chunk_lists=ivf_pq.rabitq_scan_chunk_lists(rq_index.n_lists, rq_index.max_list,
                                                        rq_index.rot_dim, 1024))
    before = b3.launches
    auto = ivf_pq.search(rq_index, Qt[:128], k, rq)
    fused = uncounted(lambda: ivf_pq.search(rq_index, Qt[:128], k, rq, mode="fused"))
    rule = ivf_common.auto_search_mode(rq_index.device, 128, True, algo="ivf_pq")
    emit(card, phase="multi", metric="rabitq_auto_on_cuda", rule_at_128=rule,
         b3_launches=b3.launches - before)
    if rule != "fused" or b3.launches - before < 1 or not torch.equal(auto[1], fused[1]):
        raise AssertionError("RaBitQ auto on the CUDA index no longer takes B3 from 128 queries")

    # (f) tiered sharded serving: the raw rows in per-shard host tiers
    pq_params = ivf_pq.IvfPqSearchParams(n_probes=30)
    r = hbm_model.residency_for_index("sharded_pq", "ivf_pq", pq_index, refine_rows=n)
    req = sum(c_.per_shard_bytes(mesh.size) for c_ in r.components if c_.required)
    raw = sum(c_.per_shard_bytes(mesh.size) for c_ in r.components if not c_.required)
    _, stage_dev = hbm_model.staging_footprint(d)
    budget = int((req + stage_dev + raw // 2) / hbm_model.HBM_HEADROOM)
    t_eng = ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=nq, res=res,
                          hbm_budget_bytes=budget)
    _, snap = with_obs(lambda: t_eng.register("pq", "sharded_ivf_pq_lists", pq_index,
                                              params=pq_params, mesh=mesh, dataset=X_card,
                                              merge_mode="ring"))
    degrades = snap["counters"].get(
        'serve.tiered_degrades{algo="sharded_ivf_pq_lists",index_id="pq"}', 0.0)
    reg = t_eng._indexes["pq"]
    placement = t_eng.sharded_placements["pq"]
    emit(card, phase="multi", metric="sharded_placement", hbm_budget_bytes_per_shard=budget,
         required_bytes_per_shard=req, raw_vectors_bytes_per_shard=raw,
         raw_vectors_tier=placement.tier("pq", "raw_vectors"), algo=reg.algo,
         tiered_degrades=degrades, table=placement.table().splitlines())
    if reg.algo != "tiered_sharded" or degrades != 1.0:
        raise AssertionError(f"the per-shard budget {budget} B did not convert the registration "
                             f"to tiered_sharded ({reg.algo}, degrades {degrades})")
    tsi = reg.index
    kk = k * tsi.refine_ratio
    emit(card, phase="multi", metric="sharded_host_tier", bytes=tsi.tier.nbytes,
         rows_per_shard=[st.size for st in tsi.tier.stores], refine_ratio=tsi.refine_ratio)

    def resident_search(q):
        _, cand = sharded_ivf_pq_lists_search(mesh, pq_index, q, kk, pq_params,
                                              merge_mode="ring")
        return refine(X_card, q, cand, k, metric=pq_index.metric)

    t_eng.warmup("pq", k)
    before_f = b6.launches
    one_sizes = sizes_to(sizes, 2048)
    one = []
    t0 = time.perf_counter()
    for s, m in zip(starts, one_sizes):
        fut = t_eng.submit("pq", Q[s:s + m], k)
        t_eng.step(force=True)
        one.append(fut.result())
    one_s = time.perf_counter() - t0
    for r_, s, m in zip(one, starts, one_sizes):
        padded = torch.zeros((r_.bucket, d), device=dev)
        padded[:m] = Qt[s:s + m]
        dv, iv = uncounted(lambda: resident_search(padded))
        if not (np.array_equal(r_.indices, iv[:m].cpu().numpy())
                and np.array_equal(r_.distances.view(np.int32), dv[:m].cpu().numpy().view(np.int32))):
            raise AssertionError("a tiered sharded request served alone is not bit-equal to the "
                                 "resident sharded search plus refine of its padded batch")

    def resident_backlog():
        """The engine's backlog batches, padded to their buckets, through the
        resident sharded search plus refine (no engine: the resident path has
        no registration of its own)."""
        for batch in backlog_batches(sizes):
            q = np.concatenate([Q[starts[i]:starts[i] + sizes[i]] for i in batch])
            padded = torch.zeros((bucket_for(q.shape[0], 128), d), device=dev)
            padded[:q.shape[0]] = torch.from_numpy(q).to(dev)
            resident_search(padded)[1].cpu()

    runs, results = {}, None
    for which in ("resident", "tiered", "tiered", "resident"):
        if which == "tiered":
            futs, secs = backlog(t_eng, "pq", Q, sizes, k)
            results = [f.result() for f in futs]
        else:
            _, secs = timed_build(lambda: uncounted(resident_backlog))
        runs.setdefault(which, []).append(nq / secs)
    batches = uncounted(lambda: check_served_batches(
        "tiered sharded IVF-PQ backlog", Q, sizes, results, resident_search, dev))
    ids, _, _ = served(results, n)
    busy = profile_backlog(card, t_eng, "pq", Q, starts, sizes, k, None, phase="multi")
    emit(card, phase="multi", metric="tiered_sharded_serve", one_client_qps=sum(one_sizes) / one_s,
         one_client_rows=sum(one_sizes), backlog_qps_tiered=runs["tiered"],
         resident_path_qps=runs["resident"],
         tiered_over_resident=float(np.median(runs["tiered"]) / np.median(runs["resident"])),
         recall=neighborhood_recall(torch.from_numpy(ids), gt_i), batches_bit_equal=batches,
         requests_bit_equal=len(one), b6_launches=b6.launches - before_f, busy_share=busy,
         plan_explain=t_eng.plan_explain("pq").splitlines())
    if b6.launches - before_f <= 0:
        raise AssertionError("tiered sharded serving never launched fused_ring_topk")
    # shard 2's host tier lost: coverage 0.75, none of its rows
    lost = sizes_to(sizes, 2048)
    with faults.injected("host.fetch", error=OSError("host tier lost"), match={"shard": 2}):
        futs, _ = backlog(t_eng, "pq", Q, lost, k)
        degraded = [f.result() for f in futs]
        t_eng.register("floor", "tiered_sharded", tsi, min_coverage=0.9)
        ffuts = [t_eng.submit("floor", Q[s:s + m], k) for s, m in zip(starts[:4], lost[:4])]
        t_eng.run_until_idle()
    typed = sum(isinstance(f.exception(), ShardFailure) for f in ffuts)
    ids = np.concatenate([r_.indices for r_ in degraded])
    owners = tsi.tier.owner[ids[ids >= 0]]
    emit(card, phase="multi", metric="tiered_sharded_tier_lost", shard=2,
         coverage=sorted({r_.coverage for r_ in degraded}),
         failed_shards=sorted({r_.failed_shards for r_ in degraded}),
         ids_of_lost_shard=int((owners == 2).sum()),
         recall=neighborhood_recall(torch.from_numpy(ids), gt_i[:sum(lost)]),
         min_coverage_futures_failed_typed=typed, min_coverage_futures=len(ffuts))
    if ({r_.coverage for r_ in degraded} != {0.75}
            or {r_.failed_shards for r_ in degraded} != {(2,)} or (owners == 2).any()
            or typed != len(ffuts)):
        raise AssertionError("shard 2's lost host tier did not give coverage 0.75, "
                             "failed_shards (2,) and none of its ids on every result, or the "
                             "min_coverage futures did not fail typed")

    # (g) the comms verbs added in this slice, each rank against numpy
    n_s = mesh.size
    blocks = np.random.default_rng(11).standard_normal((n_s, 5, 3)).astype(np.float32)
    xs = [torch.from_numpy(blocks[r]).to(dev) for r in range(n_s)]
    sq = [torch.from_numpy(np.stack([blocks[r] + 10 * j for j in range(n_s)])).to(dev)
          for r in range(n_s)]
    checks = {}
    g = comms.gather(mesh, xs, root=1)
    checks["gather"] = all(np.array_equal(g[r].cpu().numpy(), blocks if r == 1 else
                                          np.zeros_like(blocks)) for r in range(n_s))
    gv = comms.gatherv(mesh, xs, [0, 2, 5, 1], root=3)
    checks["gatherv"] = (np.array_equal(gv[3][0].cpu().numpy(), blocks)
                         and gv[3][1].cpu().tolist() == [0, 2, 5, 1]
                         and not any(gv[r][0].any() or gv[r][1].any() for r in range(3)))
    sc = comms.scatter(mesh, sq, root=2)
    checks["scatter"] = all(np.array_equal(sc[r].cpu().numpy(), blocks[2] + 10 * r)
                            for r in range(n_s))
    sr = comms.device_sendrecv(mesh, xs, [(0, 3)])
    checks["device_sendrecv"] = (np.array_equal(sr[0].cpu().numpy(), blocks[3])
                                 and np.array_equal(sr[3].cpu().numpy(), blocks[0])
                                 and not (sr[1].any() or sr[2].any()))
    mc = comms.multicast_sendrecv(mesh, xs, [(1, 0), (1, 2), (3, 3)])
    checks["multicast_sendrecv"] = (all(np.array_equal(mc[dd].cpu().numpy(), blocks[s])
                                        for s, dd in ((1, 0), (1, 2), (3, 3)))
                                    and not mc[1].any())
    checks["comm_rank"] = [int(x) for x in comms.comm_rank(mesh)] == list(range(n_s))
    own = Resources(device="cuda")
    m2 = comms.init_comms(own, devices=["cuda:0"] * n_s)
    checks["init_comms"] = own.get_mesh() is m2 and m2.size == n_s
    checks["comm_split"] = comms.comm_split(m2, "data") == {"axis": "data", "size": n_s}
    emit(card, phase="multi", metric="comms_verbs", shards=n_s, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"comms verbs against numpy: {checks}")
    launches = {f.__name__: f.launches for f in kernels}
    emit(card, phase="multi", metric="phase_s", value=time.perf_counter() - t_phase,
         launches=launches)
    return launches


#: phase 13's card-against-CPU tolerance of ``pairwise_distance``: the card
#: and the CPU add each f32 sum in another order (d = 128)
PRIMS_RTOL = PRIMS_ATOL = 1e-4
#: phase 13's shapes: the card-against-CPU check (m, n, d), then the bench's
#: (``raft_tpu/bench/prims.py``): pairwise (m, n, d), masked 1-NN (m, n, d,
#: groups), selection (rows, n, k) and the RBF gram (m, n, d)
PRIMS_SHAPES = dict(check=(256, 4096, 128), pairwise=(2048, 16384, 128),
                    masked=(16384, 16384, 64, 32), select=(512, 65536, 64),
                    rbf=(4096, 4096, 128))


def input_family(metric) -> str:
    """Which inputs fit ``metric``: ``nonneg`` (Hellinger, KL and
    Jensen-Shannon take logs or roots), ``binary`` (Jaccard, Dice,
    Russel-Rao and Hamming count set entries), ``haversine`` (d = 2
    radians) or ``normal``."""
    from raft_tpu_torch.ops.distance import DistanceType as DT

    if metric == DT.Haversine:
        return "haversine"
    if metric in (DT.HellingerExpanded, DT.KLDivergence, DT.JensenShannon):
        return "nonneg"
    if metric in (DT.JaccardExpanded, DT.DiceExpanded, DT.RusselRaoExpanded, DT.HammingUnexpanded):
        return "binary"
    return "normal"


def metric_inputs(rng, family: str, m: int, n: int, d: int):
    """Inputs of ``family`` (:func:`input_family`): non-negative rows
    summing to 1 (a fifth of the entries 0), 0/1 rows, (lat, lon) radians
    or normal rows."""
    if family == "haversine":
        def pts(k):
            return np.stack([rng.uniform(-np.pi / 2, np.pi / 2, k),
                             rng.uniform(-np.pi, np.pi, k)], 1).astype(np.float32)
        return pts(m), pts(n)
    if family == "nonneg":
        def rows(k):
            v = rng.uniform(0.0, 1.0, (k, d)) * (rng.random((k, d)) > 0.2)
            return (v / np.maximum(v.sum(1, keepdims=True), 1e-6)).astype(np.float32)
        return rows(m), rows(n)
    if family == "binary":
        return ((rng.random((m, d)) < 0.4).astype(np.float32),
                (rng.random((n, d)) < 0.4).astype(np.float32))
    return (rng.standard_normal((m, d), dtype=np.float32),
            rng.standard_normal((n, d), dtype=np.float32))


def fit_rows(metric, X):
    """The 1M rows fit to an accumulation metric on the card: ``|X|`` for
    KL and Jensen-Shannon (logs of non-negative values), ``X > 0`` as 0/1
    for Hamming, ``X`` itself otherwise."""
    from raft_tpu_torch.ops.distance import DistanceType as DT

    if metric in (DT.KLDivergence, DT.JensenShannon):
        return X.abs()
    if metric == DT.HammingUnexpanded:
        return (X > 0).to(torch.float32)
    return X


def same_topk_of_matrix(what: str, vals, ids, D, k: int) -> float:
    """``(vals, ids)`` [nq, k] against the whole matrix ``D`` [nq, n]: the
    values allclose to ``select_k``'s of ``D`` (PRIMS_RTOL/ATOL), each id
    distinct in its row and holding its value in ``D``. Returns the share
    of ids equal to ``select_k``'s (the rest are ties in another order)."""
    from raft_tpu_torch.ops.select_k import select_k

    rv, ri = select_k(D, k)
    if not torch.allclose(vals, rv, rtol=PRIMS_RTOL, atol=PRIMS_ATOL):
        raise AssertionError(f"{what}: values differ from the whole matrix's top-k by "
                             f"{float((vals - rv).abs().max())}")
    held = torch.gather(D, 1, ids.to(torch.int64))
    if not torch.allclose(held, vals, rtol=PRIMS_RTOL, atol=PRIMS_ATOL):
        raise AssertionError(f"{what}: an id does not hold its value in the whole matrix")
    if (torch.sort(ids, dim=1).values.diff(dim=1) == 0).any():
        raise AssertionError(f"{what}: an id repeats in its row")
    return float((ids == ri).to(torch.float32).mean())


def prims_phase(card, res, X_card, Qt, gt_i, k: int, seed: int) -> dict:
    """Phase 13: the search path's primitives, plain PyTorch on the card
    (:func:`run_phases`'s ``prims``). (a) ``pairwise_distance`` under each
    of the 20 computable metrics on the card against the CPU at 256 x 4,096
    x 128 (inputs fit to the metric, :func:`metric_inputs`), then timed on
    the card at the bench's 2,048 x 16,384 x 128; (b) exact
    ``brute_force.search`` of one 128-query batch over the 1M rows under
    each accumulation metric (the tiled running merge) against
    ``select_k`` of the whole ``pairwise_distance`` matrix; (c)
    ``search(mode="approx")`` of the 10,000 queries at k = 10 against the
    exact mode and ``gt_i``; (d) ``BatchKQuery`` pages 0-4 at 32 wide
    against one k = 160 search; (e) ``masked_l2_nn`` at 16,384 x 16,384 x
    64 with 32 groups against a masked whole-matrix argmin, and on integer
    rows against its lowest tied index exactly; (f)
    ``approx_select_k`` at 512 x 65,536, k = 64, and ``rbf_kernel`` at
    4,096 x 4,096 x 128, timed."""
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import DistanceType, masked_l2_nn, pairwise_distance, rbf_kernel
    from raft_tpu_torch.ops.distance import EXPANDED
    from raft_tpu_torch.ops.select_k import approx_select_k, select_k
    from raft_tpu_torch.stats.recall import neighborhood_recall

    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 13])
    out = {"metrics": {}}
    metrics = [m for m in DistanceType if m != DistanceType.Precomputed]
    timed = {}  # the bench-shape inputs on the card, one draw a family
    t_cpu = 0.0
    for metric in metrics:
        p = 3.0 if metric == DistanceType.LpUnexpanded else 2.0
        family = input_family(metric)
        x, y = metric_inputs(rng, family, *PRIMS_SHAPES["check"])
        t0 = time.perf_counter()
        ref = pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), metric, metric_arg=p)
        t_cpu += time.perf_counter() - t0
        got = pairwise_distance(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(), metric,
                                metric_arg=p).cpu()
        err = float((got - ref).abs().max())
        scaled = float(((got - ref).abs() / (PRIMS_ATOL + PRIMS_RTOL * ref.abs())).max())
        if family not in timed:
            timed[family] = tuple(torch.from_numpy(a).cuda()
                                  for a in metric_inputs(rng, family, *PRIMS_SHAPES["pairwise"]))
        xb, yb = timed[family]
        ms = cuda_ms(lambda: pairwise_distance(xb, yb, metric, metric_arg=p),
                     reps=10 if metric in EXPANDED else 2)
        out["metrics"][metric.name] = dict(max_abs_err=err, ms=ms)
        emit(card, phase="prims", metric="pairwise_distance", distance=metric.name,
             family="expanded" if metric in EXPANDED else (
                 "haversine" if metric == DistanceType.Haversine else "accumulation"),
             inputs=family,
             max_abs_err=err, scaled_err=scaled, rtol=PRIMS_RTOL, atol=PRIMS_ATOL,
             card_vs_cpu_shape=list(PRIMS_SHAPES["check"]), ms=ms,
             timed_shape=list(PRIMS_SHAPES["pairwise"]))
        if not scaled <= 1.0:
            raise AssertionError(f"pairwise_distance {metric.name}: card and CPU differ by {err} "
                                 f"(above rtol {PRIMS_RTOL}, atol {PRIMS_ATOL})")
    emit(card, phase="prims", metric="pairwise_cpu_s", value=t_cpu, metrics=len(metrics))
    del timed

    # (b) the accumulation metrics at full width: one serving batch over 1M rows
    q128 = Qt[:128]
    for metric in [m for m in metrics if m not in EXPANDED and m != DistanceType.Haversine]:
        p = 3.0 if metric == DistanceType.LpUnexpanded else 2.0
        Xf, qf = fit_rows(metric, X_card), fit_rows(metric, q128)
        index = brute_force.build(Xf, metric, metric_arg=p, res=res)
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # one call; (a) ran the same elementwise ops first
        vals, ids = brute_force.search(index, qf, k)
        torch.cuda.synchronize()
        search_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        D = pairwise_distance(qf, Xf, metric, metric_arg=p)
        torch.cuda.synchronize()
        matrix_ms = (time.perf_counter() - t0) * 1e3
        same = same_topk_of_matrix(f"brute force {metric.name}", vals, ids, D, k)
        out["metrics"][metric.name].update(search_ms=search_ms)
        emit(card, phase="prims", metric="brute_force_accumulation", distance=metric.name,
             rows=X_card.shape[0], queries=128, k=k, search_ms=search_ms,
             whole_matrix_ms=matrix_ms, ids_equal_to_whole_matrix=same)
        del index, Xf, D

    # (c) approximate mode at the full 10,000 queries on the 1M index
    index = brute_force.build(X_card, "sqeuclidean", res=res)
    modes = {}
    for mode in ("exact", "approx"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        modes[mode] = brute_force.search(index, Qt, k, mode=mode)
        torch.cuda.synchronize()
        modes[mode] = modes[mode] + ((time.perf_counter() - t0) * 1e3,)
    (ev, ei, e_ms), (av, ai, a_ms) = modes["exact"], modes["approx"]
    recall = neighborhood_recall(ai, gt_i)
    emit(card, phase="prims", metric="brute_force_approx", queries=Qt.shape[0],
         rows=X_card.shape[0], k=k, exact_ms=e_ms, approx_ms=a_ms,
         ids_equal_to_exact=bool(torch.equal(ai, ei)), recall=recall)
    if not torch.equal(ai, ei) or not torch.equal(av, ev) or recall < 0.999:
        raise AssertionError(f"approx mode differs from exact (recall {recall})")
    out.update(approx_ms=a_ms, exact_ms=e_ms, approx_recall=recall)

    # (d) BatchKQuery pages 0-4 against one k = 160 search
    fv, fi = brute_force.search(index, q128, 160)
    pages = brute_force.BatchKQuery(index, q128, batch_size=32)
    for i in range(5):
        page = pages.batch(i)
        if not (torch.equal(page.indices, fi[:, 32 * i : 32 * (i + 1)])
                and torch.equal(page.distances, fv[:, 32 * i : 32 * (i + 1)])):
            raise AssertionError(f"BatchKQuery page {i} differs from the k = 160 search")
    emit(card, phase="prims", metric="batch_k_query", pages=5, width=32, queries=128,
         equal_to_k160=True, fetched_k=pages._k)
    del index, modes, ev, ei, av, ai, fv, fi

    # (e) masked_l2_nn at the bench's shape against a masked whole-matrix argmin
    m, n, d, ng = PRIMS_SHAPES["masked"]
    x = torch.from_numpy(rng.standard_normal((m, d), dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).cuda()
    adj = torch.from_numpy(rng.random((m, ng)) < 0.5).cuda()
    adj[:4] = False  # rows with no adjacent group: (inf, -1)
    dev = x.device
    gi = torch.arange(1, ng + 1, dtype=torch.int32, device=dev) * (n // ng)
    gid = torch.clamp(torch.searchsorted(gi.to(torch.int64),
                                         torch.arange(n, device=dev), right=True), 0, ng - 1)
    cols = torch.arange(n, device=dev)

    def masked_argmin(xx, yy):
        """The masked whole matrix's row minima and their lowest column
        (-1 on a row with no adjacent group)."""
        D = pairwise_distance(xx, yy, "sqeuclidean")
        D = torch.where(adj[:, gid], D, torch.full_like(D, float("inf")))
        rmin = D.min(dim=1).values
        first = torch.where(D == rmin[:, None], cols, n).min(dim=1).values
        ok = torch.isfinite(rmin)
        return D, rmin, torch.where(ok, first, -1).to(torch.int32), ok

    bv, bi = masked_l2_nn(x, y, adj, gi)
    mask_ms = cuda_ms(lambda: masked_l2_nn(x, y, adj, gi), reps=5)
    D, rmin, first, ok = masked_argmin(x, y)
    if not (torch.equal(bi[~ok], first[~ok]) and torch.isinf(bv[~ok]).all()):
        raise AssertionError("masked_l2_nn: a row with no adjacent group is not (inf, -1)")
    if not torch.allclose(bv[ok], rmin[ok], rtol=1e-5, atol=1e-4):
        raise AssertionError("masked_l2_nn: values differ from the masked whole matrix")
    held = D[ok].gather(1, bi[ok].to(torch.int64)[:, None])[:, 0]
    if not torch.allclose(held, rmin[ok], rtol=1e-5, atol=1e-4):
        raise AssertionError("masked_l2_nn: an index does not hold the row's minimum")
    # normal rows: the tiled and the whole matmul may round a near tie apart
    same = float((bi == first).to(torch.float32).mean())
    del D
    # integer rows in -2..2: every distance is an exact integer in either
    # arithmetic, so ties abound, within and across tiles, and the ids must
    # be the lowest index among equal minima (jnp.argmin's rule) exactly
    xi = torch.from_numpy(rng.integers(-2, 3, (m, d)).astype(np.float32)).cuda()
    yi = torch.from_numpy(rng.integers(-2, 3, (n, d)).astype(np.float32)).cuda()
    tv, ti = masked_l2_nn(xi, yi, adj, gi)
    D, rmin, first, ok = masked_argmin(xi, yi)
    tied_rows = int(((D == rmin[:, None]).sum(dim=1) > 1)[ok].sum())
    ties_first = bool(torch.equal(ti, first) and torch.equal(tv[ok], rmin[ok]))
    emit(card, phase="prims", metric="masked_l2_nn", shape=[m, n, d], groups=ng, ms=mask_ms,
         ids_equal_to_whole_matrix=same, rows_without_group=int((~ok).sum()),
         integer_rows_with_tied_minima=tied_rows, integer_ids_lowest_of_ties=ties_first)
    if not ties_first or tied_rows == 0:
        raise AssertionError(f"masked_l2_nn: on integer rows ({tied_rows} with tied minima) the "
                             "ids are not the lowest index among equal minima")
    out.update(masked_l2_nn_ms=mask_ms)
    del x, y, xi, yi, adj, D

    # (f) approx_select_k and the RBF gram matrix, timed
    rows, width, kk = PRIMS_SHAPES["select"]
    v = torch.from_numpy(rng.standard_normal((rows, width), dtype=np.float32)).cuda()
    sv, si = approx_select_k(v, kk)
    ev, ei = select_k(v, kk)
    if not (torch.equal(sv, ev) and torch.equal(si, ei)):
        raise AssertionError("approx_select_k differs from select_k")
    sel_ms = cuda_ms(lambda: approx_select_k(v, kk), reps=10)
    topk_ms = cuda_ms(lambda: torch.topk(v, kk, dim=1, largest=False), reps=10)
    mr, nr, dr = PRIMS_SHAPES["rbf"]
    xr = torch.from_numpy(rng.standard_normal((mr, dr), dtype=np.float32)).cuda()
    yr = torch.from_numpy(rng.standard_normal((nr, dr), dtype=np.float32)).cuda()
    g = rbf_kernel(xr, yr, gamma=0.1)
    gref = torch.exp(-0.1 * torch.cdist(xr.double(), yr.double()) ** 2).float()
    if not (torch.isfinite(g).all() and torch.allclose(g, gref, rtol=1e-4, atol=1e-5)):
        raise AssertionError("rbf_kernel differs from its float64 reference")
    rbf_ms = cuda_ms(lambda: rbf_kernel(xr, yr, gamma=0.1), reps=10)
    emit(card, phase="prims", metric="approx_select_k", shape=[rows, width], k=kk, ms=sel_ms,
         torch_topk_ms=topk_ms, equal_to_select_k=True)
    emit(card, phase="prims", metric="rbf_kernel", shape=[mr, nr, dr], ms=rbf_ms,
         max_abs_err_vs_f64=float((g - gref).abs().max()))
    out.update(approx_select_k_ms=sel_ms, rbf_kernel_ms=rbf_ms)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(card, phase="prims", metric="phase_s", value=out["phase_s"])
    return out


def bucket_sizes_to(top: int) -> list:
    """1, 2, 4, ... ``top``."""
    return [1 << i for i in range(top.bit_length())]


def sizes_to(sizes, rows: int) -> list:
    """The leading request sizes covering ``rows`` rows (the last cut)."""
    out = []
    for m in sizes:
        if sum(out) >= rows:
            break
        out.append(min(m, rows - sum(out)))
    return out


def geo_points(rng, n: int, groups: int = 4096) -> np.ndarray:
    """``n`` (lat, lon) radian points in ``groups`` clustered groups (about
    0.01 rad across, a city's size on the globe)."""
    lat = rng.uniform(-1.4, 1.4, groups)
    lon = rng.uniform(-np.pi, np.pi, groups)
    g = rng.integers(0, groups, n)
    return np.stack([lat[g] + 0.01 * rng.standard_normal(n),
                     lon[g] + 0.01 * rng.standard_normal(n)], 1).astype(np.float32)


def exact_knn_tiled(points, queries, k: int, metric, block: int = 16384):
    """Exact kNN of ``queries`` over ``points`` by tiled ``pairwise_distance``,
    ``select_k`` and a running merge: the reference ball cover is held
    against (brute force refuses Haversine)."""
    from raft_tpu_torch.ops.distance import pairwise_distance
    from raft_tpu_torch.ops.select_k import running_merge, select_k

    nq = queries.shape[0]
    acc_v = torch.full((nq, k), float("inf"), device=queries.device)
    acc_i = torch.full((nq, k), -1, dtype=torch.int32, device=queries.device)
    for s in range(0, points.shape[0], block):
        d = pairwise_distance(queries, points[s : s + block], metric)
        ids = (s + torch.arange(d.shape[1], dtype=torch.int32, device=d.device))[None, :].expand_as(d)
        v, i = select_k(d, k, indices=ids)
        acc_v, acc_i = running_merge(acc_v, acc_i, v, i)
    return acc_v, acc_i


#: phase 14's sizes: k-means' clusters, the eps queries, ball cover's points
#: and queries
GEO_SIZES = dict(k=1024, eps_queries=4096, points=1_000_000, queries=10_000)


def geo_phase(card, res, X_card, Qt, gt_i, cg, k: int, seed: int) -> dict:
    """Phase 14: k-means' remaining entry points, the epsilon neighbourhood,
    ball cover and hnsw at full width (:func:`run_phases`'s ``geo``), on
    phase 3's 1M x 128 rows and 10,000 queries and phase 6's CAGRA index.
    (a) ``kmeans.fit_predict`` at k = 1,024 (20 Lloyd steps), labels equal to
    ``predict``; (b) ``transform`` and ``inertia`` of the queries; (c)
    ``find_k`` over 2-64 (ternary search); (d) ``fit_minibatch`` at k =
    1,024, its inertia against (a)'s; (e) ``kmeans_balanced.fit_predict`` at
    1,024 lists, labels equal to ``predict``; (f) ``eps_neighbors`` of 4,096
    queries against the 1M rows (a 4.1 GB adjacency), ``eps`` the median
    10th-neighbour squared distance: each row of degree <= 64 holds exactly
    brute force's ids below ``eps`` (ids within 1e-5 relative of ``eps``
    excepted); (g) ``ball_cover`` over 1M clustered (lat, lon) points with
    10,000 queries at k = 10, ``n_probes`` 0 and 8, ids equal to an exact
    tiled Haversine search; (h) hnsw: phase 6's index written to an hnswlib
    file under ``TMPDIR``, loaded back and searched at ``ef = 128`` on B4,
    ids ``torch.equal`` to ``cagra.search`` at ``itopk_size = 128`` on the
    same graph, B4's launches counted, the neighbour table built once."""
    import tempfile

    from raft_tpu_torch.cluster import kmeans, kmeans_balanced
    from raft_tpu_torch.neighbors import ball_cover, brute_force, cagra, eps_neighbors, hnsw
    from raft_tpu_torch.ops import cagra_search
    from raft_tpu_torch.stats.recall import neighborhood_recall

    t_phase = time.perf_counter()
    out = {}
    # (a) fit_predict at k = 1,024
    nk = GEO_SIZES["k"]
    p = kmeans.KMeansParams(n_clusters=nk, max_iter=20, seed=seed)
    (km, labels), secs = timed_build(lambda: kmeans.fit_predict(X_card, p))
    if not torch.equal(labels, kmeans.predict(X_card, km.centroids)[0]):
        raise AssertionError("kmeans.fit_predict labels differ from predict of its centroids")
    emit(card, phase="geo", metric="kmeans_fit_predict", seconds=secs, k=nk, n_iter=km.n_iter,
         inertia=km.inertia, rows=X_card.shape[0])
    # (b) transform and inertia of the queries
    (T, q_inertia), secs = timed_build(lambda: (kmeans.transform(Qt, km.centroids),
                                          kmeans.inertia(Qt, km.centroids)))
    q_lab, q_d = kmeans.predict(Qt, km.centroids)
    at_label = torch.gather(T, 1, q_lab[:, None].to(torch.int64))[:, 0]
    if not torch.allclose(at_label, T.min(dim=1).values, rtol=1e-5, atol=1e-3):
        raise AssertionError("transform's distance at predict's label is not the row minimum")
    if not torch.allclose(q_inertia, q_d.sum(), rtol=1e-4):
        raise AssertionError(f"inertia {float(q_inertia)} != sum of predict's {float(q_d.sum())}")
    emit(card, phase="geo", metric="kmeans_transform_inertia", seconds=secs, shape=list(T.shape),
         inertia=float(q_inertia))
    del T
    # (c) find_k over 2-64: the ternary search, fits counted
    fits = []
    real_fit = kmeans.fit
    kmeans.fit = lambda *a, **kw: fits.append(1) or real_fit(*a, **kw)
    try:
        (best_k, fk_inertia, fk_iter), secs = timed_build(lambda: kmeans.find_k(X_card, kmax=64, kmin=2,
                                                                          seed=seed))
    finally:
        kmeans.fit = real_fit
    if not 2 <= best_k <= 64 or not np.isfinite(fk_inertia):
        raise AssertionError(f"find_k returned k = {best_k}, inertia {fk_inertia}")
    emit(card, phase="geo", metric="kmeans_find_k", seconds=secs, best_k=best_k, fits=len(fits),
         inertia=fk_inertia, n_iter=fk_iter, kmin=2, kmax=64)
    # (d) fit_minibatch at k = 1,024
    mb, secs = timed_build(lambda: kmeans.fit_minibatch(X_card, kmeans.KMeansParams(n_clusters=nk,
                                                                              seed=seed)))
    if not np.isfinite(mb.inertia) or not torch.equal(mb.labels,
                                                      kmeans.predict(X_card, mb.centroids)[0]):
        raise AssertionError("fit_minibatch: non-finite inertia or labels off its centroids")
    emit(card, phase="geo", metric="kmeans_fit_minibatch", seconds=secs, k=nk, steps=mb.n_iter,
         inertia=mb.inertia, inertia_over_fit=mb.inertia / km.inertia)
    # (e) balanced fit_predict at 1,024 lists
    (bc, blab), secs = timed_build(lambda: kmeans_balanced.fit_predict(
        X_card, kmeans_balanced.BalancedKMeansParams(n_clusters=nk, seed=seed)))
    if not torch.equal(blab, kmeans_balanced.predict(X_card, bc)[0]):
        raise AssertionError("kmeans_balanced.fit_predict labels differ from predict")
    sizes = torch.bincount(blab.to(torch.int64), minlength=nk)
    emit(card, phase="geo", metric="kmeans_balanced_fit_predict", seconds=secs, lists=nk,
         list_size_min=int(sizes.min()), list_size_max=int(sizes.max()))
    # (f) eps_neighbors: 4,096 queries x 1M rows
    qe = Qt[: GEO_SIZES["eps_queries"]]
    bf_d, bf_i = brute_force.knn(X_card, qe, 64, metric="sqeuclidean", res=res)
    tenth = torch.sort(bf_d[:, 9]).values
    mid = qe.shape[0] // 2
    eps = float(0.5 * (tenth[mid - 1] + tenth[mid]))
    (adj, vd), secs = timed_build(lambda: eps_neighbors(qe, X_card, eps, metric="sqeuclidean",
                                                  block=512))
    inside = bf_d < eps
    near = (bf_d - eps).abs() <= 1e-5 * eps
    got = torch.gather(adj, 1, bf_i.to(torch.int64))
    rows = vd <= 64
    bad = (((got != inside) & ~near).any(dim=1)
           | ((vd != inside.sum(dim=1)) & ~near.any(dim=1))) & rows
    if bool(bad.any()):
        raise AssertionError(f"eps_neighbors: {int(bad.sum())} rows of degree <= 64 differ from "
                             "brute force")
    emit(card, phase="geo", metric="eps_neighbors", seconds=secs, queries=qe.shape[0],
         rows=X_card.shape[0], adjacency_bytes=adj.numel(), eps=eps,
         rows_checked=int(rows.sum()), ids_near_eps=int(near.sum()),
         degree_median=float(vd.float().median()), degree_max=int(vd.max()))
    del adj, got
    # (g) ball cover: 1M clustered (lat, lon) points, 10,000 queries
    grng = np.random.default_rng([seed, 14])
    n_pts = GEO_SIZES["points"]
    pts = geo_points(grng, n_pts + GEO_SIZES["queries"])
    P = torch.from_numpy(pts[:n_pts]).cuda()
    Qg = torch.from_numpy(pts[n_pts:]).cuda()
    bci, build_s = timed_build(lambda: ball_cover.build(P, seed=seed))
    (ev, ei), exact_s = timed_build(lambda: exact_knn_tiled(P, Qg, k, "haversine"))
    bcl = {}
    for n_probes in (0, 8):
        waves = []
        real_wave = ball_cover._scan_wave
        ball_cover._scan_wave = lambda *a: waves.append(1) or real_wave(*a)
        try:
            (bv, bi), secs = timed_build(lambda: ball_cover.knn_query(bci, Qg, k, n_probes=n_probes))
        finally:
            ball_cover._scan_wave = real_wave
        if not torch.equal(bi, ei):
            raise AssertionError(f"ball_cover n_probes={n_probes}: "
                                 f"{float((bi != ei).float().mean())} of ids differ from exact")
        bcl[n_probes] = secs
        emit(card, phase="geo", metric="ball_cover_knn", n_probes=n_probes, seconds=secs,
             queries=Qg.shape[0], waves=len(waves), max_abs_err=float((bv - ev).abs().max()))
    emit(card, phase="geo", metric="ball_cover_build", seconds=build_s, points=P.shape[0],
         landmarks=bci.n_landmarks, max_group=bci.group_rows.shape[1], exact_search_s=exact_s)
    del P, Qg, bci
    # (h) hnsw on phase 6's graph: write, load, search on B4
    path = os.path.join(tempfile.gettempdir(), f"chip_smoke_hnsw_{os.getpid()}.bin")
    try:
        def write():
            with open(path, "wb") as f:
                hnsw.serialize_to_hnswlib(cg, f)

        _, write_s = timed_build(write)
        file_bytes = os.path.getsize(path)

        def load():
            with open(path, "rb") as f:
                return hnsw.load_hnswlib(f, device="cuda")

        hidx, load_s = timed_build(load)
    finally:
        if os.path.exists(path):
            os.remove(path)
    if not (torch.equal(hidx.dataset, cg.dataset) and hidx.entrypoint == cg.size // 2):
        raise AssertionError("load_hnswlib did not give back the dataset and entry point")
    empty = int((cg.graph < 0).sum())
    rows_ids = torch.arange(cg.size, device=cg.graph.device, dtype=torch.int32)[:, None]
    graph = torch.where(cg.graph < 0, rows_ids, cg.graph)
    if not torch.equal(hidx.graph, graph):
        raise AssertionError("load_hnswlib did not give back the graph")
    ref_index = cg if empty == 0 else cagra.from_graph(cg.dataset, graph, cg.metric, device="cuda")
    cagra_search.cagra_fused_search.launches = 0
    (hv, hi), search_s = timed_build(lambda: hnsw.search(hidx, Qt, k, ef=128))
    table = hidx.to_cagra()._fused_table_cache[1]
    (hv2, hi2), search2_s = timed_build(lambda: hnsw.search(hidx, Qt, k, ef=128))
    b4 = cagra_search.cagra_fused_search.launches
    built_once = hidx.to_cagra()._fused_table_cache[1] is table
    rv, ri = cagra.search(ref_index, Qt, k, cagra.CagraSearchParams(itopk_size=128))
    if not (torch.equal(hi, ri) and torch.equal(hv, rv) and torch.equal(hi2, hi)):
        raise AssertionError("hnsw.search ids differ from cagra.search on the same graph")
    if b4 <= 0 or not built_once:
        raise AssertionError(f"hnsw.search launched B4 {b4} times, table built once: {built_once}")
    out.update(b4_launches=b4)
    emit(card, phase="geo", metric="hnsw", write_s=write_s, load_s=load_s, file_bytes=file_bytes,
         search_s=search_s, search_again_s=search2_s, queries=Qt.shape[0], ef=128,
         recall=neighborhood_recall(hi, gt_i), b4_launches=b4, table_built_once=built_once,
         empty_graph_slots=empty)
    del hidx
    out["phase_s"] = time.perf_counter() - t_phase
    emit(card, phase="geo", metric="phase_s", value=out["phase_s"])
    return out


#: phase 15's check shape (rows, columns), then its timed shapes: the square
#: matrices' side, R-MAT's edges and scale, the silhouette's and the
#: trustworthiness' rows
DATA_CHECK = (2048, 32)
DATA_SIZES = dict(square=4096, rmat_edges=1 << 24, rmat_scale=20, silhouette=65536,
                  trustworthiness=16384)


def data_phase(card, X_card, seed: int) -> dict:
    """Phase 15: the data and statistics primitives, plain PyTorch on the
    card (:func:`run_phases`'s ``data``). Each function runs on the card and
    on the CPU at a check shape (2,048 x 32): deterministic ones compared
    directly (rtol 1e-4, atol 1e-4; equal where the result is an integer),
    random ones (the CUDA and CPU generators differ) by their moments. Then
    each is timed at a user's shape: ``make_blobs`` 1M x 128, ``rmat`` at
    scale 20 with 16M edges, ``cov`` and ``minmax`` of the 1M x 128 rows,
    ``silhouette_score`` at 65,536 rows, ``trustworthiness_score`` at
    16,384, ``svd``/``qr``/``eig_dc``/``cholesky`` at 4,096^2, ``rsvd`` of the
    1M x 128 rows at rank 32, ``col_wise_sort`` and ``argmax`` of the 1M x
    128 rows. No hand kernel runs here."""
    from raft_tpu_torch import label, linalg, matrix, random, stats

    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 15])
    m, d = DATA_CHECK
    x = rng.standard_normal((m, d)).astype(np.float32)
    lab_a = rng.integers(0, 12, m)
    lab_b = np.where(rng.random(m) < 0.7, lab_a, rng.integers(0, 12, m))
    emb = x[:, :2] + 0.1 * rng.standard_normal((m, 2)).astype(np.float32)
    spd = (x[:256].T @ x[:256] / 256 + np.eye(d)).astype(np.float32)
    keys = rng.integers(0, 40, m)

    def sv(u):
        return linalg.svd(u)[1]

    checks = {
        "mean": lambda t: stats.mean(t["x"]),
        "stddev": lambda t: stats.stddev(t["x"], sample=True),
        "meanvar": lambda t: torch.stack(stats.meanvar(t["x"], along_rows=False)),
        "cov": lambda t: stats.cov(t["x"]),
        "weighted_mean": lambda t: stats.weighted_mean(t["x"], t["w"]),
        "minmax": lambda t: torch.stack(stats.minmax(t["x"])),
        "histogram": lambda t: stats.histogram(t["x"], 16, -3.0, 3.0),
        "contingency_matrix": lambda t: stats.contingency_matrix(t["a"], t["b"]),
        "adjusted_rand_index": lambda t: stats.adjusted_rand_index(t["a"], t["b"]),
        "v_measure": lambda t: stats.v_measure(t["a"], t["b"]),
        "silhouette_score": lambda t: stats.silhouette_score(t["x"], t["a"], chunk=512),
        "trustworthiness_score": lambda t: stats.trustworthiness_score(t["x"], t["e"], 5, chunk=512),
        "make_monotonic": lambda t: label.make_monotonic(t["a"] * 3 + 1)[0],
        "merge_labels": lambda t: label.merge_labels(t["a"], t["k"]),
        "gemm": lambda t: linalg.gemm(t["x"], t["x"], trans_b=True),
        "norm": lambda t: linalg.norm(t["x"], sqrt_out=True),
        "normalize": lambda t: linalg.normalize(t["x"]),
        "reduce_rows_by_key": lambda t: linalg.reduce_rows_by_key(t["x"], t["k"], 40),
        "eig_dc": lambda t: linalg.eig_dc(t["s"])[0],
        "svd": lambda t: sv(t["x"]),
        "qr": lambda t: (lambda q, r: q @ r)(*linalg.qr(t["x"])),
        "cholesky": lambda t: linalg.cholesky(t["s"]),
        "lstsq": lambda t: linalg.lstsq(t["x"], t["x"][:, :3]),
        "gather": lambda t: matrix.gather(t["x"], t["k"]),
        "argmax": lambda t: matrix.argmax(t["x"]),
        "col_wise_sort": lambda t: matrix.col_wise_sort(t["x"]),
        "sign_flip": lambda t: matrix.sign_flip(t["x"]),
    }
    host = dict(x=torch.from_numpy(x), w=torch.from_numpy(np.abs(x[:, 0]) + 0.1),
                a=torch.from_numpy(lab_a), b=torch.from_numpy(lab_b), e=torch.from_numpy(emb),
                s=torch.from_numpy(spd), k=torch.from_numpy(keys))
    dev = {name: v.cuda() for name, v in host.items()}
    worst = {}
    for name, fn in checks.items():
        got, want = fn(dev).cpu(), fn(host)
        if not got.dtype.is_floating_point:
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: the card and the CPU differ")
            worst[name] = 0.0
            continue
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{name}: the card and the CPU differ by {err}")
        worst[name] = err
    # random: the moments of card and CPU draws
    n_draw = 1 << 20
    moments = {}
    for name, fn in {"uniform": lambda g: random.uniform(g, (n_draw,), -1.0, 3.0),
                     "normal": lambda g: random.normal(g, (n_draw,), 2.0, 0.5),
                     "exponential": lambda g: random.exponential(g, (n_draw,), 4.0),
                     "gumbel": lambda g: random.gumbel(g, (n_draw,)),
                     "blob_noise": lambda g: (lambda X, lab, c: (X - c[lab.long()]).reshape(-1))(
                         *random.make_blobs(g, n_draw // 32, 32, 8, cluster_std=0.7)),
                     "rmat_src": lambda g: random.rmat(g, n_draw, 12, 10)[0].float()}.items():
        a = fn(random.as_key(seed, device=X_card.device)).double().cpu()
        b = fn(random.as_key(seed, device="cpu")).double()
        se = float(torch.sqrt(a.var() / a.numel() + b.var() / b.numel()))
        diff = float((a.mean() - b.mean()).abs())
        if diff > 5 * se or abs(float(a.std() / b.std()) - 1.0) > 0.01:
            raise AssertionError(f"{name}: card draws' moments differ from the CPU's")
        moments[name] = dict(mean_diff_in_se=diff / se, std_ratio=float(a.std() / b.std()))
    emit(card, phase="data", metric="card_vs_cpu", max_abs_err=worst, random_moments=moments,
         shape=[m, d])
    # timed at the users' shapes
    g = random.as_key(seed, device=X_card.device)
    n_rows = X_card.shape[0]
    side, n_sil, n_tw = DATA_SIZES["square"], DATA_SIZES["silhouette"], DATA_SIZES["trustworthiness"]
    n_edges, scale = DATA_SIZES["rmat_edges"], DATA_SIZES["rmat_scale"]
    lab64 = matrix.argmin(torch.cdist(X_card[:n_sil], X_card[:64]))
    sq = torch.randn((side, side), generator=g, device=g.device)
    sq_spd = sq @ sq.T / side + torch.eye(side, device=g.device)
    sq_sym = 0.5 * (sq + sq.T)
    timings = {
        "make_blobs": (lambda: random.make_blobs(g, n_rows, 128, 4096), 3),
        "rmat": (lambda: random.rmat(g, n_edges, scale, scale), 3),
        "cov": (lambda: stats.cov(X_card), 5),
        "minmax": (lambda: stats.minmax(X_card), 5),
        "silhouette": (lambda: stats.silhouette_score(X_card[:n_sil], lab64), 1),
        "trustworthiness": (lambda: stats.trustworthiness_score(
            X_card[:n_tw], X_card[:n_tw, :2], 5), 1),
        "svd_square": (lambda: linalg.svd(sq), 1),
        "qr_square": (lambda: linalg.qr(sq), 1),
        "eig_dc_square": (lambda: linalg.eig_dc(sq_sym), 1),
        "cholesky_square": (lambda: linalg.cholesky(sq_spd), 3),
        "rsvd_rank32": (lambda: linalg.rsvd(X_card, 32, key=g), 3),
        "col_wise_sort": (lambda: matrix.col_wise_sort(X_card), 5),
        "argmax": (lambda: matrix.argmax(X_card), 5),
    }
    ms = {name: cuda_ms(fn, reps) for name, (fn, reps) in timings.items()}
    # the timed results are right too
    _, s_r, _ = linalg.rsvd(X_card, 32, key=g)
    s_full = torch.sqrt(torch.linalg.eigvalsh(X_card.double().T @ X_card.double()).flip(0))
    rel = ((s_r.double() - s_full[:32]) / s_full[:32]).abs()
    # the rows span 16 latent directions plus isotropic noise: the 16 leading
    # values are held; the noise floor's flat tail is only reported
    rsvd_err, rsvd_tail = float(rel[:16].max()), float(rel[16:].max())
    w, v = linalg.eig_dc(sq_sym)
    eig_res = float((sq_sym @ v - v * w[None, :]).abs().max())
    src, dst = random.rmat(g, n_edges, scale, scale)
    if not (0 <= int(src.min()) and int(src.max()) < 1 << scale and int(dst.max()) < 1 << scale):
        raise AssertionError("rmat ids out of range")
    if rsvd_err > 1e-3 or eig_res > 1e-2:
        raise AssertionError(f"rsvd relative error {rsvd_err}, eig_dc residual {eig_res}")
    out = {"ms": ms, "rsvd_rel_err": rsvd_err, "eig_dc_residual": eig_res}
    out["phase_s"] = time.perf_counter() - t_phase
    emit(card, phase="data", metric="ms", value=ms, rsvd_top16_rel_err=rsvd_err,
         rsvd_17_to_32_rel_err=rsvd_tail,
         eig_dc_residual=eig_res, rows=n_rows, **DATA_SIZES)
    emit(card, phase="data", metric="phase_s", value=out["phase_s"])
    return out


#: phase 16's check shapes: the linalg matrix (rows, columns, density), the
#: native and densify distance inputs (rows, columns), the rows the CPU
#: computes of each distance matrix, the MST's and single linkage's points,
#: the Lanczos graph's communities and size, the LAP's n
GRAPH_CHECK = dict(linalg=(2048, 4096, 0.02), native=(512, 1 << 20), densify=(512, 4096),
                   cpu_rows=64, points=4096, communities=(8, 512), lap=256)
#: phase 16's users' shapes: the sparse corpus (rows, columns: scikit-learn's
#: HashingVectorizer default width, mean nnz a row), its queries, the copy's
#: width and the queries held on it, the blobs (rows, dims, blobs) behind
#: the kNN graph (k = c), the spectral clusters, the LAP's n
GRAPH_SIZES = dict(rows=100_000, width=1 << 20, nnz=64, queries=1024, copy_width=16384,
                   copy_queries=256, blobs=(100_000, 32, 8), c=15, clusters=8, lap=1024)


def random_csr(rng, rows: int, width: int, mean_nnz: int, device):
    """A CSR matrix of ``rows`` rows, each about ``mean_nnz`` distinct sorted
    columns (the count Poisson from ``rng``, at least 1, the columns uniform)
    with values in [0.1, 1.1), like TF-IDF rows; built on the host."""
    from raft_tpu_torch import sparse

    counts = np.maximum(rng.poisson(mean_nnz, rows), 1)
    row = np.repeat(np.arange(rows, dtype=np.int64), counts)
    key = np.unique(row * width + rng.integers(0, width, row.size))  # sorted, distinct
    indptr = np.zeros(rows + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(key // width, minlength=rows))
    vals = (0.1 + rng.random(key.size)).astype(np.float32)
    return sparse.CSR(torch.from_numpy(indptr.astype(np.int32)).to(device),
                      torch.from_numpy((key % width).astype(np.int32)).to(device),
                      torch.from_numpy(vals).to(device), (rows, width))


def sparse_to(m, device):
    """A COO or CSR with its tensors on ``device``."""
    return dataclasses.replace(m, **{f.name: getattr(m, f.name).to(device)
                                     for f in dataclasses.fields(m) if f.name != "shape"})


def csr_head(a, rows: int):
    """The CSR of ``a``'s first ``rows`` rows."""
    end = int(a.indptr[rows])
    return type(a)(a.indptr[: rows + 1], a.indices[:end], a.vals[:end], (rows, a.shape[1]))


def held_card_vs_cpu(what: str, got, want, tol: float = 1e-4) -> float:
    """Integers and structure equal, floats allclose at rtol/atol ``tol``:
    the largest absolute difference."""
    worst = 0.0
    for g, w in zip(got, want):
        g = g.cpu() if isinstance(g, torch.Tensor) else torch.as_tensor(g)
        w = w.cpu() if isinstance(w, torch.Tensor) else torch.as_tensor(w)
        if g.shape != w.shape:
            raise AssertionError(f"{what}: shape {tuple(g.shape)} on the card, {tuple(w.shape)} on the CPU")
        if not g.dtype.is_floating_point:
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: the card and the CPU differ")
            continue
        both_inf = torch.isinf(g) & torch.isinf(w) & (torch.sign(g) == torch.sign(w))
        diff = torch.where(both_inf, torch.zeros_like(g), (g.double() - w.double()).abs())
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        if not torch.allclose(torch.where(both_inf, 0.0, g), torch.where(both_inf, 0.0, w),
                              rtol=tol, atol=tol):
            raise AssertionError(f"{what}: the card and the CPU differ by {worst}")
    return worst


def same_knn_but_ties(what: str, got, want, rtol: float = 1e-5) -> float:
    """Values allclose at ``rtol``; where the ids differ the two values lie
    within ``rtol`` of each other (a tie). Returns the share of equal ids."""
    gv, gi = (t.cpu() for t in got)
    wv, wi = (t.cpu() for t in want)
    tol = rtol * torch.clamp(wv.abs(), min=1.0)
    if not ((gv - wv).abs() <= tol).all():
        raise AssertionError(f"{what}: values differ by {float((gv - wv).abs().max())}")
    differ = gi != wi
    if ((gv - wv).abs() > tol)[differ].any():
        raise AssertionError(f"{what}: an id differs where the values do not tie")
    return 1.0 - float(differ.to(torch.float32).mean())


def integer_blobs(rng, n: int, d: int, blobs: int) -> np.ndarray:
    """Integer points about integer centres: every distance the kNN graph
    takes is exact in f32, so the card and the CPU build one tree."""
    centers = rng.integers(-60, 61, (blobs, d))
    return (centers[rng.integers(0, blobs, n)] + rng.integers(-3, 4, (n, d))).astype(np.float32)


def community_laplacian(rng, communities: int, size: int):
    """The COO adjacency of ``communities`` random graphs of ``size`` nodes
    (edge probability 0.05 inside, 0.001 across), and a function of a device
    that gives its Laplacian's matvec there. The smallest eigenvalues (0,
    then ``communities - 1`` small ones) stand apart from the rest."""
    from raft_tpu_torch import sparse

    n = communities * size
    block = np.arange(n) // size
    p = np.where(block[:, None] == block[None, :], 0.05, 0.001)
    a = np.triu(rng.random((n, n)) < p, 1)
    r, c = np.nonzero(a | a.T)
    coo = sparse.COO(torch.from_numpy(r.astype(np.int32)), torch.from_numpy(c.astype(np.int32)),
                     torch.ones(r.size), (n, n))

    def matvec_on(device):
        g = sparse_to(coo, device)
        csr = sparse.coo_to_csr(g)
        deg = sparse.linalg.degree(g).to(torch.float32)
        return lambda v: deg * v - sparse.linalg.spmv(csr, v)

    return coo, matvec_on


def graph_checks(card, seed: int):
    """Phase 16's part (a), the card against the CPU (see
    :func:`graph_phase`); it times nothing, so the whole run calls it while
    the kernels build. Returns the generator part (b) goes on drawing from."""
    from raft_tpu_torch import sparse
    from raft_tpu_torch.cluster import single_linkage
    from raft_tpu_torch.ops.distance import DistanceType
    from raft_tpu_torch.solver import lap

    t_phase = time.perf_counter()
    sl = sparse.linalg
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rng = np.random.default_rng([seed, 16])
    worst = {}

    # -- (a) the card against the CPU ----------------------------------------------------------
    m, n, density = GRAPH_CHECK["linalg"]
    dense = (rng.random((m, n)) * (rng.random((m, n)) < density)).astype(np.float32)
    square = (rng.random((m, m)) * (rng.random((m, m)) < density)).astype(np.float32)
    other = (rng.random((m, n)) * (rng.random((m, n)) < density)).astype(np.float32)
    host = dict(a=sparse.csr_from_dense(dense, device=cpu), sq=sparse.coo_from_dense(square, device=cpu),
                o=sparse.coo_from_dense(other, device=cpu),
                v=torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
                b=torch.from_numpy(rng.standard_normal((n, 32)).astype(np.float32)),
                da=torch.from_numpy(rng.standard_normal((m, 64)).astype(np.float32)),
                db=torch.from_numpy(rng.standard_normal((64, n)).astype(np.float32)))
    dev = {k: sparse_to(v, cuda) if dataclasses.is_dataclass(v) else v.to(cuda) for k, v in host.items()}
    linalg_checks = {
        "spmv": lambda t: (sl.spmv(t["a"], t["v"]),),
        "spmm": lambda t: (sl.spmm(t["a"], t["b"]),),
        "sddmm": lambda t: (lambda c: (c.rows, c.cols, c.vals))(
            sl.sddmm(t["da"], t["db"], t["a"].to_coo(), alpha=2.0, beta=0.5)),
        "transpose": lambda t: (lambda c: (c.indptr, c.indices, c.vals))(sl.transpose(t["a"])),
        "degree": lambda t: (sl.degree(t["a"].to_coo()),),
        "row_norm_csr_l1": lambda t: (sl.row_norm_csr(t["a"], "l1"),),
        "row_norm_csr_l2": lambda t: (sl.row_norm_csr(t["a"], "l2"),),
        "row_norm_csr_linf": lambda t: (sl.row_norm_csr(t["a"], "linf"),),
        "symmetrize_max": lambda t: (lambda c: (c.rows, c.cols, c.vals))(sl.symmetrize(t["sq"], "max")),
        "symmetrize_mean": lambda t: (lambda c: (c.rows, c.cols, c.vals))(sl.symmetrize(t["sq"], "mean")),
        "add": lambda t: (lambda c: (c.rows, c.cols, c.vals, c.to_dense()))(sl.add(t["o"], t["a"].to_coo())),
        "coo_to_csr": lambda t: (lambda c: (c.indptr, c.indices, c.vals))(sparse.coo_to_csr(t["sq"])),
    }
    for name, fn in linalg_checks.items():
        worst[name] = held_card_vs_cpu(name, fn(dev), fn(host))

    cpu_rows = GRAPH_CHECK["cpu_rows"]
    natives = sorted(sparse.distance._NATIVE, key=int)
    for mode, (rows, width), metrics in (
            ("native", GRAPH_CHECK["native"], natives),
            ("densify", GRAPH_CHECK["densify"],
             [d for d in DistanceType if d not in (DistanceType.Haversine, DistanceType.Precomputed)])):
        xh, yh = (random_csr(rng, rows, width, 64, cpu) for _ in range(2))
        xd, yd = sparse_to(xh, cuda), sparse_to(yh, cuda)
        xh = csr_head(xh, cpu_rows)
        for metric in metrics:
            arg = 3.0 if metric == DistanceType.LpUnexpanded else 2.0
            got = sparse.pairwise_distance_sparse(xd, yd, metric, metric_arg=arg, mode=mode)
            want = sparse.pairwise_distance_sparse(xh, yh, metric, metric_arg=arg, mode=mode)
            worst[f"{mode}_{metric.name}"] = held_card_vs_cpu(f"{mode} {metric.name}",
                                                              (got[:cpu_rows],), (want,))

    pts = Clustered(rng, 16, 64).sample(GRAPH_CHECK["points"])
    g_host = sparse.knn_graph(pts, 15, device=cpu)
    t_mst, c_mst = sparse.mst(sparse_to(g_host, cuda)), sparse.mst(g_host)
    for f in ("src", "dst", "weights"):
        if not np.array_equal(getattr(t_mst, f), getattr(c_mst, f)):
            raise AssertionError(f"mst: the card's {f} differ from the CPU's")
    ipts = integer_blobs(rng, GRAPH_CHECK["points"], 16, 16)
    t_sl = single_linkage(ipts, n_clusters=16, device=cuda)
    c_sl = single_linkage(ipts, n_clusters=16, device=cpu)
    if not (np.array_equal(t_sl.labels, c_sl.labels) and np.array_equal(t_sl.children, c_sl.children)
            and np.array_equal(t_sl.sizes, c_sl.sizes)):
        raise AssertionError("single_linkage: the card's labels, children or sizes differ from the CPU's")
    worst["single_linkage_deltas"] = held_card_vs_cpu("single_linkage deltas", (t_sl.deltas,),
                                                      (c_sl.deltas,))
    coo, matvec_on = community_laplacian(rng, *GRAPH_CHECK["communities"])
    n_lap = coo.shape[0]
    k_eig = GRAPH_CHECK["communities"][0]
    lam_d, vec_d = sparse.lanczos(matvec_on(cuda), n_lap, k_eig, m=64, key=seed, device=cuda)
    lam_h, _ = sparse.lanczos(matvec_on(cpu), n_lap, k_eig, m=64, key=seed, device=cpu)
    eig_err = float((lam_d.cpu() - lam_h).abs().max())
    if not torch.allclose(lam_d.cpu(), lam_h, rtol=1e-3, atol=1e-3):
        raise AssertionError(f"lanczos: eigenvalues differ by {eig_err}: {lam_d.tolist()} {lam_h.tolist()}")
    worst["lanczos_eigenvalues"] = eig_err
    cost = rng.random((GRAPH_CHECK["lap"], GRAPH_CHECK["lap"]))
    got, want = lap.lap_solve(cost), lap.lap_solve_reference(cost)
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and abs(got[2] - want[2]) <= 1e-12 * abs(want[2])):
        raise AssertionError("lap_solve: the C solver differs from the plain numpy solver")
    emit(card, phase="graph", metric="card_vs_cpu", max_abs_err=worst,
         mst_edges=int(t_mst.n_edges), lanczos_eigenvalues=lam_d.tolist(),
         lap_total=got[2], shapes=GRAPH_CHECK, check_s=time.perf_counter() - t_phase)

    return rng


def graph_phase(card, seed: int, rng=None) -> dict:
    """Phase 16: sparse containers and linalg, sparse distances and kNN, the
    kNN graph, MST, Lanczos, single linkage, spectral partitioning and the
    LAP solver, plain PyTorch on the card (the LAP a C solver on the host;
    :func:`run_phases`'s ``graph``). No hand kernel runs here.

    (a) The card against the CPU at check shapes (:data:`GRAPH_CHECK`):
    every ``sparse.linalg`` function on a 2,048 x 4,096 CSR at 2 % density
    (floats within rtol/atol 1e-4, integers and structure equal);
    ``pairwise_distance_sparse`` under every native metric at 512 x 2^20
    columns and under every computable metric but Haversine in the densify
    mode at 512 x 4,096 (the CPU computes the first 64 rows; rtol/atol
    1e-4); ``mst`` of one host-built COO (the kNN graph of 4,096 points;
    edges equal); ``single_linkage`` of 4,096 x 16 integer points (labels and
    children equal, deltas within 1e-4); ``lanczos`` on a community graph's
    Laplacian (the 8 smallest eigenvalues within rtol 1e-3, atol 1e-3 for
    the zero mode: the CUDA and CPU generators differ); ``lap_solve`` at
    n = 256 equal to the plain numpy solver.

    (b) Timed at users' shapes (:data:`GRAPH_SIZES`): ``knn_sparse`` k = 10
    under ``CosineExpanded`` and ``L1``, native over 100,000 rows x 2^20
    columns (about 64 nnz a row) for 1,024 queries, and both modes over a
    16,384-column copy for 256 queries (the densify path's accumulation
    metrics take about 80 ms a 1,024-row block there), where the native ids
    equal the densify path's but for ties within 1e-5; ``spmm`` of the kNN graph's
    CSR by a 100,000 x 32 block; ``knn_graph``, ``mst`` and
    ``single_linkage`` of 100,000 x 32 blobs at c = 15 (n - 1 merges, the
    last of size n; the ARI against the blob labels reported); ``partition``
    and ``modularity_maximization`` at 8 clusters with ``analyze_partition``
    and ``modularity`` on that graph; ``lap_solve`` at n = 1,024."""
    from raft_tpu_torch import random as trandom
    from raft_tpu_torch import sparse, spectral, stats
    from raft_tpu_torch.cluster import single_linkage
    from raft_tpu_torch.ops.distance import DistanceType
    from raft_tpu_torch.solver import lap

    t_phase = time.perf_counter()
    if rng is None:  # part (a) has not run yet
        rng = graph_checks(card, seed)
    sl = sparse.linalg
    cuda = torch.device("cuda")

    # -- (b) timed at the users' shapes ----------------------------------------------------------
    def once_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    S = GRAPH_SIZES
    ms, checks = {}, {}
    y = random_csr(rng, S["rows"], S["width"], S["nnz"], cuda)
    x = random_csr(rng, S["queries"], S["width"], S["nnz"], cuda)
    y16 = random_csr(rng, S["rows"], S["copy_width"], S["nnz"], cuda)
    x16 = random_csr(rng, S["copy_queries"], S["copy_width"], S["nnz"], cuda)
    for metric in (DistanceType.CosineExpanded, DistanceType.L1):
        name = metric.name
        ms[f"knn_sparse_copy_native_{name}"], nat = once_ms(
            lambda: sparse.knn_sparse(x16, y16, 10, metric, mode="native"))
        ms[f"knn_sparse_copy_densify_{name}"], den = once_ms(
            lambda: sparse.knn_sparse(x16, y16, 10, metric, mode="densify"))
        checks[f"ids_equal_{name}"] = same_knn_but_ties(f"knn_sparse {name}", nat, den)
        ms[f"knn_sparse_native_{name}"], (v, i) = once_ms(
            lambda: sparse.knn_sparse(x, y, 10, metric, mode="native"))
        if not (torch.isfinite(v).all() and tuple(i.shape) == (S["queries"], 10)
                and int(i.min()) >= 0 and int(i.max()) < S["rows"]):
            raise AssertionError(f"knn_sparse native {name}: bad values or ids")
    del y, x, y16, x16

    nb, db, kb = S["blobs"]
    Xb, yb, _ = trandom.make_blobs(seed, nb, db, n_clusters=kb, device=cuda)
    ms["knn_graph"], g = once_ms(lambda: sparse.knn_graph(Xb, S["c"]))
    csr = sparse.coo_to_csr(g)
    block = torch.randn((nb, 32), device=cuda, generator=torch.Generator(device=cuda).manual_seed(seed))
    ms["spmm"] = cuda_ms(lambda: sl.spmm(csr, block), reps=10)
    ms["mst"], forest = once_ms(lambda: sparse.mst(g))
    ms["single_linkage"], out = once_ms(lambda: single_linkage(Xb, n_clusters=kb, c=S["c"]))
    if out.children.shape != (nb - 1, 2) or int(out.sizes[-1]) != nb:
        raise AssertionError(f"single_linkage: {out.children.shape[0]} merges, the last of size "
                             f"{int(out.sizes[-1])} (expected {nb - 1} and {nb})")
    checks["single_linkage_ari"] = float(stats.adjusted_rand_index(yb.cpu(), torch.from_numpy(out.labels)))
    checks["knn_graph_mst_edges"] = int(forest.n_edges)
    kc = S["clusters"]
    ms["partition"], (labels, emb) = once_ms(lambda: spectral.partition(g, kc, seed=seed))
    ms["modularity_maximization"], mod_labels = once_ms(
        lambda: spectral.modularity_maximization(g, kc, seed=seed))
    ms["analyze_partition"], (edge_cut, ratio_cut) = once_ms(lambda: spectral.analyze_partition(g, labels))
    ms["modularity"], q = once_ms(lambda: spectral.modularity(g, mod_labels))
    if not (np.isfinite([edge_cut, ratio_cut, q]).all() and torch.isfinite(emb).all()
            and labels.shape == (nb,) and mod_labels.shape == (nb,)):
        raise AssertionError("spectral: non-finite results or wrong shapes")
    checks.update(partition_ari=float(stats.adjusted_rand_index(yb.cpu(), torch.from_numpy(labels))),
                  modularity_ari=float(stats.adjusted_rand_index(yb.cpu(), torch.from_numpy(mod_labels))),
                  edge_cut=edge_cut, ratio_cut=ratio_cut, modularity=q)
    big = rng.random((S["lap"], S["lap"]))
    t0 = time.perf_counter()
    _, _, total = lap.lap_solve(big)
    ms["lap_solve"] = (time.perf_counter() - t0) * 1e3
    checks["lap_total"] = total
    out = {"ms": ms, "checks": checks, "phase_s": time.perf_counter() - t_phase}
    emit(card, phase="graph", metric="ms", value=ms, checks=checks, sizes=S,
         nnz=dict(knn_graph=g.nnz))
    emit(card, phase="graph", metric="phase_s", value=out["phase_s"])
    return out


# -- phase 17: multi-process meshes ----------------------------------------------------

#: merge modes phase 17 runs in every process
PROCS_MODES = ("ring", "fused_ring", "gather")


def procs_verb_blocks(n: int, seed: int = 23):
    """Phase 17's verb inputs for a world of ``n``: ``[n, 4, 3]`` blocks
    and ``[n, n, 2, 3]`` scatter buffers (f32, one a rank)."""
    rng = np.random.default_rng([seed, n])
    return (rng.standard_normal((n, 4, 3)).astype(np.float32),
            rng.standard_normal((n, n, 2, 3)).astype(np.float32))


def procs_verbs_numpy(n: int):
    """Every verb's output on each rank, computed in numpy from
    :func:`procs_verb_blocks` (reductions in rank order, as the verbs add)."""
    x, sc = procs_verb_blocks(n)

    def ordered(op):
        acc = x[0].copy()
        for b in x[1:]:
            acc = op(acc, b)
        return acc

    red = {"sum": ordered(np.add), "max": ordered(np.maximum), "min": ordered(np.minimum),
           "prod": ordered(np.multiply)}
    zero = np.zeros_like(x[0])
    c = x.shape[1] // n if x.shape[1] % n == 0 else None
    want = {}
    for r in range(n):
        w = {f"allreduce_{op}": v for op, v in red.items()}
        w["allgather"] = x
        w["allgather_tiled"] = x.reshape(-1, x.shape[2])
        if c:
            w["reducescatter"] = red["sum"][r * c:(r + 1) * c]
        w["bcast"] = x[n - 1]
        w["reduce"] = red["sum"] if r == n - 1 else zero
        w["ppermute"] = x[(r - 1) % n]
        w["send_recv"] = x[0] if r == n - 1 else zero
        w["barrier"] = np.array(n, np.int32)
        w["gather"] = x if r == n - 1 else np.zeros_like(x)
        w["scatter"] = sc[n - 1][r]
        partner = {0: n - 1, n - 1: 0}
        w["device_sendrecv"] = x[partner[r]] if r in partner and n > 1 else (
            x[r] if n == 1 else zero)
        src = {0: n - 1, n // 2: n - 1}
        w["multicast_sendrecv"] = x[src[r]] if r in src else zero
        w["comm_rank"] = np.array(r, np.int32)
        want[r] = w
    return want


def procs_verbs(mesh, n: int) -> dict:
    """Every verb over ``mesh`` (one local shard a process) against
    :func:`procs_verbs_numpy`: ``{verb: equal}`` for this process's rank."""
    from raft_tpu_torch.parallel import comms

    x, sc = procs_verb_blocks(n)
    r = mesh.local_ranks[0]
    dev = mesh.devices[0]
    xs = [torch.from_numpy(x[r]).to(dev)]
    scs = [torch.from_numpy(sc[r]).to(dev)]
    got = {f"allreduce_{op}": comms.allreduce(mesh, xs, op=op) for op in ("sum", "max", "min",
                                                                           "prod")}
    got["allgather"] = comms.allgather(mesh, xs)
    got["allgather_tiled"] = comms.allgather(mesh, xs, tiled=True)
    if x.shape[1] % n == 0:
        got["reducescatter"] = comms.reducescatter(mesh, xs)
    got["bcast"] = comms.bcast(mesh, xs, root=n - 1)
    got["reduce"] = comms.reduce(mesh, xs, root=n - 1)
    got["ppermute"] = comms.ppermute(mesh, xs, [(i, (i + 1) % n) for i in range(n)])
    got["send_recv"] = comms.send_recv(mesh, xs, 0, n - 1)
    got["barrier"] = comms.barrier(mesh)
    got["gather"] = comms.gather(mesh, xs, root=n - 1)
    got["scatter"] = comms.scatter(mesh, scs, root=n - 1)
    got["device_sendrecv"] = comms.device_sendrecv(mesh, xs, [(0, n - 1)] if n > 1 else [])
    got["multicast_sendrecv"] = comms.multicast_sendrecv(mesh, xs, [(n - 1, 0), (n - 1, n // 2)])
    got["comm_rank"] = comms.comm_rank(mesh)
    torch.cuda.synchronize()
    want = procs_verbs_numpy(n)[r]
    if n == 1:
        want["device_sendrecv"] = np.zeros_like(x[0])
    return {v: bool(np.array_equal(t[0].cpu().numpy(), want[v])) for v, t in got.items()}


#: the fields of an IVF-PQ index phase 17 digests
PQ_FIELDS = ("centers", "rotation", "pq_centers", "codes", "list_indices", "list_sizes",
             "rot_sqnorms")


def index_digest(index) -> dict:
    """A short sha256 of each field's bytes (indexes too large to ship
    between processes are compared by these)."""
    return {f: hashlib.sha256(getattr(index, f).contiguous().cpu().numpy().tobytes())
            .hexdigest()[:20] for f in PQ_FIELDS}


def with_verb_clock(fn):
    """``(fn(), {"s", "calls"})``: the host seconds spent inside the
    ``comms.allreduce`` and ``comms.allgather`` calls ``fn`` makes (the
    distributed build's exchanges: on a gloo process mesh the pinned host
    hops and the wait for the sender's stream)."""
    from raft_tpu_torch.parallel import comms

    clock = {"s": 0.0, "calls": 0}
    saved = {v: getattr(comms, v) for v in ("allreduce", "allgather")}

    def timed(f):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return f(*a, **kw)
            finally:
                clock["s"] += time.perf_counter() - t0
                clock["calls"] += 1
        return call

    for v, f in saved.items():
        setattr(comms, v, timed(f))
    try:
        return fn(), clock
    finally:
        for v, f in saved.items():
            setattr(comms, v, f)


def holds_first(mesh, axis: str, s: int) -> bool:
    """Whether this process holds the first shard at coordinate ``s`` along
    ``axis`` (always on one controller)."""
    return min(r for r in range(mesh.size) if mesh.coord(r, axis) == s) in mesh.local_ranks


def tiered_budget(pq_index, n_shards: int) -> int:
    """Phase 11 (f)'s per-shard budget: the codes stay, half the raw rows
    would not fit, so a sharded registration with ``dataset=`` converts to
    ``tiered_sharded``."""
    from raft_tpu_torch.ops import hbm_model

    r = hbm_model.residency_for_index("sharded_pq", "ivf_pq", pq_index, refine_rows=pq_index.size)
    req = sum(c.per_shard_bytes(n_shards) for c in r.components if c.required)
    raw = sum(c.per_shard_bytes(n_shards) for c in r.components if not c.required)
    _, stage_dev = hbm_model.staging_footprint(pq_index.dim)
    return int((req + stage_dev + raw // 2) / hbm_model.HBM_HEADROOM)


def serve_requests(eng, index_id: str, Q, sizes, k: int):
    """Every request of ``sizes`` (consecutive rows of ``Q``) submitted in
    order, then ``run_until_idle()``: the batches form from the queue
    alone. Returns ``(dist, ids, {(coverage, failed_shards)}, seconds)``."""
    starts = np.cumsum([0] + list(sizes[:-1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [eng.submit(index_id, Q[s:s + m], k) for s, m in zip(starts, sizes)]
    eng.run_until_idle()
    out = [f.result() for f in futs]
    secs = time.perf_counter() - t0
    return (np.concatenate([r.distances for r in out]), np.concatenate([r.indices for r in out]),
            sorted({(r.coverage, tuple(r.failed_shards)) for r in out}), secs)


def entry_cases(mesh, axis: str, flat, pq, cg, X_card, Q, spec, modes=("full", "ca"),
              parts=("build", "query", "tiered", "down")):
    """Phase 17's other sharded entry points on ``mesh`` along ``axis``, the
    same in the parent (one controller) and in every process of a world:
    ``sharded_ivf_pq_build`` of the 1M rows for each of ``modes`` (digests,
    seconds, host seconds of its exchanges), ``sharded_ivf_pq_search`` and
    ``sharded_cagra_search`` of ``spec["qs_queries"]`` queries, phase 11
    (f)'s ``tiered_sharded`` registration served under ring, fused_ring and
    gather, and a ``sharded_ivf_flat`` registration served with shard 1's
    probe failing in the one process that holds its first shard. Returns
    ``(arrays, info)``."""
    from raft_tpu_torch.core.errors import ShardFailure
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.parallel import (sharded_cagra_search, sharded_ivf_pq_build,
                                         sharded_ivf_pq_search)
    from raft_tpu_torch.robust import faults
    from raft_tpu_torch.serve import ServingEngine

    k = spec["k"]
    dev = mesh.devices[0]
    arrays, info = {}, {"build_s": {}, "build_verb_host_s": {}, "build_verb_calls": {},
                        "s": {}, "digest": {}}
    if "build" in parts:
        bp = ivf_pq.IvfPqIndexParams(**spec["build"])
        for mode in modes:
            (idx, secs), clock = with_verb_clock(lambda: timed_build(
                lambda: sharded_ivf_pq_build(mesh, X_card, bp, axis=axis, comm_mode=mode)))
            info["build_s"][mode], info["digest"][mode] = secs, index_digest(idx)
            info["build_verb_host_s"][mode] = clock["s"]
            info["build_verb_calls"][mode] = clock["calls"]
            del idx
    pp = ivf_pq.IvfPqSearchParams(n_probes=spec["pq_probes"])
    if "query" in parts:
        Qt = torch.from_numpy(Q[:spec["qs_queries"]]).to(dev)
        cp = cagra.CagraSearchParams(**spec["cagra"])
        for name, fn in (("qs_pq", lambda: sharded_ivf_pq_search(mesh, pq, Qt, k, pp, axis=axis)),
                         ("qs_cagra", lambda: sharded_cagra_search(mesh, cg, Qt, k, cp,
                                                                    axis=axis))):
            (d, i), info["s"][name] = timed_build(fn)
            arrays[name + "_d"], arrays[name + "_i"] = d.cpu().numpy(), i.cpu().numpy()
    res = Resources(device=str(dev))
    if "tiered" in parts:
        eng = ServingEngine(max_batch=128, max_wait_ms=0.0, queue_capacity=len(Q), res=res,
                            hbm_budget_bytes=tiered_budget(pq, mesh.shape[axis]))
        eng.register("ring", "sharded_ivf_pq_lists", pq, params=pp, mesh=mesh, axis=axis,
                     dataset=X_card, merge_mode="ring")
        tsi = eng._indexes["ring"].index
        info["tiered_algo"] = eng._indexes["ring"].algo
        for mode in PROCS_MODES[1:]:
            eng.register(mode, "tiered_sharded", tsi, merge_mode=mode)
        for mode in PROCS_MODES:
            d, i, cov, info["s"]["tiered_" + mode] = serve_requests(eng, mode, Q,
                                                                  spec["tiered_sizes"], k)
            arrays[f"tiered_{mode}_d"], arrays[f"tiered_{mode}_i"] = d, i
            info["tiered_cov_" + mode] = cov
        del eng, tsi
    if "down" in parts:
        eng = ServingEngine(max_batch=128, max_wait_ms=0.0, queue_capacity=len(Q), res=res)
        eng.register("down", "sharded_ivf_flat", flat,
                     params=ivf_flat.IvfFlatSearchParams(n_probes=spec["n_probes"]), mesh=mesh,
                     axis=axis)
        here = holds_first(mesh, axis, 1)
        ctx = (faults.injected("sharded_ann.shard_scan", error=ShardFailure("down", shard=1),
                               match={"shard": 1}) if here else contextlib.nullcontext())
        with ctx:
            d, i, cov, info["s"]["down"] = serve_requests(eng, "down", Q, spec["down_sizes"], k)
        arrays["down_d"], arrays["down_i"], info["down_cov"] = d, i, cov
        info["fault_installed_here"] = here
    return arrays, info


def procs_child(rank: int, world: int, work: str, backend: str, device: str, tag: str) -> int:
    """One process of a phase 17 world: bootstrap (``init_distributed`` at
    the world's address), the comms self test and every verb against numpy
    on its shard of ``global_mesh()`` (its card by default), then (unless the
    world is the NCCL world of one) the lists-sharded searches of the
    parent's saved indexes under every merge mode over the 10,000 (IVF-Flat)
    and 2,048 (IVF-PQ) queries in 1,024-row batches, ``sharded_knn`` on the
    1M rows at 1,024 queries and phase 7's scan ring (80-wide tiles, B7),
    timed per batch with the hops' host seconds apart, with its
    ``ring_stage`` launches (and those that fold wider tiles, B7's scan
    fold), its B5 ``ring_fold`` launches and its ``ring_onecard`` launches
    (B6 and B7 on one card; none here); then one more ring batch with
    each B5 fold held against ``hop_merge_reference`` on the card (launches
    not counted); then the other sharded entry points (:func:`entry_cases`: the
    distributed build full and CA, the query-sharded IVF-PQ and CAGRA
    searches, tiered sharded serving under every merge mode, the
    one-process fault), their ring launches counted apart. The NCCL world
    of one runs ``sharded_knn`` against single-device brute force, the
    build, and the query-sharded searches against the single-device
    searches. Writes ``{tag}_rank{rank}.npz`` and prints one JSON line."""
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import ring_topk as rt
    from raft_tpu_torch.parallel import (bootstrap, sharded_ivf_flat_search,
                                         sharded_ivf_pq_lists_search, sharded_knn)

    t0 = time.perf_counter()
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    assert bootstrap.init_distributed(spec["address"][tag], world, rank, backend=backend,
                                      timeout_s=spec["timeout_s"])
    mesh = bootstrap.global_mesh()  # this process's card, gloo or NCCL
    assert mesh.devices == (dev,), (mesh.devices, dev)
    out = {"tag": tag, "rank": rank, "world": world, "backend": backend, "mesh": repr(mesh),
           "init_s": time.perf_counter() - t0, "self_test": bootstrap.run_comms_self_test(mesh),
           "verbs": procs_verbs(mesh, world)}
    k, qb = spec["k"], spec["qb"]
    Qn = np.load(os.path.join(work, "Q.npy"))
    Q = torch.from_numpy(Qn).to(dev)
    X = torch.from_numpy(np.load(os.path.join(work, "X.npy"))).to(dev)
    arrays = {}
    if spec["searches"][tag]:
        t1 = time.perf_counter()
        flat = ivf_flat.load_path(os.path.join(work, "flat.idx"), device=dev)
        pq = ivf_pq.load_path(os.path.join(work, "pq.idx"), device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t1
        fp = ivf_flat.IvfFlatSearchParams(n_probes=spec["n_probes"])
        pp = ivf_pq.IvfPqSearchParams(n_probes=spec["pq_probes"])
        counted = (rt.hop_merge, rt.fused_ring_topk, rt.fused_scan_ring_topk)
        for f in counted:
            f.launches = 0
        rt.fused_ring_topk.stage_launches = 0
        rt.fused_scan_ring_topk.stage_launches = 0
        rt.fused_ring_topk.hop_s = 0.0
        timing = {}

        def batched(fn, n_q):
            outs = [fn(Q[s:s + qb]) for s in range(0, n_q, qb)]
            return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

        for mode in PROCS_MODES:
            for name, n_q, fn in (
                    ("flat", Q.shape[0], lambda qc: sharded_ivf_flat_search(
                        mesh, flat, qc, k, fp, merge_mode=mode)),
                    ("pq", spec["pq_queries"], lambda qc: sharded_ivf_pq_lists_search(
                        mesh, pq, qc, k, pp, merge_mode=mode)),
                    ("knn", spec["knn_queries"], lambda qc: sharded_knn(
                        mesh, X, qc, k, metric="sqeuclidean", merge_mode=mode))):
                torch.cuda.synchronize()
                h0, t1 = rt.fused_ring_topk.hop_s, time.perf_counter()
                d, i = batched(fn, n_q)
                torch.cuda.synchronize()
                n_b = -(-n_q // qb)
                timing[f"{name}_{mode}"] = {
                    "s_per_batch": (time.perf_counter() - t1) / n_b,
                    "hop_host_s_per_batch": (rt.fused_ring_topk.hop_s - h0) / n_b}
                arrays[f"{name}_{mode}_d"] = d.cpu().numpy()
                arrays[f"{name}_{mode}_i"] = i.cpu().numpy()
        # B7 on the path: this shard's scan at 80 candidates into the scan ring
        a = mesh.coord(mesh.local_ranks[0], "data")
        l_local = flat.n_lists // mesh.size
        sl = slice(a * l_local, (a + 1) * l_local)
        qc = Q[:qb]
        probed = ivf_flat.probe_mask(flat.centers, qc, spec["n_probes"], flat.metric)
        v80, i80 = ivf_flat.flat_scan_core(
            flat.list_data[sl], flat.list_indices[sl], flat.list_norms[sl], qc, probed[:, sl], None,
            k=8 * k, metric=flat.metric, has_filter=False,
            chunk_lists=ivf_flat.scan_chunk_lists(l_local, flat.max_list))
        sv, si = rt.scan_ring_topk(mesh, [v80], [i80], k)
        arrays["scan80_d"], arrays["scan80_i"] = sv[0].cpu().numpy(), si[0].cpu().numpy()
        torch.cuda.synchronize()
        out["timing"] = timing
        out["launches"] = {f.__name__: f.launches for f in counted}
        out["launches"]["ring_stage"] = rt.fused_ring_topk.stage_launches
        out["launches"]["scan_ring_stage"] = rt.fused_scan_ring_topk.stage_launches
        out["hop_host_s"] = rt.fused_ring_topk.hop_s
        # every B5 fold of one served ring batch against its plain version
        counts = [f.launches for f in counted] + [rt.fused_ring_topk.stage_launches,
                                                  rt.fused_scan_ring_topk.stage_launches]
        real, checked = rt._fold_block, []

        def held(lib, dst, got, key_sign):
            before = dst.clone()
            real(lib, dst, got, key_sign)

            def lanes(t):
                val = t[1].view(torch.float32)
                return (val * key_sign, t[0], val, t[2])

            want = rt.hop_merge_reference(lanes(before), lanes(got))
            same = all(torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                                   w.view(torch.int32) if w.is_floating_point() else w)
                       for g, w in zip(lanes(dst)[1:], want[1:]))
            checked.append((tuple(dst.shape[1:]), same))

        rt._fold_block = held
        try:
            sharded_ivf_flat_search(mesh, flat, Q[:qb], k, fp, merge_mode="ring")
            torch.cuda.synchronize()
        finally:
            rt._fold_block = real
        for f, c in zip(counted, counts):
            f.launches = c
        rt.fused_ring_topk.stage_launches, rt.fused_scan_ring_topk.stage_launches = counts[-2:]
        out["folds_checked"] = len(checked)
        out["fold_shapes"] = sorted({s for s, _ in checked})
        out["folds_equal"] = all(s for _, s in checked)
        # the other sharded entry points, their launches apart
        cg = cagra.load_path(os.path.join(work, "cagra.idx"), device=dev)
        for f in counted:
            f.launches = 0
        rt.fused_ring_topk.stage_launches = rt.fused_scan_ring_topk.stage_launches = 0
        rt.fused_ring_topk.hop_s = 0.0
        ep, info = entry_cases(mesh, "data", flat, pq, cg, X, Qn, spec)
        torch.cuda.synchronize()
        info["launches"] = {f.__name__: f.launches for f in counted}
        info["launches"]["ring_stage"] = rt.fused_ring_topk.stage_launches
        info["launches"]["scan_ring_stage"] = rt.fused_scan_ring_topk.stage_launches
        info["hop_host_s"] = rt.fused_ring_topk.hop_s
        out["entry"] = info
        arrays.update({"entry_" + name: a for name, a in ep.items()})
    else:  # the NCCL world of one: sharded kNN against single-device brute force
        qc = Q[:spec["knn_queries"]]
        d, i = sharded_knn(mesh, X, qc, k, metric="sqeuclidean")
        from raft_tpu_torch.core.resources import Resources

        own = Resources(device=device)
        bd, bi = brute_force.search(brute_force.build(X, metric="sqeuclidean", res=own), qc, k,
                                    dataset_tile=2048, res=own)
        torch.cuda.synchronize()
        out["knn_ids_equal"] = float((i == bi).float().mean())
        out["knn_values_close"] = bool(torch.allclose(d, bd, rtol=1e-5, atol=1e-5))
        out["knn_value_bits_equal"] = bool(torch.equal(d.view(torch.int32), bd.view(torch.int32)))
        # the build (against the parent's mesh of one shard) and the
        # query-sharded searches against the single-device searches
        pq = ivf_pq.load_path(os.path.join(work, "pq.idx"), device=dev)
        cg = cagra.load_path(os.path.join(work, "cagra.idx"), device=dev)
        ep, info = entry_cases(mesh, "data", None, pq, cg, X, Qn, spec, modes=("full",),
                             parts=("build", "query"))
        qt = Q[:spec["qs_queries"]]
        single = {"qs_pq": ivf_pq.search(pq, qt, k, ivf_pq.IvfPqSearchParams(
                      n_probes=spec["pq_probes"]), mode="scan"),
                  "qs_cagra": cagra.search(cg, qt, k, cagra.CagraSearchParams(**spec["cagra"]),
                                           mode="xla")}
        info["equal_to_single_device"] = {
            name: bool(np.array_equal(ep[name + "_i"], i.cpu().numpy()) and np.array_equal(
                ep[name + "_d"].view(np.int32), d.cpu().numpy().view(np.int32)))
            for name, (d, i) in single.items()}
        out["entry"] = info
    out["child_s"] = time.perf_counter() - t0
    np.savez(os.path.join(work, f"{tag}_rank{rank}.npz"), **arrays)
    bootstrap.shutdown()
    print(json.dumps(out), flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def procs_world(card: str, work: str, tag: str, world: int, backend: str, devices, timeout_s):
    """Start a phase 17 world's children together (``python3 -c``, this
    file's tree on the path), join them with a timeout that kills them all,
    and return each rank's JSON result and arrays; a child's failure or
    timeout raises."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {sys.path[0]!r}); sys.path.insert(0, {here!r}); "
            "import chip_smoke; sys.exit(chip_smoke.procs_child(int(sys.argv[1]), "
            "int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5], sys.argv[6]))")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), work, backend,
                               devices[r], tag], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(text.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    os.makedirs("chiprun_out", exist_ok=True)
    for r, text in enumerate(logs):
        with open(f"chiprun_out/procs_{tag}_rank{r}.log", "w") as f:
            f.write(text)
    results = []
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 17 {tag}: rank {r} exited {p.returncode}:\n{text[-3000:]}")
        last = [ln for ln in text.splitlines() if ln.startswith("{")][-1]
        results.append((json.loads(last), dict(np.load(os.path.join(work, f"{tag}_rank{r}.npz")))))
    return results


def procs_check_world(card: str, tag: str, results, refs, gt_i) -> dict:
    """A world's results against the single-process references: the self
    test, the verbs, each search's ids and value bits under every merge
    mode on every rank, the ring's launches and B5's folds; prints its
    lines and returns the launch counts by rank."""
    from raft_tpu_torch.stats.recall import neighborhood_recall

    launches = {}
    for out, arrays in results:
        r = out["rank"]
        if not out["self_test"] or not all(out["verbs"].values()):
            raise AssertionError(f"phase 17 {tag} rank {r}: self test {out['self_test']}, "
                                 f"verbs {out['verbs']}")
        for name, (d, i) in refs.items():
            modes = PROCS_MODES if name != "scan80" else ("",)
            for mode in modes:
                key = f"{name}_{mode}" if mode else name
                gd, gi = arrays[f"{key}_d"], arrays[f"{key}_i"]
                if not (np.array_equal(gi, i) and np.array_equal(gd.view(np.int32), d.view(np.int32))):
                    raise AssertionError(f"phase 17 {tag} rank {r}: {key} differs from the "
                                         f"single-process search ({(gi != i).sum()} ids)")
        lc = out["launches"]
        # the process engine: staging and B5 folds on the card, B7's scan fold
        # in the staging of the 80-wide tiles, and never ring_onecard
        if (lc["ring_stage"] <= 0 or lc["hop_merge"] <= 0 or lc["scan_ring_stage"] <= 0
                or lc["fused_ring_topk"] != 0 or lc["fused_scan_ring_topk"] != 0):
            raise AssertionError(f"phase 17 {tag} rank {r}: launches {lc}")
        if out["folds_checked"] <= 0 or not out["folds_equal"]:
            raise AssertionError(f"phase 17 {tag} rank {r}: {out['folds_checked']} B5 folds "
                                 f"checked, equal {out['folds_equal']}")
        launches[r] = lc
        emit(card, phase="procs", metric="rank", world=tag, rank=r, mesh=out["mesh"],
             init_s=out["init_s"], load_s=out["load_s"], child_s=out["child_s"], launches=lc,
             hop_host_s=out["hop_host_s"], folds_checked=out["folds_checked"],
             fold_shapes=out["fold_shapes"], timing=out["timing"])
    for name in ("flat", "pq", "knn"):
        for mode in PROCS_MODES:
            per = [out["timing"][f"{name}_{mode}"] for out, _ in results]
            emit(card, phase="procs", metric="seconds_a_batch", world=tag, search=name,
                 merge_mode=mode, s_per_batch=max(t["s_per_batch"] for t in per),
                 hop_host_s_per_batch=max(t["hop_host_s_per_batch"] for t in per),
                 ranks=len(per))
    n_q = {"flat": refs["flat"][1].shape[0], "pq": refs["pq"][1].shape[0],
           "knn": refs["knn"][1].shape[0]}
    emit(card, phase="procs", metric="recall@10", world=tag,
         **{name: neighborhood_recall(torch.from_numpy(refs[name][1]), gt_i[:n_q[name]])
            for name in n_q})
    return launches


def jsonable(x):
    """``x`` as it comes back from a child's JSON line (tuples as lists)."""
    return json.loads(json.dumps(x))


def entry_equal(what: str, arrays: dict, want: dict, prefix: str = "") -> None:
    """Every array of ``want`` equal in ids and value bits to ``arrays``'s
    (``prefix`` + its name)."""
    for name, w in want.items():
        g = arrays[prefix + name]
        if g.shape != w.shape or g.view(np.int32).tobytes() != w.view(np.int32).tobytes():
            raise AssertionError(f"phase 17 {what}: {name} differs from the single-process mesh "
                                 f"({int((g != w).sum()) if g.shape == w.shape else g.shape} "
                                 "entries)")


def entry_check(card: str, tag: str, n: int, info: dict, arrays: dict, ref, prefix: str,
              rank=None) -> None:
    """One process's (or the 2-D mesh's) results of the other sharded
    entry points against the single-process mesh's ``ref = (arrays,
    info)``: every build field's digest, every search and served answer in
    ids and value bits, the agreed degraded coverage; prints its lines."""
    ref_arrays, ref_info = ref
    who = f"{tag} rank {rank}" if rank is not None else tag
    for mode, digest in info["digest"].items():
        diff = [f for f in PQ_FIELDS if digest[f] != ref_info["digest"][mode][f]]
        if diff:
            raise AssertionError(f"phase 17 {who}: the {mode} build differs in {diff}")
    entry_equal(who, arrays, ref_arrays, prefix)
    for key in [k_ for k_ in ref_info if k_.startswith(("tiered_cov", "down_cov"))]:
        if jsonable(info[key]) != jsonable(ref_info[key]):
            raise AssertionError(f"phase 17 {who}: {key} {info[key]} against {ref_info[key]}")
    if "down_cov" in info and n > 1 and jsonable(info["down_cov"]) != [[1 - 1 / n, [1]]]:
        raise AssertionError(f"phase 17 {who}: shard 1 down in one process gave {info['down_cov']}")
    emit(card, phase="procs", metric="entry_points", world=tag, rank=rank, build_s=info["build_s"],
         build_verb_host_s=info["build_verb_host_s"], build_verb_calls=info["build_verb_calls"],
         builds_equal=sorted(info["digest"]), seconds=info["s"],
         tiered_algo=info.get("tiered_algo"), down_coverage=info.get("down_cov"),
         fault_installed_here=info.get("fault_installed_here"), launches=info.get("launches"),
         hop_host_s=info.get("hop_host_s"), equal=True)


def procs_refs(mesh, index, pq_index, X_card, Qt, spec) -> dict:
    """The single-process answers phase 17's worlds must give: each search
    over ``mesh`` (gather: ring and fused_ring are bit-equal to it, phase 7)
    and the scan ring of 80-wide tiles, as numpy ``(dist, ids)``."""
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
    from raft_tpu_torch.ops import ring_topk as rt
    from raft_tpu_torch.parallel import (sharded_ivf_flat_search, sharded_ivf_pq_lists_search,
                                         sharded_knn)

    k, qb = spec["k"], spec["qb"]
    fp = ivf_flat.IvfFlatSearchParams(n_probes=spec["n_probes"])
    pp = ivf_pq.IvfPqSearchParams(n_probes=spec["pq_probes"])

    def batched(fn, n_q):
        outs = [fn(Qt[s:s + qb]) for s in range(0, n_q, qb)]
        return (torch.cat([o[0] for o in outs]).cpu().numpy(),
                torch.cat([o[1] for o in outs]).cpu().numpy())

    refs = {"flat": batched(lambda qc: sharded_ivf_flat_search(mesh, index, qc, k, fp,
                                                               merge_mode="gather"), Qt.shape[0]),
            "pq": batched(lambda qc: sharded_ivf_pq_lists_search(mesh, pq_index, qc, k, pp,
                                                                 merge_mode="gather"),
                          spec["pq_queries"]),
            "knn": batched(lambda qc: sharded_knn(mesh, X_card, qc, k, metric="sqeuclidean",
                                                  merge_mode="gather"), spec["knn_queries"])}
    n = mesh.size
    l_local = index.n_lists // n
    qc = Qt[:qb]
    probed = ivf_flat.probe_mask(index.centers, qc, spec["n_probes"], index.metric)
    vs, is_ = [], []
    for r in range(n):
        sl = slice(r * l_local, (r + 1) * l_local)
        v, i = ivf_flat.flat_scan_core(
            index.list_data[sl], index.list_indices[sl], index.list_norms[sl], qc, probed[:, sl],
            None, k=8 * k, metric=index.metric, has_filter=False,
            chunk_lists=ivf_flat.scan_chunk_lists(l_local, index.max_list))
        vs.append(v.to(mesh.devices[r]))
        is_.append(i.to(mesh.devices[r]))
    sv, si = rt.gather_merge(mesh, vs, is_, k, True)
    refs["scan80"] = (sv[0].cpu().numpy(), si[0].cpu().numpy())
    return refs


def procs_phase(card: str, index, pq_index, cg, X, X_card, Q, gt_i, k: int, sizes) -> dict:
    """Phase 17: multi-process meshes on the card (see the module
    docstring). Returns ``{"launches": the B5, B6, B7 and staging launches
    of each world's processes over the lists-sharded searches, "entry": the
    same over the other sharded entry points' paths, "onecard_2d": the 2-D
    mesh's ring_onecard launches, "ca_digest": the CA build's digests on
    make_mesh(["cuda:0"] * 4)}``."""
    import shutil
    import tempfile

    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import ring_topk as rt
    from raft_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="procs_")
    n_cards = torch.cuda.device_count()
    worlds = [("gloo2", 2, "gloo", ["cuda:0"] * 2), ("gloo4", 4, "gloo", ["cuda:0"] * 4),
              ("nccl1", 1, "nccl", ["cuda:0"])]
    if n_cards >= 2:
        m = min(4, n_cards)
        worlds.append((f"nccl{m}", m, "nccl", [f"cuda:{i}" for i in range(m)]))
    out = {"launches": {}, "entry": {}}
    try:
        t0 = time.perf_counter()
        ivf_flat.save_path(index, os.path.join(work, "flat.idx"))
        ivf_pq.save_path(pq_index, os.path.join(work, "pq.idx"))
        cagra.save_path(cg, os.path.join(work, "cagra.idx"))
        np.save(os.path.join(work, "X.npy"), X)
        np.save(os.path.join(work, "Q.npy"), Q)
        spec = {"k": k, "qb": 1024, "n_probes": 20, "pq_probes": 30, "pq_queries": 2048,
                "knn_queries": 1024, "timeout_s": 120.0,
                "build": {"n_lists": 1024, "pq_dim": 64, "pq_bits": 8}, "qs_queries": 4096,
                "cagra": {"itopk_size": 128, "search_width": 8, "dedup": "post",
                          "init_sample": SERVE_INIT_SAMPLE},
                "tiered_sizes": [int(m) for m in sizes_to(sizes, 2048)],
                "down_sizes": [int(m) for m in sizes_to(sizes, 1024)],
                "address": {tag: f"127.0.0.1:{_free_port()}" for tag, *_ in worlds},
                "searches": {tag: backend == "gloo" or n > 1 for tag, n, backend, _ in worlds}}
        with open(os.path.join(work, "spec.json"), "w") as f:
            json.dump(spec, f)
        emit(card, phase="procs", metric="save_s", value=time.perf_counter() - t0,
             index_bytes=os.path.getsize(os.path.join(work, "flat.idx")),
             cagra_bytes=os.path.getsize(os.path.join(work, "cagra.idx")))
        Qt = torch.from_numpy(Q).cuda()
        entry_refs = {}
        for tag, n, backend, devices in worlds:
            t0 = time.perf_counter()
            ref_mesh = make_mesh(devices)
            refs = (procs_refs(ref_mesh, index, pq_index, X_card, Qt, spec)
                    if spec["searches"][tag] else None)
            entry_refs[n] = (entry_cases(ref_mesh, "data", index, pq_index, cg, X_card, Q, spec)
                          if spec["searches"][tag] else
                          entry_cases(ref_mesh, "data", index, pq_index, cg, X_card, Q, spec,
                                    modes=("full",), parts=("build",)))
            refs_s = time.perf_counter() - t0
            torch.cuda.empty_cache()  # the children share the card: hand back its cached blocks
            t0 = time.perf_counter()
            results = procs_world(card, work, tag, n, backend, devices, 420.0)
            world_s = time.perf_counter() - t0
            if refs is not None:
                out["launches"][tag] = procs_check_world(card, tag, results, refs, gt_i)
                out["entry"][tag] = {}
                for res_out, arrays in results:
                    r = res_out["rank"]
                    entry_check(card, tag, n, res_out["entry"], arrays, entry_refs[n], "entry_",
                                rank=r)
                    lc = res_out["entry"]["launches"]
                    if (lc["ring_stage"] <= 0 or lc["hop_merge"] <= 0 or lc["fused_ring_topk"] != 0
                            or lc["fused_scan_ring_topk"] != 0):
                        raise AssertionError(f"phase 17 {tag} rank {r}: the other entry points' "
                                             f"launches {lc}")
                    out["entry"][tag][r] = lc
            else:
                res_out = results[0][0]
                info = res_out["entry"]
                if (not res_out["self_test"] or not all(res_out["verbs"].values())
                        or res_out["knn_ids_equal"] != 1.0 or not res_out["knn_values_close"]
                        or not all(info["equal_to_single_device"].values())):
                    raise AssertionError(f"phase 17 {tag}: {res_out}")
                entry_check(card, tag, n, info, {}, entry_refs[n], "")
                emit(card, phase="procs", metric="nccl_world_of_one", mesh=res_out["mesh"],
                     self_test=res_out["self_test"], verbs=res_out["verbs"],
                     knn_ids_equal=res_out["knn_ids_equal"],
                     knn_value_bits_equal=res_out["knn_value_bits_equal"],
                     query_sharded_equal_to_single_device=info["equal_to_single_device"],
                     child_s=res_out["child_s"])
            emit(card, phase="procs", metric="world_s", world=tag, processes=n, backend=backend,
                 value=world_s, reference_s=refs_s,
                 reference_build_s=entry_refs[n][1]["build_s"],
                 reference_build_verb_host_s=entry_refs[n][1]["build_verb_host_s"],
                 reference_seconds=entry_refs[n][1]["s"])
        if n_cards < 2:
            emit(card, phase="procs", metric="nccl_across_cards",
                 value="waits for a machine with several cards", cards=n_cards)
        # (d) the five entry points on a 2 x 2 mesh along "cols", against the
        # one-axis mesh of two shards; one ring_onecard launch a group a ring
        t0 = time.perf_counter()
        mesh2d = make_mesh(["cuda:0"] * 4, shape=(2, 2), axis_names=("rows", "cols"))
        before = rt.fused_ring_topk.launches + rt.fused_scan_ring_topk.launches
        arrays2d, info2d = entry_cases(mesh2d, "cols", index, pq_index, cg, X_card, Q, spec,
                                     modes=("ca",))
        out["onecard_2d"] = rt.fused_ring_topk.launches + rt.fused_scan_ring_topk.launches - before
        info2d["launches"] = {"ring_onecard": out["onecard_2d"]}
        entry_check(card, "2x2_cols", 2, info2d, arrays2d, entry_refs[2], "")
        if out["onecard_2d"] <= 0 or out["onecard_2d"] % 2:
            raise AssertionError(f"phase 17 (d): {out['onecard_2d']} ring_onecard launches on the "
                                 "2 x 2 mesh (one a group a ring expected)")
        emit(card, phase="procs", metric="mesh_2x2", axis="cols",
             against="make_mesh(['cuda:0'] * 2)", equal=True,
             ring_onecard_launches=out["onecard_2d"], value=time.perf_counter() - t0)
        out["ca_digest"] = entry_refs[4][1]["digest"]["ca"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(card, phase="procs", metric="phase_s", value=time.perf_counter() - t_phase)
    return out


# -- phase 18: the bench (raft_tpu_torch.bench) ------------------------------------------

#: phase 18 (b)'s points on the 1M registry set: (build params, search grid)
BENCH_FULL = {
    "raft_ivf_flat": ({"nlist": 1024, "ratio": 4, "niter": 20}, {"nprobe": [10, 20, 50]}),
    "raft_ivf_pq": ({"nlist": 1024, "pq_dim": 64, "pq_bits": 8, "ratio": 10, "niter": 20},
                    {"nprobe": [20, 50], "refine_ratio": [1, 2]}),
    # the IVF-PQ route is the one phase 6 builds 1M CAGRA with
    "raft_cagra": ({"graph_degree": 32, "intermediate_graph_degree": 64,
                    "graph_build_algo": "IVF_PQ"}, {"itopk": [64, 128], "search_width": [1, 4]}),
}
#: phase 18 (b)'s cap on the sweeps of a point, far above what one second
#: of 1,000-query sweeps takes, so that ``min_search_time`` sets the window
BENCH_MAX_ITERATIONS = 10_000
#: phase 18 (c): how far the served recall@10 of a batch-dependent tile may
#: fall under a direct search's of the same rows
BENCH_SERVED_RECALL_TOL = 0.01
#: phase 18 (c): requests of 8 rows, closed loop at 16 in flight, open loop at
#: 2,000 requests/s
BENCH_LOAD = dict(requests=2000, rows=8, concurrency=16, rate_qps=2000.0)


@contextlib.contextmanager
def kept_index(harness, algo: str):
    """Keep the index ``harness.run_case`` builds for ``algo`` (the list
    the context yields), so that a direct search can query it."""
    build, search = harness.ALGOS[algo]
    kept = []

    def keep(ds, p, res):
        kept.append(build(ds, p, res))
        return kept[-1]

    harness.ALGOS[algo] = (keep, search)
    try:
        yield kept
    finally:
        harness.ALGOS[algo] = (build, search)


def host_knn_check(base: np.ndarray, queries: np.ndarray, gt: np.ndarray, rows) -> int:
    """Hold ``gt``'s top-k ids of the queries ``rows`` against an exact
    float64 kNN on the host (L2). Where the id sets differ, the sorted
    exact distances must agree within 1e-5 of the norms' scale (about the
    error of the float32 expanded form the card computes): a tie.
    Returns the number of queries whose id sets differ by ties; raises on
    any other difference."""
    k = gt.shape[1]
    xs = base.astype(np.float64)
    x2 = np.einsum("ij,ij->i", xs, xs)
    q = queries[rows].astype(np.float64)
    d = x2[None, :] - 2.0 * (q @ xs.T) + np.einsum("ij,ij->i", q, q)[:, None]
    ties = 0
    for r in range(len(rows)):
        got = gt[rows[r]]
        ref = np.argpartition(d[r], k)[:k]
        if set(got.tolist()) == set(ref.tolist()):
            continue
        tol = 1e-5 * (x2.max() + float(q[r] @ q[r]))
        if (len(set(got.tolist())) != k or got.min() < 0
                or not np.allclose(np.sort(d[r][got]), np.sort(d[r][ref]), rtol=0, atol=tol)):
            raise AssertionError(f"ground truth of query {rows[r]} differs from an exact "
                                 f"float64 kNN beyond ties: {sorted(got)} vs {sorted(ref)}")
        ties += 1
    return ties


def bench_phase(card: str, res) -> dict:
    """Phase 18, the bench, in a temporary work directory (its data cache,
    reports and CSVs): (a) the CLI over the ``smoke`` group on
    ``smoke-10k`` for each algorithm, each report and CSV held against the
    grid, brute force's recall >= 0.999, and B1, B2 and B4 launched under
    ``raft_ivf_flat``, ``raft_ivf_pq`` and ``raft_cagra``, the CLI's ground
    truth equal to a float64 kNN on the host up to ties; (b) ``run_case``
    at full width on ``sift-128-euclidean`` (1M x 128, 1,000 queries,
    ground truth by the port's brute force on the card, 64 of its queries
    held against a float64 kNN on the host) over :data:`BENCH_FULL`, each
    point's window set by ``min_search_time`` (1 s), the first point of
    each algorithm's ``found`` ids equal to a direct search of the same
    index, the rows and the operating point at recall 0.95; (c) closed and
    open loops of :data:`BENCH_LOAD` on a ``ServingEngine(max_batch=128)``
    serving (b)'s IVF-Flat index through B1 at ``n_probes=20``, every
    request accounted for: with one-query tiles of one-list units (every
    answer independent of the batch it rode in) each request's ids equal
    to a direct search of its rows, and with phase 3's serving tile the
    served recall@10 within :data:`BENCH_SERVED_RECALL_TOL` of a direct
    search's; (d) ``prims.run`` over the eight cases. Returns the launches
    of B1, B2 and B4 in the phase."""
    import csv
    import shutil
    import tempfile

    from raft_tpu_torch.bench import __main__ as bench_cli
    from raft_tpu_torch.bench import configs, datasets, harness, loadgen, prims
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import cagra_search, ivf_scan, pq_scan
    from raft_tpu_torch.serve import ServingEngine

    t_phase = time.perf_counter()
    kernels = {"fused_list_topk": ivf_scan.fused_list_topk, "fused_pq_topk": pq_scan.fused_pq_topk,
               "cagra_fused_search": cagra_search.cagra_fused_search}
    expected = {"raft_ivf_flat": "fused_list_topk", "raft_ivf_pq": "fused_pq_topk",
                "raft_cagra": "cagra_fused_search"}
    totals = dict.fromkeys(kernels, 0)

    def zero():
        for f in kernels.values():
            f.launches = 0

    def read():
        got = {name: f.launches for name, f in kernels.items()}
        for name, n in got.items():
            totals[name] += n
        return got

    work = tempfile.mkdtemp(prefix="bench_")
    saved_env, saved_dir = os.environ.get("RAFT_TPU_BENCH_DATA"), datasets.DATA_DIR
    os.environ["RAFT_TPU_BENCH_DATA"] = work
    datasets.DATA_DIR = work
    try:
        # (a) the CLI, in process, one algorithm a call
        t0 = time.perf_counter()
        smoke = configs.GROUPS["smoke"]
        for algo, grids in smoke.items():
            out, csv_out = os.path.join(work, f"{algo}.json"), os.path.join(work, f"{algo}.csv")
            zero()
            rc = bench_cli.main(["--dataset", "smoke-10k", "--group", "smoke", "--algos", algo,
                                 "--min-search-time", "0.5", "--out", out, "--csv-out", csv_out])
            launches = read()
            if rc != 0:
                raise AssertionError(f"phase 18 (a): the CLI exited {rc} on {algo}")
            with open(out) as f:
                report = json.load(f)
            cons = configs.constraint(algo)
            points = [(bp, sp) for bp in harness._grid(grids["build"])
                      for sp in harness._grid(grids["search"]) if cons is None or cons(bp, sp)]
            rows = report["benchmarks"]
            if len(rows) != len(points):
                raise AssertionError(f"phase 18 (a): {algo} gave {len(rows)} rows for "
                                     f"{len(points)} grid points")
            keys = set(harness.BenchResult("", "", "", 0, 0, {}, {}, 0.0, 0.0, 1, 0, 0.0, 0.0,
                                           0.0).to_json())
            if any(set(r) != keys for r in rows):
                raise AssertionError(f"phase 18 (a): {algo}'s rows do not carry to_json's keys")
            if [(r["build_params"], r["search_params"]) for r in rows] != points:
                raise AssertionError(f"phase 18 (a): {algo}'s rows are not the grid's points")
            with open(csv_out) as f:
                csv_names = [r["name"] for r in csv.DictReader(f)]
            if csv_names != [r["name"] for r in rows]:
                raise AssertionError(f"phase 18 (a): {algo}'s CSV rows differ from its report")
            if algo == "raft_brute_force" and min(r["Recall"] for r in rows) < 0.999:
                raise AssertionError(f"phase 18 (a): brute force recall {rows[0]['Recall']}")
            if algo in expected and launches[expected[algo]] <= 0:
                raise AssertionError(f"phase 18 (a): {expected[algo]} not launched under {algo}: "
                                     f"{launches}")
            emit(card, phase="bench", part="cli", algo=algo, device=report["context"]["device"],
                 rows=[{k: r[k] for k in ("name", "items_per_second", "Recall", "Latency",
                                          "build_time", "iterations")} for r in rows],
                 launches=launches)
        # the CLI's ground truth (cached in the work directory) against an
        # exact float64 kNN on the host, every query
        sm = datasets.get_dataset("smoke-10k")
        ties = host_knn_check(sm.base, sm.queries, sm.ground_truth(10, res=res),
                              np.arange(sm.queries.shape[0]))
        emit(card, phase="bench", part="cli", metric="ground_truth_vs_host_f64", equal=True,
             queries=sm.queries.shape[0], differing_by_ties=ties)
        emit(card, phase="bench", part="cli", metric="phase_s", value=time.perf_counter() - t0)

        # (b) full width: run_case on the 1M registry set
        t0 = time.perf_counter()
        ds = datasets.get_dataset("sift-128-euclidean")
        t_gt = time.perf_counter()
        gt = ds.ground_truth(10, res=res)
        emit(card, phase="bench", part="full", metric="ground_truth_s",
             value=time.perf_counter() - t_gt, n=ds.n, dim=ds.dim, queries=ds.queries.shape[0])
        # 64 of its queries, evenly spaced, against an exact float64 kNN on the host
        sample = np.arange(0, ds.queries.shape[0], ds.queries.shape[0] // 64)[:64]
        t_host = time.perf_counter()
        ties = host_knn_check(ds.base, ds.queries, gt, sample)
        emit(card, phase="bench", part="full", metric="ground_truth_vs_host_f64", equal=True,
             queries=len(sample), differing_by_ties=ties, host_s=time.perf_counter() - t_host)
        Qd = torch.from_numpy(ds.queries).cuda()
        direct = {
            "raft_ivf_flat": lambda index, sp: ivf_flat.search(
                index, Qd, 10, ivf_flat.IvfFlatSearchParams(
                    n_probes=sp["nprobe"], fused_qt=64, fused_probe_factor=4, fused_group=1,
                    fused_merge="seg", fused_precision="highest"), query_batch=1024),
            "raft_ivf_pq": lambda index, sp: ivf_pq.search(
                index, Qd, 10, ivf_pq.IvfPqSearchParams(n_probes=sp["nprobe"]), query_batch=1024),
            "raft_cagra": lambda index, sp: cagra.search(
                index, Qd, 10, cagra.CagraSearchParams(itopk_size=sp["itopk"],
                                                       search_width=sp["search_width"]),
                query_batch=1024),
        }
        full, flat_index = {}, None
        for algo, (bp, grid) in BENCH_FULL.items():
            with kept_index(harness, algo) as kept:
                zero()
                # the window is set by min_search_time, not by the
                # iteration cap (a 1,000-query sweep takes 2-15 ms)
                rows = harness.run_case(ds, algo, bp, list(harness._grid(grid)), k=10,
                                        batch=1024, min_search_time=1.0,
                                        max_iterations=BENCH_MAX_ITERATIONS, res=res)
                torch.cuda.synchronize()
                launches = read()
            index = kept[0]
            first = rows[0]
            _, ids = direct[algo](index, first.search_params)
            if not np.array_equal(first.found, ids.cpu().numpy()):
                raise AssertionError(f"phase 18 (b): {algo}'s harness ids differ from a direct "
                                     f"search at {first.search_params}")
            if launches[expected[algo]] <= 0:
                raise AssertionError(f"phase 18 (b): {expected[algo]} not launched under {algo}")
            short = [(r.search_params, r.iterations, r.end_to_end) for r in rows
                     if r.end_to_end < 1.0]
            if short:
                raise AssertionError(f"phase 18 (b): {algo}'s windows under min_search_time "
                                     f"(the iteration cap ended them): {short}")
            op = harness.operating_point(rows, 0.95)
            full[algo] = {"rows": [r.to_json() for r in rows],
                          "operating_point": op.to_json() if op else None, "launches": launches}
            emit(card, phase="bench", part="full", algo=algo, build_s=first.build_time,
                 rows=[{"search_params": r.search_params, "qps": r.qps, "recall": r.recall,
                        "latency_s": r.latency, "iterations": r.iterations,
                        "window_s": r.end_to_end} for r in rows],
                 operating_point_95=None if op is None else {
                     "search_params": op.search_params, "qps": op.qps, "recall": op.recall},
                 launches=launches, harness_ids_equal_direct=True)
            if algo == "raft_ivf_flat":
                flat_index = index
                # the harness's fused defaults (JAX's: 64-query tiles, a
                # table of 4 x n_probes units of one list) against the base
                # grid's knobs and phase 3's tile, at 20 probes (reported)
                table = {}
                for qt, pf, g in ((64, 4, 1), (64, 32, 8), (SERVE_QT, 32, 8)):
                    _, i = ivf_flat.search(index, Qd, 10, ivf_flat.IvfFlatSearchParams(
                        n_probes=20, fused_qt=qt, fused_probe_factor=pf, fused_group=g),
                        mode="fused")
                    table[f"qt{qt}_pf{pf}_group{g}"] = harness.recall_at_k(i.cpu().numpy(), gt, 10)
                emit(card, phase="bench", part="full", metric="ivf_flat_recall_by_probe_table",
                     n_probes=20, value=table)
            del index, kept
            torch.cuda.empty_cache()
        emit(card, phase="bench", part="full", metric="phase_s", value=time.perf_counter() - t0,
             **memory())

        # (c) load on the engine over (b)'s IVF-Flat index
        t0 = time.perf_counter()
        # a fused tile scans the union of its queries' probes, and the
        # queries are sorted into tiles, so only one-query tiles of one-list
        # units make an answer independent of the batch it rode in: those
        # answers must equal a direct search's. Phase 3's serving tile (16
        # queries, units of 8 lists) answers by the batch, so its served
        # recall@10 is held to the direct search's within BENCH_SERVED_RECALL_TOL
        load = {}
        served = (("qt1", ivf_flat.IvfFlatSearchParams(n_probes=20, fused_qt=1, fused_group=1)),
                  (f"qt{SERVE_QT}", ivf_flat.IvfFlatSearchParams(n_probes=20, fused_qt=SERVE_QT)))
        for tiles, params in served:
            exact = tiles == "qt1"
            eng = ServingEngine(max_batch=128, res=res)
            eng.register("sift", "ivf_flat", flat_index, params=params, mode="fused")
            _, want = ivf_flat.search(flat_index, Qd, 10, params, mode="fused")
            want = want.cpu().numpy()
            eng.submit("sift", ds.queries[:128], 10)  # the engine's first batch outside the runs
            eng.run_until_idle()
            for mode in ("closed", "open"):
                zero()
                if mode == "closed":
                    rep, got = loadgen.run_closed_loop(
                        eng, "sift", ds.queries, 10, concurrency=BENCH_LOAD["concurrency"],
                        n_requests=BENCH_LOAD["requests"], request_rows=BENCH_LOAD["rows"],
                        collect=True)
                else:
                    rep, got = loadgen.run_open_loop(
                        eng, "sift", ds.queries, 10, rate_qps=BENCH_LOAD["rate_qps"],
                        n_requests=BENCH_LOAD["requests"], request_rows=BENCH_LOAD["rows"],
                        seed=0, collect=True)
                launches = read()
                where = f"phase 18 (c) {mode}, {tiles}"
                if rep.completed + sum(rep.rejected.values()) != rep.n_requests:
                    raise AssertionError(f"{where}: {rep.completed} completed and "
                                         f"{rep.rejected} rejected of {rep.n_requests}")
                rows_ids = np.concatenate([ids for ids, _ in got])
                served_ids = np.concatenate([r for _, r in got])
                served_recall = harness.recall_at_k(served_ids, gt[rows_ids], 10)
                direct_recall = harness.recall_at_k(want[rows_ids], gt[rows_ids], 10)
                differing = sum(not np.array_equal(r, want[ids]) for ids, r in got)
                if exact and differing:
                    raise AssertionError(f"{where}: {differing} requests' ids differ from a "
                                         "direct search of their rows")
                if served_recall < direct_recall - BENCH_SERVED_RECALL_TOL:
                    raise AssertionError(f"{where}: served recall@10 {served_recall} under the "
                                         f"direct search's {direct_recall} - "
                                         f"{BENCH_SERVED_RECALL_TOL}")
                if not rep.latency_ms_p50 <= rep.latency_ms_p95 <= rep.latency_ms_p99:
                    raise AssertionError(f"{where}: percentiles out of order {rep.row()}")
                if launches["fused_list_topk"] <= 0:
                    raise AssertionError(f"{where}: B1 not launched")
                load[f"{mode}_{tiles}"] = dict(rep.row(), launches=launches["fused_list_topk"])
                emit(card, phase="bench", part="load", mode=mode, tiles=tiles, row=rep.row(),
                     duration_s=rep.duration_s, latency_ms_mean=rep.latency_ms_mean,
                     latency_ms_max=rep.latency_ms_max, rejected=rep.rejected,
                     checked=len(got), requests_differing_from_direct=differing,
                     served_recall=served_recall, direct_recall=direct_recall,
                     b1_launches=launches["fused_list_topk"])
            del eng
        del flat_index
        torch.cuda.empty_cache()
        emit(card, phase="bench", part="load", metric="phase_s", value=time.perf_counter() - t0)

        # (d) the prims
        t0 = time.perf_counter()
        prim_rows = prims.run("", inner=8, device="cuda")
        if len(prim_rows) != 8 or any(not r["real_time"] > 0 for r in prim_rows):
            raise AssertionError(f"phase 18 (d): {prim_rows}")
        emit(card, phase="bench", part="prims", rows=prim_rows)
        emit(card, phase="bench", part="prims", metric="phase_s", value=time.perf_counter() - t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        datasets.DATA_DIR = saved_dir
        if saved_env is None:
            os.environ.pop("RAFT_TPU_BENCH_DATA", None)
        else:
            os.environ["RAFT_TPU_BENCH_DATA"] = saved_env
    emit(card, phase="bench", metric="phase_s", value=time.perf_counter() - t_phase,
         launches=totals, **memory())
    return {"launches": totals, "full": full, "load": load}


#: the parts ``--phases`` runs alone
PHASE_PARTS = ("paths", "serve", "ring", "b1", "b3", "rabitq", "b4", "mutable", "robust",
               "tiered", "multi", "replica", "prims", "geo", "data", "graph", "procs", "bench")


def run_phases(card: str, parts, seed: int, tree: str, this_tree: bool,
               compare: bool = False) -> None:
    """Parts of the run alone (``--phases``), on the data the whole run
    makes from ``seed``, in this order: ``paths`` (:func:`paths_ms`),
    ``serve`` (:func:`serve_qps`),
    ``ring`` (phase 2's ring checks and lines, :func:`ring_checks`), ``b3``
    (phase 2's B3 checks, :func:`rabitq_checks`) and ``rabitq`` (phase 5,
    :func:`rabitq_phase`, on the 1M set and its exact neighbours); ``b1``
    runs first: phase 2's B1 checks (:func:`flat_checks`), then B1 at the
    main path's two shapes on the 1M IVF-Flat index (:func:`b1_main`);
    ``b4``: phase 2's B4 checks (:func:`cagra_checks`), then the 1M
    CAGRA index built as phase 6 builds it and B4 and ``cagra.search`` at
    the main path's shapes (:func:`b4_main`); ``mutable``: phase 8
    (:func:`mutable_phase`) on phase 3's data; ``robust`` last: phase 9
    (:func:`robust_phase`) on phase 3's data and indexes built as phases 3,
    4 and 6 build them, or with ``compare`` (``--tree`` given) only the
    sharded backlog's QPS (:func:`sharded_serve_qps`); ``tiered``: phase 10
    (:func:`tiered_phase`) on phase 3's data and the indexes of phases 3, 4
    and 6 (the CAGRA one after a fused search); ``multi``: phase 11
    (:func:`multi_phase`) on phase 3's data and the indexes of phases 4, 5
    and 6; ``replica``: phase 12 (:func:`replica_phase`) on phase 3's data
    and IVF-Flat index (its churn rows follow phase 3's draws, not phase
    8's); ``prims``: phase 13 (:func:`prims_phase`) on phase 3's data;
    ``geo``: phase 14 (:func:`geo_phase`) on phase 3's data and the CAGRA
    index built as phase 6 builds it; ``data``: phase 15 (:func:`data_phase`)
    on phase 3's rows; ``graph``: phase 16 (:func:`graph_phase`) on its own
    data; ``procs``: phase 17 (:func:`procs_phase`) on phase 3's data and the
    indexes of phases 3, 4 and 6; ``bench``: phase 18 (:func:`bench_phase`)
    on the bench's own registry data. Each builds the kernels it launches
    first.
    ``tree`` is the tree whose
    package runs; ``this_tree`` is False when it is not this file's, and
    then the lines an older kernel cannot give are skipped."""
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import ivf_scan, rabitq_scan
    from raft_tpu_torch.ops import ring_topk as rt

    if "paths" in parts:
        paths_ms(card, tree, seed)
    if "serve" in parts:
        serve_qps(card, tree, seed)
    max_err = {}
    if "b1" in parts:
        _, build_s, log = ivf_scan.build_kernel(True)
        emit(card, phase="build", kernel="fused_list_topk", build_s=build_s,
             ptxas=[line for line in log.splitlines() if "registers" in line or "spill" in line])
        max_err["fused_list_topk"] = 0.0
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        X_mid = gen.sample(65536)
        Q_mid = torch.from_numpy(gen.sample(512)).cuda()
        flat_checks(card, seed, Resources(device="cuda", seed=seed), X_mid, Q_mid, max_err,
                    this_tree)
        gen = Clustered(rng, 128, 4096)
        X, Q = gen.sample(1_000_000), gen.sample(10_000)
        index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024),
                               res=Resources(device="cuda", seed=seed))
        b1_main(card, index, torch.from_numpy(Q).cuda(), ivf_flat.IvfFlatSearchParams(n_probes=20),
                10, max_err, this_tree, phase="b1")
        del index
    if "ring" in parts:
        _, build_s, log = rt.build_kernel(True)
        emit(card, phase="build", kernel="ring_topk", build_s=build_s,
             ptxas=[line for line in log.splitlines() if "registers" in line or "spill" in line])
        max_err.update(fused_ring_topk=0.0, fused_scan_ring_topk=0.0)
        ring_rng = np.random.default_rng([seed, 7])
        ring_checks(card, ring_rng, max_err)
        ring_lines(card, ring_rng)
    if "b3" in parts or "rabitq" in parts:
        _, build_s, log = rabitq_scan.build_kernel(True)
        emit(card, phase="build", kernel="fused_rabitq_topk", build_s=build_s,
             ptxas=[line for line in log.splitlines() if "registers" in line or "spill" in line])
        max_err["fused_rabitq_topk"] = 0.0
        res = Resources(device="cuda", seed=seed)
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        X_mid = gen.sample(65536)
        Q_mid = torch.from_numpy(gen.sample(512)).cuda()
        if "b3" in parts:
            index = ivf_pq.build(X_mid, ivf_pq.IvfPqIndexParams(n_lists=64, pq_bits=1), res=res)
            rabitq_checks(card, seed, index, Q_mid, max_err, this_tree)
            del index
        if "rabitq" in parts:
            gen = Clustered(rng, 128, 4096)
            X, Q = gen.sample(1_000_000), gen.sample(10_000)
            _, gt_i = brute_force.knn(X, Q, 10, metric="sqeuclidean", res=res)
            rabitq_phase(card, res, X, torch.from_numpy(X).cuda(), torch.from_numpy(Q).cuda(),
                         gt_i, 10, 80, max_err, this_tree)
    if "b4" in parts:
        from raft_tpu_torch.neighbors import cagra
        from raft_tpu_torch.ops import cagra_search

        _, build_s, log = cagra_search.build_kernel(True)
        emit(card, phase="build", kernel="cagra_fused_search", build_s=build_s,
             ptxas=[line for line in log.splitlines() if "registers" in line or "spill" in line])
        max_err["cagra_fused_search"] = 0.0
        res = Resources(device="cuda", seed=seed)
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        X_mid = gen.sample(65536)
        Q_mid = torch.from_numpy(gen.sample(512)).cuda()
        cagra_checks(card, seed, res, X_mid, Q_mid, max_err, this_tree)
        gen = Clustered(rng, 128, 4096)
        X, Q = gen.sample(1_000_000), gen.sample(10_000)
        X_card = torch.from_numpy(X).cuda()
        pq_index = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res)
        cg, build_s = timed_build(lambda: cagra.build(
            X_card, cagra.CagraIndexParams(intermediate_graph_degree=32, graph_degree=16,
                                           build_algo="ivf_pq"), res=res, pq_index=pq_index))
        del pq_index
        emit(card, phase="b4", metric="cagra_build_s", value=build_s,
             empty_graph_slots=int((cg.graph < 0).sum()))
        b4_main(card, cg, torch.from_numpy(Q).cuda(), 10, max_err, this_tree, phase="b4")
    if "mutable" in parts:
        _, build_s, log = ivf_scan.build_kernel(True)
        emit(card, phase="build", kernel="fused_list_topk", build_s=build_s,
             ptxas=[line for line in log.splitlines() if "registers" in line or "spill" in line])
        res = Resources(device="cuda", seed=seed)
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        gen.sample(65536), gen.sample(512)  # phase 2's draws: phase 3's data follow them
        gen = Clustered(rng, 128, 4096)
        X, Q = gen.sample(1_000_000), gen.sample(10_000)
        _, gt_i = brute_force.knn(X, Q, 10, metric="sqeuclidean", res=res)
        mutable_phase(card, res, X, Q, gt_i, gen, 10, seed)
    if "robust" in parts and compare:
        sharded_serve_qps(card, tree, seed)
    elif "robust" in parts:
        from raft_tpu_torch.neighbors import cagra
        from raft_tpu_torch.ops import cagra_search, pq_scan

        mods = {"fused_list_topk": ivf_scan, "fused_pq_topk": pq_scan,
                "cagra_fused_search": cagra_search, "ring_topk": rt}
        with concurrent.futures.ThreadPoolExecutor(len(mods)) as ex:
            builds = {name: ex.submit(mod.build_kernel, True) for name, mod in mods.items()}
            for name, f in builds.items():
                emit(card, phase="build", kernel=name, build_s=f.result()[1])
        res = Resources(device="cuda", seed=seed)
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        gen.sample(65536), gen.sample(512)  # phase 2's draws: phase 3's data follow them
        gen = Clustered(rng, 128, 4096)
        X, Q = gen.sample(1_000_000), gen.sample(10_000)
        sizes = request_sizes(rng, Q.shape[0])
        index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024), res=res)
        _, gt_i = brute_force.knn(X, Q, 10, metric="sqeuclidean", res=res)
        X_card = torch.from_numpy(X).cuda()
        pq_index = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res)
        cg = cagra.build(X_card, cagra.CagraIndexParams(intermediate_graph_degree=32,
                                                        graph_degree=16, build_algo="ivf_pq"),
                         res=res, pq_index=pq_index)
        robust_phase(card, res, index, pq_index, cg, X_card, Q, gt_i, 10, sizes)
    if "tiered" in parts:
        from raft_tpu_torch.neighbors import cagra
        from raft_tpu_torch.ops import cagra_search, pq_scan

        mods = {"fused_list_topk": ivf_scan, "fused_pq_topk": pq_scan,
                "fused_rabitq_topk": rabitq_scan, "cagra_fused_search": cagra_search,
                "ring_topk": rt}
        with concurrent.futures.ThreadPoolExecutor(len(mods)) as ex:
            builds = {name: ex.submit(mod.build_kernel, True) for name, mod in mods.items()}
            ptxas = {}
            for name, f in builds.items():
                _, build_s, log = f.result()
                ptxas[name] = [line for line in log.splitlines()
                               if "registers" in line or "spill" in line]
                emit(card, phase="build", kernel=name, build_s=build_s)
        res = Resources(device="cuda", seed=seed)
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        gen.sample(65536), gen.sample(512)  # phase 2's draws: phase 3's data follow them
        gen = Clustered(rng, 128, 4096)
        X, Q = gen.sample(1_000_000), gen.sample(10_000)
        sizes = request_sizes(rng, Q.shape[0])
        mem = {"ivf_flat": [torch.cuda.memory_allocated()]}
        index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024), res=res)
        mem["ivf_flat"].append(torch.cuda.memory_allocated())
        _, gt_i = brute_force.knn(X, Q, 10, metric="sqeuclidean", res=res)
        X_card = torch.from_numpy(X).cuda()
        mem["ivf_pq"] = [torch.cuda.memory_allocated()]
        pq_index = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res)
        mem["ivf_pq"].append(torch.cuda.memory_allocated())
        mem["cagra"] = [torch.cuda.memory_allocated()]
        cg = cagra.build(X_card, cagra.CagraIndexParams(intermediate_graph_degree=32,
                                                        graph_degree=16, build_algo="ivf_pq"),
                         res=res, pq_index=pq_index)
        mem["cagra"].append(torch.cuda.memory_allocated())
        # phase 6's fused search: the table and seeds it keeps on the index
        cagra.search(cg, torch.from_numpy(Q[:128]).cuda(), 10, cagra.CagraSearchParams(
            itopk_size=128, search_width=8, dedup="post", init_sample=SERVE_INIT_SAMPLE),
            mode="fused")
        tiered_phase(card, res, index, pq_index, cg, X, X_card, Q, gt_i, 10, sizes, mem, ptxas)
    if "multi" in parts:
        from raft_tpu_torch.neighbors import cagra
        from raft_tpu_torch.ops import pq_scan

        mods = {"fused_pq_topk": pq_scan, "fused_rabitq_topk": rabitq_scan, "ring_topk": rt}
        with concurrent.futures.ThreadPoolExecutor(len(mods)) as ex:
            builds = {name: ex.submit(mod.build_kernel, True) for name, mod in mods.items()}
            for name, f in builds.items():
                emit(card, phase="build", kernel=name, build_s=f.result()[1])
        res = Resources(device="cuda", seed=seed)
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        gen.sample(65536), gen.sample(512)  # phase 2's draws: phase 3's data follow them
        gen = Clustered(rng, 128, 4096)
        X, Q = gen.sample(1_000_000), gen.sample(10_000)
        sizes = request_sizes(rng, Q.shape[0])
        _, gt_i = brute_force.knn(X, Q, 10, metric="sqeuclidean", res=res)
        X_card = torch.from_numpy(X).cuda()
        pq_index = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res)
        rq_index = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024, pq_bits=1), res=res)
        cg = cagra.build(X_card, cagra.CagraIndexParams(intermediate_graph_degree=32,
                                                        graph_degree=16, build_algo="ivf_pq"),
                         res=res, pq_index=pq_index)
        multi_phase(card, res, X, X_card, Q, gt_i, 10, sizes, pq_index, cg, rq_index)
    if "replica" in parts:
        _, build_s, log = ivf_scan.build_kernel(True)
        emit(card, phase="build", kernel="fused_list_topk", build_s=build_s)
        res = Resources(device="cuda", seed=seed)
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        gen.sample(65536), gen.sample(512)  # phase 2's draws: phase 3's data follow them
        gen = Clustered(rng, 128, 4096)
        X, Q = gen.sample(1_000_000), gen.sample(10_000)
        sizes = request_sizes(rng, Q.shape[0])
        index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024), res=res)
        _, gt_i = brute_force.knn(X, Q, 10, metric="sqeuclidean", res=res)
        replica_phase(card, res, index, X, Q, gt_i, gen, 10, seed, sizes)
    if "prims" in parts:
        res = Resources(device="cuda", seed=seed)
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        gen.sample(65536), gen.sample(512)  # phase 2's draws: phase 3's data follow them
        gen = Clustered(rng, 128, 4096)
        X, Q = gen.sample(1_000_000), gen.sample(10_000)
        _, gt_i = brute_force.knn(X, Q, 10, metric="sqeuclidean", res=res)
        prims_phase(card, res, torch.from_numpy(X).cuda(), torch.from_numpy(Q).cuda(), gt_i, 10,
                    seed)
    if "geo" in parts:
        from raft_tpu_torch.neighbors import cagra
        from raft_tpu_torch.ops import cagra_search, pq_scan

        mods = {"fused_pq_topk": pq_scan, "cagra_fused_search": cagra_search}
        with concurrent.futures.ThreadPoolExecutor(len(mods)) as ex:
            builds = {name: ex.submit(mod.build_kernel, True) for name, mod in mods.items()}
            for name, f in builds.items():
                emit(card, phase="build", kernel=name, build_s=f.result()[1])
        res = Resources(device="cuda", seed=seed)
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        gen.sample(65536), gen.sample(512)  # phase 2's draws: phase 3's data follow them
        gen = Clustered(rng, 128, 4096)
        X, Q = gen.sample(1_000_000), gen.sample(10_000)
        _, gt_i = brute_force.knn(X, Q, 10, metric="sqeuclidean", res=res)
        X_card = torch.from_numpy(X).cuda()
        pq_index = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res)
        cg = cagra.build(X_card, cagra.CagraIndexParams(intermediate_graph_degree=32,
                                                        graph_degree=16, build_algo="ivf_pq"),
                         res=res, pq_index=pq_index)
        del pq_index
        geo_phase(card, res, X_card, torch.from_numpy(Q).cuda(), gt_i, cg, 10, seed)
    if "data" in parts:
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        gen.sample(65536), gen.sample(512)  # phase 2's draws: phase 3's data follow them
        X = Clustered(rng, 128, 4096).sample(1_000_000)
        data_phase(card, torch.from_numpy(X).cuda(), seed)
    if "graph" in parts:
        graph_phase(card, seed)
    if "bench" in parts:
        from raft_tpu_torch.ops import cagra_search, pq_scan

        mods = {"fused_list_topk": ivf_scan, "fused_pq_topk": pq_scan,
                "cagra_fused_search": cagra_search}
        with concurrent.futures.ThreadPoolExecutor(len(mods)) as ex:
            builds = {name: ex.submit(mod.build_kernel, True) for name, mod in mods.items()}
            for name, f in builds.items():
                emit(card, phase="build", kernel=name, build_s=f.result()[1])
        bench_phase(card, Resources(device="cuda", seed=seed))
    if "procs" in parts:
        from raft_tpu_torch.neighbors import cagra
        from raft_tpu_torch.ops import pq_scan

        mods = {"fused_pq_topk": pq_scan, "ring_topk": rt}  # B2: the CAGRA build's self-search
        with concurrent.futures.ThreadPoolExecutor(len(mods)) as ex:
            builds = {name: ex.submit(mod.build_kernel, True) for name, mod in mods.items()}
            for name, f in builds.items():
                emit(card, phase="build", kernel=name, build_s=f.result()[1])
        res = Resources(device="cuda", seed=seed)
        rng = np.random.default_rng(seed)
        gen = Clustered(rng, 128, 512)
        gen.sample(65536), gen.sample(512)  # phase 2's draws: phase 3's data follow them
        gen = Clustered(rng, 128, 4096)
        X, Q = gen.sample(1_000_000), gen.sample(10_000)
        sizes = request_sizes(rng, Q.shape[0])
        _, gt_i = brute_force.knn(X, Q, 10, metric="sqeuclidean", res=res)
        X_card = torch.from_numpy(X).cuda()
        index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024), res=res)
        pq_index = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res)
        cg = cagra.build(X_card, cagra.CagraIndexParams(intermediate_graph_degree=32,
                                                        graph_degree=16, build_algo="ivf_pq"),
                         res=res, pq_index=pq_index)
        procs_phase(card, index, pq_index, cg, X, X_card, Q, gt_i, 10, sizes)
    if max_err:
        emit(card, phase="kernel_vs_plain", metric="max_abs_err", value=max_err)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="phases 1-2 only")
    ap.add_argument("--profile", action="store_true",
                    help="also trace the serving backlogs with torch.profiler")
    ap.add_argument("--phases",
                    help="only these parts, comma-separated: " + ", ".join(PHASE_PARTS))
    ap.add_argument("--tree", help="with --phases: the tree whose raft_tpu_torch to import")
    args = ap.parse_args()
    parts = args.phases.split(",") if args.phases else []
    if any(p not in PHASE_PARTS for p in parts):
        ap.error(f"--phases takes {', '.join(PHASE_PARTS)}")
    if args.tree and not parts:
        ap.error("--tree goes with --phases")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_run = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    tree = os.path.abspath(args.tree or here)
    sys.path.insert(0, tree)
    if parts:
        run_phases(card_line(), parts, args.seed, tree, this_tree=tree == here,
                   compare=args.tree is not None)
        return 0
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import cagra_search, ivf_scan, pq_scan, rabitq_scan
    from raft_tpu_torch.ops import ring_topk as rt
    from raft_tpu_torch.parallel import make_mesh
    from raft_tpu_torch.serve import ServingEngine
    from raft_tpu_torch.stats.recall import neighborhood_recall

    # ---- phase 1: device and build --------------------------------------
    card = card_line()
    print(card, flush=True)
    emit(card, phase="device", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    kernels = {"fused_list_topk": ivf_scan, "fused_pq_topk": pq_scan,
               "fused_rabitq_topk": rabitq_scan, "cagra_fused_search": cagra_search,
               "ring_topk": rt}
    os.makedirs("chiprun_out", exist_ok=True)
    # every build starts now; B3's (the longest, 24 instantiations) goes on
    # under phases 2-4, which launch no B3, and is waited for before phase 5
    t_build = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(len(kernels))
    builds = {name: pool.submit(mod.build_kernel, True) for name, mod in kernels.items()}
    built = {}

    def wait_builds(names):
        for name in names:
            _, build_s, log = built[name] = builds[name].result()
            with open(f"chiprun_out/{name}_ptxas.txt", "w") as f:
                f.write(log)
            emit(card, phase="build", kernel=name, build_s=build_s,
                 ptxas=[line for line in log.splitlines() if "registers" in line or "spill" in line])
        if len(built) == len(kernels):
            pool.shutdown()
            emit(card, phase="build", metric="parallel_build_s",
                 value=time.perf_counter() - t_build)

    res = Resources(device="cuda", seed=args.seed)
    rng = np.random.default_rng(args.seed)
    # the ring checks draw from their own stream, so phases 3-6 see the data
    # and requests they saw before the ring was added
    ring_rng = np.random.default_rng([args.seed, 7])
    # phases 2 and 3 draw their data from ``rng`` in this order while the kernels build
    d = 128
    gen = Clustered(rng, d, 512)
    X_mid, Q_mid_np = gen.sample(65536), gen.sample(512)
    gen = Clustered(rng, d, 4096)
    X, Q = gen.sample(1_000_000), gen.sample(10_000)
    wait_builds(["ring_topk"])
    emit(card, phase="build", metric="phase_s", value=time.perf_counter() - t_run,
         waiting_for=[name for name in kernels if name != "ring_topk"])
    max_err = {name: 0.0 for name in ("fused_list_topk", "fused_pq_topk", "fused_rabitq_topk",
                                       "cagra_fused_search", "hop_merge", "fused_ring_topk",
                                       "fused_scan_ring_topk")}

    def check(name, run, a, k, metric_name, **tags):
        rv, rs = run(a, k, reference=True)
        for n_split in (1, None):  # one CTA per tile share, and the default split
            kv, ks = run(a, k, n_split=n_split)
            torch.cuda.synchronize()
            err = compare_topk(kv, ks, rv, rs)
            max_err[name] = max(max_err[name], err)
            emit(card, phase="kernel_vs_plain", kernel=name, metric=metric_name, k=k,
                 n_split=n_split or "auto", max_abs_err=err, **tags)

    # ---- phase 2: kernel vs plain ----------------------------------------
    # While the other kernels compile, the ring's parts run first (the ring
    # builds first: B5-B7's checks, then its timed lines), then phase 16's
    # card-vs-CPU checks (no kernel), B2's checks once B2 is built, then B1's
    # and B4's. The timed lines of B1 and B4 wait for their builds; B3's
    # checks wait for B3, after phase 17.
    t_phase = time.perf_counter()
    parts = {}

    def part(name, t0):
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()

    Q_mid = torch.from_numpy(Q_mid_np).cuda()
    t0 = time.perf_counter()
    # B5: the fold, against its plain version on the card
    for rows in (32, 2560):
        for w in (10, 80, 256):
            for select_min in (True, False):
                a = fold_tiles(ring_rng, rows, w, select_min, 0)
                b = fold_tiles(ring_rng, rows, w, select_min, 1)
                got = rt.hop_merge(a, b)
                torch.cuda.synchronize()
                err = exact_err(f"hop_merge rows {rows} w {w}", got, rt.hop_merge_reference(a, b))
                max_err["hop_merge"] = max(max_err["hop_merge"], err)
                emit(card, phase="kernel_vs_plain", kernel="hop_merge", rows=rows, w=w,
                     select_min=select_min, max_abs_err=err)
    t0 = part("hop_merge", t0)
    # B6 and B7: the ring over virtual meshes, one shard demoted
    ring_checks(card, ring_rng, max_err)
    t0 = part("ring", t0)
    ring_lines(card, ring_rng)
    t0 = part("ring_lines", t0)
    graph_rng = graph_checks(card, args.seed)  # phase 16's card-vs-CPU part times nothing
    t0 = part("graph_checks", t0)
    wait_builds(["fused_pq_topk"])
    t0 = part("wait_fused_pq_topk", t0)
    mid_pq = ivf_pq.IvfPqSearchParams(n_probes=8, fused_qt=32)
    for label, kw, as_u8 in [("nib8", {}, False),
                             ("p4", dict(pq_kind="kmeans", pq_bits=4), False),
                             ("u8_ksub16", dict(pq_kind="kmeans", pq_bits=4), True),
                             ("u8_ksub256", dict(pq_kind="kmeans", pq_bits=8), False),
                             ("b5", dict(pq_kind="kmeans", pq_bits=5), False)]:
        index = ivf_pq.build(X_mid, ivf_pq.IvfPqIndexParams(n_lists=64, **kw), res=res)
        for metric in ("L2Expanded", "InnerProduct"):
            a = pq_args(index, Q_mid, mid_pq, ivf_pq.DistanceType[metric], as_u8=as_u8)
            for k in (10, 80):
                check("fused_pq_topk", run_pq, a, k, metric, codes=label, code_mode=a["code_mode"],
                      ksub=a["ksub"])
    t0 = part("fused_pq_topk", t0)
    wait_builds(["cagra_fused_search", "fused_list_topk"])
    t0 = part("wait_fused_list_topk", t0)
    flat_checks(card, args.seed, res, X_mid, Q_mid, max_err)
    t0 = part("fused_list_topk", t0)
    cagra_checks(card, args.seed, res, X_mid, Q_mid, max_err)
    t0 = part("cagra_fused_search", t0)
    emit(card, phase="kernel_vs_plain", metric="max_abs_err", value=max_err)

    # the build's determinism, on the mid-size set
    check_deterministic(card, "determinism", "ivf_flat_65536",
                        lambda: ivf_flat.build(X_mid, ivf_flat.IvfFlatIndexParams(n_lists=256), res=res),
                        ("centers", "list_sizes", "list_indices", "list_data", "list_norms"))
    check_deterministic(card, "determinism", "ivf_pq_65536",
                        lambda: ivf_pq.build(X_mid, ivf_pq.IvfPqIndexParams(n_lists=256), res=res),
                        ("centers", "pq_centers", "list_sizes", "list_indices", "codes", "rot_sqnorms"))
    part("determinism", t0)
    emit(card, phase="kernel_vs_plain", metric="phase_s", value=time.perf_counter() - t_phase,
         without="fused_rabitq_topk (after phase 4)", parts=parts, **memory())

    def rabitq_part():
        """Phase 2's B3 checks, once B3 is built."""
        t0 = time.perf_counter()
        wait_builds(["fused_rabitq_topk"])
        t1 = time.perf_counter()
        rq_mid = ivf_pq.build(X_mid, ivf_pq.IvfPqIndexParams(n_lists=64, pq_bits=1), res=res)
        rabitq_checks(card, args.seed, rq_mid, Q_mid, max_err)
        emit(card, phase="kernel_vs_plain", metric="phase_s_fused_rabitq_topk",
             value=time.perf_counter() - t1, build_wait_s=t1 - t0, **memory())
        del rq_mid
        torch.cuda.empty_cache()  # hand back the blocks of the checks' temporaries

    if args.quick:
        rabitq_part()
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 3: IVF-Flat at full width ----------------------------------
    t_phase = time.perf_counter()
    n, nq, k = 1_000_000, 10_000, 10
    torch.cuda.synchronize()
    mem = {"ivf_flat": [torch.cuda.memory_allocated()]}
    t0 = time.perf_counter()
    index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024), res=res)
    torch.cuda.synchronize()
    mem["ivf_flat"].append(torch.cuda.memory_allocated())
    emit(card, phase="main", metric="build_s", value=time.perf_counter() - t0, n=n, d=d,
         n_lists=index.n_lists, max_list=index.max_list)
    _, gt_i = brute_force.knn(X, Q, k, metric="sqeuclidean", res=res)
    gt = gt_i.cpu()
    params = ivf_flat.IvfFlatSearchParams(n_probes=20)
    serve_params = dataclasses.replace(params, fused_qt=SERVE_QT)

    eng = ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=nq, res=res)
    eng.register("sift1m", "ivf_flat", index, params=serve_params)
    eng.warmup("sift1m", k)
    sizes = request_sizes(rng, nq)
    starts = np.cumsum([0] + sizes[:-1])
    flat_launches = serve_both_ways(card, eng, "sift1m", Q, sizes, starts, k, n, gt,
                                    ivf_scan.fused_list_topk, "main", serve_qt=SERVE_QT,
                                    n_probes=20)
    emit(card, phase="main", metric="serve_launches", value=flat_launches)

    Qt = torch.from_numpy(Q).cuda()
    # one batch: all 10,000 queries are sorted into tiles together
    _, f_ids = ivf_flat.search(index, Qt, k, params, mode="fused", query_batch=nq)
    _, p_ids = ivf_flat.search(index, Qt, k, params, mode="probe")
    fused_recall = neighborhood_recall(f_ids, gt_i)
    probe_recall = neighborhood_recall(p_ids, gt_i)
    emit(card, phase="main", metric="fused_recall@10", value=fused_recall, n_probes=20,
         query_batch=nq, fused_qt=params.fused_qt)
    emit(card, phase="main", metric="probe_recall@10", value=probe_recall, n_probes=20)
    if fused_recall < probe_recall - 0.005:
        raise AssertionError(f"fused recall {fused_recall} < probe recall {probe_recall} - 0.005")
    if min(fused_recall, probe_recall) < 0.90:
        raise AssertionError(f"recall@10 below 0.90: fused {fused_recall}, probe {probe_recall}")
    # select_k where the paths run it: a dense scan's [128, 524288] block
    # (k = 20, largest first, three quarters -inf as unprobed lists are),
    # and a 16-row probe-path search (20 probes: its merges)
    from raft_tpu_torch.ops.select_k import select_k

    gen_t = torch.Generator(device="cuda").manual_seed(args.seed)
    blk = torch.randn((128, 524288), device="cuda", generator=gen_t)
    blk[torch.rand(blk.shape, device="cuda", generator=gen_t) < 0.75] = float("-inf")
    emit(card, phase="main", metric="select_k_ms",
         scan_block=cuda_ms(lambda: select_k(blk, 20, select_min=False), reps=20),
         probe_search_16_rows=cuda_ms(lambda: ivf_flat.search(index, Qt[:16], k, params,
                                                              mode="probe"), reps=20))
    del blk

    # the tile size of an unsorted 128-row batch: recall and time per batch
    sub = 2048
    for qt in (128, 32, 16):
        p_qt = dataclasses.replace(params, fused_qt=qt)
        run = lambda: ivf_flat.search(index, Qt[:sub], k, p_qt, mode="fused", query_batch=128)
        _, ids = run()
        fi_qt = flat_args(index, Qt[:128], p_qt)
        emit(card, phase="main", metric="fused_128_row_batches", fused_qt=qt,
             recall=neighborhood_recall(ids, gt_i[:sub]),
             ms_per_batch=cuda_ms(run, reps=2) / (sub // 128),
             valid_units_per_tile=float((fi_qt.probe_valid > 0).sum()) / fi_qt.tile_probes.shape[0],
             units=int(fi_qt.list_data.shape[0]))

    # the kernel at the serving path's shapes
    b1 = b1_main(card, index, Qt, params, k, max_err)
    if args.profile:
        profile_backlog(card, eng, "sift1m", Q, starts, sizes, k, "serve_backlog_trace.json")

    emit(card, phase="main", metric="phase_s", value=time.perf_counter() - t_phase,
         **memory())

    # ---- phase 4: IVF-PQ at full width ------------------------------------
    t_phase = time.perf_counter()
    X_card = torch.from_numpy(X).cuda()
    torch.cuda.synchronize()
    mem["ivf_pq"] = [torch.cuda.memory_allocated()]
    t0 = time.perf_counter()
    pq_index = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res)
    torch.cuda.synchronize()
    mem["ivf_pq"].append(torch.cuda.memory_allocated())
    emit(card, phase="ivf_pq", metric="build_s", value=time.perf_counter() - t0, n=n, d=d,
         n_lists=pq_index.n_lists, max_list=pq_index.max_list, pq_dim=pq_index.pq_dim,
         code_bytes_per_row=int(pq_index.codes.shape[2]), nibble=pq_index.additive)
    # the same build again: equal in every field
    again, again_s = timed_build(lambda: ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res))
    _, atomic_s = timed_build(lambda: ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res),
                              atomic_segment_sum)
    diff = differing_fields(pq_index, again, ("centers", "pq_centers", "list_sizes", "list_indices",
                                              "codes", "rot_sqnorms"))
    emit(card, phase="ivf_pq", metric="build_determinism", rebuild_s=again_s,
         atomic_sums_build_s=atomic_s, fields_differing=diff, max_list=[pq_index.max_list,
                                                                        again.max_list])
    if diff:
        raise AssertionError(f"the 1M IVF-PQ index built twice from one seed differs in {diff}")
    del again
    pq_params = ivf_pq.IvfPqSearchParams(n_probes=30)
    serve_pq = dataclasses.replace(pq_params, fused_qt=SERVE_QT_PQ)
    eng.register("sift1m_pq", "ivf_pq", pq_index, params=serve_pq, dataset=X_card)
    eng.warmup("sift1m_pq", k)
    pq_launches = serve_both_ways(card, eng, "sift1m_pq", Q, sizes, starts, k, n, gt,
                                  pq_scan.fused_pq_topk, "ivf_pq", serve_qt=SERVE_QT_PQ,
                                  n_probes=30, refine_ratio=8)
    emit(card, phase="ivf_pq", metric="serve_launches", value=pq_launches)

    no_refine = dataclasses.replace(pq_params, refine_ratio=1)
    _, f_ids = ivf_pq.search(pq_index, Qt, k, no_refine, mode="fused", query_batch=nq)
    _, p_ids = ivf_pq.search(pq_index, Qt, k, no_refine, mode="probe")
    fused_recall = neighborhood_recall(f_ids, gt_i)
    probe_recall = neighborhood_recall(p_ids, gt_i)
    emit(card, phase="ivf_pq", metric="fused_recall@10_no_refine", value=fused_recall,
         n_probes=30, query_batch=nq, fused_qt=pq_params.fused_qt)
    emit(card, phase="ivf_pq", metric="probe_recall@10_no_refine", value=probe_recall, n_probes=30)
    if fused_recall < probe_recall - 0.01:
        raise AssertionError(f"IVF-PQ fused recall {fused_recall} < probe {probe_recall} - 0.01")

    for qt in (128, 32, 16):
        p_qt = dataclasses.replace(pq_params, fused_qt=qt)
        run = lambda: ivf_pq.search(pq_index, Qt[:sub], k, p_qt, mode="fused", query_batch=128,
                                    dataset=X_card)
        _, ids = run()
        _, ids_nr = ivf_pq.search(pq_index, Qt[:sub], k, dataclasses.replace(p_qt, refine_ratio=1),
                                  mode="fused", query_batch=128)
        a = pq_args(pq_index, Qt[:128], p_qt)
        emit(card, phase="ivf_pq", metric="fused_128_row_batches", fused_qt=qt,
             recall=neighborhood_recall(ids, gt_i[:sub]),
             recall_no_refine=neighborhood_recall(ids_nr, gt_i[:sub]),
             ms_per_batch=cuda_ms(run, reps=2) / (sub // 128),
             valid_units_per_tile=float((a["args"][6] > 0).sum()) / a["args"][5].shape[0],
             units=int(a["args"][0].shape[0]))

    # B2 at the serving path's shapes: one 128-row batch, k * refine_ratio = 80
    kk = k * pq_params.refine_ratio
    a = pq_args(pq_index, Qt[:128], serve_pq)
    kv, ks = run_pq(a, kk)
    rv, rs = run_pq(a, kk, reference=True)
    max_err["fused_pq_topk"] = max(max_err["fused_pq_topk"], compare_topk(kv, ks, rv, rs))
    # timed as the search calls it: the index keeps the group tables
    tables = pq_scan.group_tables(torch.isfinite(a["args"][1]))
    b2 = time_kernel(lambda a, k, reference=False, **kw: run_pq(
        a, k, reference, **kw, **({} if reference else {"tables": tables})), a, kk, reps=20)
    b2["bound_ms"], b2["bound_by"] = pq_bound_ms(a, kk)
    emit(card, phase="ivf_pq", metric="fused_pq_topk_ms_serving_batch", value=b2["ms"],
         bound_ms=b2["bound_ms"], bound_by=b2["bound_by"], plain_ms=b2["plain_ms"],
         ms_building_tables=cuda_ms(lambda: run_pq(a, kk), reps=20),
         n_split_ms=b2["n_split_ms"], k=kk, fused_qt=SERVE_QT_PQ,
         n_qt=int(a["args"][5].shape[0]), valid_units=int((a["args"][6] > 0).sum()),
         unit_rows=int(a["args"][0].shape[1]), code_mode=a["code_mode"],
         queries_per_cta=pq_scan.queries_per_cta(a["args"][2].shape[1], kk, pq_index.n_lists
                                                 // a["args"][0].shape[0]))
    # where B2's cycles go at that shape: one launch with the stage clock on
    rec = pq_scan.fused_pq_topk_stages(*a["args"], k=kk, metric=a["metric"], qt=a["qt"],
                                       code_mode=a["code_mode"], ksub=a["ksub"])
    emit(card, phase="ivf_pq", metric="fused_pq_topk_split", k=kk, fused_qt=SERVE_QT_PQ,
         **stage_split(rec, pq_scan.STAGES, pq_scan.COUNTS))
    if args.profile:
        profile_backlog(card, eng, "sift1m_pq", Q, starts, sizes, k, "serve_pq_backlog_trace.json")

    emit(card, phase="ivf_pq", metric="phase_s", value=time.perf_counter() - t_phase,
         **memory())

    # ---- phase 6: CAGRA at full width --------------------------------------
    t_phase = time.perf_counter()
    cagra_search.cagra_fused_search.launches = 0
    pq_scan.fused_pq_topk.launches = 0
    mem["cagra"] = [torch.cuda.memory_allocated()]
    cg, build_s = timed_build(lambda: cagra.build(
        X_card, cagra.CagraIndexParams(intermediate_graph_degree=32, graph_degree=16,
                                       build_algo="ivf_pq"), res=res, pq_index=pq_index))
    mem["cagra"].append(torch.cuda.memory_allocated())
    build_b2 = pq_scan.fused_pq_topk.launches
    emit(card, phase="cagra", metric="build_s", value=build_s, stages_s=cg.build_seconds,
         graph_degree=cg.graph_degree, self_search_b2_launches=build_b2,
         empty_graph_slots=int((cg.graph < 0).sum()))
    if build_b2 <= 0:
        raise AssertionError("the CAGRA build's self-search never launched fused_pq_topk")
    cp = cagra.CagraSearchParams(itopk_size=128, search_width=8, dedup="post",
                                 init_sample=SERVE_INIT_SAMPLE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = cagra._fused_table(cg, cp.fused_table_dtype)
    torch.cuda.synchronize()
    emit(card, phase="cagra", metric="table_build_s", value=time.perf_counter() - t0,
         table_bytes=table.numel() * table.element_size(), shape=list(table.shape))
    mode_recall = {}
    for mode in ("fused", "xla"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ids = cagra.search(cg, Qt, k, cp, mode=mode)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        mode_recall[mode] = neighborhood_recall(ids, gt_i)
        emit(card, phase="cagra", metric="search_recall@10", mode=mode, value=mode_recall[mode],
             qps=nq / secs, itopk=128, width=8, init_sample=cp.init_sample,
             iters=cagra.derive_search_config(cp, k, n)[2])
    if mode_recall["fused"] < mode_recall["xla"] - 0.01:
        raise AssertionError(f"CAGRA fused recall {mode_recall['fused']} < xla {mode_recall['xla']} - 0.01")
    for init_sample in (4096, 16384):  # the default and the serving point
        sp = dataclasses.replace(cp, init_sample=init_sample)
        run = lambda: cagra.search(cg, Qt, k, sp, mode="fused")
        _, ids = run()
        emit(card, phase="cagra", metric="init_sample_sweep", init_sample=init_sample, mode="fused",
             recall=neighborhood_recall(ids, gt_i), qps=nq / (cuda_ms(run, reps=2) / 1e3))
    for itopk in (96, 160):  # around the serving point, 128, searched above
        sp = dataclasses.replace(cp, itopk_size=itopk)
        run = lambda: cagra.search(cg, Qt, k, sp)
        _, ids = run()
        emit(card, phase="cagra", metric="itopk_sweep", itopk=itopk, mode="auto",
             init_sample=sp.init_sample,
             recall=neighborhood_recall(ids, gt_i), qps=nq / (cuda_ms(run, reps=2) / 1e3),
             iters=cagra.derive_search_config(sp, k, n)[2])
    for bq in (1, 10):
        sp = cagra.plan_search_params(bq, k, n, cagra.CagraSearchParams(itopk_size=128, dedup="post"))
        lat = []
        for rep in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, ids = cagra.search(cg, Qt[rep * bq : (rep + 1) * bq], k, sp)
            ids.cpu()
            lat.append((time.perf_counter() - t0) * 1e3)
        _, ids = cagra.search(cg, Qt[:256], k, sp, query_batch=bq)
        emit(card, phase="cagra", metric="latency_ms", batch=bq, mean_ms=float(np.mean(lat[1:])),
             all_ms=lat, width=sp.search_width, init_sample=sp.init_sample,
             recall_256_queries=neighborhood_recall(ids, gt_i[:256]))
    eng.register("sift1m_cagra", "cagra", cg, params=cp)
    eng.warmup("sift1m_cagra", k)
    cagra_launches = serve_both_ways(card, eng, "sift1m_cagra", Q, sizes, starts, k, n, gt,
                                     cagra_search.cagra_fused_search, "cagra", min_recall=0.80,
                                     itopk=128, width=8)
    emit(card, phase="cagra", metric="serve_launches", value=cagra_launches)
    if args.profile:
        profile_backlog(card, eng, "sift1m_cagra", Q, starts, sizes, k, "serve_cagra_backlog_trace.json")
    # B4 at the main path's shapes: the serving batch, batch 1 and 10, and
    # a batch of the 10,000-query search
    b4 = b4_main(card, cg, Qt, k, max_err)

    emit(card, phase="cagra", metric="phase_s", value=time.perf_counter() - t_phase,
         **memory())

    # ---- phase 7: sharded search over four virtual shards ------------------
    t_phase = time.perf_counter()
    from raft_tpu_torch.parallel import (sharded_ivf_flat_search, sharded_ivf_pq_lists_search,
                                         sharded_knn)

    mesh = make_mesh(["cuda:0"] * 4)
    print(repr(mesh), flush=True)
    emit(card, phase="sharded", metric="mesh", shards=mesh.size, devices=[str(x) for x in mesh.devices],
         virtual=mesh.virtual)
    ring_kernels = (rt.hop_merge, rt.fused_ring_topk, rt.fused_scan_ring_topk)
    for f in ring_kernels:
        f.launches = 0
    rt.fused_ring_topk.folds = 0
    qb = 1024

    def batched(fn):
        outs = [fn(Qt[s : s + qb]) for s in range(0, nq, qb)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    sharded = {}
    for mode in ("ring", "fused_ring", "gather"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded[mode] = batched(lambda qc: sharded_ivf_flat_search(mesh, index, qc, k, params,
                                                                   merge_mode=mode))
        torch.cuda.synchronize()
        emit(card, phase="sharded", metric="sharded_ivf_flat_qps", merge_mode=mode,
             value=nq / (time.perf_counter() - t0), query_batch=qb, n_probes=20, shards=mesh.size,
             recall=neighborhood_recall(sharded[mode][1], gt_i))
    for mode in ("fused_ring", "gather"):
        exact_err(f"sharded IVF-Flat {mode} vs ring", sharded[mode], sharded["ring"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, scan_ids = ivf_flat.search(index, Qt, k, params, mode="scan")
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    sharded_recall = neighborhood_recall(sharded["ring"][1], gt_i)
    scan_recall = neighborhood_recall(scan_ids, gt_i)
    emit(card, phase="sharded", metric="sharded_ivf_flat_recall@10", value=sharded_recall,
         single_device_scan_recall=scan_recall, single_device_scan_qps=nq / scan_s,
         ids_equal_to_single_device_scan=float((scan_ids == sharded["ring"][1]).to(torch.float32).mean()))
    if sharded_recall < 0.90 or abs(sharded_recall - scan_recall) > 0.001:
        raise AssertionError(f"sharded IVF-Flat recall {sharded_recall} (single-device scan "
                             f"{scan_recall}): below 0.90 or more than 0.001 apart")

    # served: the sharded registration, ring exchange, both ways
    eng.register("sift1m_sharded", "sharded_ivf_flat", index, params=params, mesh=mesh,
                 merge_mode="ring")
    eng.warmup("sift1m_sharded", k)
    before = rt.fused_ring_topk.launches
    served_b6 = serve_both_ways(card, eng, "sift1m_sharded", Q, sizes, starts, k, n, gt,
                                rt.fused_ring_topk, "sharded", n_probes=20, shards=mesh.size,
                                merge_mode="ring")
    rt.fused_ring_topk.launches = before + served_b6
    if args.profile:
        counts = [f.launches for f in ring_kernels] + [rt.fused_ring_topk.folds]
        profile_backlog(card, eng, "sift1m_sharded", Q, starts, sizes, k,
                        "serve_sharded_backlog_trace.json")
        for f, c in zip(ring_kernels, counts):
            f.launches = c
        rt.fused_ring_topk.folds = counts[-1]
    emit(card, phase="sharded", metric="serve_launches", value=served_b6,
         bytes_per_query=rt.fused_ring_topk.last_bytes["per_query"],
         wire_model_bytes_per_query=rt.fused_ring_topk.last_bytes["model_per_query"])

    # B7 on the path: the per-shard scan at 80 candidates into scan_ring_topk(k)
    kk = 8 * k
    l_local = index.n_lists // mesh.size
    g_local = ivf_flat.scan_chunk_lists(l_local, index.max_list)

    def shard_scan(qc, width):
        probed = ivf_flat.probe_mask(index.centers, qc, params.n_probes, index.metric)
        vs, is_ = [], []
        for r in range(mesh.size):
            sl = slice(r * l_local, (r + 1) * l_local)
            v, i = ivf_flat.flat_scan_core(index.list_data[sl], index.list_indices[sl],
                                           index.list_norms[sl], qc, probed[:, sl], None, k=width,
                                           metric=index.metric, has_filter=False,
                                           chunk_lists=g_local)
            vs.append(v)
            is_.append(i)
        return vs, is_

    b567 = {}
    for rows_q in (128, qb):
        qc = Qt[:rows_q]
        vs80, is80 = shard_scan(qc, kk)
        vs10, is10 = shard_scan(qc, k)
        got = rt.scan_ring_topk(mesh, vs80, is80, k)
        torch.cuda.synchronize()
        what = f"scan ring at {rows_q} queries"
        max_err["fused_scan_ring_topk"] = max(
            max_err["fused_scan_ring_topk"],
            ring_err(what + " vs gather", got, rt.gather_merge(mesh, vs80, is80, k, True)),
            ring_err(what, got, rt.ring_kernel_reference(vs80, is80, k)))
        # the comparisons and timings below stay out of the path's launch counts
        counts = [f.launches for f in ring_kernels] + [rt.fused_ring_topk.folds]
        got = rt.ring_topk(mesh, vs10, is10, k)
        torch.cuda.synchronize()
        max_err["fused_ring_topk"] = max(
            max_err["fused_ring_topk"],
            ring_err(f"ring at {rows_q} queries vs gather", got, rt.gather_merge(mesh, vs10, is10, k, True)),
            ring_err(f"ring at {rows_q} queries", got, rt.ring_kernel_reference(vs10, is10, k)))
        # B5 at one hop's shape: B = rows / shards rows of k candidates
        B = -(-rows_q // mesh.size)
        fa, fb = fold_tiles(ring_rng, B, k, True, 0), fold_tiles(ring_rng, B, k, True, 1)
        max_err["hop_merge"] = max(max_err["hop_merge"], exact_err(
            f"hop_merge at {B} rows", rt.hop_merge(fa, fb), rt.hop_merge_reference(fa, fb)))
        if rows_q != 128:  # timed at the serving batch only; 1,024 rows are checked above
            for f, c in zip(ring_kernels, counts):
                f.launches = c
            rt.fused_ring_topk.folds = counts[-1]
            continue
        t = {
            "hop_merge": dict(ms=cuda_ms(lambda: rt.hop_merge(fa, fb), reps=50),
                              plain_ms=cuda_ms(lambda: rt.hop_merge_reference(fa, fb), reps=5),
                              bound=bound_ms(0.0, 3 * B * k * 16.0), rows=B, w=k),
            "fused_ring_topk": dict(
                ms=cuda_ms(lambda: rt.fused_ring_topk(mesh, vs10, is10, k), reps=20),
                plain_ms=cuda_ms(lambda: rt.ring_kernel_reference(vs10, is10, k), reps=3),
                gather_ms=cuda_ms(lambda: rt.gather_merge(mesh, vs10, is10, k, True), reps=20),
                schedule_ms=cuda_ms(lambda: rt._run_ring(mesh, vs10, is10, k, True), reps=20),
                bound=ring_bound_ms(mesh.size, rows_q, k, k), nq=rows_q, kc=k),
            "fused_scan_ring_topk": dict(
                ms=cuda_ms(lambda: rt.fused_scan_ring_topk(mesh, vs80, is80, k), reps=20),
                plain_ms=cuda_ms(lambda: rt.ring_kernel_reference(vs80, is80, k), reps=3),
                gather_ms=cuda_ms(lambda: rt.gather_merge(mesh, vs80, is80, k, True), reps=20),
                schedule_ms=cuda_ms(lambda: rt._run_ring(mesh, vs80, is80, k, True), reps=20),
                bound=ring_bound_ms(mesh.size, rows_q, kk, k), nq=rows_q, kc=kk),
        }
        for f, c in zip(ring_kernels, counts):
            f.launches = c
        rt.fused_ring_topk.folds = counts[-1]
        for name, row in t.items():
            bms, bby = row.pop("bound")
            row.update(bound_ms=bms, bound_by=bby)
            emit(card, phase="sharded", metric=f"{name}_ms", queries=rows_q, shards=mesh.size, **row)
        b567[rows_q] = t

    # lists-sharded IVF-PQ on phase 4's index: ring against gather
    pq_sp = ivf_pq.IvfPqSearchParams(n_probes=30)
    pq_out = {}
    for mode in ("ring", "gather"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [sharded_ivf_pq_lists_search(mesh, pq_index, Qt[s : s + qb], k, pq_sp, merge_mode=mode)
                for s in range(0, 2 * qb, qb)]
        torch.cuda.synchronize()
        pq_out[mode] = (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
        emit(card, phase="sharded", metric="sharded_ivf_pq_lists", merge_mode=mode,
             qps=2 * qb / (time.perf_counter() - t0), n_probes=30, queries=2 * qb,
             recall_no_refine=neighborhood_recall(pq_out[mode][1], gt_i[: 2 * qb]))
    exact_err("sharded IVF-PQ gather vs ring", pq_out["gather"], pq_out["ring"])

    # row-sharded exact kNN on the 1M rows: ring against gather, ids against brute force
    knn_out = {}
    for mode in ("ring", "gather"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        knn_out[mode] = sharded_knn(mesh, X_card, Qt[:qb], k, metric="sqeuclidean", merge_mode=mode)
        torch.cuda.synchronize()
        emit(card, phase="sharded", metric="sharded_knn", merge_mode=mode,
             seconds=time.perf_counter() - t0, queries=qb, rows=n)
    exact_err("sharded kNN gather vs ring", knn_out["gather"], knn_out["ring"])
    knn_same = float((knn_out["ring"][1].cpu() == gt[:qb]).to(torch.float32).mean())
    knn_recall = neighborhood_recall(knn_out["ring"][1], gt_i[:qb])
    emit(card, phase="sharded", metric="sharded_knn_vs_brute_force", ids_equal=knn_same,
         recall=knn_recall)
    if knn_recall < 0.999:
        raise AssertionError(f"sharded kNN recall against brute force {knn_recall} < 0.999")

    phase7 = {f.__name__: f.launches for f in ring_kernels}
    folds = rt.fused_ring_topk.folds
    emit(card, phase="sharded", metric="launches", value=phase7, folds_inside_rings=folds)
    # on one card each ring is one launch of B6/B7, B5's folds run inside it
    for name in ("fused_ring_topk", "fused_scan_ring_topk"):
        if phase7[name] <= 0:
            raise AssertionError(f"phase 7 never launched {name}")
    if folds <= 0 or phase7["hop_merge"] != 0:
        raise AssertionError(f"phase 7's rings folded {folds} blocks inside the kernel and "
                             f"launched B5 {phase7['hop_merge']} times (expected > 0 and 0)")
    emit(card, phase="kernel_vs_plain", metric="max_abs_err", value=max_err)
    emit(card, phase="sharded", metric="phase_s", value=time.perf_counter() - t_phase,
         **memory())

    # ---- phase 9: robustness in serving --------------------------------------
    t_phase = time.perf_counter()
    robust = robust_phase(card, res, index, pq_index, cg, X_card, Q, gt_i, k, sizes)
    emit(card, phase="robust", metric="phase_s", value=time.perf_counter() - t_phase,
         **memory())

    # ---- phase 17: multi-process meshes (while B3 compiles: it launches no B3) --
    procs = procs_phase(card, index, pq_index, cg, X, X_card, Q, gt_i, k, sizes)
    emit(card, phase="procs", metric="memory", **memory())

    # ---- phase 5: RaBitQ, after phase 2's B3 checks (phases 6, 7, 9 and 17 ran
    # while B3 compiled; they launch no B3) ----------------------------------------
    rabitq_part()
    t_phase = time.perf_counter()
    rq_launches, b3, rq_index = rabitq_phase(card, res, X, X_card, Qt, gt_i, k, kk, max_err)
    emit(card, phase="rabitq", metric="phase_s", value=time.perf_counter() - t_phase,
         **memory())

    # ---- phase 8: the mutable index, served across a background flip -------
    t_phase = time.perf_counter()
    mutable = mutable_phase(card, res, X, Q, gt_i, gen, k, args.seed, immutable=index)
    emit(card, phase="mutable", metric="phase_s", value=time.perf_counter() - t_phase,
         **memory())

    # ---- phase 10: placement and planning ------------------------------------
    ptxas = {name: [line for line in log.splitlines() if "registers" in line or "spill" in line]
             for name, (_, _, log) in built.items()}
    tiered = tiered_phase(card, res, index, pq_index, cg, X, X_card, Q, gt_i, k, sizes, mem,
                          ptxas)
    emit(card, phase="tiered", metric="memory", **memory())

    # ---- phase 11: the distributed build, query-sharded and tiered sharded --
    multi = multi_phase(card, res, X, X_card, Q, gt_i, k, sizes, pq_index, cg, rq_index,
                        ca_digest=procs["ca_digest"])
    emit(card, phase="multi", metric="memory", **memory())

    # ---- phase 12: replicated serving and the rest of obs --------------------
    t_phase = time.perf_counter()
    replica = replica_phase(card, res, index, X, Q, gt_i, gen, k, args.seed, sizes)
    emit(card, phase="replica", metric="phase_s", value=time.perf_counter() - t_phase,
         **memory())

    # ---- phase 13: the search path's primitives --------------------------------
    prims_phase(card, res, X_card, Qt, gt_i, k, args.seed)
    emit(card, phase="prims", metric="memory", **memory())

    # ---- phase 14: k-means' entry points, eps, ball cover and hnsw on B4 ---------
    geo = geo_phase(card, res, X_card, Qt, gt_i, cg, k, args.seed)
    emit(card, phase="geo", metric="memory", **memory())

    # ---- phase 15: the data and statistics primitives ---------------------------
    data_phase(card, X_card, args.seed)
    emit(card, phase="data", metric="memory", **memory())

    # ---- phase 16: sparse, graphs, spectral and the LAP ----------------------------
    graph_phase(card, args.seed, rng=graph_rng)
    emit(card, phase="graph", metric="memory", **memory())

    # ---- phase 18: the bench (raft_tpu_torch.bench) ----------------------------------
    bench = bench_phase(card, res)

    rows = []
    for name, src, line, launches, t in (
            ("fused_list_topk", "ivf_scan.cu", "raft_tpu/ops/pallas/ivf_scan.py:321", flat_launches, b1),
            ("fused_pq_topk", "pq_scan.cu", "raft_tpu/ops/pallas/pq_scan.py:340", pq_launches, b2),
            ("fused_rabitq_topk", "rabitq_scan.cu", "raft_tpu/ops/pallas/rabitq_scan.py:260",
             rq_launches, b3),
            ("cagra_fused_search", "cagra_search.cu", "raft_tpu/ops/pallas/cagra_search.py:272",
             cagra_launches, b4),
            ("hop_merge", "ring_topk.cu", "raft_tpu/ops/pallas/ring_topk.py:328",
             phase7["hop_merge"], b567[128]["hop_merge"]),
            ("fused_ring_topk", "ring_topk.cu", "raft_tpu/ops/pallas/ring_topk.py:505",
             phase7["fused_ring_topk"], b567[128]["fused_ring_topk"]),
            ("fused_scan_ring_topk", "ring_topk.cu", "raft_tpu/ops/pallas/ring_topk.py:530",
             phase7["fused_scan_ring_topk"], b567[128]["fused_scan_ring_topk"])):
        rows.append({"name": name, "route": "cuda", "source": f"raft_tpu_torch/csrc/{src}",
                     "replaces": line, "launches": launches, "max_abs_err": max_err[name],
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
        if name == "fused_list_topk":  # phase 8's served run: main and delta scans
            rows[-1].update(launches_mutable=mutable["launches"],
                            launches_mutable_delta=mutable["serve"]["b1_launches_delta"],
                            launches_replica=replica["launches"])
        if name in tiered:  # phase 10: the host tier's scans
            rows[-1]["launches_tiered"] = tiered[name]
        if name in multi:  # phase 11's (b)-(f)
            rows[-1]["launches_multi"] = multi[name]
        if name == "hop_merge":  # on one card B5's folds run inside B6's and B7's launches
            rows[-1]["folds_inside_rings"] = folds
        # phase 17, by world and rank: the process engine's B5 ring_fold
        # launches, its ring_stage launches (B6's host schedule) and those of
        # them that fold 80-wide tiles (B7's scan fold), over the
        # lists-sharded searches and apart over the other sharded entry
        # points; ring_onecard never runs across processes, and runs once a
        # group a ring on the 2 x 2 mesh
        for name_, key, lane in (("hop_merge", "launches_procs", "hop_merge"),
                                 ("fused_ring_topk", "ring_stage_launches_procs", "ring_stage"),
                                 ("fused_scan_ring_topk", "scan_stage_launches_procs",
                                  "scan_ring_stage")):
            if name == name_:
                for part, suffix in (("launches", ""), ("entry", "_entry")):
                    rows[-1][key + suffix] = {tag: {r: lc[lane] for r, lc in ranks.items()}
                                              for tag, ranks in procs[part].items()}
        if name == "fused_ring_topk":
            rows[-1]["launches_procs_2x2"] = procs["onecard_2d"]
        if name == "fused_ring_topk":  # phase 9's backlog with shard 2 down
            rows[-1]["launches_degraded"] = robust["b6_launches"]
        if name in bench["launches"]:  # phase 18: the bench's harness, CLI and load
            rows[-1]["launches_bench"] = bench["launches"][name]
        if name == "cagra_fused_search":  # phase 14's hnsw searches launch B4 too
            rows[-1].update(per_step_us=t["per_step_us"], chain_floor_ms=t.get("chain_floor_ms"),
                            launches_hnsw=geo["b4_launches"])
    emit(card, phase="run", metric="total_s", value=time.perf_counter() - t_run)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
