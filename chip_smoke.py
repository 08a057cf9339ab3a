"""Chip smoke test of the raft_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--quick] [--profile]
    python3 chip_smoke.py --phases paths,serve,ring,b1,b3,rabitq,b4,mutable [--tree DIR] [--seed 0]

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
   on all 10,000 queries, an itopk sweep of 96/128/160, batch-1 and
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
   gather; B5-B7 timed at the served (128-row) and 1,024-row shapes, B6
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
``cuda_ms``) at 128 and 1,024 queries over four shards, and reads the
kernel's stage clock (``fused_ring_topk_split``).

Each kernel's launch count is zeroed just before its path runs (phases
3-8) and read just after. ``--quick`` runs phases 1-2 only; ``--profile``
adds torch.profiler traces of the IVF-Flat, IVF-PQ, CAGRA and sharded
IVF-Flat serving backlogs. ``--phases`` runs only the parts it names
(:func:`run_phases`): ``paths`` times the IVF-Flat search paths per call
(:func:`paths_ms`), ``serve`` phase 3's IVF-Flat serving QPS
(:func:`serve_qps`), ``ring`` phase 2's ring checks and lines, ``b3``
phase 2's B3 checks, ``rabitq`` phase 5, ``b1`` and ``b4`` phase 2's B1
or B4 checks and then that kernel at the main path's shapes on the 1M
index, ``mutable`` phase 8; with ``--tree`` they import
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
    its bound (``fused_rabitq_topk_sliced_ms``). The other indexes and the
    filters draw from their own seeds, so the later phases see the data
    and indexes they saw before. ``this_tree``: False for an older tree's
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
    indexes = {128: (index, Q_mid)}
    for dim, rows in ((136, 65536), (1544, 65536), (3072, 16384)):
        gen = Clustered(np.random.default_rng([seed, 8, dim]), dim, 512)
        indexes[dim] = (ivf_pq.build(gen.sample(rows), ivf_pq.IvfPqIndexParams(n_lists=64, pq_bits=1),
                                     res=Resources(device="cuda", seed=seed)),
                        torch.from_numpy(gen.sample(512)).cuda())
    bits = {}
    for dim, (idx, _) in indexes.items():
        keep = np.packbits(rng.random(-(-idx.size // 32) * 32) < 0.7, bitorder="little")
        bits[dim] = torch.from_numpy(keep.view(np.int32).copy()).cuda()
    for dim, qt, filtered, metric, k in shapes:
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
    read just after. Returns ``(launches, B3's times)``."""
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
    return rq_launches, b3


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
    sizes = []
    while sum(sizes) < nq:
        sizes.append(int(min(rng.integers(1, 129), nq - sum(sizes))))
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


def ring_checks(card: str, rng, max_err: dict) -> None:
    """B6 (tiles of at most k = 10 columns) and B7 (wider tiles) over
    virtual meshes of 2, 3, 4 and 8 shards of the card, 1, 37, 128 and 1,024
    queries, tiles of 6, 10, 23, 80 and 83 columns, one shard demoted,
    min- and max-select in turns: each bit-equal to the gather merge, to
    the kernel's plain mirror and to the host schedule (the engine of
    shards on distinct cards) on the same mesh. Then, over four shards at
    128 and 1,024 queries, each engine's ``ring_host_device`` line and the
    kernel's stage split (``fused_ring_topk_split``)."""
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
    mesh = make_mesh(["cuda:0"] * 4)
    for nq in (128, 1024):
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
        sizes = []
        while sum(sizes) < nq:
            sizes.append(int(min(rng.integers(1, 129), nq - sum(sizes))))
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


#: the parts ``--phases`` runs alone
PHASE_PARTS = ("paths", "serve", "ring", "b1", "b3", "rabitq", "b4", "mutable")


def run_phases(card: str, parts, seed: int, tree: str, this_tree: bool) -> None:
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
    the main path's shapes (:func:`b4_main`); ``mutable`` last: phase 8
    (:func:`mutable_phase`) on phase 3's data. Each builds the kernels it
    launches first. ``tree`` is the tree whose
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
        ring_checks(card, np.random.default_rng([seed, 7]), max_err)
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
    here = os.path.dirname(os.path.abspath(__file__))
    tree = os.path.abspath(args.tree or here)
    sys.path.insert(0, tree)
    if parts:
        run_phases(card_line(), parts, args.seed, tree, this_tree=tree == here)
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
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as ex:
        builds = {name: ex.submit(mod.build_kernel, True) for name, mod in kernels.items()}
        built = {name: f.result() for name, f in builds.items()}
    emit(card, phase="build", metric="parallel_build_s", value=time.perf_counter() - t0)
    for name, (_, build_s, log) in built.items():
        with open(f"chiprun_out/{name}_ptxas.txt", "w") as f:
            f.write(log)
        emit(card, phase="build", kernel=name, build_s=build_s,
             ptxas=[line for line in log.splitlines() if "registers" in line or "spill" in line])
    res = Resources(device="cuda", seed=args.seed)
    rng = np.random.default_rng(args.seed)
    # the ring checks draw from their own stream, so phases 3-6 see the data
    # and requests they saw before the ring was added
    ring_rng = np.random.default_rng([args.seed, 7])
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
    d = 128
    gen = Clustered(rng, d, 512)
    X_mid = gen.sample(65536)
    Q_mid = torch.from_numpy(gen.sample(512)).cuda()
    flat_checks(card, args.seed, res, X_mid, Q_mid, max_err)
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
    index = ivf_pq.build(X_mid, ivf_pq.IvfPqIndexParams(n_lists=64, pq_bits=1), res=res)
    rabitq_checks(card, args.seed, index, Q_mid, max_err)
    cagra_checks(card, args.seed, res, X_mid, Q_mid, max_err)
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
    # B6 and B7: the ring over virtual meshes, one shard demoted
    ring_checks(card, ring_rng, max_err)
    emit(card, phase="kernel_vs_plain", metric="max_abs_err", value=max_err)

    # the build's determinism, on the mid-size set
    check_deterministic(card, "determinism", "ivf_flat_65536",
                        lambda: ivf_flat.build(X_mid, ivf_flat.IvfFlatIndexParams(n_lists=256), res=res),
                        ("centers", "list_sizes", "list_indices", "list_data", "list_norms"))
    check_deterministic(card, "determinism", "ivf_pq_65536",
                        lambda: ivf_pq.build(X_mid, ivf_pq.IvfPqIndexParams(n_lists=256), res=res),
                        ("centers", "pq_centers", "list_sizes", "list_indices", "codes", "rot_sqnorms"))
    if args.quick:
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 3: IVF-Flat at full width ----------------------------------
    n, nq, k = 1_000_000, 10_000, 10
    gen = Clustered(rng, d, 4096)
    X = gen.sample(n)
    Q = gen.sample(nq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024), res=res)
    torch.cuda.synchronize()
    emit(card, phase="main", metric="build_s", value=time.perf_counter() - t0, n=n, d=d,
         n_lists=index.n_lists, max_list=index.max_list)
    _, gt_i = brute_force.knn(X, Q, k, metric="sqeuclidean", res=res)
    gt = gt_i.cpu()
    params = ivf_flat.IvfFlatSearchParams(n_probes=20)
    serve_params = dataclasses.replace(params, fused_qt=SERVE_QT)

    eng = ServingEngine(max_batch=128, max_wait_ms=2.0, queue_capacity=nq, res=res)
    eng.register("sift1m", "ivf_flat", index, params=serve_params)
    eng.warmup("sift1m", k)
    sizes = []
    while sum(sizes) < nq:
        sizes.append(int(min(rng.integers(1, 129), nq - sum(sizes))))
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

    # ---- phase 4: IVF-PQ at full width ------------------------------------
    X_card = torch.from_numpy(X).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pq_index = ivf_pq.build(X, ivf_pq.IvfPqIndexParams(n_lists=1024), res=res)
    torch.cuda.synchronize()
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

    # ---- phase 5: RaBitQ ---------------------------------------------------
    rq_launches, b3 = rabitq_phase(card, res, X, X_card, Qt, gt_i, k, kk, max_err)

    # ---- phase 6: CAGRA at full width --------------------------------------
    cagra_search.cagra_fused_search.launches = 0
    pq_scan.fused_pq_topk.launches = 0
    cg, build_s = timed_build(lambda: cagra.build(
        X_card, cagra.CagraIndexParams(intermediate_graph_degree=32, graph_degree=16,
                                       build_algo="ivf_pq"), res=res, pq_index=pq_index))
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
    for init_sample in (4096, 8192, 16384, 32768):
        sp = dataclasses.replace(cp, init_sample=init_sample)
        run = lambda: cagra.search(cg, Qt, k, sp, mode="fused")
        _, ids = run()
        emit(card, phase="cagra", metric="init_sample_sweep", init_sample=init_sample, mode="fused",
             recall=neighborhood_recall(ids, gt_i), qps=nq / (cuda_ms(run, reps=2) / 1e3))
    for itopk in (96, 128, 160):
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

    # ---- phase 7: sharded search over four virtual shards ------------------
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
                                           metric=index.metric, chunk_lists=g_local)
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

    # ---- phase 8: the mutable index, served across a background flip -------
    mutable = mutable_phase(card, res, X, Q, gt_i, gen, k, args.seed, immutable=index)

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
                            launches_mutable_delta=mutable["serve"]["b1_launches_delta"])
        if name == "hop_merge":  # on one card B5's folds run inside B6's and B7's launches
            rows[-1]["folds_inside_rings"] = folds
        if name == "cagra_fused_search":
            rows[-1].update(per_step_us=t["per_step_us"], chain_floor_ms=t.get("chain_floor_ms"))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
