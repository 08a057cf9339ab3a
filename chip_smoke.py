"""Chip smoke test of the raft_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--quick] [--profile]

Phases, in order; any failure exits non-zero:

1. device and build: the card's name and power limit, torch/CUDA versions,
   and the build of every kernel of the port from ``raft_tpu_torch/csrc``
   (one nvcc per source, all started together), with ``-Xptxas -v``;
2. kernel vs plain, each kernel on the card against its plain PyTorch
   version on the card, on mid-size indexes (65,536 x 128): B1
   ``fused_list_topk`` for the four metrics and int8 and bf16 lists at
   k = 10 and 100; B2 ``fused_pq_topk`` for nib8, u8 (ksub 16 and 256),
   p4 and b5 codes under L2 and IP at k = 10 and 80; B3
   ``fused_rabitq_topk`` under L2 and IP at k = 10 and 80; each with one
   CTA per tile share and with the default split; B4 ``cagra_fused_search``
   on CAGRA graphs of degree 16 and 32 built through the ``ivf_pq`` route,
   under L2 and IP, with f32 and bf16 tables, at (itopk, width) of (64, 1),
   (64, 4) and (128, 8); then the build's determinism: the same IVF-Flat
   and IVF-PQ index built twice from one seed must be equal, and one build
   with the float-atomic sums the port used before is timed beside them;
3. IVF-Flat at full width: a 1,000,000 x 128 f32 clustered dataset (the
   SIFT-1M shape) and 10,000 queries made with numpy from ``--seed``;
   ``ivf_flat.build(n_lists=1024)``; served through
   ``ServingEngine(max_batch=128)`` with requests of 1-128 rows, first one
   request at a time (buckets 1-128: the probe path and the fused scan),
   then as one backlog (full 128-row batches); served recall@10 against
   exact ``brute_force.knn``; fused against probe recall on all 10,000
   queries in one batch; B1 held against its plain version at the main
   path's shapes and timed beside its bound;
4. IVF-PQ at full width, on the same data: ``ivf_pq.build(n_lists=1024)``
   with the defaults (nibble codes, pq_dim 64), served with
   ``IvfPqSearchParams(n_probes=30)`` and ``dataset=`` (8x exact refine)
   in both serving modes; fused against probe recall without refine; a
   sweep of the fused tile size over unsorted 128-row batches; B2 at the
   serving shape (k = 80) against its plain version and its bound;
5. RaBitQ: ``ivf_pq.build(n_lists=1024, pq_bits=1)``, ``search`` in auto
   mode with ``dataset=`` on the 10,000 queries; B3 at that path's shape
   against its plain version and its bound;
6. CAGRA at full width: ``cagra.build(intermediate_graph_degree=32,
   graph_degree=16, build_algo="ivf_pq")`` on phase 4's IVF-PQ index (its
   self-search runs B2), search with ``CagraSearchParams(itopk_size=128,
   search_width=8, dedup="post")`` and the bf16 table in fused and xla mode
   on all 10,000 queries, an itopk sweep of 96/128/160, batch-1 and
   batch-10 latency through ``plan_search_params``, served through
   ``ServingEngine`` both ways; B4 at the serving shape against its plain
   version and its bound;
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
   gather; B5-B7 timed at the served (128-row) and 1,024-row shapes.

Phase 2 also holds B5 ``hop_merge`` (rows 32 and 2,560, widths 10, 80 and
256, with ties, signed zeros, padding and ``inf``), B6 ``fused_ring_topk``
(virtual meshes of 2, 3, 4 and 8 shards, 128 and 1,000 queries, one shard
demoted) and B7 ``fused_scan_ring_topk`` (tiles of k, 3k, 8k and 8k + 3
columns) against their plain versions and the gather merge: same ids, same
value bits.

Each kernel's launch count is zeroed just before its path runs (phases
3-7) and read just after. ``--quick`` runs phases 1-2 only; ``--profile``
adds torch.profiler traces of the IVF-Flat, IVF-PQ, CAGRA and sharded
IVF-Flat serving backlogs.
The last line is ``{"ok": true, "device": {...}}``, after the
``{"kernels": [...]}`` line and the card's name and power limit. Other
numbers print one JSON object per line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
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


def profile_backlog(card, eng, index_id, Q, starts, sizes, k, trace: str, n_req: int = 64) -> None:
    """Device busy share and kernel time by name over a backlog of
    ``n_req`` requests (torch.profiler); the trace goes to chiprun_out/."""
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
    prof.export_chrome_trace(f"chiprun_out/{trace}")
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    emit(card, phase="profile", index_id=index_id, metric="backlog_device_busy_share",
         value=busy_us / wall_us, wall_ms=wall_us / 1e3, requests=n_req,
         rows=int(sum(sizes[:n_req])),
         kernels_ms={e.key[:80]: [e.count, e.self_device_time_total / 1e3] for e in top})


def bound_ms(flops: float, bytes_: float) -> tuple:
    """The larger of operations over the FP32 peak and bytes over the HBM
    rate, in ms, and which one it is."""
    t_ops = flops / H100_FP32_FLOPS * 1e3
    t_bytes = bytes_ / H100_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _filled_work(tile_probes, probe_valid, filled):
    """(rows scanned summed over tiles, filled rows of the distinct units)
    for the valid probe steps; ``filled [n_units]`` f64."""
    valid = probe_valid > 0
    per_tile = float(filled[tile_probes[valid].to(torch.int64)].sum())
    distinct = float(filled[torch.unique(tile_probes[valid]).to(torch.int64)].sum())
    return per_tile, distinct


def flat_bound_ms(fi, k: int) -> tuple:
    """Least time for one fused_list_topk call on these inputs: 2·qt·d FP32
    operations per filled slot of each tile's valid units (empty slots
    need none) vs the filled rows of the probed units, queries, probe
    tables and outputs moved once."""
    n_units, gm, d = fi.list_data.shape
    n_qt = fi.tile_probes.shape[0]
    qt = fi.queries_sorted.shape[0] // n_qt
    filled = (fi.list_indices >= 0).sum(dim=1).to(torch.float64)
    rows, distinct = _filled_work(fi.tile_probes, fi.probe_valid, filled)
    item = fi.list_data.element_size()
    return bound_ms(2.0 * qt * d * rows,
                    distinct * (d * item + 8) + fi.queries_sorted.numel() * 4
                    + fi.tile_probes.numel() * 8 + fi.queries_sorted.shape[0] * k * 8)


def pq_bound_ms(a, k: int) -> tuple:
    """Least time for one fused_pq_topk call: one FP32 add per LUT lookup
    (qt x filled rows of each tile's valid units x lookups per row) vs the
    filled code rows of the distinct units plus 8 B a row (ln, id), the
    LUT, the rotated queries, the tables and the outputs moved once."""
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
                    + q_rot.shape[0] * k * 8)


def rabitq_bound_ms(a, k: int) -> tuple:
    """Least time for one fused_rabitq_topk call: qt x filled rows x D FP32
    adds vs the filled code rows of the distinct units plus 12 B a row
    (ln, g, id), the rotated queries, the tables and the outputs."""
    codes, ln, _, q_rot, _, tp, pv = a["args"]
    n_qt = tp.shape[0]
    qt = q_rot.shape[0] // n_qt
    bpr = codes.shape[2]
    filled = torch.isfinite(ln.reshape(codes.shape[0], -1)).sum(dim=1).to(torch.float64)
    rows, distinct = _filled_work(tp, pv, filled)
    return bound_ms(float(qt) * rows * 8 * bpr,
                    distinct * (bpr + 12) + q_rot.numel() * 4 + tp.numel() * 8
                    + q_rot.shape[0] * k * 8)


def flat_args(index, queries, params):
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import ivf_scan

    return ivf_scan.fused_search_inputs(
        index.centers, index.center_rank, index.list_data, index.list_indices,
        index.list_norms, queries, None, n_probes=params.n_probes, metric=index.metric,
        qt=params.fused_qt, probe_factor=params.fused_probe_factor,
        group=ivf_flat.fused_group(index, params),
    )


def run_flat(fi, k, metric, reference=False, **kw):
    from raft_tpu_torch.ops import ivf_scan

    fn = ivf_scan.fused_list_topk_reference if reference else ivf_scan.fused_list_topk
    qt = fi.queries_sorted.shape[0] // fi.tile_probes.shape[0]
    return fn(fi.list_data, fi.list_norms, fi.list_indices, fi.queries_sorted,
              fi.tile_probes, fi.probe_valid, k=k, metric=metric, qt=qt, **kw)


def code_inputs(index, queries, params, metric, codes):
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import pq_scan

    rank, group = ivf_pq.fused_rank_group(index, params)
    return pq_scan.code_scan_inputs(
        index.centers, index.centers_rot, rank, index.rotation, codes, index.list_indices,
        queries, None, n_probes=min(params.n_probes, index.n_lists), metric=metric,
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


def rabitq_args(index, queries, params, metric=None):
    from raft_tpu_torch.ops import rabitq_scan

    metric = metric or index.metric
    ci = code_inputs(index, queries, params, metric, index.codes)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="phases 1-2 only")
    ap.add_argument("--profile", action="store_true",
                    help="also trace the serving backlogs with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    for metric, dtype in [(m, "float32") for m in ("sqeuclidean", "euclidean", "inner_product",
                                                   "cosine")] + [("sqeuclidean", "int8"),
                                                                 ("sqeuclidean", "bfloat16")]:
        if dtype == "int8":
            data = np.clip(np.round(X_mid * 12), -127, 127).astype(np.int8)
        elif dtype == "bfloat16":
            data = torch.from_numpy(X_mid).to(torch.bfloat16)
        else:
            data = X_mid
        index = ivf_flat.build(data, ivf_flat.IvfFlatIndexParams(n_lists=64, metric=metric), res=res)
        fi = flat_args(index, Q_mid, ivf_flat.IvfFlatSearchParams(n_probes=8))
        for k in (10, 100):
            check("fused_list_topk", lambda a, kk, **kw: run_flat(a, kk, index.metric, **kw), fi, k,
                  metric, dtype=dtype)
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
    for metric in ("L2Expanded", "InnerProduct"):
        a = rabitq_args(index, Q_mid, mid_pq, ivf_pq.DistanceType[metric])
        for k in (10, 80):
            check("fused_rabitq_topk", run_rabitq, a, k, metric)
    for deg in (16, 32):
        cg = cagra.build(X_mid, cagra.CagraIndexParams(intermediate_graph_degree=2 * deg,
                                                       graph_degree=deg, build_algo="ivf_pq"), res=res)
        for table_dtype in ("float32", "bfloat16"):
            for ip in (False, True):
                for itopk, width in ((64, 1), (64, 4), (128, 8)):
                    a = b4_args(cg, Q_mid, itopk, width, ip, table_dtype)
                    rv, ri = run_b4(a, reference=True)
                    kv, ki = run_b4(a)
                    torch.cuda.synchronize()
                    err = compare_beam(kv, ki, rv, ri)
                    max_err["cagra_fused_search"] = max(max_err["cagra_fused_search"], err)
                    emit(card, phase="kernel_vs_plain", kernel="cagra_fused_search", graph_degree=deg,
                         metric="InnerProduct" if ip else "L2Expanded", table=table_dtype,
                         itopk=itopk, width=width, iters=a["kw"]["iters"], max_abs_err=err,
                         live_slots=float((ki >= 0).to(torch.float32).mean()))
        del cg
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
    # B6: the ring over virtual meshes, one shard demoted
    for n in (2, 3, 4, 8):
        ring_mesh = make_mesh(["cuda:0"] * n)
        for nq_r in (128, 1000):
            for select_min in (True, False):
                vs, is_ = shard_tiles(ring_rng, n, nq_r, 10, select_min, demote=(n // 2,))
                got = rt.fused_ring_topk(ring_mesh, vs, is_, 10, select_min)
                torch.cuda.synchronize()
                what = f"fused_ring_topk n {n} nq {nq_r} select_min {select_min}"
                err = max(ring_err(what, got, rt.ring_topk_reference(vs, is_, 10, select_min, ring_mesh)),
                          ring_err(what + " vs gather", got,
                                   rt.gather_merge(ring_mesh, vs, is_, 10, select_min)))
                max_err["fused_ring_topk"] = max(max_err["fused_ring_topk"], err)
                emit(card, phase="kernel_vs_plain", kernel="fused_ring_topk", n_shards=n, nq=nq_r,
                     k=10, select_min=select_min, demoted=[n // 2], max_abs_err=err,
                     bytes_per_query=rt.fused_ring_topk.last_bytes["per_query"],
                     wire_model_bytes_per_query=rt.fused_ring_topk.last_bytes["model_per_query"])
    # B7: the scan ring on wide tiles (and the scan fold alone on one shard)
    for n, kc in ((4, 10), (4, 30), (4, 80), (4, 83), (1, 80)):
        ring_mesh = make_mesh(["cuda:0"] * n)
        for select_min in (True, False):
            vs, is_ = shard_tiles(ring_rng, n, 1000, kc, select_min, demote=(1,) if n > 1 else (),
                                  sort=False)
            got = rt.fused_scan_ring_topk(ring_mesh, vs, is_, 10, select_min)
            torch.cuda.synchronize()
            what = f"fused_scan_ring_topk n {n} kc {kc} select_min {select_min}"
            err = max(ring_err(what, got, rt.ring_topk_reference(vs, is_, 10, select_min, ring_mesh,
                                                                  scan_fold=True)),
                      ring_err(what + " vs gather", got,
                               rt.gather_merge(ring_mesh, vs, is_, 10, select_min)))
            max_err["fused_scan_ring_topk"] = max(max_err["fused_scan_ring_topk"], err)
            emit(card, phase="kernel_vs_plain", kernel="fused_scan_ring_topk", n_shards=n, nq=1000,
                 kc=kc, k=10, select_min=select_min, max_abs_err=err)
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

    # the kernel at the serving path's shapes: one 128-row batch
    run_b1 = lambda a, kk, **kw: run_flat(a, kk, index.metric, **kw)
    fi = flat_args(index, Qt[:128], serve_params)
    kv, ks = run_b1(fi, k)
    rv, rs = run_b1(fi, k, reference=True)
    max_err["fused_list_topk"] = max(max_err["fused_list_topk"], compare_topk(kv, ks, rv, rs))
    b1 = time_kernel(run_b1, fi, k, reps=20)
    b1["bound_ms"], b1["bound_by"] = flat_bound_ms(fi, k)
    emit(card, phase="main", metric="fused_list_topk_ms_serving_batch", value=b1["ms"],
         bound_ms=b1["bound_ms"], bound_by=b1["bound_by"], plain_ms=b1["plain_ms"],
         n_split_ms=b1["n_split_ms"], fused_qt=SERVE_QT, n_qt=int(fi.tile_probes.shape[0]),
         valid_units=int((fi.probe_valid > 0).sum()), unit_rows=int(fi.list_data.shape[1]),
         filled_slot_share=float((fi.list_indices >= 0).to(torch.float32).mean()))
    # and at the 10,000-query batch's shapes (79 sorted 128-query tiles)
    fi_all = flat_args(index, Qt, params)
    n_qt = fi_all.tile_probes.shape[0]
    kv, ks = run_b1(fi_all, k)
    rv, rs = run_b1(fi_all, k, reference=True)
    max_err["fused_list_topk"] = max(max_err["fused_list_topk"], compare_topk(kv, ks, rv, rs))
    all_bound, all_by = flat_bound_ms(fi_all, k)
    emit(card, phase="main", metric="fused_list_topk_ms_per_tile_10k_batch",
         value=cuda_ms(lambda: run_b1(fi_all, k), reps=3) / n_qt,
         bound_ms=all_bound / n_qt, bound_by=all_by, n_qt=n_qt,
         valid_units_per_tile=float((fi_all.probe_valid > 0).sum()) / n_qt)
    if args.profile:
        profile_backlog(card, eng, "sift1m", Q, starts, sizes, k, "serve_backlog_trace.json")
    del fi_all

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
    b2 = time_kernel(run_pq, a, kk, reps=20)
    b2["bound_ms"], b2["bound_by"] = pq_bound_ms(a, kk)
    emit(card, phase="ivf_pq", metric="fused_pq_topk_ms_serving_batch", value=b2["ms"],
         bound_ms=b2["bound_ms"], bound_by=b2["bound_by"], plain_ms=b2["plain_ms"],
         n_split_ms=b2["n_split_ms"], k=kk, fused_qt=SERVE_QT_PQ,
         n_qt=int(a["args"][5].shape[0]), valid_units=int((a["args"][6] > 0).sum()),
         unit_rows=int(a["args"][0].shape[1]), code_mode=a["code_mode"],
         queries_per_cta=pq_scan.queries_per_cta(a["args"][2].shape[1], kk, pq_index.n_lists
                                                 // a["args"][0].shape[0]))
    if args.profile:
        profile_backlog(card, eng, "sift1m_pq", Q, starts, sizes, k, "serve_pq_backlog_trace.json")

    # ---- phase 5: RaBitQ ---------------------------------------------------
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
         launches=rq_launches, n_probes=rq_params.n_probes, refine_ratio=rq_params.refine_ratio)
    if rq_launches <= 0:
        raise AssertionError("RaBitQ search(mode='auto') never launched fused_rabitq_topk")
    if rq_recall < 0.90:
        raise AssertionError(f"RaBitQ recall@10 with refine {rq_recall} < 0.90")
    # B3 at that path's shapes: one 1,024-query batch, k * refine_ratio = 80
    a = rabitq_args(rq_index, Qt[:1024], rq_params)
    kv, ks = run_rabitq(a, kk)
    rv, rs = run_rabitq(a, kk, reference=True)
    max_err["fused_rabitq_topk"] = max(max_err["fused_rabitq_topk"], compare_topk(kv, ks, rv, rs))
    b3 = time_kernel(run_rabitq, a, kk, reps=10)
    b3["bound_ms"], b3["bound_by"] = rabitq_bound_ms(a, kk)
    emit(card, phase="rabitq", metric="fused_rabitq_topk_ms_1024_query_batch", value=b3["ms"],
         bound_ms=b3["bound_ms"], bound_by=b3["bound_by"], plain_ms=b3["plain_ms"],
         n_split_ms=b3["n_split_ms"], k=kk, n_qt=int(a["args"][5].shape[0]),
         valid_units=int((a["args"][6] > 0).sum()), unit_rows=int(a["args"][0].shape[1]))

    del rq_index

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
    # B4 at the serving path's shapes: one 128-row batch
    a = b4_args(cg, Qt[:128], 128, 8, False, cp.fused_table_dtype, init_sample=cp.init_sample)
    work = {}
    rv, ri = run_b4(a, reference=True, work=work)
    kv, ki = run_b4(a)
    max_err["cagra_fused_search"] = max(max_err["cagra_fused_search"], compare_beam(kv, ki, rv, ri))
    b4 = dict(ms=cuda_ms(lambda: run_b4(a), reps=20),
              plain_ms=cuda_ms(lambda: run_b4(a, reference=True), reps=1))
    b4["bound_ms"], b4["bound_by"] = b4_bound_ms(a, work)
    full = 128 * a["kw"]["iters"] * 8 * cg.graph_degree
    emit(card, phase="cagra", metric="cagra_fused_search_ms_serving_batch", value=b4["ms"],
         bound_ms=b4["bound_ms"], bound_by=b4["bound_by"], plain_ms=b4["plain_ms"],
         rows_scored=work["rows"], rows_at_most=full,
         formula_bound_ms=bound_ms(3.0 * full * d, full * (d * 2 + 4)), iters=a["kw"]["iters"])

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
        counts = [f.launches for f in ring_kernels]
        profile_backlog(card, eng, "sift1m_sharded", Q, starts, sizes, k,
                        "serve_sharded_backlog_trace.json")
        for f, c in zip(ring_kernels, counts):
            f.launches = c
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
            ring_err(what, got, rt.ring_topk_reference(vs80, is80, k, True, mesh, scan_fold=True)))
        # the comparisons and timings below stay out of the path's launch counts
        counts = [f.launches for f in ring_kernels]
        got = rt.ring_topk(mesh, vs10, is10, k)
        torch.cuda.synchronize()
        max_err["fused_ring_topk"] = max(
            max_err["fused_ring_topk"],
            ring_err(f"ring at {rows_q} queries vs gather", got, rt.gather_merge(mesh, vs10, is10, k, True)),
            ring_err(f"ring at {rows_q} queries", got, rt.ring_topk_reference(vs10, is10, k, True, mesh)))
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
                plain_ms=cuda_ms(lambda: rt.ring_topk_reference(vs10, is10, k, True, mesh), reps=3),
                gather_ms=cuda_ms(lambda: rt.gather_merge(mesh, vs10, is10, k, True), reps=20),
                bound=ring_bound_ms(mesh.size, rows_q, k, k), nq=rows_q, kc=k),
            "fused_scan_ring_topk": dict(
                ms=cuda_ms(lambda: rt.fused_scan_ring_topk(mesh, vs80, is80, k), reps=20),
                plain_ms=cuda_ms(lambda: rt.ring_topk_reference(vs80, is80, k, True, mesh,
                                                                scan_fold=True), reps=3),
                gather_ms=cuda_ms(lambda: rt.gather_merge(mesh, vs80, is80, k, True), reps=20),
                bound=ring_bound_ms(mesh.size, rows_q, kk, k), nq=rows_q, kc=kk),
        }
        for f, c in zip(ring_kernels, counts):
            f.launches = c
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
    emit(card, phase="sharded", metric="launches", value=phase7)
    for name, c in phase7.items():
        if c <= 0:
            raise AssertionError(f"phase 7 never launched {name}")
    emit(card, phase="kernel_vs_plain", metric="max_abs_err", value=max_err)

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
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
