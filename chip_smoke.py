"""Chip smoke test of the raft_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--quick] [--profile]

Phases, in order; any failure exits non-zero:

1. device and build: the card's name and power limit, torch/CUDA versions,
   and the build of every kernel of the path from ``raft_tpu_torch/csrc``;
2. kernel vs plain: ``fused_list_topk`` on the card against
   ``fused_list_topk_reference`` on the card, on a mid-size index, for the
   four metrics and int8 lists, at k = 10 and 100;
3. main path at full width: a 1,000,000 x 128 f32 clustered dataset (the
   SIFT-1M shape) and 10,000 queries made with numpy from ``--seed``;
   ``ivf_flat.build(n_lists=1024)``; the index served through
   ``ServingEngine(max_batch=128)`` with requests of 1-128 rows, first one
   request at a time (buckets 1-128: the probe path and the fused scan),
   then as one backlog (full 128-row batches); served recall@10 against
   exact ``brute_force.knn``; fused against probe recall on all 10,000
   queries in one batch; the kernel held against its plain version at the
   main path's shapes and timed beside its bound. The kernel's launch
   count is zeroed before the serving runs and read after them.

``--quick`` runs phases 1-2 only; ``--profile`` adds a torch.profiler
trace of a serving backlog. The last line is ``{"ok": true, "device":
{...}}``, after the ``{"kernels": [...]}`` line and the card's name and
power limit. Other numbers print one JSON object per line with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
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
# Query tile of the served index. A 128-row serving batch holds unrelated
# queries, so with the default 128-row tile its probe union overflows the
# tile's table of fused_probe_factor * n_probes / group units and each query
# loses some of its own lists; 16-row tiles keep the union inside the table
# (phase 3 prints recall and time per batch for tiles of 128, 32 and 16).
SERVE_QT = 16


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


def profile_backlog(card, eng, Q, starts, sizes, k, n_req: int = 64) -> None:
    """Device busy share and kernel time by name over a backlog of
    ``n_req`` requests (torch.profiler); the trace goes to chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [eng.submit("sift1m", Q[s : s + m], k) for s, m in zip(starts[:n_req], sizes[:n_req])]
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for f in futs:
        f.result()
    prof.export_chrome_trace("chiprun_out/serve_backlog_trace.json")
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    emit(card, phase="profile", metric="backlog_device_busy_share", value=busy_us / wall_us,
         wall_ms=wall_us / 1e3, requests=n_req, rows=int(sum(sizes[:n_req])),
         kernels_ms={e.key[:80]: [e.count, e.self_device_time_total / 1e3] for e in top})


def kernel_bound_ms(fi, k: int) -> tuple:
    """Least time for one fused_list_topk call on these inputs: the FP32
    operations these inputs need (each tile's queries against the filled
    slots of its valid units; empty slots need none) over the FP32 peak,
    vs the bytes of every needed input read once (filled rows of the
    probed units, queries, probe tables) and every output written once
    over the HBM rate."""
    n_units, gm, d = fi.list_data.shape
    n_qt, _ = fi.tile_probes.shape
    qt = fi.queries_sorted.shape[0] // n_qt
    valid = fi.probe_valid > 0
    filled = (fi.list_indices >= 0).sum(dim=1).to(torch.float64)  # [n_units]
    flops = 2.0 * qt * d * float(filled[fi.tile_probes[valid].to(torch.int64)].sum())
    used_units = torch.unique(fi.tile_probes[valid]).to(torch.int64)
    item = fi.list_data.element_size()
    bytes_ = (float(filled[used_units].sum()) * (d * item + 8)  # rows + ln + li
              + fi.queries_sorted.numel() * 4 + fi.tile_probes.numel() * 8
              + fi.queries_sorted.shape[0] * k * 8)
    t_ops = flops / H100_FP32_FLOPS * 1e3
    t_bytes = bytes_ / H100_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="phases 1-2 only")
    ap.add_argument("--profile", action="store_true",
                    help="also trace a serving backlog with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.ops import ivf_scan
    from raft_tpu_torch.serve import ServingEngine
    from raft_tpu_torch.stats.recall import neighborhood_recall

    # ---- phase 1: device and build --------------------------------------
    card = card_line()
    print(card, flush=True)
    emit(card, phase="device", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    _, build_s, log = ivf_scan.build_kernel(verbose=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/ivf_scan_ptxas.txt", "w") as f:
        f.write(log)
    emit(card, phase="build", kernel="fused_list_topk", build_s=build_s,
         ptxas=[line for line in log.splitlines() if "registers" in line or "spill" in line])
    res = Resources(device="cuda", seed=args.seed)
    rng = np.random.default_rng(args.seed)

    def fused_inputs(index, queries, params):
        return ivf_scan.fused_search_inputs(
            index.centers, index.center_rank, index.list_data, index.list_indices,
            index.list_norms, queries, None, n_probes=params.n_probes, metric=index.metric,
            qt=params.fused_qt, probe_factor=params.fused_probe_factor,
            group=ivf_flat.fused_group(index, params),
        )

    def run_kernel(fi, k, metric, reference=False, **kw):
        fn = ivf_scan.fused_list_topk_reference if reference else ivf_scan.fused_list_topk
        qt = fi.queries_sorted.shape[0] // fi.tile_probes.shape[0]
        return fn(fi.list_data, fi.list_norms, fi.list_indices, fi.queries_sorted,
                  fi.tile_probes, fi.probe_valid, k=k, metric=metric, qt=qt, **kw)

    # ---- phase 2: kernel vs plain ----------------------------------------
    d = 128
    gen = Clustered(rng, d, 512)
    X_mid = gen.sample(65536)
    Q_mid = torch.from_numpy(gen.sample(512)).cuda()
    max_err = 0.0
    cases = [(m, np.float32) for m in ("sqeuclidean", "euclidean", "inner_product", "cosine")]
    cases.append(("sqeuclidean", np.int8))
    for metric, dtype in cases:
        data = X_mid if dtype == np.float32 else np.clip(np.round(X_mid * 12), -127, 127).astype(np.int8)
        index = ivf_flat.build(data, ivf_flat.IvfFlatIndexParams(n_lists=64, metric=metric), res=res)
        params = ivf_flat.IvfFlatSearchParams(n_probes=8)
        fi = fused_inputs(index, Q_mid, params)
        for k in (10, 100):
            rv, rs = run_kernel(fi, k, index.metric, reference=True)
            for n_split in (1, None):  # one CTA per tile share, and the default split
                ivf_scan.fused_list_topk.launches = 0
                kv, ks = run_kernel(fi, k, index.metric, n_split=n_split)
                torch.cuda.synchronize()
                launches = ivf_scan.fused_list_topk.launches
                err = compare_topk(kv, ks, rv, rs)
                max_err = max(max_err, err)
                emit(card, phase="kernel_vs_plain", metric=metric, dtype=np.dtype(dtype).name, k=k,
                     n_split=n_split or "auto", launches=launches, max_abs_err=err)
    if args.quick:
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 3: main path at full width --------------------------------
    n, nq, k = 1_000_000, 10_000, 10
    gen = Clustered(rng, d, 4096)
    X = gen.sample(n)
    Q = gen.sample(nq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_flat.build(X, ivf_flat.IvfFlatIndexParams(n_lists=1024), res=res)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emit(card, phase="main", metric="build_s", value=build_s, n=n, d=d, n_lists=index.n_lists,
         max_list=index.max_list)
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

    ivf_scan.fused_list_topk.launches = 0
    torch.cuda.synchronize()
    # (a) one client: each request is submitted and served alone, so its
    # bucket is its own size (128 -> fused scan, smaller -> probe path)
    t0 = time.perf_counter()
    one = []
    for s, m in zip(starts, sizes):
        fut = eng.submit("sift1m", Q[s : s + m], k)
        eng.step(force=True)
        one.append(fut.result())
    one_s = time.perf_counter() - t0
    # (b) a backlog: every request queued first, then drained in full
    # 128-row micro-batches
    t0 = time.perf_counter()
    futs = [eng.submit("sift1m", Q[s : s + m], k) for s, m in zip(starts, sizes)]
    eng.run_until_idle()
    backlog = [f.result() for f in futs]
    backlog_s = time.perf_counter() - t0
    serve_launches = ivf_scan.fused_list_topk.launches
    if serve_launches <= 0:
        raise AssertionError("the serving run never launched fused_list_topk")

    for name, results, secs in (("one_client", one, one_s), ("backlog", backlog, backlog_s)):
        ids, lat, buckets = served(results, n)
        recall = neighborhood_recall(torch.from_numpy(ids), gt)
        by_bucket = {str(b): [len(v), float(np.mean(v))] for b, v in sorted(buckets.items())}
        emit(card, phase="main", serving=name, metric="serve_qps", value=nq / secs,
             requests=len(sizes), serve_qt=SERVE_QT)
        emit(card, phase="main", serving=name, metric="request_latency_ms",
             p50=float(np.percentile(lat, 50)), p99=float(np.percentile(lat, 99)),
             requests_and_mean_ms_by_bucket=by_bucket)
        emit(card, phase="main", serving=name, metric="serve_recall@10", value=recall, n_probes=20)
        if recall < 0.90:
            raise AssertionError(f"{name} served recall@10 {recall} < 0.90")
        if name == "one_client" and not ({"128"} < set(by_bucket)):
            raise AssertionError(f"one-client serving did not run both paths: buckets {sorted(by_bucket)}")
    emit(card, phase="main", metric="serve_launches", value=serve_launches)

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
        fi_qt = fused_inputs(index, Qt[:128], p_qt)
        emit(card, phase="main", metric="fused_128_row_batches", fused_qt=qt,
             recall=neighborhood_recall(ids, gt_i[:sub]),
             ms_per_batch=cuda_ms(run, reps=2) / (sub // 128),
             valid_units_per_tile=float((fi_qt.probe_valid > 0).sum()) / fi_qt.tile_probes.shape[0],
             units=int(fi_qt.list_data.shape[0]))

    # the kernel at the serving path's shapes: one 128-row batch
    fi = fused_inputs(index, Qt[:128], serve_params)
    kv, ks = run_kernel(fi, k, index.metric)
    rv, rs = run_kernel(fi, k, index.metric, reference=True)
    max_err = max(max_err, compare_topk(kv, ks, rv, rs))
    kern_ms = cuda_ms(lambda: run_kernel(fi, k, index.metric), reps=20)
    plain_ms = cuda_ms(lambda: run_kernel(fi, k, index.metric, reference=True), reps=3)
    split_ms = {"1": [], "auto": []}
    for n_split in (1, None, None, 1):  # one CTA per query group vs the default split, in turns
        split_ms[str(n_split or "auto")].append(
            cuda_ms(lambda: run_kernel(fi, k, index.metric, n_split=n_split), reps=5))
    bound_ms, bound_by = kernel_bound_ms(fi, k)
    emit(card, phase="main", metric="fused_list_topk_ms_serving_batch", value=kern_ms,
         bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms, n_split_ms=split_ms,
         fused_qt=SERVE_QT, n_qt=int(fi.tile_probes.shape[0]),
         valid_units=int((fi.probe_valid > 0).sum()), unit_rows=int(fi.list_data.shape[1]),
         filled_slot_share=float((fi.list_indices >= 0).to(torch.float32).mean()))
    # and at the 10,000-query batch's shapes (79 sorted 128-query tiles)
    fi_all = fused_inputs(index, Qt, params)
    n_qt = fi_all.tile_probes.shape[0]
    kv, ks = run_kernel(fi_all, k, index.metric)
    rv, rs = run_kernel(fi_all, k, index.metric, reference=True)
    max_err = max(max_err, compare_topk(kv, ks, rv, rs))
    all_bound, all_by = kernel_bound_ms(fi_all, k)
    emit(card, phase="main", metric="fused_list_topk_ms_per_tile_10k_batch",
         value=cuda_ms(lambda: run_kernel(fi_all, k, index.metric), reps=3) / n_qt,
         bound_ms=all_bound / n_qt, bound_by=all_by, n_qt=n_qt,
         valid_units_per_tile=float((fi_all.probe_valid > 0).sum()) / n_qt)

    if args.profile:
        profile_backlog(card, eng, Q, starts, sizes, k)

    print(json.dumps({"kernels": [{
        "name": "fused_list_topk", "route": "cuda", "source": "raft_tpu_torch/csrc/ivf_scan.cu",
        "replaces": "raft_tpu/ops/pallas/ivf_scan.py:321", "launches": serve_launches,
        "max_abs_err": max_err, "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
