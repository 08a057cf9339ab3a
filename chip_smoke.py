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
   CTA per tile share and with the default split;
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
   against its plain version and its bound.

Each kernel's launch count is zeroed just before its path runs (phases
3-5) and read just after. ``--quick`` runs phases 1-2 only; ``--profile``
adds torch.profiler traces of the IVF-Flat and IVF-PQ serving backlogs.
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


def serve_both_ways(card, eng, index_id, Q, sizes, starts, k, n, gt, kernel, phase, **extra):
    """Serve every request as one client, then as one backlog; gate recall
    and the one-client buckets. ``kernel.launches`` is zeroed just before
    each serving run and read just after it. Returns the launches of both
    runs."""
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
        if recall < 0.90:
            raise AssertionError(f"{phase} {name} served recall@10 {recall} < 0.90")
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
    from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
    from raft_tpu_torch.ops import ivf_scan, pq_scan, rabitq_scan
    from raft_tpu_torch.serve import ServingEngine
    from raft_tpu_torch.stats.recall import neighborhood_recall

    # ---- phase 1: device and build --------------------------------------
    card = card_line()
    print(card, flush=True)
    emit(card, phase="device", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    kernels = {"fused_list_topk": ivf_scan, "fused_pq_topk": pq_scan,
               "fused_rabitq_topk": rabitq_scan}
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
    max_err = {name: 0.0 for name in kernels}

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
    emit(card, phase="kernel_vs_plain", metric="max_abs_err", value=max_err)
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

    rows = []
    for name, src, line, launches, t in (
            ("fused_list_topk", "ivf_scan.cu", "raft_tpu/ops/pallas/ivf_scan.py:321", flat_launches, b1),
            ("fused_pq_topk", "pq_scan.cu", "raft_tpu/ops/pallas/pq_scan.py:340", pq_launches, b2),
            ("fused_rabitq_topk", "rabitq_scan.cu", "raft_tpu/ops/pallas/rabitq_scan.py:260",
             rq_launches, b3)):
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
