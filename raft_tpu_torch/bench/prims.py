"""Primitive microbenchmarks (``raft_tpu.bench.prims`` counterpart): the
``cpp/bench/prims`` analog (``cpp/bench/prims/common/benchmark.hpp``
fixtures for ``matrix/select_k.cu``, ``distance/fused_l2_nn.cu``,
``cluster/kmeans_balanced.cu``, ``neighbors/*``).

Each case times one of the port's primitives at the JAX package's shapes,
as plain calls, on inputs drawn from a ``torch.Generator`` seeded 0 on the
target device. Launches are asynchronous, so a timed run ends in a
synchronise of the device. Rows are gbench-style entries.

Run: ``python -m raft_tpu_torch.bench.prims [--filter distance] [--device cuda]``
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Tuple

import torch

from raft_tpu_torch.core import serialize
from raft_tpu_torch.core.resources import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn: Callable[[], object], inner: int = 8, reps: int = 2, device=None) -> float:
    """Best of ``reps`` mean seconds a call over ``inner`` calls, after one
    warm-up call."""
    device = resolve_device(device)
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def _cases(device=None) -> List[Tuple[str, Callable[[], Tuple[Callable, Dict]]]]:
    """``(name, make)`` for each case; ``make()`` draws the inputs on
    ``device`` (default ``cuda``) and returns ``(fn, meta)``."""

    def gen() -> Tuple[torch.Generator, torch.device]:
        dev = resolve_device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        return g, dev

    def normal(g, dev, *shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32)

    def pairwise_distance():
        from raft_tpu_torch.ops.distance import DistanceType, pairwise_distance

        g, dev = gen()
        m, n, d = 2048, 16384, 128
        x, y = normal(g, dev, m, d), normal(g, dev, n, d)
        return (lambda: pairwise_distance(x, y, DistanceType.L2Expanded)), {
            "items": m * n, "flop": 2 * m * n * d}

    def fused_l2_nn():
        from raft_tpu_torch.ops.fused_1nn import fused_l2_nn as f

        g, dev = gen()
        m, n, d = 65536, 1024, 128
        x, y = normal(g, dev, m, d), normal(g, dev, n, d)
        return (lambda: f(x, y)), {"items": m, "flop": 2 * m * n * d}

    def masked_l2_nn():
        from raft_tpu_torch.ops.masked_nn import masked_l2_nn as f

        g, dev = gen()
        m, n, d, ng = 16384, 16384, 64, 32
        x, y = normal(g, dev, m, d), normal(g, dev, n, d)
        adj = torch.rand((m, ng), generator=g, device=dev) < 0.5
        gi = torch.arange(1, ng + 1, dtype=torch.int32, device=dev) * (n // ng)
        return (lambda: f(x, y, adj, gi)), {"items": m}

    def select_k_exact():
        from raft_tpu_torch.ops.select_k import select_k

        g, dev = gen()
        b, n, k = 512, 65536, 64
        v = normal(g, dev, b, n)
        return (lambda: select_k(v, k)), {"items": b * n}

    def select_k_approx():
        from raft_tpu_torch.ops.select_k import approx_select_k

        g, dev = gen()
        b, n, k = 512, 65536, 64
        v = normal(g, dev, b, n)
        return (lambda: approx_select_k(v, k)), {"items": b * n}

    def kmeans_balanced_fit():
        from raft_tpu_torch.cluster import kmeans_balanced
        from raft_tpu_torch.cluster.kmeans_balanced import BalancedKMeansParams
        from raft_tpu_torch.core.resources import Resources

        g, dev = gen()
        n, d, k = 65536, 64, 256
        x = normal(g, dev, n, d)
        res = Resources(device=dev)
        return (lambda: kmeans_balanced.fit(x, BalancedKMeansParams(n_clusters=k, n_iters=5),
                                            res=res)), {"items": n}

    def rng_normal():
        from raft_tpu_torch.random import rng

        g, dev = gen()
        return (lambda: rng.normal(g, (1 << 24,))), {"items": 1 << 24}

    def gram_rbf():
        from raft_tpu_torch.ops.kernels import rbf_kernel

        g, dev = gen()
        m, n, d = 4096, 4096, 128
        x, y = normal(g, dev, m, d), normal(g, dev, n, d)
        return (lambda: rbf_kernel(x, y, gamma=0.1)), {"items": m * n, "flop": 2 * m * n * d}

    return [
        ("distance/pairwise_l2", pairwise_distance),
        ("distance/fused_l2_nn", fused_l2_nn),
        ("distance/masked_l2_nn", masked_l2_nn),
        ("matrix/select_k_exact", select_k_exact),
        ("matrix/select_k_approx", select_k_approx),
        ("cluster/kmeans_balanced", kmeans_balanced_fit),
        ("random/normal_16M", rng_normal),
        ("distance/gram_rbf", gram_rbf),
    ]


def run(filter_substr: str = "", inner: int = 8, device=None) -> List[Dict]:
    """Time every case whose name holds ``filter_substr`` on ``device``
    (default ``cuda``); one gbench-style row a case."""
    results = []
    for name, make in _cases(device):
        if filter_substr and filter_substr not in name:
            continue
        fn, meta = make()
        dt = _timed(fn, inner=inner, device=device)
        row = {
            "name": name,
            "real_time": dt,
            "time_unit": "s",
            "items_per_second": meta.get("items", 0) / dt,
        }
        if "flop" in meta:
            row["tflops"] = round(meta["flop"] / dt / 1e12, 2)
        results.append(row)
        extra = f"  {row['tflops']} TFLOP/s" if "tflops" in row else ""
        print(f"# {name:28s} {dt*1e3:10.2f} ms  {row['items_per_second']:>16,.0f} items/s{extra}", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("raft_tpu_torch.bench.prims")
    ap.add_argument("--filter", default="", help="substring filter on case names")
    ap.add_argument("--inner", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="where to run (cuda | cpu)")
    args = ap.parse_args(argv)
    results = run(args.filter, args.inner, args.device)
    if args.out:
        payload = json.dumps({"benchmarks": results}, indent=2).encode("utf-8")
        serialize.atomic_write(args.out, lambda f: f.write(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
