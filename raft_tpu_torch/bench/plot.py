"""Recall-QPS Pareto-frontier plots (``raft_tpu.bench.plot`` counterpart):
``python/raft-ann-bench/src/raft_ann_bench/plot/__main__.py``.

One throughput plot a dataset: x = recall@k, y = QPS (log scale), one line
an algorithm along its Pareto frontier, markers for the dominated points,
the figure the reference publishes
(``docs/source/raft_ann_benchmarks.md:255``). matplotlib is imported only
when a plot is drawn.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple, Union


def _frontier(points: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Upper-right Pareto frontier of (recall, qps) points."""
    pts = sorted(points, key=lambda p: (-p[0], -p[1]))
    out = []
    best_qps = -1.0
    for r, q in pts:
        if q > best_qps:
            out.append((r, q))
            best_qps = q
    return out[::-1]  # ascending recall


def plot_report(report: Union[Dict, str], out_path: str, title: str = "") -> str:
    """Render the recall-QPS plot for a gbench-style report. Returns
    ``out_path`` (PNG)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(report, str):
        with open(report) as f:
            report = json.load(f)

    by_algo: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    k = None
    dataset = ""
    for b in report.get("benchmarks", []):
        r, q = b.get("Recall"), b.get("items_per_second")
        if r is None or q is None:
            continue
        by_algo[b.get("algo", "?")].append((float(r), float(q)))
        k = b.get("k", k)
        dataset = b.get("dataset", dataset)

    fig, ax = plt.subplots(figsize=(8, 5.5))
    for algo, pts in sorted(by_algo.items()):
        fr = _frontier(pts)
        ax.plot(*zip(*fr), marker="o", label=algo)
        dominated = [p for p in pts if p not in fr]
        if dominated:
            ax.scatter(*zip(*dominated), s=12, alpha=0.35)
    ax.set_xlabel(f"recall@{k if k is not None else 'k'}")
    ax.set_ylabel("QPS")
    ax.set_yscale("log")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    ax.set_title(title or f"{dataset}: recall vs throughput")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_results(results: Sequence, out_path: str, title: str = "") -> str:
    """Convenience: plot a list of :class:`BenchResult` directly."""
    from raft_tpu_torch.bench.harness import to_report

    return plot_report(to_report(results), out_path, title)


def main(argv: Iterable[str] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser("raft_tpu_torch.bench.plot")
    ap.add_argument("report", help="gbench-style JSON report file")
    ap.add_argument("--out", default=None, help="PNG path (default: report stem + .png)")
    ap.add_argument("--title", default="")
    args = ap.parse_args(argv)
    out = args.out or os.path.splitext(args.report)[0] + ".png"
    print(plot_report(args.report, out, args.title))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
