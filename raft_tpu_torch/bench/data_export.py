"""JSON -> CSV export of benchmark results (``raft_tpu.bench.data_export``
counterpart): ``python/raft-ann-bench/src/raft_ann_bench/data_export/__main__.py``.

The reference walks gbench JSON result files and writes one CSV per
(dataset, algorithm) with the throughput, latency and recall columns the
plot tool reads; this does the same for
:func:`raft_tpu_torch.bench.harness.to_report` documents, with the JAX
package's columns.
"""
from __future__ import annotations

import csv
import io
import json
import os
from typing import Dict, Iterable, List, Sequence, Union

from raft_tpu_torch.core import serialize

# the reference's throughput-mode column set (data_export/__main__.py
# write_frame_* column sets)
_COLUMNS = [
    "name",
    "algo",
    "dataset",
    "k",
    "n_queries",
    "recall",
    "qps",
    "latency",
    "end_to_end",
    "build_time",
    "build_params",
    "search_params",
]


def _rows_of(report: Dict) -> List[Dict]:
    rows = []
    for b in report.get("benchmarks", []):
        rows.append(
            {
                "name": b.get("name", ""),
                "algo": b.get("algo", ""),
                "dataset": b.get("dataset", ""),
                "k": b.get("k", ""),
                "n_queries": b.get("n_queries", ""),
                "recall": b.get("Recall", ""),
                "qps": b.get("items_per_second", ""),
                "latency": b.get("Latency", ""),
                "end_to_end": b.get("end_to_end", ""),
                "build_time": b.get("build_time", ""),
                "build_params": json.dumps(b.get("build_params", {}), sort_keys=True),
                "search_params": json.dumps(b.get("search_params", {}), sort_keys=True),
            }
        )
    return rows


def export_csv(report: Union[Dict, str], out_path: str) -> str:
    """Write one CSV for a gbench-style report (dict or path to JSON).
    Returns ``out_path``."""
    if isinstance(report, str):
        with open(report) as f:
            report = json.load(f)
    rows = _rows_of(report)
    buf = io.StringIO(newline="")
    w = csv.DictWriter(buf, fieldnames=_COLUMNS)
    w.writeheader()
    for r in rows:
        w.writerow(r)
    payload = buf.getvalue().encode("utf-8")
    return serialize.atomic_write(out_path, lambda f: f.write(payload))


def export_results_csv(results: Sequence, out_path: str) -> str:
    """Convenience: export a list of :class:`BenchResult` directly."""
    from raft_tpu_torch.bench.harness import to_report

    return export_csv(to_report(results), out_path)


def main(argv: Iterable[str] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser("raft_tpu_torch.bench.data_export")
    ap.add_argument("report", help="gbench-style JSON report file")
    ap.add_argument("--out", default=None, help="CSV path (default: report stem + .csv)")
    args = ap.parse_args(argv)
    out = args.out or os.path.splitext(args.report)[0] + ".csv"
    print(export_csv(args.report, out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
