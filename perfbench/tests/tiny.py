"""Tiny sizes of any cell, for runs on the CPU: every width as the
configuration states it, the scale cut."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path
from typing import Tuple

from perfbench import harness

ROWS, QUERIES, LISTS, BLOBS = 20000, 300, 64, 128
SEED = 2**31 + 4242


def overrides(cell: harness.Cell) -> dict:
    c = cell.config
    build = {**c["build"], "n_lists": LISTS}
    if "kmeans_trainset_fraction" in build:
        build["kmeans_trainset_fraction"] = 0.5
    return {"n_rows": ROWS, "n_queries": QUERIES, "build": build,
            "data": {**c["data"], "n_clusters": BLOBS}}


def cell(workload: str, root=harness.ROOT) -> harness.Cell:
    cl = harness.load_cell(workload, root=root)
    cl = harness.load_cell(workload, root=root, overrides=overrides(cl))
    cl.traffic = copy.deepcopy(cl.traffic)
    return cl


def checkout(tmp_path) -> Path:
    """A copy of the benchmark's files, to add files to."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def add_cell(root: Path, config: dict, traffic: str, limits: dict, like: str) -> str:
    """Add ``config`` (a configuration file) and its cell under ``traffic``
    to the checkout ``root``, with ``limits``; the cell reports what the
    cell ``like`` reports. Returns the cell's name."""
    name = config["name"]
    (root / f"perfbench/configs/{name}.json").write_text(json.dumps(config))
    workload = f"{name}.{traffic}"
    (root / f"perfbench/limits/{workload}.json").write_text(json.dumps({"limits": limits}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": name, "source": "https://example.org",
                            "file": f"perfbench/configs/{name}.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": workload, "config": name, "traffic": traffic,
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(workload)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return workload


def pq_cell(tmp_path) -> Tuple[Path, str]:
    """A checkout with an IVF-PQ cell (nibble codes, 8x refine) beside the
    benchmark's own: ``(root, workload)``."""
    root = checkout(tmp_path)
    base = json.loads((root / "perfbench/configs/sift1m-ivf_flat.json").read_text())
    config = {**base, "name": "tiny-ivf_pq", "index": "ivf_pq", "dim": 96,
              "build": {"n_lists": LISTS, "kmeans_trainset_fraction": 0.5},
              "search": {"n_probes": 8, "refine_ratio": 8}}
    limits = {"invalid": 0, "ids_once": 0, "dist_err": 1e-3, "topk_miss": 5e-4,
              "recall_miss": 0.03, "list_miss": 1e-5, "code_miss": 0.01, "kmeans_excess": 0.1}
    return root, add_cell(root, config, "batch10k", limits, like="sift1m-ivf_flat.batch10k")


def run(workload: str, root=harness.ROOT, **kw):
    kw.setdefault("seed", SEED)
    kw.setdefault("seconds", 0.5)
    kw.setdefault("trace", False)
    return harness.run_cell(cell(workload, root), device="cpu", log=lambda line: None, **kw)
