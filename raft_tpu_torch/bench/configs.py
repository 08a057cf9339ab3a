"""Benchmark parameter grids (``raft_tpu.bench.configs`` counterpart): the
``run/conf/algos/*.yaml`` groups
(``python/raft-ann-bench/src/raft_ann_bench/run/conf/algos/raft_ivf_pq.yaml:1-17``,
``raft_cagra.yaml``, ``raft_ivf_flat.yaml``, ``raft_brute_force.yaml``)
as Python dicts equal to the JAX package's, and the per-algorithm
constraint hooks (``raft_ann_bench/constraints/__init__.py``).

The grids are smaller than the reference's full sweeps: ``base`` covers
the reference's competitive region, ``smoke`` is a sanity sweep of
seconds. ``list_dtype`` and the ``fused_*`` knobs of ``raft_ivf_flat`` are
the JAX package's additions; ``graph_build_algo`` keeps the reference's
spelling (``"NN_DESCENT"``), which the harness maps onto the port's.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

# group -> algo -> {"build": grid, "search": grid}
GROUPS: Dict[str, Dict[str, Dict[str, Dict[str, Sequence[Any]]]]] = {
    "base": {
        "raft_brute_force": {
            "build": {},
            "search": {"mode": ["approx"]},
        },
        "raft_ivf_flat": {
            # raft_ivf_flat.yaml: nlist [1024,2048,4096], ratio, niter;
            # list_dtype half + the fused-scan knobs are the JAX package's additions
            "build": {"nlist": [1024, 2048], "ratio": [4], "niter": [20], "list_dtype": ["float", "half"]},
            "search": {
                "nprobe": [5, 10, 20, 50, 100],
                "fused_group": [8],
                "fused_qt": [128],
                "fused_pf": [16, 32],
                "fused_precision": ["default"],
            },
        },
        "raft_ivf_pq": {
            # raft_ivf_pq.yaml:1-17
            "build": {"nlist": [1024], "pq_dim": [64, 32], "pq_bits": [8], "ratio": [10], "niter": [20]},
            "search": {
                "nprobe": [5, 10, 20, 50],
                "smemLutDtype": ["float", "half"],
                "refine_ratio": [1, 2],
            },
        },
        "raft_cagra": {
            # raft_cagra.yaml
            "build": {"graph_degree": [32, 64], "intermediate_graph_degree": [64], "graph_build_algo": ["NN_DESCENT"]},
            "search": {"itopk": [32, 64, 128], "search_width": [1, 2, 4]},
        },
    },
    "smoke": {
        "raft_brute_force": {"build": {}, "search": {"mode": ["approx"]}},
        "raft_ivf_flat": {"build": {"nlist": [64]}, "search": {"nprobe": [5, 10]}},
        "raft_ivf_pq": {"build": {"nlist": [64], "pq_dim": [16]}, "search": {"nprobe": [5, 10]}},
        "raft_cagra": {"build": {"graph_degree": [16], "intermediate_graph_degree": [32]}, "search": {"itopk": [32]}},
    },
}


def constraint(algo: str):
    """Per-algo (build_params, search_params) validity hook
    (``raft_ann_bench/constraints/__init__.py`` analog)."""

    def ivf_pq(bp: Dict[str, Any], sp: Dict[str, Any]) -> bool:
        # raft_ivf_pq_search_constraints: nprobe <= nlist
        return sp.get("nprobe", 1) <= bp.get("nlist", 1024)

    def ivf_flat(bp: Dict[str, Any], sp: Dict[str, Any]) -> bool:
        return sp.get("nprobe", 1) <= bp.get("nlist", 1024)

    def cagra(bp: Dict[str, Any], sp: Dict[str, Any]) -> bool:
        # raft_cagra_search_constraints: itopk >= k handled at run time;
        # search_width*graph_degree bounded to keep candidate sets sane
        return sp.get("itopk", 64) <= 512

    return {"raft_ivf_pq": ivf_pq, "raft_ivf_flat": ivf_flat, "raft_cagra": cagra}.get(algo)
