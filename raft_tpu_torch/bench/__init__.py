"""ANN benchmark harness, layer L8 (``raft_tpu.bench`` counterpart): the
Python form of ``cpp/bench/ann`` and ``python/raft-ann-bench``.

* :mod:`raft_tpu_torch.bench.datasets`: the dataset registry and the
  ground-truth cache
* :mod:`raft_tpu_torch.bench.harness`: timed build and search, recall in
  the harness, gbench-schema results, sweeps, Pareto front, operating point
* :mod:`raft_tpu_torch.bench.configs`: the algorithms' grids and constraints
* :mod:`raft_tpu_torch.bench.loadgen`: open- and closed-loop load on
  :class:`raft_tpu_torch.serve.ServingEngine`
* :mod:`raft_tpu_torch.bench.prims`: primitive microbenchmarks
* :mod:`raft_tpu_torch.bench.data_export`, :mod:`raft_tpu_torch.bench.plot`:
  CSV export and the recall-QPS plot (matplotlib, imported when plotting)
* ``python -m raft_tpu_torch.bench``: the CLI
"""
from raft_tpu_torch.bench.datasets import Dataset, get_dataset, make_clustered, make_uniform, read_fbin, write_fbin
from raft_tpu_torch.bench.loadgen import (
    LoadReport,
    poisson_arrivals,
    run_closed_loop,
    run_open_loop,
)
from raft_tpu_torch.bench.harness import (
    ALGOS,
    BenchResult,
    operating_point,
    pareto_frontier,
    recall_at_k,
    run_case,
    save_report,
    sweep,
    to_report,
)

__all__ = [
    "ALGOS",
    "BenchResult",
    "Dataset",
    "LoadReport",
    "get_dataset",
    "make_clustered",
    "make_uniform",
    "operating_point",
    "pareto_frontier",
    "poisson_arrivals",
    "read_fbin",
    "recall_at_k",
    "run_case",
    "run_closed_loop",
    "run_open_loop",
    "save_report",
    "sweep",
    "to_report",
    "write_fbin",
]
