"""Row-sharded exact kNN (``raft_tpu.parallel.sharded_knn`` counterpart).

The dataset's rows are split into equal blocks, one per coordinate along
the mesh's ``axis`` (replicated over its other axes, as JAX's ``P(axis,
None)``); queries are replicated. Each shard runs the port's tiled
brute-force search on its block, shifts its ids to global rows, and the
per-shard ``[nq, k]`` candidates merge along ``axis`` through the ring
top-k or the gather merge (the ``knn_merge_parts`` pattern across shards).
On a process mesh every process passes the whole dataset, as the JAX
package's processes do, and keeps its local shards' blocks.
"""
from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.neighbors.brute_force import NORM_METRICS, BruteForceIndex, _search_batch
from raft_tpu_torch.ops.distance import DistanceType, is_min_close, resolve_metric, row_norms
from raft_tpu_torch.parallel import comms


def sharded_knn(mesh: comms.Mesh, dataset, queries, k: int,
                metric=DistanceType.L2SqrtExpanded, metric_arg: float = 2.0,
                axis: str = comms.DEFAULT_AXIS, dataset_tile: int = 2048,
                merge_mode: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with ``dataset [n, d]`` row-sharded along ``axis`` of
    ``mesh`` (``n`` divisible by that axis's size) and ``queries``
    replicated. Returns ``(distances [nq, k], indices [nq, k])`` on the
    first local shard's device, the same under every ``merge_mode``
    (``"ring"``, ``"fused_ring"``, ``"gather"``, ``"auto"`` = ring when
    sharded)."""
    from raft_tpu_torch.parallel.sharded_ann import _exchange_merge, _resolve_merge_mode

    metric = resolve_metric(metric)
    n_shards = comms.comm_size(mesh, axis)
    dataset = ser.as_tensor(dataset, mesh.devices[0])
    queries = ser.as_tensor(queries, mesh.devices[0])
    expects(dataset.ndim == 2 and queries.ndim == 2 and queries.shape[1] == dataset.shape[1],
            "sharded_knn: dataset [n, d] and queries [nq, d] expected")
    n = dataset.shape[0]
    expects(n % n_shards == 0, "dataset rows %d not divisible by %d shards", n, n_shards)
    per = n // n_shards
    expects(0 < k <= per, "k=%d larger than per-shard rows %d", k, per)
    select_min = is_min_close(metric)
    mode = _resolve_merge_mode(merge_mode, n_shards, k)
    blocks = comms.row_sharded(mesh, dataset, axis)
    qs = comms.replicated(mesh, queries)
    mesh.fork()
    vs, is_ = [], []
    for j, r in enumerate(mesh.local_ranks):
        with mesh.on(j):
            a = mesh.coord(r, axis)
            local = BruteForceIndex(dataset=blocks[j],
                                    norms=row_norms(blocks[j]) if metric in NORM_METRICS else None,
                                    metric=metric, metric_arg=float(metric_arg))
            v, i = _search_batch(local, qs[j], None, k=k, tile=min(dataset_tile, per))
            vs.append(v)
            is_.append(torch.where(i >= 0, i + a * per, i))
    vals, ids = _exchange_merge(mesh, vs, is_, k, select_min, mode, axis)
    return vals[0], ids[0]
