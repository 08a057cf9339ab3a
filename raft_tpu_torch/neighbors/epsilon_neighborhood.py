"""Epsilon neighbourhood (``raft_tpu.neighbors.epsilon_neighborhood``
counterpart; reference ``neighbors/epsilon_neighborhood.cuh``
``epsUnexpL2SqNeighborhood``).

One tiled distance pass giving a boolean adjacency and the vertex degrees.
The adjacency is allocated once and filled a row block at a time, so a
block's distances are the only ``[block, n]`` float temporary.
"""
from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.ops.distance import DistanceType, pairwise_distance, resolve_metric


def eps_neighbors(x, y, eps: float, metric=DistanceType.L2Expanded,
                  block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """``adj[i, j] = dist(x_i, y_j) < eps`` (bool ``[m, n]``) and the
    degrees ``vd`` (int32 ``[m]``), on ``y``'s device. Any dense metric,
    with ``eps`` in its units (the reference fixes squared L2)."""
    metric = resolve_metric(metric)
    y = torch.as_tensor(y)
    x = ser.as_tensor(x, y.device)
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1], "bad shapes")
    expects(block > 0, "block must be positive")
    adj = torch.empty((x.shape[0], y.shape[0]), dtype=torch.bool, device=y.device)
    for s in range(0, x.shape[0], block):
        adj[s : s + block] = pairwise_distance(x[s : s + block], y, metric) < eps
    return adj, torch.sum(adj, dim=1, dtype=torch.int32)
