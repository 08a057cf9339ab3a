"""Sparse-neighbours utilities (``raft_tpu.sparse.neighbors`` counterpart;
reference ``raft/sparse/neighbors/knn_graph.cuh`` and
``cross_component_nn.cuh``): the kNN graph of a dense dataset as a
symmetric COO, and the nearest pair between connected components (the
single-linkage connectivity fix-up).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric
from raft_tpu_torch.sparse.types import COO, as_input, segment_min, target_device


def knn_graph(X, k: int, metric=DistanceType.L2SqrtExpanded, res: Optional[Resources] = None,
              device=None) -> COO:
    """Symmetrized kNN graph as COO edges (``sparse/neighbors/
    knn_graph.cuh``): each row connects to its k nearest, itself excluded;
    both directions of each edge are emitted (static nnz ``2 * n * k``).
    Runs where :func:`~raft_tpu_torch.sparse.types.target_device` puts
    ``X``."""
    from raft_tpu_torch.neighbors import brute_force

    metric = resolve_metric(metric)
    X = as_input(X, target_device(X, res, device))
    n = X.shape[0]
    expects(0 < k < n, "k out of range")
    index = brute_force.build(X, metric=metric, res=ensure_resources(res, X.device))
    dists, nbrs = brute_force.search(index, X, k + 1, res=res)
    # drop the self column (rank 0 at distance 0 for the L2 family): a
    # stable sort moves it last
    ar = torch.arange(n, dtype=torch.int32, device=X.device)
    rows = torch.repeat_interleave(ar, k)
    self_mask = (nbrs == ar[:, None]).to(torch.int32)
    order = torch.argsort(self_mask, dim=1, stable=True)
    nbrs_k = torch.gather(nbrs, 1, order)[:, :k].reshape(-1)
    dists_k = torch.gather(dists, 1, order)[:, :k].reshape(-1)
    return COO(torch.cat([rows, nbrs_k]), torch.cat([nbrs_k, rows]),
               torch.cat([dists_k, dists_k]).to(torch.float32), (n, n))


def cross_component_nn(
    X, labels, n_components: int, metric=DistanceType.L2SqrtExpanded,
    res: Optional[Resources] = None, device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The nearest point pair between each component and any other
    (``sparse/neighbors/cross_component_nn.cuh``): ``(src, dst, dist)``
    numpy arrays, one entry per component that has a foreign point. The
    distances use ``metric``, so the connecting edges are commensurate with
    the kNN graph's weights."""
    from raft_tpu_torch.ops.distance import pairwise_distance

    dev = target_device(X, res, device)
    X = as_input(X, dev).to(torch.float32)
    y = as_input(labels, dev).to(torch.int32)
    n = X.shape[0]
    metric = resolve_metric(metric)
    # blocked scan: peak memory O(block * n)
    block = max(256, min(n, (1 << 24) // max(n, 1)))
    inf = torch.tensor(float("inf"), device=dev)
    bj_parts, bd_parts = [], []
    for s in range(0, n, block):
        d = pairwise_distance(X[s : s + block], X, metric)
        d = torch.where(y[s : s + block, None] == y[None, :], inf, d)
        bj = torch.argmin(d, dim=1)  # the first index on ties
        bj_parts.append(bj)
        bd_parts.append(torch.gather(d, 1, bj[:, None])[:, 0])
    best_j = torch.cat(bj_parts)
    best_d = torch.cat(bd_parts)
    # per component: the row with the smallest foreign distance, the lowest
    # index among equals (a component of one label everywhere keeps n)
    comp_best = segment_min(best_d, y, n_components)
    is_best = best_d == comp_best[torch.clamp(y.to(torch.int64), 0, n_components - 1)]
    row_ids = torch.where(is_best, torch.arange(n, device=dev), torch.full_like(best_j, n))
    rep = segment_min(row_ids, y, n_components).cpu().numpy()
    src = rep[rep < n]
    dst = best_j.cpu().numpy()[src]
    dist = best_d.cpu().numpy()[src]
    return src.astype(np.int32), dst.astype(np.int32), dist.astype(np.float32)
