"""Single-linkage agglomerative clustering (``raft_tpu.cluster.single_linkage``
counterpart; reference ``cluster/single_linkage.cuh``,
``cluster/detail/{connectivities,mst,agglomerative}.cuh``).

The reference's pipeline: the kNN graph's connectivities, its minimum
spanning tree (with up to 64 rounds of the cross-component fix-up when the
kNN graph is disconnected), the dendrogram by merging the tree's edges in
weight order, and flat labels from cutting it at ``n_clusters``. The graph
and the tree run on the device (:mod:`raft_tpu_torch.sparse`); the
dendrogram is a sequential union-find over n - 1 edges on the host, in
numpy, as in the JAX package and the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric
from raft_tpu_torch.sparse.neighbors import cross_component_nn, knn_graph
from raft_tpu_torch.sparse.solver import mst
from raft_tpu_torch.sparse.types import COO, as_input, target_device


@dataclasses.dataclass
class SingleLinkageOutput:
    """``linkage_output`` analog (``cluster/single_linkage_types.hpp``)."""

    labels: np.ndarray  # [n] flat cluster labels
    children: np.ndarray  # [n-1, 2] merged node ids (scipy linkage style)
    deltas: np.ndarray  # [n-1] merge distances
    sizes: np.ndarray  # [n-1] merged cluster sizes
    n_clusters: int


class _UnionFind:
    def __init__(self, n):
        self.parent = np.arange(n)

    def find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[rb] = ra
        return True


def _components(n, src, dst):
    uf = _UnionFind(n)
    for a, b in zip(src, dst):
        uf.union(int(a), int(b))
    roots = np.array([uf.find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels, len(np.unique(roots))


def single_linkage(
    X,
    n_clusters: int = 2,
    c: int = 15,
    metric=DistanceType.L2SqrtExpanded,
    res: Optional[Resources] = None,
    device=None,
) -> SingleLinkageOutput:
    """Fit single-linkage clustering (``single_linkage.cuh:60``); ``c`` sets
    the kNN graph's connectivity (k = min(c, n - 1), the reference's ``c``).
    The device work runs where
    :func:`~raft_tpu_torch.sparse.types.target_device` puts ``X``."""
    metric = resolve_metric(metric)
    dev = target_device(X, res, device)
    X = as_input(X, dev)
    n = X.shape[0]
    expects(1 <= n_clusters <= n, "n_clusters out of range")
    k = min(max(c, 2), n - 1)

    g = knn_graph(X, k, metric=metric, res=res)
    out = mst(g)
    src, dst, w = out.src, out.dst, out.weights

    # connect the components until the tree spans (connect_components and
    # the cross_component_nn fix-up, detail/connectivities.cuh)
    for _ in range(64):
        labels, n_comp = _components(n, src, dst)
        if n_comp == 1:
            break
        cs, cd, cw = cross_component_nn(X, labels, n_comp, metric=metric)
        extra = COO(
            torch.from_numpy(np.concatenate([src, cs]).astype(np.int32)).to(dev),
            torch.from_numpy(np.concatenate([dst, cd]).astype(np.int32)).to(dev),
            torch.from_numpy(np.concatenate([w, cw]).astype(np.float32)).to(dev),
            (n, n),
        )
        out = mst(extra)
        src, dst, w = out.src, out.dst, out.weights

    expects(len(w) == n - 1, "failed to build spanning tree")

    # -- dendrogram: merge the edges in weight order (agglomerative.cuh) ------
    order = np.argsort(w, kind="stable")
    src_o, dst_o, w_o = src[order], dst[order], w[order]
    uf = _UnionFind(2 * n - 1)
    cluster_of = np.arange(n)  # the dendrogram node of each root
    sizes_acc = np.ones(2 * n - 1, np.int64)
    children = np.empty((n - 1, 2), np.int64)
    deltas = np.empty(n - 1, np.float64)
    sizes = np.empty(n - 1, np.int64)
    nxt = n
    for i in range(n - 1):
        ra, rb = uf.find(int(src_o[i])), uf.find(int(dst_o[i]))
        ca, cb = cluster_of[ra], cluster_of[rb]
        children[i] = (ca, cb)
        deltas[i] = w_o[i]
        sizes[i] = sizes_acc[ca] + sizes_acc[cb]
        sizes_acc[nxt] = sizes[i]
        uf.union(ra, rb)
        cluster_of[uf.find(ra)] = nxt
        nxt += 1

    # -- flat labels: cut the last (n_clusters - 1) merges ---------------------
    uf2 = _UnionFind(n)
    for i in range(n - 1 - (n_clusters - 1)):
        uf2.union(int(src_o[i]), int(dst_o[i]))
    roots = np.array([uf2.find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)

    return SingleLinkageOutput(
        labels=labels.astype(np.int32),
        children=children,
        deltas=deltas,
        sizes=sizes,
        n_clusters=n_clusters,
    )
