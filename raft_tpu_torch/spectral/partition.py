"""Spectral graph partitioning and modularity maximization
(``raft_tpu.spectral.partition`` counterpart; reference
``raft/spectral/partition.cuh:52`` and
``raft/spectral/modularity_maximization.cuh``).

As in the reference: a Lanczos eigensolver
(:func:`raft_tpu_torch.sparse.solver.lanczos`) embeds the vertices (the
Laplacian's smallest eigenvectors for a balanced min cut, the largest of
``B = A - d dᵀ / 2m`` for modularity) and k-means clusters the embedding
(``cluster_solvers.cuh``). Everything runs on the graph's device. The
labels depend on k-means' draws, which come from a ``torch.Generator``:
they match the JAX package's up to the draws (the tests hold them by the
adjusted Rand index).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.sparse.linalg import spmv
from raft_tpu_torch.sparse.solver import lanczos
from raft_tpu_torch.sparse.types import COO, as_input, coo_to_csr, segment_sum, take


def _degrees(adj: COO) -> torch.Tensor:
    return segment_sum(adj.vals.to(torch.float32), adj.rows, adj.shape[0])


def fit_embedding(adj: COO, n_components: int, which: str = "smallest") -> torch.Tensor:
    """Spectral embedding [n, k]: eigenvectors of the Laplacian
    (``partition.cuh``'s eigen step). ``which="smallest"`` skips the
    trivial near-zero constant mode; ``"largest"`` returns the top k."""
    n = adj.shape[0]
    expects(adj.shape[0] == adj.shape[1], "adjacency must be square")
    csr = coo_to_csr(adj)
    deg = _degrees(adj)

    def mv(v):
        return deg * v - spmv(csr, v)

    dev = adj.vals.device
    if which == "smallest":
        _, vecs = lanczos(mv, n, n_components + 1, which=which, device=dev)
        return vecs[:, 1 : n_components + 1]
    _, vecs = lanczos(mv, n, n_components, which=which, device=dev)
    return vecs


def partition(adj: COO, n_clusters: int, seed: int = 0) -> Tuple[np.ndarray, torch.Tensor]:
    """Balanced min-cut spectral partition (``partition.cuh:52``): the
    Laplacian's eigenvectors, then k-means. Returns ``(labels, embedding)``."""
    emb = fit_embedding(adj, max(1, n_clusters - 1))
    out = kmeans.fit(emb, kmeans.KMeansParams(n_clusters=n_clusters, seed=seed, max_iter=50))
    return out.labels.cpu().numpy(), emb


def modularity_maximization(adj: COO, n_clusters: int, seed: int = 0) -> np.ndarray:
    """Clusters by maximizing modularity (``modularity_maximization.cuh``):
    the largest eigenvectors of ``B = A - d dᵀ / 2m``, then k-means."""
    n = adj.shape[0]
    csr = coo_to_csr(adj)
    d = _degrees(adj)
    two_m = torch.clamp(torch.sum(d), min=1e-30)

    def mv(v):
        return spmv(csr, v) - d * (torch.dot(d, v) / two_m)

    _, vecs = lanczos(mv, n, n_clusters, which="largest", device=adj.vals.device)
    out = kmeans.fit(vecs, kmeans.KMeansParams(n_clusters=n_clusters, seed=seed, max_iter=50))
    return out.labels.cpu().numpy()


def _labels(adj: COO, labels) -> torch.Tensor:
    return as_input(labels, adj.vals.device).to(torch.int32)


def analyze_partition(adj: COO, labels) -> Tuple[float, float]:
    """``(edge_cut, cost)`` of a partition (``partition.cuh``
    analyzePartition); the cost is the ratio cut, the sum over clusters of
    cut / size."""
    y = _labels(adj, labels)
    yr = take(y, adj.rows)
    cross = yr != take(y, adj.cols)
    cut_vals = torch.where(cross, adj.vals.to(torch.float32), torch.zeros((), device=y.device))
    edge_cut = float(torch.sum(torch.where(cross, adj.vals, torch.zeros_like(adj.vals)))) / 2.0
    n_clusters = int(torch.max(y)) + 1
    sizes = segment_sum(torch.ones_like(y, dtype=torch.float32), y, n_clusters)
    cut_per = segment_sum(cut_vals, yr, n_clusters)
    cost = float(torch.sum(cut_per / torch.clamp(sizes, min=1.0)))
    return edge_cut, cost


def modularity(adj: COO, labels) -> float:
    """Newman modularity Q of a labelling (``modularity_maximization.cuh``
    analyzeModularity)."""
    y = _labels(adj, labels)
    d = _degrees(adj)
    two_m = float(torch.sum(d))
    same = take(y, adj.rows) == take(y, adj.cols)
    a_in = float(torch.sum(torch.where(same, adj.vals, torch.zeros_like(adj.vals))))
    n_clusters = int(torch.max(y)) + 1
    d_per = segment_sum(d, y, n_clusters)
    expected = float(torch.sum(d_per * d_per)) / two_m
    return (a_in - expected) / two_m
