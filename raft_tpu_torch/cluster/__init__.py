"""Clustering: k-means and balanced k-means.

Exports the JAX package's ``raft_tpu.cluster.__all__`` except
``single_linkage`` and ``SingleLinkageOutput`` (ROADMAP queue A7d)."""
from raft_tpu_torch.cluster import kmeans, kmeans_balanced
from raft_tpu_torch.cluster.kmeans import KMeansOutput, KMeansParams
from raft_tpu_torch.cluster.kmeans_balanced import BalancedKMeansParams

__all__ = [
    "kmeans",
    "kmeans_balanced",
    "KMeansOutput",
    "KMeansParams",
    "BalancedKMeansParams",
]
