"""Clustering: k-means, balanced k-means and single linkage.

Exports the JAX package's ``raft_tpu.cluster.__all__``."""
from raft_tpu_torch.cluster import kmeans, kmeans_balanced
from raft_tpu_torch.cluster.kmeans import KMeansOutput, KMeansParams
from raft_tpu_torch.cluster.kmeans_balanced import BalancedKMeansParams
from raft_tpu_torch.cluster.single_linkage import SingleLinkageOutput, single_linkage

__all__ = [
    "kmeans",
    "kmeans_balanced",
    "KMeansOutput",
    "KMeansParams",
    "BalancedKMeansParams",
    "SingleLinkageOutput",
    "single_linkage",
]
