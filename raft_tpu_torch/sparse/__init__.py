"""Sparse layer: COO/CSR containers and conversions, sparse linalg (spmv,
spmm, sddmm, transpose, degree, norm, symmetrize, add), sparse pairwise
distances and kNN, the kNN graph, and the MST and Lanczos solvers.

Exports the JAX package's ``raft_tpu.sparse.__all__``."""
from raft_tpu_torch.sparse import linalg
from raft_tpu_torch.sparse.distance import (
    knn_sparse,
    pairwise_distance_sparse,
    pairwise_distance_sparse_native,
    sparse_gram,
)
from raft_tpu_torch.sparse.neighbors import cross_component_nn, knn_graph
from raft_tpu_torch.sparse.solver import MSTResult, lanczos, mst
from raft_tpu_torch.sparse.types import COO, CSR, coo_from_dense, coo_to_csr, csr_from_dense

__all__ = [
    "COO",
    "CSR",
    "MSTResult",
    "coo_from_dense",
    "coo_to_csr",
    "cross_component_nn",
    "csr_from_dense",
    "knn_graph",
    "knn_sparse",
    "lanczos",
    "linalg",
    "mst",
    "pairwise_distance_sparse",
    "pairwise_distance_sparse_native",
    "sparse_gram",
]
