"""Primitive ops: pairwise distance, top-k selection, fused and masked
1-NN, kernel gram matrices; the hand kernels' wrappers (``ivf_scan``,
``pq_scan``, ``rabitq_scan``, ``cagra_search``, ``ring_topk``) are
imported by module.

Exports the JAX package's ``raft_tpu.ops.__all__``. As there, the name
``select_k`` is the function: reach the module with
``importlib.import_module("raft_tpu_torch.ops.select_k")``."""
from raft_tpu_torch.ops.distance import (
    DistanceType,
    is_min_close,
    pairwise_distance,
    resolve_metric,
    row_norms,
)
from raft_tpu_torch.ops.fused_1nn import fused_l2_nn, min_cluster_and_distance
from raft_tpu_torch.ops.kernels import (
    KernelParams,
    KernelType,
    gram_matrix,
    linear_kernel,
    polynomial_kernel,
    rbf_kernel,
    tanh_kernel,
)
from raft_tpu_torch.ops.masked_nn import masked_l2_nn
from raft_tpu_torch.ops.select_k import merge_parts, running_merge, select_k, worst_value

__all__ = [
    "KernelParams",
    "KernelType",
    "gram_matrix",
    "linear_kernel",
    "masked_l2_nn",
    "polynomial_kernel",
    "rbf_kernel",
    "tanh_kernel",
    "DistanceType",
    "is_min_close",
    "pairwise_distance",
    "resolve_metric",
    "row_norms",
    "fused_l2_nn",
    "min_cluster_and_distance",
    "merge_parts",
    "running_merge",
    "select_k",
    "worst_value",
]
