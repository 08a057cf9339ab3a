"""Spectral layer: partitioning and modularity maximization (``raft/spectral``).

Exports the JAX package's ``raft_tpu.spectral.__all__``."""
from raft_tpu_torch.spectral.partition import (
    analyze_partition,
    fit_embedding,
    modularity,
    modularity_maximization,
    partition,
)

__all__ = [
    "analyze_partition",
    "fit_embedding",
    "modularity",
    "modularity_maximization",
    "partition",
]
