"""Index families: brute force, IVF-Flat, IVF-PQ, CAGRA (with NN-descent),
refine.

Exports the JAX package's ``raft_tpu.neighbors.__all__`` except
``ball_cover``, ``eps_neighbors`` and ``hnsw`` (ROADMAP queue A7b). As
there, the name ``refine`` is the function: reach the module with
``importlib.import_module("raft_tpu_torch.neighbors.refine")``."""
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq, nn_descent
from raft_tpu_torch.neighbors.refine import refine

__all__ = [
    "brute_force",
    "cagra",
    "ivf_flat",
    "ivf_pq",
    "nn_descent",
    "refine",
]
