"""Index families: brute force, IVF-Flat, IVF-PQ, CAGRA (with NN-descent),
ball cover, hnsw interop, refine and the epsilon neighbourhood.

Exports the JAX package's ``raft_tpu.neighbors.__all__``. As there, the
name ``refine`` is the function: reach the module with
``importlib.import_module("raft_tpu_torch.neighbors.refine")``."""
from raft_tpu_torch.neighbors import (
    ball_cover,
    brute_force,
    cagra,
    hnsw,
    ivf_flat,
    ivf_pq,
    nn_descent,
)
from raft_tpu_torch.neighbors.epsilon_neighborhood import eps_neighbors
from raft_tpu_torch.neighbors.refine import refine

__all__ = [
    "ball_cover",
    "brute_force",
    "cagra",
    "eps_neighbors",
    "hnsw",
    "ivf_flat",
    "ivf_pq",
    "nn_descent",
    "refine",
]
