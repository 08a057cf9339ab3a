"""Solver layer: the linear assignment problem (``solver/linear_assignment.cuh``).

Exports the JAX package's ``raft_tpu.solver.__all__``."""
from raft_tpu_torch.solver.lap import lap_solve

__all__ = ["lap_solve"]
