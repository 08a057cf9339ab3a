"""Linear assignment problem solver (``raft_tpu.solver.lap`` counterpart;
reference ``raft::solver::LinearAssignmentProblem``,
``solver/linear_assignment.cuh``).

A host-side shortest-augmenting-path (Jonker–Volgenant) solve: the
reference's consumers solve modest assignment problems (cluster matching,
tracking) at build or evaluation time, where an O(n³) host solve is the
right tool. :func:`lap_solve` runs the port's own C solver
(``raft_tpu_torch/native/lap.c``, built at first use); a build that fails
raises ``KernelFailure``, where the JAX package falls back to numpy.
:func:`lap_solve_reference` is that numpy solver, the plain version the
tests hold the C one against; ``n < 2`` takes it, as JAX does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.errors import KernelFailure, expects
from raft_tpu_torch.ops.guard import kernel_guard


def _cost_matrix(cost) -> np.ndarray:
    if isinstance(cost, torch.Tensor):
        cost = cost.detach().cpu().numpy()
    c = np.asarray(cost, np.float64)
    expects(c.ndim == 2 and c.shape[0] == c.shape[1], "cost must be square")
    return c


def _assignments(c: np.ndarray, row_assign: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    n = c.shape[0]
    col_assign = np.argsort(row_assign)
    total = float(c[np.arange(n), row_assign].sum())
    return row_assign.astype(np.int32), col_assign.astype(np.int32), total


def _native_solve(c: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    from raft_tpu_torch.native import load_native

    lib = load_native("lap")
    n = c.shape[0]
    cc = np.ascontiguousarray(c, np.float64)
    p = np.empty((n,), np.int64)  # p[j] = row assigned to column j (a C long)
    with kernel_guard("native lap_jv"):
        fn = lib.lap_jv
        fn.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
        fn.restype = ctypes.c_int
        rc = fn(cc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ctypes.c_long(n),
                p.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if rc != 0:
        raise KernelFailure(f"native lap_jv failed (rc {rc}) at n = {n}")
    row_assign = np.zeros(n, np.int64)
    row_assign[p] = np.arange(n)
    return _assignments(cc, row_assign)


def lap_solve(cost) -> Tuple[np.ndarray, np.ndarray, float]:
    """Min-cost perfect assignment on a square cost matrix (numpy or a
    tensor, solved on the host in float64).

    Returns ``(row_assignment, col_assignment, total_cost)``:
    ``row_assignment[i]`` is the column given to row i (the reference's
    ``getRowAssignments`` / ``getColAssignments`` /
    ``getPrimalObjectiveValue``)."""
    c = _cost_matrix(cost)
    if c.shape[0] < 2:
        return lap_solve_reference(c)
    return _native_solve(c)


def lap_solve_reference(cost) -> Tuple[np.ndarray, np.ndarray, float]:
    """The vectorized numpy Jonker–Volgenant solve, :func:`lap_solve`'s
    plain version (the JAX package's no-compiler path)."""
    c = _cost_matrix(cost)
    n = c.shape[0]
    INF = np.inf
    u = np.zeros(n + 1)  # row potentials (1-indexed)
    v = np.zeros(n + 1)  # column potentials
    p = np.zeros(n + 1, np.int64)  # p[j] = row assigned to column j
    way = np.zeros(n + 1, np.int64)

    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            # relaxation over the unused columns
            cols = np.nonzero(~used)[0]
            cur = c[i0 - 1, cols - 1] - u[i0] - v[cols]
            better = cur < minv[cols]
            minv[cols] = np.where(better, cur, minv[cols])
            way[cols[better]] = j0
            j1 = cols[np.argmin(minv[cols])]
            delta = minv[j1]
            # dual update over the used and unused partitions
            used_idx = np.nonzero(used)[0]
            u[p[used_idx]] += delta
            v[used_idx] -= delta
            minv[cols] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        # augment along the alternating path
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    row_assign = np.zeros(n, np.int64)
    for j in range(1, n + 1):
        if p[j] > 0:
            row_assign[p[j] - 1] = j - 1
    return _assignments(c, row_assign)
