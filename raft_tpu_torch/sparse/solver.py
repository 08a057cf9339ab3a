"""Sparse solvers: Borůvka MST and the Lanczos eigensolver
(``raft_tpu.sparse.solver`` counterpart; reference
``raft/sparse/solver/mst.cuh`` and ``raft/sparse/solver/lanczos.cuh``).

MST is Borůvka vectorized over the static edge list, as in the JAX
package: a round picks each component's cheapest outgoing edge by a
segment min over the edges' ``(weight, edge id)`` rank, lets only the
minimum-rank hook per ``hi`` component win, and collapses the forest with
``ceil(log2 n)`` pointer jumps. JAX's ``lax.while_loop`` is a Python loop
here that reads one flag from the device a round.

Lanczos keeps full reorthogonalization and the breakdown restart with
``beta = 0``. Its start and restart vectors come from a ``torch.Generator``
through :func:`_draw`; ``key=None`` means seed 0, as in JAX (not the
handle's generator). Each step reads the breakdown test on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.random.rng import as_key
from raft_tpu_torch.sparse.types import COO, segment_min, take


@dataclasses.dataclass
class MSTResult:
    """``Graph_COO`` output of ``mst::mst`` (``sparse/mst/mst.cuh``)."""

    src: np.ndarray  # [n_mst_edges]
    dst: np.ndarray
    weights: np.ndarray
    n_edges: int


def _pointer_jump(parent: torch.Tensor, rounds: int) -> torch.Tensor:
    for _ in range(rounds):
        parent = parent[parent]
    return parent


def mst(coo: COO, max_rounds: Optional[int] = None) -> MSTResult:
    """Minimum spanning forest of an undirected graph given as COO edges
    (one direction or both). Returns the chosen edges as host arrays, as the
    reference's ``mst::mst`` does; the rounds run on the graph's device."""
    n = coo.shape[0]
    expects(coo.shape[0] == coo.shape[1], "mst expects square adjacency")
    e = coo.nnz
    # a hook-contest loser defers its merge, so the bound is n rounds
    rounds = max_rounds or n
    jump = max(1, int(np.ceil(np.log2(max(n, 2)))))
    dev = coo.vals.device

    src = coo.rows.to(torch.int32)
    dst = coo.cols.to(torch.int32)
    w = coo.vals.to(torch.float32)
    valid0 = (src != dst) & (src >= 0) & (dst >= 0)

    # ties broken by (weight, edge id): a unique rank per edge
    order = torch.argsort(w, stable=True)
    rank = torch.empty(e, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(e, dtype=torch.int64, device=dev)
    big = torch.full_like(rank, e)

    parent = torch.arange(n, dtype=torch.int64, device=dev)
    chosen = torch.zeros(e, dtype=torch.bool, device=dev)
    for _ in range(rounds):
        comp_s = take(parent, src)
        comp_d = take(parent, dst)
        cross = (comp_s != comp_d) & valid0
        # the cheapest outgoing edge of each component
        r = torch.where(cross, rank, big)
        best = torch.minimum(segment_min(r, comp_s, n), segment_min(r, comp_d, n))
        sel = cross & ((best[comp_s] == rank) | (best[comp_d] == rank))
        # hook hi onto lo; of the edges that hook one hi only the min rank
        # wins (the reference's atomicMin), the losers retry later
        lo = torch.minimum(comp_s, comp_d)
        hi = torch.maximum(comp_s, comp_d)
        win = segment_min(torch.where(sel, rank, big), hi, n)
        sel = sel & (win[hi] == rank)
        ext = torch.cat([parent, parent.new_zeros(1)])  # slot n takes the unselected writes
        ext[torch.where(sel, hi, torch.full_like(hi, n))] = torch.where(sel, lo, torch.zeros_like(lo))
        parent = _pointer_jump(ext[:n], jump)
        chosen |= sel
        if not bool(sel.any()):
            break

    chosen_np = chosen.cpu().numpy()
    return MSTResult(
        src=src.cpu().numpy()[chosen_np],
        dst=dst.cpu().numpy()[chosen_np],
        weights=w.cpu().numpy()[chosen_np],
        n_edges=int(chosen_np.sum()),
    )


def _draw(gen: torch.Generator, n: int, step: Optional[int]) -> torch.Tensor:
    """One standard normal [n] f32 vector: the start vector (``step`` None)
    or the restart at Lanczos step ``step``. Every draw of :func:`lanczos`
    goes through here."""
    return torch.randn(n, generator=gen, device=gen.device, dtype=torch.float32)


def lanczos(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    n_components: int,
    m: Optional[int] = None,
    which: str = "smallest",
    key=None,
    res: Optional[Resources] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric Lanczos (``sparse/solver/lanczos.cuh``
    ``computeSmallestEigenvectors`` / ``computeLargestEigenvectors``).

    Returns ``(eigenvalues [k], eigenvectors [n, k])``. ``m`` is the
    Krylov size (default ``max(2k + 16, 32)``, clamped to n). On breakdown
    (an invariant subspace before ``m`` steps) the iteration restarts from
    a fresh random vector orthogonal to the converged block with
    ``beta = 0``, so ``T`` is block-diagonal and no spurious zero
    eigenvalue appears. ``key`` is an int seed or a ``torch.Generator``
    (None: seed 0); vectors live on ``res``'s or ``device`` (default
    ``cuda``), since a matvec names no device."""
    expects(which in ("smallest", "largest"), "which must be smallest|largest")
    k = n_components
    m = min(n, m or max(2 * k + 16, 32))
    expects(k <= m, "n_components must be <= Krylov size")

    gen = as_key(0 if key is None else key, res, device)
    dev = gen.device
    v0 = _draw(gen, n, None).to(dev)
    v0 = v0 / torch.linalg.norm(v0)

    V = torch.zeros((m, n), dtype=torch.float32, device=dev)
    V[0] = v0
    alpha = torch.zeros(m, dtype=torch.float32, device=dev)
    beta = torch.zeros(m, dtype=torch.float32, device=dev)
    anorm = torch.tensor(1e-30, dtype=torch.float32, device=dev)
    for i in range(m - 1):
        v = V[i]
        w = matvec(v).to(torch.float32)
        a = torch.dot(w, v)
        w = w - a * v
        if i > 0:
            w = w - beta[i - 1] * V[i - 1]
        # full reorthogonalization against rows 0..i
        Vi = V[: i + 1]
        w = w - Vi.T @ (Vi @ w)
        b = torch.linalg.norm(w)
        # breakdown is relative to a running estimate of ||A||
        anorm = torch.maximum(anorm, torch.abs(a) + b)
        alpha[i] = a
        if bool(b <= 1e-6 * anorm):
            r = _draw(gen, n, i).to(dev)
            r = r - Vi.T @ (Vi @ r)
            V[i + 1] = r / torch.clamp(torch.linalg.norm(r), min=1e-30)
            beta[i] = 0.0
        else:
            V[i + 1] = w / torch.clamp(b, min=1e-30)
            beta[i] = b
    vm = V[m - 1]
    alpha[m - 1] = torch.dot(matvec(vm).to(torch.float32), vm)

    T = torch.diag(alpha) + torch.diag(beta[: m - 1], 1) + torch.diag(beta[: m - 1], -1)
    evals, evecs = torch.linalg.eigh(T)  # ascending
    if which == "smallest":
        sel = torch.arange(k, device=dev)
    else:
        sel = torch.arange(m - 1, m - k - 1, -1, device=dev)
    lam = evals[sel]
    vecs = (evecs[:, sel].T @ V).T  # [n, k]
    vecs = vecs / torch.clamp(torch.linalg.norm(vecs, dim=0, keepdim=True), min=1e-30)
    return lam, vecs
