"""Graph utilities for the neighbor-graph algorithms (NN-descent, CAGRA)
(``raft_tpu.utils.graph`` counterpart).

The reference builds reverse adjacency by scattering into ragged per-node
lists with atomics (``detail/cagra/graph_core.cuh`` ``kern_make_rev_graph``).
Here it is a stable sort by destination, a first-occurrence rank and a
scatter of unique ``(row, column)`` pairs, so no sum is ever accumulated and
the result is the same on every device.
"""
from __future__ import annotations

import torch


def reverse_edges(graph: torch.Tensor, n: int, r: int, order_by_rank: bool = False) -> torch.Tensor:
    """Rank-limited reverse adjacency: for edges ``u -> graph[u, j]`` keep up
    to ``r`` sources per destination, returned as ``[n, r]`` int32 (-1
    padded).

    ``order_by_rank=True`` orders each reverse list by the edge's forward
    rank ``j`` (the reference's k-major insertion order); otherwise edges
    keep their flattened order."""
    dev = graph.device
    deg = graph.shape[1]
    src = torch.arange(n, dtype=torch.int64, device=dev).repeat_interleave(deg)
    dst = graph.reshape(-1).to(torch.int64)
    dst = torch.where(dst < 0, torch.full_like(dst, n), dst)  # invalid edges sort to the end
    if order_by_rank:
        fwd_rank = torch.arange(deg, dtype=torch.int64, device=dev).repeat(n)
        order = torch.argsort(dst * deg + fwd_rank, stable=True)
    else:
        order = torch.argsort(dst, stable=True)
    dsts = dst[order]
    srcs = src[order]
    first = torch.searchsorted(dsts, dsts, side="left")
    rank = torch.arange(n * deg, dtype=torch.int64, device=dev) - first
    keep = (rank < r) & (dsts < n)
    rev = torch.full((n, r), -1, dtype=torch.int32, device=dev)
    rev[dsts[keep], rank[keep]] = srcs[keep].to(torch.int32)
    return rev
