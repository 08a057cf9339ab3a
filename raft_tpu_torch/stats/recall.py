"""ANN recall (``raft_tpu.stats.recall`` counterpart;
``stats/neighborhood_recall.cuh:35-62``)."""
from __future__ import annotations

from typing import Optional

import torch


def neighborhood_recall(
    indices,
    ref_indices,
    distances: Optional[torch.Tensor] = None,
    ref_distances: Optional[torch.Tensor] = None,
    eps: float = 1e-3,
) -> float:
    """Fraction of (query, rank) pairs whose id appears in the query's
    ground-truth top-k (order-insensitive); with distances, a
    non-matching id still counts when its distance is within ``eps`` of a
    ground-truth distance."""
    indices = torch.as_tensor(indices)
    ref_indices = torch.as_tensor(ref_indices).to(indices.device)
    if tuple(indices.shape) != tuple(ref_indices.shape):
        raise ValueError("indices/ref shape mismatch")
    match = (indices[:, :, None] == ref_indices[:, None, :]).any(dim=2)
    if distances is not None and ref_distances is not None:
        distances = torch.as_tensor(distances).to(indices.device)
        ref_distances = torch.as_tensor(ref_distances).to(indices.device)
        match = match | (torch.abs(distances[:, :, None] - ref_distances[:, None, :]) < eps).any(dim=2)
    return float(match.to(torch.float32).mean())
