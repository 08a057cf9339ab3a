"""Batched top-k selection (``raft_tpu.ops.select_k`` counterpart).

The tie order is ``lax.top_k``'s: among equal values the lower column
comes first. ``torch.topk`` does not promise that, so :func:`select_k`
uses ``torch.topk`` only to find each row's k-th value, then keeps every
entry at or better than it in column order and finishes with a stable
sort of that short candidate set.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import expects


def _stable_smallest(v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest per row of ``v`` [b, n], lower column first on ties.
    Returns ``(values, int64 columns)``."""
    b, n = v.shape
    if 8 * k >= n or n <= 4096:
        vals, pos = torch.sort(v, dim=1, stable=True)
        return vals[:, :k], pos[:, :k]
    kth = torch.topk(v, k, dim=1, largest=False, sorted=False).values.max(dim=1, keepdim=True).values
    cand = v <= kth  # >= k entries per row (ties at the k-th value included)
    width = int(cand.sum(dim=1).max())
    # compact candidate columns in column order: rank = running count
    rank = torch.cumsum(cand.to(torch.int32), dim=1) - 1
    dest = torch.where(cand, rank, torch.full_like(rank, width)).to(torch.int64)
    cols = torch.arange(n, device=v.device).expand(b, n)
    buf_v = torch.full((b, width + 1), worst_value(v.dtype), dtype=v.dtype, device=v.device)
    buf_c = torch.full((b, width + 1), n, dtype=torch.int64, device=v.device)
    buf_v.scatter_(1, dest, v)
    buf_c.scatter_(1, dest, cols)
    buf_v, buf_c = buf_v[:, :width], buf_c[:, :width]
    vals, order = torch.sort(buf_v, dim=1, stable=True)
    return vals[:, :k], torch.gather(buf_c, 1, order[:, :k])


def select_k(
    values,
    k: int,
    select_min: bool = True,
    indices: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest (or largest) entries per row, best first.

    ``values`` [batch, n]; optional ``indices`` [batch, n] carries source
    ids (positional int32 columns when absent). Returns
    ``(out_values [batch, k], out_indices [batch, k])``."""
    values = torch.as_tensor(values)
    expects(values.ndim == 2, "select_k expects [batch, n] values, got ndim=%d", values.ndim)
    n = values.shape[1]
    expects(0 < k <= n, "k=%d out of range for n=%d columns", k, n)
    if select_min:
        vals, pos = _stable_smallest(values, k)
    else:
        vals, pos = _stable_smallest(-values, k)
        vals = -vals
    if indices is not None:
        return vals, torch.gather(torch.as_tensor(indices), 1, pos)
    return vals, pos.to(torch.int32)


def running_merge(
    acc_values: torch.Tensor,
    acc_indices: torch.Tensor,
    new_values: torch.Tensor,
    new_indices: torch.Tensor,
    select_min: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming top-k: merge a running [batch, k] result with a fresh
    [batch, t] candidate tile (accumulated entries win ties)."""
    k = acc_values.shape[1]
    vals = torch.cat([acc_values, new_values], dim=1)
    idx = torch.cat([acc_indices, new_indices], dim=1)
    return select_k(vals, k, select_min=select_min, indices=idx)


def worst_value(dtype, select_min: bool = True):
    """Sentinel used to pad candidate buffers."""
    if not torch.empty((), dtype=dtype).is_floating_point():
        info = torch.iinfo(dtype)
        return info.max if select_min else info.min
    return float("inf") if select_min else float("-inf")
