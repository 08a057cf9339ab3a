"""Batched top-k selection (``raft_tpu.ops.select_k`` counterpart).

The tie order is ``lax.top_k``'s: among equal values the lower column
comes first. ``torch.topk`` does not promise that, so :func:`select_k`
uses ``torch.topk`` only to find each row's k-th value, then keeps every
entry better than it and, of the entries equal to it, the first ones in
column order, exactly k a row, and finishes with a stable sort of those
k. (Keeping every entry equal to the k-th value would sort whole rows
where many entries tie there, as a masked row of ``inf`` does.)
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
    less = v < kth
    eq = v == kth
    need = k - torch.sum(less, dim=1, keepdim=True, dtype=torch.int32)
    cand = less | (eq & (torch.cumsum(eq, dim=1, dtype=torch.int32) <= need))  # k a row
    # compact the candidates in column order: rank = running count
    rank = torch.cumsum(cand, dim=1, dtype=torch.int32) - 1
    dest = torch.where(cand, rank, k).to(torch.int64)
    cols = torch.arange(n, device=v.device).expand(b, n)
    buf_v = torch.full((b, k + 1), worst_value(v.dtype), dtype=v.dtype, device=v.device)
    buf_c = torch.full((b, k + 1), n, dtype=torch.int64, device=v.device)
    buf_v.scatter_(1, dest, v)
    buf_c.scatter_(1, dest, cols)
    vals, order = torch.sort(buf_v[:, :k], dim=1, stable=True)
    return vals, torch.gather(buf_c[:, :k], 1, order)


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


def merge_parts(
    part_values: torch.Tensor,
    part_indices: torch.Tensor,
    k: int,
    select_min: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-part top-k lists ``[batch, n_parts * k_part]`` (each entry
    carrying a global index) into one top-k (``knn_merge_parts``)."""
    expects(tuple(part_values.shape) == tuple(part_indices.shape),
            "merge_parts values/indices shape mismatch")
    return select_k(part_values, k, select_min=select_min, indices=part_indices)


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


def running_merge_unique(
    acc_values: torch.Tensor,
    acc_indices: torch.Tensor,
    new_values: torch.Tensor,
    new_indices: torch.Tensor,
    select_min: bool = True,
    acc_flags: Optional[torch.Tensor] = None,
    new_flags: Optional[torch.Tensor] = None,
):
    """:func:`running_merge` with per-row id deduplication (the visited
    hashmap of the reference's graph searches, as a sort and an adjacent
    compare). Negative ids are padding. Assumes equal ids carry equal
    values.

    With ``acc_flags`` a boolean flag lane (CAGRA's "visited", NN-descent's
    "already sampled") rides through the merge: the entries are sorted by
    the composite key ``id * 2 + (1 - flag)`` (stable), so on a duplicate id
    the flagged copy survives, and a third tensor, the flags, is returned.
    Then ``select_k`` keeps the lower column on value ties."""
    k = acc_values.shape[1]
    vals = torch.cat([acc_values, new_values], dim=1)
    ids = torch.cat([acc_indices, new_indices], dim=1)
    worst = worst_value(vals.dtype, select_min)
    vals = torch.where(ids < 0, torch.full_like(vals, worst), vals)
    with_flags = acc_flags is not None
    if with_flags:
        if new_flags is None:
            new_flags = torch.zeros(new_indices.shape, dtype=torch.bool, device=ids.device)
        flg = torch.cat([acc_flags, new_flags], dim=1)
        composite = ids.to(torch.int64) * 2 + (1 - flg.to(torch.int64))
        composite = torch.where(ids < 0, torch.full_like(composite, torch.iinfo(torch.int32).max),
                                composite)
        order = torch.argsort(composite, dim=1, stable=True)
        flg_s = torch.gather(flg, 1, order)
    else:
        order = torch.argsort(ids, dim=1, stable=True)
    ids_s = torch.gather(ids, 1, order)
    vals_s = torch.gather(vals, 1, order)
    prev = torch.cat([torch.full_like(ids_s[:, :1], -2), ids_s[:, :-1]], dim=1)
    dup = (ids_s == prev) & (ids_s >= 0)
    vals_s = torch.where(dup, torch.full_like(vals_s, worst), vals_s)
    out_v, pos = select_k(vals_s, k, select_min=select_min)
    pos = pos.to(torch.int64)
    out_i = torch.gather(ids_s, 1, pos)
    # slots that selected a sentinel (all-invalid row tails) report id -1
    out_i = torch.where(out_v == worst, torch.full_like(out_i, -1), out_i)
    if with_flags:
        return out_v, out_i, torch.gather(flg_s, 1, pos)
    return out_v, out_i


def worst_value(dtype, select_min: bool = True):
    """Sentinel used to pad candidate buffers."""
    if not torch.empty((), dtype=dtype).is_floating_point():
        info = torch.iinfo(dtype)
        return info.max if select_min else info.min
    return float("inf") if select_min else float("-inf")
