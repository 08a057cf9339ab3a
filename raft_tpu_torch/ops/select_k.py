"""Batched top-k selection (``raft_tpu.ops.select_k`` counterpart).

The order is ``lax.top_k``'s. Among equal values the lower column comes
first; ``torch.topk`` does not promise that, so on wide rows
:func:`select_k` takes from ``torch.topk`` only the entries better than
the k-th value, and finds the first ones equal to it in column order by
a binary search over the running count of ties. NaN is ordered by the
total order of the float bits: a NaN with the sign bit clear ranks after
``+inf``, one with it set before ``-inf``. So with ``select_min=True``
and ordinary NaNs the finite entries come first, then the NaNs at their
own columns; with ``select_min=False`` the NaNs come first. Both paths
select over integer keys of that order (one integer view and a where);
``-0`` ties ``+0`` (``lax.top_k`` puts ``-0`` first; the port's ring
exchange and its gather merge tie them).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import expects


_INT_OF_SIZE = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _order_keys(v: torch.Tensor) -> torch.Tensor:
    """Integer keys in the ascending order of ``v``: a float's bits with
    the sign-magnitude of negative values turned into two's complement
    (``-0`` lands on ``+0``). Integer values are their own keys."""
    if not v.is_floating_point():
        return v
    itype = _INT_OF_SIZE[v.element_size()]
    bits = v.view(itype)
    # negative: -(bits & MAX) = MIN - bits; the other branch's wrap is discarded
    return torch.where(bits < 0, torch.iinfo(itype).min - bits, bits)


def _stable_best(v: torch.Tensor, k: int, largest: bool) -> torch.Tensor:
    """Columns of the k best per row of the integer keys ``v`` [b, n]
    (smallest, or largest with ``largest``), best first and the lower
    column first on ties: int64 ``[b, k]``, every column < n."""
    b, n = v.shape
    if 8 * k >= n or n <= 4096:
        return torch.sort(v, dim=1, stable=True, descending=largest).indices[:, :k]
    top, top_c = torch.topk(v, k, dim=1, largest=largest, sorted=True)
    kth = top[:, k - 1 :]
    tied = top == kth  # the last slots: which of the k-th value's ties to take
    ties = torch.cumsum(v == kth, dim=1, dtype=torch.int32)  # running count, non-decreasing
    first = torch.searchsorted(ties, torch.cumsum(tied, dim=1, dtype=torch.int32))
    cols = torch.sort(torch.where(tied, first, top_c), dim=1).values
    order = torch.sort(torch.gather(v, 1, cols), dim=1, stable=True, descending=largest).indices
    return torch.gather(cols, 1, order)


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
    pos = _stable_best(_order_keys(values), k, largest=not select_min)
    vals = torch.gather(values, 1, pos)
    if indices is not None:
        return vals, torch.gather(torch.as_tensor(indices), 1, pos)
    return vals, pos.to(torch.int32)


def approx_select_k(
    values,
    k: int,
    select_min: bool = True,
    indices: Optional[torch.Tensor] = None,
    recall_target: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`select_k` under the JAX package's approximate contract
    (``lax.approx_min_k`` / ``approx_max_k``: each true top-k entry
    returned with probability ``recall_target``, best first).

    The port selects exactly, which meets any ``recall_target``: the
    TPU's PartialReduce has no counterpart on the card, and an exact
    selection costs one :func:`select_k`. Off a TPU JAX's op returns the
    exact top-k values too, with ties resolved in its own order, so ids
    agree with JAX's only up to the order of equal values."""
    values = torch.as_tensor(values)
    expects(values.ndim == 2, "approx_select_k expects [batch, n] values")
    n = values.shape[1]
    expects(0 < k <= n, "k=%d out of range for n=%d columns", k, n)
    expects(0.0 < recall_target <= 1.0, "recall_target must be in (0, 1], got %s", recall_target)
    return select_k(values, k, select_min=select_min, indices=indices)


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
