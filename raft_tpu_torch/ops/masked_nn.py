"""Masked L2 1-nearest-neighbour (``raft_tpu.ops.masked_nn`` counterpart;
reference ``raft::distance::masked_l2_nn``, ``distance/masked_nn.cuh:39``).

The rows of ``y`` fall into contiguous groups, and ``adj [m, num_groups]``
says which groups each row of ``x`` may reach. As in the JAX package the
search is dense: ``y`` in tiles, each tile's expanded-L2 block masked to
``+inf`` outside the adjacent groups and folded into a running
(value, index) minimum. The JAX package leaves it to XLA, so it is plain
PyTorch here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.ops.distance import row_norms


def masked_l2_nn(
    x,
    y,
    adj,
    group_idxs,
    x_sqnorm: Optional[torch.Tensor] = None,
    y_sqnorm: Optional[torch.Tensor] = None,
    sqrt: bool = False,
    tile: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``x``, ``(distance, index)`` of its nearest row of
    ``y`` among the adjacent groups only (squared L2, or L2 with
    ``sqrt``). ``group_idxs[g]`` is one past the last row of group ``g``
    (END indices, as in the reference); a row of ``y`` belongs to the
    first group whose end exceeds it, rows past the last end to the last
    group. A row of ``x`` with no adjacent group (or no row in one)
    returns ``(inf, -1)``; ties take the lowest index."""
    x = torch.as_tensor(x).to(torch.float32)
    y = torch.as_tensor(y).to(device=x.device, dtype=torch.float32)
    adj = torch.as_tensor(adj).to(device=x.device, dtype=torch.bool)
    group_idxs = torch.as_tensor(group_idxs).to(device=x.device, dtype=torch.int64)
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1], "bad x/y shapes")
    m, n = x.shape[0], y.shape[0]
    num_groups = group_idxs.shape[0]
    expects(tuple(adj.shape) == (m, num_groups), "adj must be [m, num_groups]")
    rows = torch.arange(n, dtype=torch.int64, device=x.device)
    group_ids = torch.clamp(torch.searchsorted(group_idxs, rows, right=True), 0, num_groups - 1)
    xn = row_norms(x) if x_sqnorm is None else torch.as_tensor(x_sqnorm).to(x.device, torch.float32)
    yn = row_norms(y) if y_sqnorm is None else torch.as_tensor(y_sqnorm).to(x.device, torch.float32)
    tile = int(min(tile, max(n, 8)))
    best_v = torch.full((m,), float("inf"), dtype=torch.float32, device=x.device)
    best_i = torch.full((m,), -1, dtype=torch.int64, device=x.device)
    for s in range(0, n, tile):
        dist = torch.clamp(xn[:, None] + yn[None, s : s + tile] - 2.0 * (x @ y[s : s + tile].T),
                           min=0.0)
        dist = torch.where(adj[:, group_ids[s : s + tile]], dist, torch.full_like(dist, float("inf")))
        # torch.min takes the lowest index among equal minima, as
        # jnp.argmin does (held on the card by chip_smoke.py's phase 13)
        tv, ti = torch.min(dist, dim=1)
        take = tv < best_v
        best_v = torch.where(take, tv, best_v)
        best_i = torch.where(take, ti + s, best_i)
    best_i = torch.where(torch.isfinite(best_v), best_i, torch.full_like(best_i, -1))
    if sqrt:
        best_v = torch.sqrt(torch.clamp(best_v, min=0.0))
    best_v = torch.where(best_i >= 0, best_v, torch.full_like(best_v, float("inf")))
    return best_v, best_i.to(torch.int32)
