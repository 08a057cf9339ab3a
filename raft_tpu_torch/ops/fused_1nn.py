"""Distance + argmin (``raft_tpu.ops.fused_1nn`` counterpart).

For each row the nearest centroid and its distance — the k-means E step
(``cluster/detail/kmeans.cuh:435``). Rows are processed in blocks so the
[block, n_centroids] distance tile is the peak temporary. Ties go to the
lower centroid index (``torch.argmin`` returns the first minimum), as in
the JAX package's scan with a strict ``<`` across tiles.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric, row_norms

_BLOCK_ELEMS = 1 << 26  # [block, n_centroids] f32 tile budget (256 MiB)


def _row_block(n_centroids: int) -> int:
    return max(1024, _BLOCK_ELEMS // max(1, n_centroids))


def fused_l2_nn(
    x: torch.Tensor,
    y: torch.Tensor,
    x_sqnorm: Optional[torch.Tensor] = None,
    y_sqnorm: Optional[torch.Tensor] = None,
    sqrt: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``x`` [m, d] the (squared) L2 distance to and index of
    its nearest row in ``y`` [n, d]. Returns ``(min_dist f32, argmin i32)``.
    Rows of ``y`` with an infinite norm never win."""
    expects(x.ndim == 2 and y.ndim == 2, "fused_l2_nn expects 2-D inputs")
    expects(x.shape[1] == y.shape[1], "feature dims differ")
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    xn = row_norms(xf) if x_sqnorm is None else x_sqnorm.to(torch.float32)
    yn = row_norms(yf) if y_sqnorm is None else y_sqnorm.to(torch.float32)
    pad = torch.isinf(yn)[None, :]
    vals, idxs = [], []
    block = _row_block(y.shape[0])
    for s in range(0, x.shape[0], block):
        dot = xf[s : s + block] @ yf.T
        d2 = torch.clamp(xn[s : s + block, None] + yn[None, :] - 2.0 * dot, min=0.0)
        d2 = torch.where(pad, torch.full_like(d2, float("inf")), d2)
        v, i = torch.min(d2, dim=1)
        vals.append(v)
        idxs.append(i.to(torch.int32))
    best_val = torch.cat(vals) if vals else xf.new_zeros((0,))
    best_idx = torch.cat(idxs) if idxs else torch.zeros((0,), dtype=torch.int32, device=x.device)
    if sqrt:
        best_val = torch.sqrt(best_val)
    return best_val, best_idx


def _fused_ip_nn(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-inner-product 1-NN: ``(max dot, first argmax)``."""
    vals, idxs = [], []
    block = _row_block(y.shape[0])
    for s in range(0, x.shape[0], block):
        v, i = torch.max(x[s : s + block] @ y.T, dim=1)
        vals.append(v)
        idxs.append(i.to(torch.int32))
    return torch.cat(vals), torch.cat(idxs)


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Unit rows with the JAX package's 1e-12 norm clamp."""
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)


def min_cluster_and_distance(
    x,
    centroids,
    metric=DistanceType.L2Expanded,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample nearest centroid ``(labels i32, distances f32)``.

    L2 variants: the L2 scan directly. Cosine: rows and centroids are
    normalized first and the distance is ``||x̂-ĉ||²/2 == 1 - cos``.
    InnerProduct: max inner product; the "distance" is the raw dot."""
    metric = resolve_metric(metric)
    x = torch.as_tensor(x).to(torch.float32)
    c = torch.as_tensor(centroids).to(device=x.device, dtype=torch.float32)
    if metric == DistanceType.InnerProduct:
        dot, idx = _fused_ip_nn(x, c)
        return idx, dot
    if metric == DistanceType.CosineExpanded:
        d2, idx = fused_l2_nn(normalize_rows(x), normalize_rows(c))
        return idx, 0.5 * d2
    sqrt = metric in (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)
    dist, idx = fused_l2_nn(x, c, sqrt=sqrt)
    return idx, dist
