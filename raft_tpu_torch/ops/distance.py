"""Pairwise distances (``raft_tpu.ops.distance`` counterpart).

``DistanceType`` keeps every enum value of the JAX package (and of the
reference's ``distance/distance_types.hpp:23-68``), so serialized indexes
carry the same metric ids. This slice computes the four expanded metrics
the IVF-Flat path needs — L2Expanded, L2SqrtExpanded, InnerProduct,
CosineExpanded — as one f32 matmul plus an epilogue; every other metric
raises :class:`~raft_tpu_torch.core.errors.LogicError`.

Matmuls run in full f32 (the package turns TF32 off on import).
"""
from __future__ import annotations

import enum
from typing import Optional

import torch

from raft_tpu_torch.core.errors import expects, fail


class DistanceType(enum.IntEnum):
    """Metric enum; values match the JAX package and the reference."""

    L2Expanded = 0
    L2SqrtExpanded = 1
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7
    Canberra = 8
    LpUnexpanded = 9
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19
    Precomputed = 100


_METRIC_ALIASES = {
    "euclidean": DistanceType.L2SqrtExpanded,
    "l2": DistanceType.L2SqrtExpanded,
    "sqeuclidean": DistanceType.L2Expanded,
    "l2_expanded": DistanceType.L2Expanded,
    "l2_unexpanded": DistanceType.L2Unexpanded,
    "cosine": DistanceType.CosineExpanded,
    "inner_product": DistanceType.InnerProduct,
    "dot": DistanceType.InnerProduct,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "manhattan": DistanceType.L1,
    "chebyshev": DistanceType.Linf,
    "linf": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "minkowski": DistanceType.LpUnexpanded,
    "lp": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "haversine": DistanceType.Haversine,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "kldivergence": DistanceType.KLDivergence,
    "russellrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
}

#: the metrics this slice computes
SUPPORTED = frozenset(
    {
        DistanceType.L2Expanded,
        DistanceType.L2SqrtExpanded,
        DistanceType.CosineExpanded,
        DistanceType.InnerProduct,
    }
)


def resolve_metric(metric) -> DistanceType:
    """Resolve a ``DistanceType``, int, or string alias to the enum."""
    if isinstance(metric, DistanceType):
        return metric
    if isinstance(metric, str):
        key = metric.lower()
        expects(key in _METRIC_ALIASES, "unknown metric name %s", metric)
        return _METRIC_ALIASES[key]
    return DistanceType(metric)


def is_min_close(metric) -> bool:
    """Whether smaller distance means more similar."""
    return resolve_metric(metric) != DistanceType.InnerProduct


def row_norms(x: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """Squared (or plain) L2 row norms in f32."""
    xf = x.to(torch.float32)
    sq = torch.sum(xf * xf, dim=-1)
    return sq if squared else torch.sqrt(sq)


def expanded_distance(
    x: torch.Tensor,
    y: torch.Tensor,
    metric: DistanceType,
    x_sqnorm: Optional[torch.Tensor] = None,
    y_sqnorm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Matmul + epilogue. ``x`` [m, d], ``y`` [n, d] -> [m, n] f32."""
    if metric not in SUPPORTED:
        fail("metric %s is not ported yet (supported: %s)", metric,
             ", ".join(m.name for m in sorted(SUPPORTED)))
    dot = x.to(torch.float32) @ y.to(torch.float32).T
    if metric == DistanceType.InnerProduct:
        return dot
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        xn = row_norms(x) if x_sqnorm is None else x_sqnorm.to(torch.float32)
        yn = row_norms(y) if y_sqnorm is None else y_sqnorm.to(torch.float32)
        d2 = torch.clamp(xn[:, None] + yn[None, :] - 2.0 * dot, min=0.0)
        return torch.sqrt(d2) if metric == DistanceType.L2SqrtExpanded else d2
    xn = row_norms(x, squared=False) if x_sqnorm is None else torch.sqrt(x_sqnorm.to(torch.float32))
    yn = row_norms(y, squared=False) if y_sqnorm is None else torch.sqrt(y_sqnorm.to(torch.float32))
    denom = xn[:, None] * yn[None, :]
    return 1.0 - dot / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def pairwise_distance(
    x,
    y,
    metric=DistanceType.L2SqrtExpanded,
    metric_arg: float = 2.0,
    x_sqnorm: Optional[torch.Tensor] = None,
    y_sqnorm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The full [m, n] pairwise distance matrix
    (``raft::distance::pairwise_distance``). ``metric_arg`` is kept for
    signature parity; no supported metric reads it."""
    metric = resolve_metric(metric)
    expects(metric != DistanceType.Precomputed, "Precomputed is not a computable metric")
    x = torch.as_tensor(x)
    y = torch.as_tensor(y)
    expects(x.ndim == 2 and y.ndim == 2, "pairwise_distance expects 2-D inputs")
    expects(x.shape[1] == y.shape[1], "feature dims differ: %d vs %d", x.shape[1], y.shape[1])
    return expanded_distance(x, y, metric, x_sqnorm, y_sqnorm)
