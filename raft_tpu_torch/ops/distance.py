"""Pairwise distances (``raft_tpu.ops.distance`` counterpart).

``DistanceType`` keeps every enum value of the JAX package (and of the
reference's ``distance/distance_types.hpp:23-68``), so serialized indexes
carry the same metric ids. Every metric but ``Precomputed`` is computed,
in the JAX package's two families:

* the matmul family (:data:`EXPANDED`: L2, cosine, inner product,
  correlation, Jaccard, Hellinger, Russel-Rao, Dice): one f32 ``x @ y.T``
  plus an epilogue of row statistics with JAX's zero guards and clamps;
* the accumulation family (L1, L2 and L2Sqrt unexpanded, Linf, Canberra,
  Lp, Bray-Curtis, Hamming, KL divergence, Jensen-Shannon): an
  elementwise step a feature chunk, combined over chunks (a sum, Linf a
  max) and finalized, with the chunk cut so the step's ``[m, n, chunk]``
  temporaries (:func:`accum_live_blocks` of them) stay within
  :data:`ACCUM_TEMP_BYTES`;

and ``Haversine`` on ``d == 2`` points. The JAX package leaves all of
this to XLA, so it is plain PyTorch here too.

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

#: the matmul family: one f32 ``x @ y.T`` plus an epilogue of row statistics
EXPANDED = frozenset(
    {
        DistanceType.L2Expanded,
        DistanceType.L2SqrtExpanded,
        DistanceType.CosineExpanded,
        DistanceType.InnerProduct,
        DistanceType.CorrelationExpanded,
        DistanceType.JaccardExpanded,
        DistanceType.HellingerExpanded,
        DistanceType.RusselRaoExpanded,
        DistanceType.DiceExpanded,
    }
)

#: bytes the accumulation family's ``[m, n, chunk]`` temporaries may take
#: (JAX's 256 MiB); the feature chunk is cut to fit them
ACCUM_TEMP_BYTES = 256 << 20

#: ``[m, n, chunk]`` f32 blocks an accumulation step holds at its peak:
#: eager PyTorch materializes every elementwise op (XLA fuses them), so
#: a step is 2 blocks (the difference and its abs or square), and the
#: zero-guarded bodies hold more (their ``where`` operands)
_ACCUM_LIVE_BLOCKS = {DistanceType.Canberra: 6, DistanceType.JensenShannon: 5}


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


def _safe(denom: torch.Tensor) -> torch.Tensor:
    """``denom`` with its zeros replaced by 1 (the 0/0 guards)."""
    return torch.where(denom == 0.0, torch.ones_like(denom), denom)


def _row_sums(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v.to(torch.float32), dim=-1)


def expanded_epilogue(dot, x, y, metric: DistanceType, xb, yb, x_sqnorm=None, y_sqnorm=None):
    """The matmul family's epilogue on ``dot`` (for Hellinger: the product
    of the rows' square roots). ``xb`` and ``yb`` put a row statistic of
    ``x`` or ``y`` where it broadcasts against ``dot``: ``[:, None]`` and
    ``[None, :]`` for a pairwise ``[m, n]``, ``[:, None]`` and as-is for
    refine's ``[nq, n_cand]``. Guards and clamps are the JAX package's."""
    d = x.shape[-1]
    if metric == DistanceType.InnerProduct:
        return dot
    if metric == DistanceType.HellingerExpanded:
        # rectify negatives from rounding before the sqrt
        return torch.sqrt(torch.clamp(1.0 - dot, min=0.0))
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        xn = row_norms(x) if x_sqnorm is None else x_sqnorm.to(torch.float32)
        yn = row_norms(y) if y_sqnorm is None else y_sqnorm.to(torch.float32)
        d2 = torch.clamp(xb(xn) + yb(yn) - 2.0 * dot, min=0.0)
        return torch.sqrt(d2) if metric == DistanceType.L2SqrtExpanded else d2
    if metric == DistanceType.CosineExpanded:
        xn = row_norms(x, squared=False) if x_sqnorm is None else torch.sqrt(x_sqnorm.to(torch.float32))
        yn = row_norms(y, squared=False) if y_sqnorm is None else torch.sqrt(y_sqnorm.to(torch.float32))
        return 1.0 - dot / _safe(xb(xn) * yb(yn))
    if metric == DistanceType.CorrelationExpanded:
        # 1 - (d*dot - sx*sy) / sqrt((d*x2 - sx^2)(d*y2 - sy^2))
        sx, sy = _row_sums(x), _row_sums(y)
        numer = d * dot - xb(sx) * yb(sy)
        q = d * row_norms(x) - sx * sx
        r = d * row_norms(y) - sy * sy
        denom = torch.sqrt(torch.clamp(xb(q) * yb(r), min=0.0))
        return 1.0 - numer / _safe(denom)
    if metric == DistanceType.JaccardExpanded:
        # 1 - dot / (|x| + |y| - dot), 0/0 -> similarity 0
        union = xb(_row_sums(x)) + yb(_row_sums(y)) - dot
        return 1.0 - torch.where(union == 0.0, torch.zeros_like(dot), dot / _safe(union))
    if metric == DistanceType.DiceExpanded:
        # 1 - 2 dot / (|x| + |y|), 0/0 -> similarity 0
        denom = xb(_row_sums(x)) + yb(_row_sums(y))
        return 1.0 - torch.where(denom == 0.0, torch.zeros_like(dot), 2.0 * dot / _safe(denom))
    if metric == DistanceType.RusselRaoExpanded:
        return (d - dot) / d
    fail("not an expanded metric: %s", metric)


def expanded_distance(
    x: torch.Tensor,
    y: torch.Tensor,
    metric: DistanceType,
    x_sqnorm: Optional[torch.Tensor] = None,
    y_sqnorm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Matmul + epilogue. ``x`` [m, d], ``y`` [n, d] -> [m, n] f32.
    ``x_sqnorm``/``y_sqnorm`` pass precomputed squared norms."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    if metric == DistanceType.HellingerExpanded:
        xf, yf = torch.sqrt(xf), torch.sqrt(yf)
    return expanded_epilogue(xf @ yf.T, x, y, metric, lambda s: s[:, None],
                             lambda s: s[None, :], x_sqnorm, y_sqnorm)


# ---------------------------------------------------------------------------
# Accumulation family
# ---------------------------------------------------------------------------


def kl_term(a, b) -> torch.Tensor:
    """Elementwise ``a * (log a - log b)``, zero-guarded as the reference's
    functor: ``a == 0`` terms vanish, ``b == 0`` drops the log-b term.
    Shared by the dense engine and the sparse path."""
    one = torch.ones_like(a)
    la = torch.log(torch.where(a == 0.0, one, a))
    lb = torch.where(b == 0.0, torch.zeros_like(b), torch.log(torch.where(b == 0.0, torch.ones_like(b), b)))
    return a * (la - lb)


def js_term(a, b) -> torch.Tensor:
    """Elementwise Jensen-Shannon contribution ``-a (log m - log a) -
    b (log m - log b)``, ``m = (a + b) / 2``, zero-guarded. Finalize with
    ``sqrt(max(0.5 * sum, 0))``."""
    m = 0.5 * (a + b)
    lm = torch.where(m == 0.0, torch.zeros_like(m), torch.log(torch.where(m == 0.0, torch.ones_like(m), m)))
    la = torch.log(torch.where(a == 0.0, torch.ones_like(a), a))
    lb = torch.log(torch.where(b == 0.0, torch.ones_like(b), b))
    return -a * (lm - la) - b * (lm - lb)


def haversine_core(lat1, lon1, lat2, lon2) -> torch.Tensor:
    """Great-circle distance from broadcast-compatible (lat, lon in
    radians) components. Shared by the pairwise engine and ball cover."""
    sin_0 = torch.sin(0.5 * (lat1 - lat2))
    sin_1 = torch.sin(0.5 * (lon1 - lon2))
    rdist = sin_0 * sin_0 + torch.cos(lat1) * torch.cos(lat2) * sin_1 * sin_1
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(rdist, 0.0, 1.0)))


def accum_step(xb: torch.Tensor, yb: torch.Tensor, metric: DistanceType, p: float) -> torch.Tensor:
    """One feature chunk's contribution of broadcast f32 operands (``[m, 1,
    dc]`` against ``[1, n, dc]``, or refine's ``[nq, 1, d]`` against
    ``[nq, n_cand, d]``), reduced over the last axis. BrayCurtis stacks
    its two sums on a new axis 0. The bodies are the JAX package's."""
    if metric == DistanceType.L1:
        return torch.sum(torch.abs(xb - yb), dim=-1)
    if metric in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
        diff = xb - yb
        return torch.sum(diff * diff, dim=-1)
    if metric == DistanceType.Linf:
        return torch.amax(torch.abs(xb - yb), dim=-1)
    if metric == DistanceType.Canberra:
        diff = torch.abs(xb - yb)
        add = torch.abs(xb) + torch.abs(yb)
        return torch.sum(torch.where(add == 0.0, torch.zeros_like(diff), diff / _safe(add)), dim=-1)
    if metric == DistanceType.LpUnexpanded:
        return torch.sum(torch.abs(xb - yb) ** p, dim=-1)
    if metric == DistanceType.BrayCurtis:
        return torch.stack([torch.sum(torch.abs(xb - yb), dim=-1),
                            torch.sum(torch.abs(xb + yb), dim=-1)], dim=0)
    if metric == DistanceType.HammingUnexpanded:
        return torch.sum((xb != yb).to(torch.float32), dim=-1)
    if metric == DistanceType.KLDivergence:
        return torch.sum(kl_term(xb, yb), dim=-1)
    if metric == DistanceType.JensenShannon:
        return torch.sum(js_term(xb, yb), dim=-1)
    fail("not an accumulation metric: %s", metric)


def accum_live_blocks(metric: DistanceType) -> int:
    """Peak ``[m, n, chunk]`` f32 blocks of :func:`accum_step` under
    ``metric``; the budgets of :func:`accum_distance` and brute force's
    tile divide by it."""
    return _ACCUM_LIVE_BLOCKS.get(metric, 2)


def accum_combine(acc: torch.Tensor, contrib: torch.Tensor, metric: DistanceType) -> torch.Tensor:
    if metric == DistanceType.Linf:
        return torch.maximum(acc, contrib)
    return acc + contrib


def accum_finalize(acc: torch.Tensor, metric: DistanceType, p: float, d: int) -> torch.Tensor:
    if metric == DistanceType.L2SqrtUnexpanded:
        return torch.sqrt(acc)
    if metric == DistanceType.LpUnexpanded:
        return acc ** (1.0 / p)
    if metric == DistanceType.HammingUnexpanded:
        return acc / d
    if metric == DistanceType.JensenShannon:
        return torch.sqrt(torch.clamp(0.5 * acc, min=0.0))
    if metric == DistanceType.BrayCurtis:
        num, den = acc[0], acc[1]
        return torch.where(den == 0.0, torch.zeros_like(num), num / _safe(den))
    return acc


def accum_distance(x: torch.Tensor, y: torch.Tensor, metric: DistanceType, p: float) -> torch.Tensor:
    """The accumulation family: ``d`` in chunks, so the step's
    ``[m, n, chunk]`` temporaries stay within :data:`ACCUM_TEMP_BYTES`
    (JAX's chunking; a ``[m, n, d]`` broadcast at serving sizes would not
    fit on the card)."""
    m, d = x.shape
    n = y.shape[0]
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    block_bytes = 4 * accum_live_blocks(metric)
    chunk = max(1, min(d, (ACCUM_TEMP_BYTES // block_bytes) // max(1, m * n)))
    acc = None
    for s in range(0, d, chunk):
        step = accum_step(xf[:, None, s : s + chunk], yf[None, :, s : s + chunk], metric, p)
        acc = step if acc is None else accum_combine(acc, step, metric)
    return accum_finalize(acc, metric, p, d)


def tile_distances(q, q_sqnorm, y, yn, metric: DistanceType, p: float) -> torch.Tensor:
    """One ``[batch, tile]`` block for brute force and refine (JAX's
    ``_tile_distances``): the matmul family with precomputed norms, the
    accumulation family broadcast whole (the caller sizes the tile so
    that ``batch * tile * d`` fits)."""
    if metric in EXPANDED:
        return expanded_distance(q, y, metric, q_sqnorm, yn)
    acc = accum_step(q.to(torch.float32)[:, None, :], y.to(torch.float32)[None, :, :], metric, p)
    return accum_finalize(acc, metric, p, q.shape[1])


def pairwise_distance(
    x,
    y,
    metric=DistanceType.L2SqrtExpanded,
    metric_arg: float = 2.0,
    x_sqnorm: Optional[torch.Tensor] = None,
    y_sqnorm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The full [m, n] pairwise distance matrix
    (``raft::distance::pairwise_distance``). ``metric`` is a
    :class:`DistanceType`, its value or a string alias; ``metric_arg`` is
    the Minkowski ``p`` of ``LpUnexpanded``."""
    metric = resolve_metric(metric)
    expects(metric != DistanceType.Precomputed, "Precomputed is not a computable metric")
    x = torch.as_tensor(x)
    y = torch.as_tensor(y)
    expects(x.ndim == 2 and y.ndim == 2, "pairwise_distance expects 2-D inputs")
    expects(x.shape[1] == y.shape[1], "feature dims differ: %d vs %d", x.shape[1], y.shape[1])
    if metric == DistanceType.Haversine:
        expects(x.shape[1] == 2, "Haversine requires 2-D (lat, lon) points")
        xf, yf = x.to(torch.float32), y.to(torch.float32)
        return haversine_core(xf[:, 0:1], xf[:, 1:2], yf[None, :, 0], yf[None, :, 1])
    if metric in EXPANDED:
        return expanded_distance(x, y, metric, x_sqnorm, y_sqnorm)
    return accum_distance(x, y, metric, float(metric_arg))
