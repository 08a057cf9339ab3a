"""Hierarchical balanced k-means (``raft_tpu.cluster.kmeans_balanced``
counterpart; reference ``cluster/detail/kmeans_balanced.cuh:952``).

The trainer behind IVF-Flat. Same three phases as the JAX package:

1. mesoclusters: Lloyd with ``≈√k`` clusters (random init) on a
   trainset subsample;
2. fine clusters: per mesocluster a weighted Lloyd (0/1 weights) with a
   proportional share of ``k``; for L2 every mesocluster trains at one
   padded ``k`` with unused centers parked at a far sentinel;
3. balancing EM: full-data EM where clusters below ``avg * threshold``
   are nudged toward points drawn from crowded clusters.

The random draws (subsample, seeds, adjust candidates) come from a
``torch.Generator`` seeded with ``params.seed``; they cannot match
``jax.random``'s, so the two packages train different centers from the
same seed. With injected centers the EM steps match.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans import (
    KMeansParams,
    fit as kmeans_fit,
    flash_min_cluster_and_distance,
    flash_norm_cache,
    kmeans_plus_plus,
    make_generator,
    segment_sum,
)
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric
from raft_tpu_torch.ops.fused_1nn import min_cluster_and_distance

# Reference constant kAdjustCentersWeight (kmeans_balanced.cuh:78).
_ADJUST_WEIGHT = 7.0


@dataclasses.dataclass
class BalancedKMeansParams:
    """``kmeans_balanced_params`` analog."""

    n_clusters: int = 8
    n_iters: int = 20  # balancing EM iterations
    metric: DistanceType = DistanceType.L2Expanded
    seed: int = 0
    max_train_points_per_cluster: int = 256
    balancing_threshold: float = 0.25


def _segment_mean(X, labels, k: int, weights=None, min_count: float = 1.0):
    w = torch.ones((X.shape[0],), dtype=torch.float32, device=X.device) if weights is None else weights
    sums = segment_sum(X * w[:, None] if weights is not None else X, labels, k)
    counts = segment_sum(w, labels, k)
    return sums / torch.clamp(counts[:, None], min=min_count), counts


def _weighted_lloyd(X, weights, init_centers, *, k: int, metric, n_iters: int):
    """Lloyd restricted to ``weights``-selected points."""
    cache = flash_norm_cache(X, metric)
    centers = init_centers
    for _ in range(n_iters):
        labels, _ = flash_min_cluster_and_distance(X, centers, metric=metric, cache=cache)
        means, counts = _segment_mean(X, labels, k, weights, min_count=1e-9)
        centers = torch.where(counts[:, None] > 0, means, centers)
    return centers


def draw_proportional(gen: torch.Generator, p, m: int) -> torch.Tensor:
    """``m`` indices drawn with replacement in proportion to ``p`` (> 0,
    finite) by inverse CDF over exact int64 prefix sums: ``p`` as int64
    multiples of ``2^-e`` (the largest ``e`` with ``sum(p) < 2^52``), a
    uniform integer below the total, a binary search. Integer sums come out
    the same in any order, so the draws are the same on every run;
    ``torch.multinomial`` on the card draws against a float prefix sum
    whose last bits change from run to run. The uniform integer is a
    53-bit draw scaled to the total: ``torch.randint`` below a total that
    is not a power of two reduces a 64-bit draw modulo it, which favours
    small integers by up to 25 % when the total is near ``2^62``."""
    pf = p.to(torch.float64)
    e = min(1000, 52 - math.ceil(math.log2(float(torch.sum(pf)))))
    cdf = torch.cumsum(torch.round(pf * 2.0 ** e).to(torch.int64), dim=0)
    total = int(cdf[-1])
    u = torch.randint(0, 2 ** 53, (m,), generator=gen, device=p.device, dtype=torch.int64)
    t = torch.clamp(torch.floor(u.to(torch.float64) * (total / 2.0 ** 53)).to(torch.int64), max=total - 1)
    return torch.searchsorted(cdf, t, right=True)


def _adjust_centers(gen, X, centers, labels, counts, threshold: float):
    """Re-seed under-populated clusters toward random data points drawn in
    proportion to the population of the point's cluster."""
    k = centers.shape[0]
    avg = X.shape[0] / k
    small = counts < (avg * threshold)
    p = torch.clamp(counts[labels.to(torch.int64)], min=1e-9)
    idx = draw_proportional(gen, p, k)
    blended = (centers * _ADJUST_WEIGHT + X[idx]) / (_ADJUST_WEIGHT + 1.0)
    return torch.where(small[:, None], blended, centers), int(small.sum())


def _em_iters(gen, X, centers, k: int, metric, n_iters: int, threshold: float):
    """Balancing EM: assignment + mean update + center adjustment, then a
    final pure-mean pass."""
    cache = flash_norm_cache(X, metric)

    def assign(c):
        return flash_min_cluster_and_distance(X, c, metric=metric, cache=cache)

    for _ in range(n_iters):
        labels, _ = assign(centers)
        means, counts = _segment_mean(X, labels, k)
        centers = torch.where(counts[:, None] > 0, means, centers)
        centers, _ = _adjust_centers(gen, X, centers, labels, counts, threshold)
    labels, _ = assign(centers)
    means, counts = _segment_mean(X, labels, k)
    return torch.where(counts[:, None] > 0, means, centers)


def fit(
    X,
    params: Optional[BalancedKMeansParams] = None,
    res: Optional[Resources] = None,
    **kwargs,
) -> torch.Tensor:
    """Train balanced cluster centers; returns ``centroids [k, d] f32`` on
    ``X``'s device."""
    if params is None:
        params = BalancedKMeansParams(**kwargs)
    metric = resolve_metric(params.metric)
    X = torch.as_tensor(X).to(torch.float32)
    if res is not None:
        X = X.to(res.device)
    expects(X.ndim == 2, "X must be 2-D")
    n, d = X.shape
    k = params.n_clusters
    expects(0 < k <= n, "n_clusters=%d out of range for n=%d", k, n)
    gen = make_generator(params.seed, X.device)

    max_train = min(n, k * params.max_train_points_per_cluster)
    if max_train < n:
        Xt = X[torch.randperm(n, generator=gen, device=X.device)[:max_train]]
    else:
        Xt = X
    nt = Xt.shape[0]

    n_meso = int(min(max(1, round(math.sqrt(k))), k))
    if n_meso <= 1 or k <= 8:
        init = kmeans_plus_plus(gen, Xt, k)
        return _em_iters(gen, X, init, k, metric, params.n_iters, params.balancing_threshold)

    meso = kmeans_fit(
        Xt,
        KMeansParams(n_clusters=n_meso, max_iter=20, metric=params.metric,
                     seed=params.seed, init="random"),
    )
    meso_labels, _ = min_cluster_and_distance(Xt, meso.centroids, metric=metric)

    counts = torch.bincount(meso_labels.to(torch.int64), minlength=n_meso).cpu().numpy().astype(np.float64)
    raw = counts / max(counts.sum(), 1.0) * k
    alloc = np.maximum(np.floor(raw).astype(int), 1)
    while alloc.sum() > k:
        alloc[np.argmax(alloc)] -= 1
    while alloc.sum() < k:
        alloc[np.argmax(raw - alloc)] += 1

    l2_family = metric in (
        DistanceType.L2Expanded,
        DistanceType.L2SqrtExpanded,
        DistanceType.L2Unexpanded,
        DistanceType.L2SqrtUnexpanded,
    )
    k_pad = int(alloc.max())
    fine_centers = []
    for m in range(n_meso):
        km = k_pad if l2_family else int(alloc[m])
        weights = (meso_labels == m).to(torch.float32)
        # weighted sample without replacement via Gumbel top-k
        u = torch.rand((nt,), generator=gen, device=X.device)
        g = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
        seed_idx = torch.topk(torch.log(torch.clamp(weights, min=1e-30)) + g, km).indices
        init = Xt[seed_idx]
        if l2_family:
            live = (torch.arange(km, device=X.device) < int(alloc[m]))[:, None]
            init = torch.where(live, init, torch.full_like(init, 1e30))
        out = _weighted_lloyd(Xt, weights, init, k=km, metric=metric, n_iters=8)
        fine_centers.append(out[: int(alloc[m])])
    centers = torch.cat(fine_centers, dim=0)
    return _em_iters(gen, X, centers, k, metric, params.n_iters, params.balancing_threshold)


def predict(X, centroids, metric=DistanceType.L2Expanded) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment ``(labels, distances)``."""
    return min_cluster_and_distance(torch.as_tensor(X).to(torch.float32), centroids, metric=metric)


def fit_predict(X, params: Optional[BalancedKMeansParams] = None, **kwargs):
    """:func:`fit`, then :func:`predict` on the returned centers:
    ``(centers, labels)``."""
    centers = fit(X, params, **kwargs)
    metric = params.metric if params is not None else kwargs.get("metric", DistanceType.L2Expanded)
    labels, _ = predict(torch.as_tensor(X).to(centers.device), centers, metric=metric)
    return centers, labels
