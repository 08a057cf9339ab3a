"""K-means (Lloyd) with k-means++ init (``raft_tpu.cluster.kmeans``
counterpart; reference ``cluster/kmeans.cuh:89``).

The EM loop, E step and M step follow the JAX package step for step:
the loop runs while ``it < max_iter`` and the squared center shift is
above ``tol²``, empty clusters keep their previous center, and a final E
step makes labels and inertia match the returned centers. With the same
initial centers (``init="array"``) both packages walk the same
trajectory. Random draws come from an explicit ``torch.Generator``
seeded with ``params.seed``, so ``random``/``kmeans++`` inits differ from
``jax.random``'s.

``algorithm="flash"`` is the Flash-KMeans E step: sample norms cached once
per fit and reused by every iteration, rows assigned in blocks. The JAX
package also skips center tiles by a norm bound; that skip never changes
a label, and a data-dependent skip costs a host round trip per tile on a
GPU, so the port computes every tile.

``find_k`` is JAX's search (exhaustive over a range of 24 or less, else
ternary, each fit cached). ``fit_minibatch`` is JAX's update (the
running-count learning rate, ``n_epochs * (n // batch_samples)`` steps, a
final full :func:`predict`); its batches and its k-means++ init draw from
the fit's ``torch.Generator`` where JAX splits Threefry keys, so its
centers differ from JAX's by design.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.ops.distance import (DistanceType, is_min_close, pairwise_distance,
                                         resolve_metric, row_norms)
from raft_tpu_torch.ops.fused_1nn import min_cluster_and_distance, normalize_rows


@dataclasses.dataclass
class KMeansParams:
    """``cluster/kmeans_types.hpp:38-70`` analog."""

    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    init: str = "kmeans++"  # "kmeans++" | "random" | "array"
    n_init: int = 1
    metric: DistanceType = DistanceType.L2Expanded
    seed: int = 0
    oversampling_factor: float = 2.0  # kept for param parity; unused by Lloyd
    batch_samples: int = 1 << 15  # kept for param parity
    algorithm: str = "lloyd"  # "lloyd" | "flash"


@dataclasses.dataclass
class KMeansOutput:
    centroids: torch.Tensor  # [k, d] f32
    labels: torch.Tensor  # [n] i32
    inertia: float
    n_iter: int


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def kmeans_plus_plus(gen: torch.Generator, X: torch.Tensor, k: int, sample_weights=None) -> torch.Tensor:
    """k-means++ seeding: first center uniform, then each next center drawn
    with probability proportional to (weighted) squared distance to the
    nearest chosen center."""
    n, d = X.shape
    w = torch.ones((n,), device=X.device) if sample_weights is None else sample_weights.float()
    first = int(torch.randint(0, n, (1,), generator=gen, device=X.device))
    centers = torch.zeros((k, d), dtype=torch.float32, device=X.device)
    centers[0] = X[first]
    min_d2 = torch.sum((X - X[first]) ** 2, dim=1)
    for i in range(1, k):
        p = torch.clamp(w * min_d2, min=1e-30)
        idx = torch.multinomial(p, 1, generator=gen)
        c = X[idx[0]]
        centers[i] = c
        min_d2 = torch.minimum(min_d2, torch.sum((X - c) ** 2, dim=1))
    return centers


def segment_sum(values, labels, k: int, batched: bool = False) -> torch.Tensor:
    """Per label in ``[0, k)`` the f32 sum of the rows of ``values [n, ...]``
    with that label: ``[k, ...]`` (``batched``: ``values [B, n, ...]``,
    ``labels [B, n]`` -> ``[B, k, ...]``).

    The sums are exact integer sums, so they come out the same in any
    order: each value becomes an int64 multiple of ``2^-e``, with ``e`` the
    largest exponent for which ``n * max|value|`` stays under ``2^62``, the
    integers are added with ``index_add_`` and the sum is rounded once to
    f32. A build then gives the same bits on every run; float sums with
    CUDA's ``index_add_`` and ``scatter_add_`` add with atomics in an order
    that changes from run to run. The quantization step is at most ``n *
    max|value| * 2^-61``. Of the fixed-order sums held against each other
    on an H100 (``chip_determinism.py``: also ``index_put_(accumulate=True)``
    and a sort with ``segment_reduce``), this one gives the fastest builds:
    the other two add each label's rows one after another, which is slow for
    the narrow rows of the counts and codebook updates."""
    lab = labels.to(torch.int64)
    if batched:
        B, n = lab.shape
        flat = (lab + k * torch.arange(B, device=lab.device)[:, None]).reshape(-1)
        out = segment_sum(values.reshape((B * n,) + tuple(values.shape[2:])), flat, B * k)
        return out.reshape((B, k) + tuple(values.shape[2:]))
    v = values.to(torch.float64)
    top = float(torch.max(torch.abs(v))) if v.numel() else 0.0
    expects(math.isfinite(top), "segment_sum needs finite values")
    e = 0 if top == 0.0 else min(1000, 62 - math.ceil(math.log2(top * max(1, v.shape[0]))))
    q = torch.round(v * 2.0 ** e).to(torch.int64)
    out = torch.zeros((k,) + tuple(v.shape[1:]), dtype=torch.int64, device=v.device)
    return (out.index_add_(0, lab, q).to(torch.float64) * 2.0 ** -e).to(torch.float32)


def update_centroids(X, labels, k: int, old_centroids, weights):
    """M step: weighted mean of assigned points; empty clusters keep their
    previous centroid. Returns ``(centroids, counts)``."""
    sums = segment_sum(X * weights[:, None], labels, k)
    counts = segment_sum(weights, labels, k)
    means = sums / torch.clamp(counts[:, None], min=1e-9)
    return torch.where(counts[:, None] > 0, means, old_centroids), counts


def flash_norm_cache(X, metric=DistanceType.L2Expanded):
    """Per-dataset arrays the flash E step reuses across EM iterations:
    ``(rows, squared norms, norms)`` — unit rows for cosine."""
    metric = resolve_metric(metric)
    X = torch.as_tensor(X).to(torch.float32)
    if metric == DistanceType.CosineExpanded:
        X = normalize_rows(X)
    xn = row_norms(X)
    return (X, xn, torch.sqrt(xn))


def flash_min_cluster_and_distance(
    X,
    centroids,
    metric=DistanceType.L2Expanded,
    cache=None,
    row_block: int = 65536,
):
    """Same labels and distances as :func:`min_cluster_and_distance`, with
    the sample norms taken from ``cache`` (:func:`flash_norm_cache`)."""
    metric = resolve_metric(metric)
    if cache is None:
        cache = flash_norm_cache(X, metric)
    Xc, xn, _ = cache
    c = torch.as_tensor(centroids).to(device=Xc.device, dtype=torch.float32)
    if metric == DistanceType.InnerProduct:
        return min_cluster_and_distance(Xc, c, metric)
    if metric == DistanceType.CosineExpanded:
        c = normalize_rows(c)
    cn = row_norms(c)
    pad = torch.isinf(cn)[None, :]
    labels, vals = [], []
    for s in range(0, Xc.shape[0], row_block):
        dot = Xc[s : s + row_block] @ c.T
        d2 = torch.clamp(xn[s : s + row_block, None] + cn[None, :] - 2.0 * dot, min=0.0)
        d2 = torch.where(pad, torch.full_like(d2, float("inf")), d2)
        v, i = torch.min(d2, dim=1)
        vals.append(v)
        labels.append(i.to(torch.int32))
    v = torch.cat(vals)
    lab = torch.cat(labels)
    if metric == DistanceType.CosineExpanded:
        return lab, 0.5 * v
    if metric in (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded):
        v = torch.sqrt(v)
    return lab, v


def _lloyd(X, init_centers, k: int, metric, max_iter: int, tol: float, weights, flash: bool):
    if flash:
        cache = flash_norm_cache(X, metric)

        def assign(c):
            return flash_min_cluster_and_distance(X, c, metric=metric, cache=cache)
    else:

        def assign(c):
            return min_cluster_and_distance(X, c, metric=metric)

    tol2 = float(torch.tensor(tol * tol, dtype=torch.float32))  # f32, as the JAX carry
    centers = init_centers
    it, shift2 = 0, float("inf")
    while it < max_iter and shift2 > tol2:
        labels, _ = assign(centers)
        new_centers, _ = update_centroids(X, labels, k, centers, weights)
        shift2 = float(torch.sum((new_centers - centers) ** 2))
        centers = new_centers
        it += 1
    labels, dists = assign(centers)
    return KMeansOutput(
        centroids=centers, labels=labels, inertia=float(torch.sum(weights * dists)), n_iter=it
    )


def fit(
    X,
    params: Optional[KMeansParams] = None,
    centroids: Optional[torch.Tensor] = None,
    sample_weights: Optional[torch.Tensor] = None,
    res: Optional[Resources] = None,
    **kwargs,
) -> KMeansOutput:
    """Lloyd EM (``kmeans::fit``). ``X`` is taken on its own device. With
    :mod:`raft_tpu_torch.obs` enabled: ``kmeans.fit.calls{init}``,
    ``.samples``, synced ``kmeans.fit.init`` and ``kmeans.fit.lloyd`` spans
    a trial and the ``.n_iter`` histogram."""
    if params is None:
        params = KMeansParams(**kwargs)
    metric = resolve_metric(params.metric)
    X = torch.as_tensor(X).to(torch.float32)
    if res is not None:
        X = X.to(res.device)
    expects(X.ndim == 2, "X must be [n_samples, n_features]")
    n, d = X.shape
    k = params.n_clusters
    expects(0 < k <= n, "n_clusters=%d out of range for %d samples", k, n)
    expects(
        params.init != "array" or centroids is not None,
        "init='array' requires an explicit centroids argument",
    )
    expects(
        params.algorithm in ("lloyd", "flash"),
        "algorithm must be 'lloyd' or 'flash', got %s", params.algorithm,
    )
    weights = (
        torch.ones((n,), dtype=torch.float32, device=X.device)
        if sample_weights is None
        else torch.as_tensor(sample_weights).to(device=X.device, dtype=torch.float32)
    )
    expects(tuple(weights.shape) == (n,), "sample_weights must be [n_samples]")
    min_close = is_min_close(metric)
    if obs.is_enabled():
        obs.inc("kmeans.fit.calls", init=str(params.init if centroids is None else "array"))
        obs.inc("kmeans.fit.samples", float(n))
    gen = make_generator(params.seed, X.device)
    best = None
    for trial in range(max(1, params.n_init)):
        with obs.span("kmeans.fit.init", k=k, n=n, trial=trial) as sp:
            if centroids is not None:
                init_centers = torch.as_tensor(centroids).to(device=X.device, dtype=torch.float32)
                expects(tuple(init_centers.shape) == (k, d), "explicit centroids shape mismatch")
            elif params.init == "random":
                idx = torch.randperm(n, generator=gen, device=X.device)[:k]
                init_centers = X[idx]
            else:
                init_centers = kmeans_plus_plus(gen, X, k, sample_weights)
            sp.sync(init_centers)
        with obs.span("kmeans.fit.lloyd", k=k, n=n, trial=trial, algorithm=params.algorithm) as sp:
            out = _lloyd(X, init_centers, k, metric, params.max_iter, params.tol, weights,
                         flash=params.algorithm == "flash")
            sp.sync(out.centroids)
        if obs.is_enabled():
            obs.observe("kmeans.fit.n_iter", float(out.n_iter))
        better = best is None or (
            out.inertia < best.inertia if min_close else out.inertia > best.inertia
        )
        if better:
            best = out
        if centroids is not None:
            break
    return best


def predict(X, centroids, metric=DistanceType.L2Expanded) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign samples to nearest centroids. Returns ``(labels, distances)``."""
    return min_cluster_and_distance(torch.as_tensor(X).to(torch.float32), centroids, metric=metric)


def fit_predict(X, params: Optional[KMeansParams] = None, **kwargs) -> Tuple[KMeansOutput, torch.Tensor]:
    """:func:`fit`, then the labels of its final E step."""
    out = fit(X, params, **kwargs)
    return out, out.labels


def transform(X, centroids, metric=DistanceType.L2Expanded) -> torch.Tensor:
    """Distances to every centroid (``kmeans::transform``): ``[n, k]``."""
    return pairwise_distance(torch.as_tensor(X).to(torch.float32), centroids, metric=metric)


def inertia(X, centroids, metric=DistanceType.L2Expanded) -> torch.Tensor:
    """Sum of each sample's distance to its nearest centroid (a 0-dim
    tensor on the data's device)."""
    _, dists = predict(X, centroids, metric)
    return torch.sum(dists)


def cluster_dispersion(centroids, cluster_sizes) -> torch.Tensor:
    """Cluster dispersion (``stats/dispersion.cuh:85``): sqrt of the
    size-weighted squared distances between the centroids and their
    size-weighted mean."""
    c = torch.as_tensor(centroids).to(torch.float32)
    w = torch.as_tensor(cluster_sizes).to(device=c.device, dtype=torch.float32)
    total = torch.clamp(torch.sum(w), min=1.0)
    g = torch.sum(c * w[:, None], dim=0) / total
    return torch.sqrt(torch.sum(w * torch.sum((c - g) ** 2, dim=1)))


def find_k(X, kmax: int, kmin: int = 1, max_iter: int = 100, tol: float = 1e-2,
           seed: int = 0) -> Tuple[int, float, int]:
    """Auto-select k (``kmeans::find_k``): the k in ``[max(2, kmin), kmax]``
    maximizing ``(n - k) / (k - 1) * dispersion(k) / inertia(k)``, by
    exhaustive search over a range of 24 or less and a ternary search
    above that, each k fitted once (cached). Returns ``(best_k, inertia,
    n_iter)`` of the best fit."""
    X = torch.as_tensor(X).to(torch.float32)
    n = X.shape[0]
    expects(1 <= kmin <= kmax <= n, "need 1 <= kmin <= kmax <= n")
    cache = {}

    def objective(k):
        if k not in cache:
            out = fit(X, KMeansParams(n_clusters=k, max_iter=max_iter, tol=tol, seed=seed))
            sizes = torch.bincount(out.labels.to(torch.int64), minlength=k)
            disp = float(cluster_dispersion(out.centroids, sizes))
            inert = max(out.inertia, 1e-20)
            cache[k] = ((n - k) / max(k - 1, 1) * disp / inert, out)
        return cache[k]

    def best_of(ks):
        best = max(ks, key=lambda k: objective(k)[0])
        out = objective(best)[1]
        return best, out.inertia, out.n_iter

    left, right = max(2, kmin), kmax
    if left >= right:
        return best_of([right])
    if right - left <= 24:
        # small range: every k (the slope-sign bisection walks the wrong way
        # when the objective is monotone, e.g. the true k at kmin)
        return best_of(range(left, right + 1))
    while right - left > 2:
        m1 = left + (right - left) // 3
        m2 = right - (right - left) // 3
        if objective(m1)[0] < objective(m2)[0]:
            left = m1 + 1
        else:
            right = m2 - 1
    return best_of(range(left, right + 1))


def fit_minibatch(X, params: Optional[KMeansParams] = None, n_epochs: int = 10,
                  res: Optional[Resources] = None, **kwargs) -> KMeansOutput:
    """Mini-batch Lloyd: each step assigns ``batch_samples`` rows drawn
    with replacement and moves each center by the running-count learning
    rate (sklearn's ``MiniBatchKMeans`` update), ``max(1, n_epochs * (n //
    batch_samples))`` steps from a k-means++ init on a ``batch_samples``
    subsample; then one full :func:`predict`. Draws come from a
    ``torch.Generator`` seeded with ``params.seed``. ``n_iter`` is the
    step count."""
    if params is None:
        params = KMeansParams(**kwargs)
    metric = resolve_metric(params.metric)
    X = torch.as_tensor(X).to(torch.float32)
    if res is not None:
        X = X.to(res.device)
    n, _ = X.shape
    k = params.n_clusters
    b = int(min(params.batch_samples, n))
    expects(0 < k <= b, "n_clusters=%d must be <= batch_samples=%d", k, b)
    gen = make_generator(params.seed, X.device)
    init_idx = torch.randperm(n, generator=gen, device=X.device)[:b]
    centers = kmeans_plus_plus(gen, X[init_idx], k)
    steps = max(1, n_epochs * (n // b))
    counts = torch.zeros((k,), dtype=torch.float32, device=X.device)
    ones = torch.ones((b,), dtype=torch.float32, device=X.device)
    for _ in range(steps):
        batch = X[torch.randint(0, n, (b,), generator=gen, device=X.device)]
        labels, _ = min_cluster_and_distance(batch, centers, metric=metric)
        bsum = segment_sum(batch, labels, k)
        bcnt = segment_sum(ones, labels, k)
        counts = counts + bcnt
        lr = torch.where(counts > 0, bcnt / torch.clamp(counts, min=1.0), torch.zeros_like(counts))
        bmean = bsum / torch.clamp(bcnt[:, None], min=1e-9)
        centers = torch.where((bcnt > 0)[:, None], centers + lr[:, None] * (bmean - centers),
                              centers)
    labels, dists = min_cluster_and_distance(X, centers, metric=metric)
    return KMeansOutput(centroids=centers, labels=labels, inertia=float(torch.sum(dists)),
                        n_iter=steps)
