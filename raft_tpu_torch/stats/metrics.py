"""Model metrics (``raft_tpu.stats.metrics`` counterpart; reference
``stats/{accuracy,r2_score,regression_metrics,contingency_matrix,
adjusted_rand_index,rand_index,entropy,mutual_info_score,homogeneity_score,
completeness_score,v_measure,kl_divergence,silhouette_score,dispersion,
information_criterion,trustworthiness_score}.cuh``).

The label-pair metrics go through one contingency matrix (a ``bincount``
of ``true * n_classes + pred``). ``silhouette_score`` and
``trustworthiness_score`` work a block of ``chunk`` rows at a time, so no
``[n, n]`` matrix is held. Results are 0-dim tensors on the inputs'
device (numpy inputs: the CPU).
"""
from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.ops.distance import DistanceType, pairwise_distance
from raft_tpu_torch.ops.select_k import select_k


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _labels(y) -> torch.Tensor:
    return torch.as_tensor(y).to(torch.int64)


def accuracy(predictions, ref_predictions) -> torch.Tensor:
    """``raft::stats::accuracy`` (``stats/accuracy.cuh``)."""
    p = torch.as_tensor(predictions)
    r = torch.as_tensor(ref_predictions).to(p.device)
    expects(p.shape == r.shape, "shape mismatch")
    return torch.mean((p == r).to(torch.float32))


def r2_score(y, y_hat) -> torch.Tensor:
    """``raft::stats::r2_score`` (``stats/r2_score.cuh``)."""
    y = _f32(y)
    y_hat = _f32(y_hat).to(y.device)
    ss_res = torch.sum((y - y_hat) ** 2)
    ss_tot = torch.sum((y - torch.mean(y)) ** 2)
    return 1.0 - ss_res / ss_tot


def regression_metrics(predictions, ref) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mean_abs_error, mean_squared_error, median_abs_error)``
    (``stats/regression_metrics.cuh``); the median of an even count is the
    mean of the middle two, as numpy's."""
    p = _f32(predictions)
    err = torch.abs(p - _f32(ref).to(p.device))
    srt = torch.sort(err.reshape(-1)).values
    m = srt.shape[0]
    med = srt[m // 2] if m % 2 else 0.5 * (srt[m // 2 - 1] + srt[m // 2])
    return torch.mean(err), torch.mean(err * err), med


def contingency_matrix(y_true, y_pred, n_classes: Optional[int] = None) -> torch.Tensor:
    """``[n_classes, n_classes]`` f32 co-occurrence counts
    (``stats/contingency_matrix.cuh``); labels in ``[0, n_classes)``."""
    t = _labels(y_true)
    p = _labels(y_pred).to(t.device)
    expects(t.shape == p.shape and t.ndim == 1, "labels must be matching 1-D")
    if n_classes is None:
        n_classes = int(torch.maximum(torch.max(t), torch.max(p))) + 1
    counts = torch.bincount(t * n_classes + p, minlength=n_classes * n_classes)
    return counts.to(torch.float32).reshape(n_classes, n_classes)


def _pair_sums(c):
    a = torch.sum(c, dim=1)
    b = torch.sum(c, dim=0)
    return (torch.sum(c * (c - 1)) / 2.0, torch.sum(a * (a - 1)) / 2.0,
            torch.sum(b * (b - 1)) / 2.0)


def rand_index(y_true, y_pred) -> torch.Tensor:
    """``raft::stats::rand_index`` (``stats/rand_index.cuh``)."""
    c = contingency_matrix(y_true, y_pred)
    n = torch.sum(c)
    sum_comb_c, sum_comb_a, sum_comb_b = _pair_sums(c)
    total = n * (n - 1) / 2.0
    return (sum_comb_c + (total - sum_comb_a - sum_comb_b + sum_comb_c)) / total


def adjusted_rand_index(y_true, y_pred) -> torch.Tensor:
    """``raft::stats::adjusted_rand_index``
    (``stats/adjusted_rand_index.cuh``)."""
    c = contingency_matrix(y_true, y_pred)
    n = torch.sum(c)
    sum_comb, comb_a, comb_b = _pair_sums(c)
    total = n * (n - 1) / 2.0
    expected = comb_a * comb_b / torch.clamp(total, min=1.0)
    max_index = 0.5 * (comb_a + comb_b)
    return (sum_comb - expected) / torch.clamp(max_index - expected, min=1e-30)


def entropy(labels, n_classes: Optional[int] = None) -> torch.Tensor:
    """Shannon entropy of a labelling in nats (``stats/entropy.cuh``)."""
    y = _labels(labels)
    if n_classes is None:
        n_classes = int(torch.max(y)) + 1
    counts = torch.bincount(y, minlength=n_classes).to(torch.float32)
    p = counts / torch.clamp(torch.sum(counts), min=1.0)
    safe = torch.where(p > 0, p, torch.ones_like(p))
    return -torch.sum(torch.where(p > 0, p * torch.log(safe), torch.zeros_like(p)))


def mutual_info_score(y_true, y_pred, n_classes: Optional[int] = None) -> torch.Tensor:
    """``raft::stats::mutual_info_score`` (``stats/mutual_info_score.cuh``)."""
    c = contingency_matrix(y_true, y_pred, n_classes)
    pij = c / torch.clamp(torch.sum(c), min=1.0)
    denom = torch.sum(pij, dim=1, keepdim=True) * torch.sum(pij, dim=0, keepdim=True)
    ok = (pij > 0) & (denom > 0)
    ratio = torch.where(ok, pij / torch.where(denom > 0, denom, torch.ones_like(denom)),
                        torch.ones_like(pij))
    return torch.sum(torch.where(pij > 0, pij * torch.log(ratio), torch.zeros_like(pij)))


def _ratio_or_one(mi, h):
    return torch.where(h == 0, torch.ones_like(mi), mi / torch.where(h == 0, torch.ones_like(h), h))


def homogeneity_score(y_true, y_pred, n_classes: Optional[int] = None) -> torch.Tensor:
    """``raft::stats::homogeneity_score`` (``stats/homogeneity_score.cuh``):
    MI / H(true)."""
    return _ratio_or_one(mutual_info_score(y_true, y_pred, n_classes), entropy(y_true, n_classes))


def completeness_score(y_true, y_pred, n_classes: Optional[int] = None) -> torch.Tensor:
    """``raft::stats::completeness_score``
    (``stats/completeness_score.cuh``): MI / H(pred)."""
    return _ratio_or_one(mutual_info_score(y_true, y_pred, n_classes), entropy(y_pred, n_classes))


def v_measure(y_true, y_pred, n_classes: Optional[int] = None, beta: float = 1.0) -> torch.Tensor:
    """``raft::stats::v_measure`` (``stats/v_measure.cuh``)."""
    h = homogeneity_score(y_true, y_pred, n_classes)
    c = completeness_score(y_true, y_pred, n_classes)
    denom = beta * h + c
    return torch.where(denom == 0, torch.zeros_like(denom),
                       (1.0 + beta) * h * c / torch.where(denom == 0, torch.ones_like(denom), denom))


def kl_divergence(p, q) -> torch.Tensor:
    """``raft::stats::kl_divergence`` (``stats/kl_divergence.cuh``)."""
    p = _f32(p)
    q = _f32(q).to(p.device)
    ratio = torch.where((p > 0) & (q > 0), p / torch.where(q > 0, q, torch.ones_like(q)),
                        torch.ones_like(p))
    return torch.sum(torch.where(p > 0, p * torch.log(ratio), torch.zeros_like(p)))


def silhouette_score(X, labels, n_clusters: Optional[int] = None, chunk: int = 2048) -> torch.Tensor:
    """Mean silhouette coefficient (``stats/silhouette_score.cuh``; the
    batched variant of ``batched_silhouette_score``): a sample's ``(b - a)
    / max(a, b)`` from its mean intra- and nearest inter-cluster
    Euclidean distance, ``chunk`` rows of distances at a time."""
    X = _f32(X)
    y = _labels(labels).to(X.device)
    n = X.shape[0]
    if n_clusters is None:
        n_clusters = int(torch.max(y)) + 1
    onehot = torch.nn.functional.one_hot(y, n_clusters).to(torch.float32)  # [n, k]
    counts = torch.sum(onehot, dim=0)
    scores = []
    for s in range(0, n, chunk):
        xc, yc = X[s : s + chunk], y[s : s + chunk]
        sums = pairwise_distance(xc, X, DistanceType.L2SqrtExpanded) @ onehot  # [c, k]
        own = counts[yc]
        row = torch.arange(xc.shape[0], device=X.device)
        a = sums[row, yc] / torch.clamp(own - 1.0, min=1.0)
        mean_other = sums / torch.clamp(counts[None, :], min=1.0)
        mean_other[row, yc] = float("inf")
        b = torch.min(mean_other, dim=1).values
        sil = torch.where(own > 1, (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30),
                          torch.zeros_like(a))
        scores.append(sil)
    return torch.mean(torch.cat(scores))


def dispersion(centroids, cluster_sizes, global_centroid=None) -> torch.Tensor:
    """Between-cluster dispersion (``stats/dispersion.cuh``): sqrt of the
    size-weighted squared distances of the centroids to the global one."""
    c = _f32(centroids)
    sizes = _f32(cluster_sizes).to(c.device)
    if global_centroid is None:
        global_centroid = torch.sum(c * sizes[:, None], dim=0) / torch.clamp(torch.sum(sizes), min=1.0)
    else:
        global_centroid = _f32(global_centroid).to(c.device)
    d2 = torch.sum((c - global_centroid[None, :]) ** 2, dim=1)
    return torch.sqrt(torch.sum(sizes * d2))


class CriterionType(enum.IntEnum):
    """``batched::linalg::detail::ic_type`` analog
    (``stats/information_criterion.cuh``)."""

    AIC = 0
    AICc = 1
    BIC = 2


def information_criterion(log_likelihood, criterion: CriterionType, n_params: int,
                          n_samples: int) -> torch.Tensor:
    """``raft::stats::information_criterion_batched``
    (``stats/information_criterion.cuh``)."""
    base = -2.0 * _f32(log_likelihood)
    if criterion == CriterionType.AIC:
        return base + 2.0 * n_params
    if criterion == CriterionType.AICc:
        corr = 2.0 * n_params * (n_params + 1) / max(n_samples - n_params - 1, 1)
        return base + 2.0 * n_params + corr
    return base + n_params * torch.log(torch.tensor(float(n_samples), dtype=torch.float32))


def trustworthiness_score(X, X_embedded, n_neighbors: int = 5, chunk: int = 2048) -> torch.Tensor:
    """Embedding trustworthiness (``stats/trustworthiness_score.cuh``):
    penalizes embedded-space neighbours that are far in the original
    space, ``chunk`` rows of both distance matrices at a time."""
    X = _f32(X)
    E = _f32(X_embedded).to(X.device)
    n = X.shape[0]
    k = n_neighbors
    expects(k < n, "n_neighbors must be < n_samples")
    ranks_of = torch.arange(n, device=X.device)
    t = torch.zeros((), dtype=torch.float32, device=X.device)
    for s in range(0, n, chunk):
        d_orig = pairwise_distance(X[s : s + chunk], X, DistanceType.L2Expanded)
        d_emb = pairwise_distance(E[s : s + chunk], E, DistanceType.L2Expanded)
        c = d_orig.shape[0]
        row = torch.arange(c, device=X.device)
        # rank of every sample in the original space (0 = self)
        order = torch.argsort(d_orig, dim=1, stable=True)
        ranks = torch.empty_like(order).scatter_(1, order, ranks_of[None, :].expand(c, n))
        d_emb[row, s + row] = float("inf")  # not its own neighbour
        _, nbrs = select_k(d_emb, k, select_min=True)
        r = torch.gather(ranks, 1, nbrs.to(torch.int64))
        t = t + torch.sum(torch.clamp(r - k, min=0).to(torch.float32))
    norm = 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))
    return 1.0 - norm * t
