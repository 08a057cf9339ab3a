"""Summary statistics (``raft_tpu.stats.summary`` counterpart; reference
``stats/{mean,stddev,sum,cov,minmax,histogram,meanvar,weighted_mean,
mean_center}.cuh``).

Shape-checked PyTorch reductions with the reference's orientation flags
(``along_rows=True`` reduces over rows: one value a column) and sample or
population denominators. Tensors are taken on their own device; numpy
inputs become CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.errors import expects


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _axis(along_rows: bool) -> int:
    return 0 if along_rows else 1


def mean(x, along_rows: bool = True) -> torch.Tensor:
    """``raft::stats::mean`` (``stats/mean.cuh``)."""
    return torch.mean(_f32(x), dim=_axis(along_rows))


def sum_(x, along_rows: bool = True) -> torch.Tensor:
    """``raft::stats::sum`` (``stats/sum.cuh``)."""
    return torch.sum(_f32(x), dim=_axis(along_rows))


def stddev(x, sample: bool = False, along_rows: bool = True) -> torch.Tensor:
    """``raft::stats::stddev`` (``stats/stddev.cuh``); ``sample`` takes the
    n - 1 denominator."""
    return torch.std(_f32(x), dim=_axis(along_rows), correction=1 if sample else 0)


def meanvar(x, sample: bool = False, along_rows: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``raft::stats::meanvar`` (``stats/meanvar.cuh``)."""
    x = _f32(x)
    ax = _axis(along_rows)
    return torch.mean(x, dim=ax), torch.var(x, dim=ax, correction=1 if sample else 0)


def mean_center(x, mu=None, along_rows: bool = True) -> torch.Tensor:
    """``raft::stats::mean_center`` (``stats/mean_center.cuh``)."""
    x = _f32(x)
    mu = mean(x, along_rows) if mu is None else _f32(mu).to(x.device)
    return x - (mu[None, :] if along_rows else mu[:, None])


def mean_add(x, mu, along_rows: bool = True) -> torch.Tensor:
    """``raft::stats::mean_add`` (``stats/mean_center.cuh``)."""
    x = _f32(x)
    mu = _f32(mu).to(x.device)
    return x + (mu[None, :] if along_rows else mu[:, None])


def cov(x, mu=None, sample: bool = True, stable: bool = True) -> torch.Tensor:
    """Covariance of the columns (``raft::stats::cov``, ``stats/cov.cuh``):
    ``[d, d]`` from ``[n, d]``. ``stable=False`` is the reference's
    single-pass ``E[x x^T] - n mu mu^T`` form."""
    x = _f32(x)
    expects(x.ndim == 2, "cov expects [n, d]")
    n = x.shape[0]
    mu = torch.mean(x, dim=0) if mu is None else _f32(mu).to(x.device)
    denom = max(n - 1, 1) if sample else n
    if stable:
        xc = x - mu[None, :]
        return (xc.T @ xc) / denom
    return (x.T @ x - n * torch.outer(mu, mu)) / denom


def weighted_mean(x, weights, along_rows: bool = True) -> torch.Tensor:
    """``raft::stats::weighted_mean`` (``stats/weighted_mean.cuh``)."""
    x = _f32(x)
    w = _f32(weights).to(x.device)
    ax = _axis(along_rows)
    wb = w[:, None] if ax == 0 else w[None, :]
    return torch.sum(x * wb, dim=ax) / torch.clamp(torch.sum(w), min=1e-30)


def minmax(x, along_rows: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``raft::stats::minmax`` (``stats/minmax.cuh``)."""
    x = torch.as_tensor(x)
    return torch.aminmax(x, dim=_axis(along_rows))


def histogram(x, n_bins: int, lower: float, upper: float) -> torch.Tensor:
    """Fixed-width histogram of each column (``raft::stats::histogram``,
    ``stats/histogram.cuh``): int32 ``[n_bins, d]`` counts of the values in
    ``[lower, upper)``."""
    x = _f32(x)
    expects(x.ndim == 2, "histogram expects [n, d]")
    expects(upper > lower, "upper must exceed lower")
    d = x.shape[1]
    width = (upper - lower) / n_bins
    bins = torch.clamp(((x - lower) / width).to(torch.int32), 0, n_bins - 1)
    inside = (x >= lower) & (x < upper)
    flat = (bins + torch.arange(d, dtype=torch.int32, device=x.device)[None, :] * n_bins)
    counts = torch.bincount(flat[inside].to(torch.int64), minlength=d * n_bins)
    return counts.to(torch.int32).reshape(d, n_bins).T
