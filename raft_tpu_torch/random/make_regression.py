"""Regression data (``raft_tpu.random.make_regression`` counterpart;
reference ``random/make_regression.cuh:38-99`` and
``random/multi_variable_gaussian.cuh``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.random.rng import KeyLike, as_key


def make_regression(
    key: KeyLike,
    n_samples: int,
    n_features: int,
    n_informative: Optional[int] = None,
    n_targets: int = 1,
    bias: float = 0.0,
    effective_rank: Optional[int] = None,
    tail_strength: float = 0.5,
    noise: float = 0.0,
    shuffle: bool = True,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A random linear-regression problem ``(X [n, p], y [n, t], coef [p,
    t])`` with ``y = X @ coef + bias + N(0, noise)``
    (``make_regression.cuh:73``): ``n_informative`` features carry
    non-zero coefficients; with ``effective_rank``, X is low rank with a
    ``tail_strength`` fat tail of singular values."""
    n_informative = n_features if n_informative is None else min(n_informative, n_features)
    expects(n_samples >= 1 and n_features >= 1 and n_targets >= 1, "bad shapes")
    g = as_key(key, device=device)
    dev = g.device
    if effective_rank is None:
        X = torch.randn((n_samples, n_features), generator=g, device=dev).to(dtype)
    else:
        r = min(effective_rank, min(n_samples, n_features))
        nmin = min(n_samples, n_features)
        u, _ = torch.linalg.qr(torch.randn((n_samples, nmin), generator=g, device=dev))
        v, _ = torch.linalg.qr(torch.randn((n_features, nmin), generator=g, device=dev))
        idx = torch.arange(nmin, dtype=torch.float32, device=dev)
        low = torch.exp(-((idx / r) ** 2))
        tail = tail_strength * torch.exp(-0.1 * idx / r)
        s = (1.0 - tail_strength) * low + tail
        X = ((u * s[None, :]) @ v.T).to(dtype)
    coef = torch.zeros((n_features, n_targets), dtype=dtype, device=dev)
    coef[:n_informative] = 100.0 * torch.rand((n_informative, n_targets), generator=g,
                                              device=dev).to(dtype)
    y = X @ coef + bias
    if noise > 0:
        y = y + noise * torch.randn(tuple(y.shape), generator=g, device=dev).to(dtype)
    if shuffle:
        row_perm = torch.randperm(n_samples, generator=g, device=dev)
        col_perm = torch.randperm(n_features, generator=g, device=dev)
        X = X[row_perm][:, col_perm]
        y = y[row_perm]
        coef = coef[col_perm]
    return X, y, coef


def multi_variable_gaussian(key: KeyLike, n_samples: int, mean, cov, method: str = "cholesky",
                            dtype=torch.float32, device=None) -> torch.Tensor:
    """``[n_samples, dim]`` samples of N(mean, cov)
    (``multi_variable_gaussian.cuh``; ``method`` is ``cholesky`` or
    ``jacobi``, an eigendecomposition). Draws on the generator's device."""
    g = as_key(key, device=device)
    mean = ser.as_tensor(mean, g.device).to(torch.float32)
    cov = ser.as_tensor(cov, g.device).to(torch.float32)
    d = mean.shape[0]
    expects(tuple(cov.shape) == (d, d), "cov must be [dim, dim]")
    expects(method in ("cholesky", "jacobi"), "method must be cholesky|jacobi")
    z = torch.randn((n_samples, d), generator=g, device=g.device)
    if method == "cholesky":
        chol = torch.linalg.cholesky(cov + 1e-8 * torch.eye(d, device=g.device))
        samples = z @ chol.T
    else:
        w, v = torch.linalg.eigh(cov)
        samples = z @ (v * torch.sqrt(torch.clamp(w, min=0.0))[None, :]).T
    return (samples + mean[None, :]).to(dtype)
