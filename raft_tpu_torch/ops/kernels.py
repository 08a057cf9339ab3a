"""Kernel gram matrices (``raft_tpu.ops.kernels`` counterpart; reference
``raft::distance::kernels``: ``gram_matrix.cuh`` ``GramMatrixBase``,
``kernel_matrices.cuh``, ``kernel_factory.cuh``).

Each kernel is one f32 matmul (RBF: the expanded-L2 distance) plus an
elementwise epilogue. The JAX package leaves them to XLA, so they are
plain PyTorch here.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.ops.distance import DistanceType, pairwise_distance


class KernelType(enum.IntEnum):
    """``KernelType`` (``kernel_factory.cuh``); values match the JAX package."""

    LINEAR = 0
    POLYNOMIAL = 1
    RBF = 2
    TANH = 3


@dataclasses.dataclass
class KernelParams:
    """``KernelParams``: (kernel, degree, gamma, coef0)."""

    kernel: KernelType = KernelType.LINEAR
    degree: int = 3
    gamma: float = 1.0
    coef0: float = 0.0


def linear_kernel(x, y) -> torch.Tensor:
    """``x @ y.T`` in f32."""
    return torch.as_tensor(x).to(torch.float32) @ torch.as_tensor(y).to(torch.float32).T


def polynomial_kernel(x, y, degree: int = 3, gamma: float = 1.0, coef0: float = 0.0) -> torch.Tensor:
    """``(gamma x.y + coef0) ** degree``."""
    return (gamma * linear_kernel(x, y) + coef0) ** degree


def tanh_kernel(x, y, gamma: float = 1.0, coef0: float = 0.0) -> torch.Tensor:
    """``tanh(gamma x.y + coef0)``."""
    return torch.tanh(gamma * linear_kernel(x, y) + coef0)


def rbf_kernel(x, y, gamma: float = 1.0) -> torch.Tensor:
    """``exp(-gamma ||x - y||^2)``, through ``pairwise_distance(L2Expanded)``."""
    return torch.exp(-gamma * pairwise_distance(x, y, DistanceType.L2Expanded))


def gram_matrix(x, y=None, params: Optional[KernelParams] = None, **kwargs) -> torch.Tensor:
    """The gram matrix of ``params.kernel`` (``KernelFactory::create`` +
    ``operator()``); ``params`` defaults to ``KernelParams(**kwargs)`` and
    ``y=None`` is the symmetric gram of ``x`` with itself."""
    if params is None:
        params = KernelParams(**kwargs)
    y = x if y is None else y
    k = KernelType(params.kernel)
    if k == KernelType.LINEAR:
        return linear_kernel(x, y)
    if k == KernelType.POLYNOMIAL:
        return polynomial_kernel(x, y, params.degree, params.gamma, params.coef0)
    if k == KernelType.TANH:
        return tanh_kernel(x, y, params.gamma, params.coef0)
    expects(k == KernelType.RBF, "unknown kernel %s", k)
    return rbf_kernel(x, y, params.gamma)
