"""Matrix operations (``raft_tpu.matrix.ops`` counterpart; reference
``matrix/{gather,scatter,slice,argmax,argmin,col_wise_sort,diagonal,
linewise_op,reverse,sample_rows,sign_flip,threshold,triangular}.cuh``).

Shape-checked PyTorch one-liners; tensors are taken on their own device
(numpy inputs become CPU tensors). ``scatter`` returns a new tensor, as the
JAX package's does.
"""
from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.errors import expects


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


def gather(matrix, indices) -> torch.Tensor:
    """Row gather (``matrix/gather.cuh``): ``out[i] = matrix[indices[i]]``."""
    m = _t(matrix)
    idx = _t(indices).to(device=m.device, dtype=torch.int64)
    expects(m.ndim == 2 and idx.ndim == 1, "gather expects matrix + 1-D indices")
    return m[idx]


def gather_if(matrix, indices, stencil, pred: Callable, fill=0) -> torch.Tensor:
    """Conditional row gather (``gather_if``): rows whose stencil fails
    ``pred`` are ``fill``."""
    out = gather(matrix, indices)
    keep = pred(_t(stencil).to(out.device))
    return torch.where(keep[:, None], out, torch.full_like(out, fill))


def scatter(matrix, indices, updates) -> torch.Tensor:
    """Row scatter (``matrix/scatter.cuh``): ``out[indices[i]] =
    updates[i]``."""
    m = _t(matrix).clone()
    idx = _t(indices).to(device=m.device, dtype=torch.int64)
    m[idx] = _t(updates).to(device=m.device, dtype=m.dtype)
    return m


def matrix_slice(matrix, row0: int, col0: int, row1: int, col1: int) -> torch.Tensor:
    """Submatrix copy (``matrix/slice.cuh``): ``[row0:row1, col0:col1]``."""
    m = _t(matrix)
    expects(0 <= row0 < row1 <= m.shape[0], "bad row slice")
    expects(0 <= col0 < col1 <= m.shape[1], "bad col slice")
    return m[row0:row1, col0:col1].clone()


def argmax(matrix) -> torch.Tensor:
    """Per-row argmax (``matrix/argmax.cuh``), the first on ties."""
    return torch.argmax(_t(matrix), dim=1).to(torch.int32)


def argmin(matrix) -> torch.Tensor:
    """Per-row argmin (``matrix/argmin.cuh``), the first on ties."""
    return torch.argmin(_t(matrix), dim=1).to(torch.int32)


def col_wise_sort(matrix, ascending: bool = True) -> torch.Tensor:
    """Sort each column (``matrix/col_wise_sort.cuh``)."""
    out = torch.sort(_t(matrix), dim=0).values
    return out if ascending else torch.flip(out, dims=(0,))


def diagonal(matrix) -> torch.Tensor:
    """``matrix/diagonal.cuh``."""
    return torch.diagonal(_t(matrix)).clone()


def linewise_op(matrix, vec, op: Callable, along_lines: bool = True) -> torch.Tensor:
    """``matrix/linewise_op.cuh``: ``op(matrix, vec)`` with ``vec``
    broadcast along the rows (True) or the columns."""
    m = _t(matrix)
    v = _t(vec).to(m.device)
    return op(m, v[None, :] if along_lines else v[:, None])


def reverse(matrix, along_rows: bool = False) -> torch.Tensor:
    """``matrix/reverse.cuh``: flip the column order (or the row order)."""
    return torch.flip(_t(matrix), dims=(0,) if along_rows else (1,))


def sample_rows(key, matrix, n_samples: int) -> torch.Tensor:
    """Uniform row subsample without replacement
    (``matrix/sample_rows.cuh``); ``key`` is an int seed, a
    ``torch.Generator`` or None (:func:`raft_tpu_torch.random.as_key`)."""
    from raft_tpu_torch.random.rng import as_key

    m = _t(matrix)
    expects(0 < n_samples <= m.shape[0], "n_samples out of range")
    g = as_key(key, device=m.device)
    idx = torch.randperm(m.shape[0], generator=g, device=g.device)[:n_samples]
    return m[idx.to(m.device)]


def sign_flip(matrix) -> torch.Tensor:
    """``matrix/sign_flip.cuh``: each column's sign flipped so that its
    largest-magnitude element is positive."""
    m = _t(matrix)
    pivot = torch.gather(m, 0, torch.argmax(torch.abs(m), dim=0)[None, :])[0]
    return m * torch.where(pivot < 0, -1.0, 1.0).to(m.dtype)[None, :]


def threshold(matrix, value: float, fill: float = 0.0) -> torch.Tensor:
    """Entries below ``value`` become ``fill`` (``matrix/threshold.cuh``)."""
    m = _t(matrix)
    return torch.where(m < value, torch.full_like(m, fill), m)


def triangular_upper(matrix) -> torch.Tensor:
    """Upper-triangular copy (``matrix/triangular.cuh``)."""
    return torch.triu(_t(matrix))
