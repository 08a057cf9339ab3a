"""Linear algebra (``raft_tpu.linalg.ops`` counterpart; reference
``linalg/gemm.cuh:63``, ``linalg/{add,subtract,multiply,divide,eltwise,
unary_op,binary_op,ternary_op,map,map_reduce}.cuh``,
``linalg/{reduce,reduce_rows_by_key,reduce_cols_by_key}.cuh``,
``linalg/{norm,normalize}.cuh``, ``linalg/{eig,svd,qr,rsvd,lstsq}.cuh``,
``linalg/transpose.cuh``).

BLAS-like and elementwise wrappers with the reference's orientation flags
and norm types; products are ``torch.matmul`` and the decompositions
``torch.linalg`` (the JAX package leaves the same work to XLA).
``reduce_rows_by_key`` adds in exact fixed point
(:func:`raft_tpu_torch.cluster.kmeans.segment_sum`), so its sums are the
same on every run. ``lstsq`` solves through the SVD (numpy's cutoff of
small singular values), as ``jnp.linalg.lstsq`` does, on any device.
``rsvd`` draws its test matrix from a ``torch.Generator``. Tensors are
taken on their own device; numpy inputs become CPU tensors.
"""
from __future__ import annotations

import enum
from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.core.errors import expects


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


# -- BLAS-like --------------------------------------------------------------


def gemm(a, b, trans_a: bool = False, trans_b: bool = False, alpha: float = 1.0,
         beta: float = 0.0, c=None) -> torch.Tensor:
    """``raft::linalg::gemm`` (``linalg/gemm.cuh:63``): ``alpha op(A) op(B)
    + beta C``."""
    a, b = _t(a), _t(b)
    if trans_a:
        a = a.T
    if trans_b:
        b = b.T
    out = alpha * (a @ b.to(a.device))
    if beta != 0.0:
        expects(c is not None, "beta != 0 requires C")
        out = out + beta * _t(c).to(out.device)
    return out


def gemv(a, x, trans_a: bool = False, alpha: float = 1.0, beta: float = 0.0,
         y=None) -> torch.Tensor:
    """``raft::linalg::gemv`` (``linalg/gemv.cuh``)."""
    a = _t(a)
    if trans_a:
        a = a.T
    out = alpha * (a @ _t(x).to(a.device))
    if beta != 0.0:
        expects(y is not None, "beta != 0 requires y")
        out = out + beta * _t(y).to(out.device)
    return out


def dot(x, y) -> torch.Tensor:
    """``raft::linalg::dot`` (``linalg/dot.cuh``)."""
    x = _t(x)
    return torch.dot(x, _t(y).to(x.device))


def axpy(alpha: float, x, y) -> torch.Tensor:
    """``raft::linalg::axpy`` (``linalg/axpy.cuh``): ``alpha x + y``."""
    x = _t(x)
    return alpha * x + _t(y).to(x.device)


# -- elementwise ------------------------------------------------------------


def add(x, y):
    """``linalg/add.cuh``."""
    return _t(x) + _t(y)


def subtract(x, y):
    """``linalg/subtract.cuh``."""
    return _t(x) - _t(y)


def eltwise_multiply(x, y):
    """``linalg/eltwise.cuh`` eltwiseMultiply."""
    return _t(x) * _t(y)


def eltwise_add(x, y):
    """``linalg/eltwise.cuh`` eltwiseAdd."""
    return _t(x) + _t(y)


def divide(x, y):
    """``linalg/divide.cuh``."""
    return _t(x) / _t(y)


def multiply_scalar(x, scalar: float):
    """``linalg/multiply.cuh`` multiplyScalar."""
    return _t(x) * scalar


def power(x, y):
    """``linalg/power.cuh``."""
    return torch.pow(_t(x), _t(y))


def sqrt(x):
    """``linalg/sqrt.cuh``."""
    return torch.sqrt(_t(x))


def unary_op(x, op: Callable):
    """``linalg/unary_op.cuh``: elementwise ``op(x)``."""
    return op(_t(x))


def binary_op(x, y, op: Callable):
    """``linalg/binary_op.cuh``: elementwise ``op(x, y)``."""
    return op(_t(x), _t(y))


def ternary_op(x, y, z, op: Callable):
    """``linalg/ternary_op.cuh``."""
    return op(_t(x), _t(y), _t(z))


def map_(op: Callable, *arrays):
    """``linalg/map.cuh`` map: elementwise ``op`` over the arrays."""
    return op(*[_t(a) for a in arrays])


def map_reduce(op: Callable, reduce_op: Callable, *arrays, init=0.0):
    """``linalg/map_reduce.cuh``: ``reduce(map(op, arrays))`` to a 0-dim
    tensor. ``reduce_op`` is an associative binary function (``torch.add``,
    ``torch.maximum``, ...) with identity ``init``; the reduction is a tree
    of elementwise calls, ``log2(n)`` deep."""
    v = op(*[_t(a) for a in arrays]).reshape(-1)
    identity = torch.full((1,), init, dtype=v.dtype, device=v.device)
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = torch.cat([v, identity])
        v = reduce_op(v[0::2], v[1::2])
    return reduce_op(identity, v)[0] if v.shape[0] else identity[0]


# -- reductions -------------------------------------------------------------


def reduce_(x, along_rows: bool = False, main_op: Optional[Callable] = None,
            reduce_op=torch.sum, final_op: Optional[Callable] = None) -> torch.Tensor:
    """``raft::linalg::reduce`` (``linalg/reduce.cuh``): one value a row (or
    a column with ``along_rows``), with optional maps before and after;
    ``reduce_op(x, dim=...)`` reduces (``torch.sum``, ``torch.amax``, ...)."""
    x = _t(x)
    expects(x.ndim == 2, "reduce expects a matrix")
    if main_op is not None:
        x = main_op(x)
    out = reduce_op(x, dim=0 if along_rows else 1)
    return final_op(out) if final_op is not None else out


def reduce_rows_by_key(x, keys, n_keys: int, weights=None) -> torch.Tensor:
    """``linalg/reduce_rows_by_key.cuh``: the sum of the rows sharing a key,
    ``[n_keys, d]`` f32 (exact sums, see the module docstring)."""
    from raft_tpu_torch.cluster.kmeans import segment_sum

    x = _f32(x)
    keys = _t(keys).to(device=x.device, dtype=torch.int64)
    expects(x.ndim == 2 and tuple(keys.shape) == (x.shape[0],), "bad shapes")
    if weights is not None:
        x = x * _f32(weights).to(x.device)[:, None]
    return segment_sum(x, keys, n_keys)


def reduce_cols_by_key(x, keys, n_keys: int) -> torch.Tensor:
    """``linalg/reduce_cols_by_key.cuh``: the sum of the columns sharing a
    key, ``[n, n_keys]``."""
    x = _f32(x)
    keys = _t(keys).to(device=x.device, dtype=torch.int64)
    expects(x.ndim == 2 and tuple(keys.shape) == (x.shape[1],), "bad shapes")
    return x @ torch.nn.functional.one_hot(keys, n_keys).to(x.dtype)


class NormType(enum.IntEnum):
    """``raft::linalg::NormType`` (``linalg/norm_types.hpp``)."""

    L1Norm = 0
    L2Norm = 1
    LinfNorm = 2


def norm(x, norm_type: NormType = NormType.L2Norm, along_rows: bool = False,
         sqrt_out: bool = False) -> torch.Tensor:
    """``raft::linalg::norm`` (``linalg/norm.cuh``) of each row (or column
    with ``along_rows``). L2 is the squared norm unless ``sqrt_out``, as in
    the reference."""
    x = _f32(x)
    ax = 0 if along_rows else 1
    if norm_type == NormType.L1Norm:
        out = torch.sum(torch.abs(x), dim=ax)
    elif norm_type == NormType.L2Norm:
        out = torch.sum(x * x, dim=ax)
    else:
        out = torch.amax(torch.abs(x), dim=ax)
    return torch.sqrt(out) if sqrt_out and norm_type == NormType.L2Norm else out


def normalize(x, norm_type: NormType = NormType.L2Norm, eps: float = 1e-12) -> torch.Tensor:
    """``raft::linalg::row_normalize`` (``linalg/normalize.cuh``)."""
    x = _f32(x)
    n = norm(x, norm_type, sqrt_out=True)
    return x / torch.clamp(n[:, None], min=eps)


def matrix_vector_op(m, v, op: Callable = torch.add, along_rows: bool = True) -> torch.Tensor:
    """``raft::linalg::matrix_vector_op`` (``linalg/matrix_vector_op.cuh``):
    ``op(m, v)`` with ``v`` broadcast across the rows (one entry a column)
    or the columns."""
    m = _t(m)
    v = _t(v).to(m.device)
    return op(m, v[None, :] if along_rows else v[:, None])


def mean_squared_error(a, b, weight: float = 1.0) -> torch.Tensor:
    """``linalg/mean_squared_error.cuh``."""
    a = _f32(a)
    return weight * torch.mean((a - _f32(b).to(a.device)) ** 2)


def transpose(x) -> torch.Tensor:
    """``linalg/transpose.cuh``."""
    return _t(x).T.contiguous()


# -- decompositions ---------------------------------------------------------


def eig_dc(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition (``linalg/eig.cuh`` eigDC):
    ``(eigenvalues ascending, eigenvectors [d, d] as columns)``."""
    x = _f32(x)
    expects(x.ndim == 2 and x.shape[0] == x.shape[1], "eig_dc expects square")
    return torch.linalg.eigh(x)


def svd(x, full_matrices: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``linalg/svd.cuh`` svdQR: ``(U, S, V)``, V's columns the right
    singular vectors (V, not V^T)."""
    u, s, vh = torch.linalg.svd(_f32(x), full_matrices=full_matrices)
    return u, s, vh.T


def qr(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """``linalg/qr.cuh`` qrGetQR (reduced)."""
    return torch.linalg.qr(_f32(x))


def cholesky(x, lower: bool = True) -> torch.Tensor:
    """The factor of ``linalg/choleskyRank1Update`` (potrf)."""
    c = torch.linalg.cholesky(_f32(x))
    return c if lower else c.T


def lstsq(a, b) -> torch.Tensor:
    """Least squares (``linalg/lstsq.cuh`` lstsqSvdQR) through the SVD:
    singular values at or below ``eps * max(m, n) * s_max`` count as 0."""
    a = _f32(a)
    b = _f32(b).to(a.device)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cut = torch.finfo(torch.float32).eps * max(a.shape) * s[:1]
    inv = torch.where(s > cut, 1.0 / torch.where(s > cut, s, torch.ones_like(s)), torch.zeros_like(s))
    ub = u.T @ b
    return vh.T @ (inv[:, None] * ub if b.ndim == 2 else inv * ub)


def rsvd(x, k: int, p: int = 10, n_iters: int = 2, key=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomized SVD (``linalg/rsvd.cuh`` rsvdFixedRank): a Gaussian test
    matrix with ``p`` oversamples, ``n_iters`` power iterations, then one
    small exact SVD. ``key``: an int seed (default 0), a
    ``torch.Generator`` or None (the handle's generator)."""
    from raft_tpu_torch.random.rng import as_key

    x = _f32(x)
    m, n = x.shape
    expects(0 < k <= min(m, n), "rank k out of range")
    ell = min(k + p, n)
    g = as_key(key if key is not None else 0, device=x.device)
    omega = torch.randn((n, ell), generator=g, device=g.device).to(x.device)
    q, _ = torch.linalg.qr(x @ omega)
    for _ in range(n_iters):
        q, _ = torch.linalg.qr(x.T @ q)
        q, _ = torch.linalg.qr(x @ q)
    ub, s, vh = torch.linalg.svd(q.T @ x, full_matrices=False)
    return (q @ ub)[:, :k], s[:k], vh[:k].T
