"""Sparse containers (``raft_tpu.sparse.types`` counterpart; reference
``raft/core/{coo_matrix,csr_matrix}.hpp``, ``raft/sparse/detail/{coo,csr}.cuh``).

``COO`` and ``CSR`` are dataclasses of tensors with a static nnz, as in
the JAX package: a matrix is rebuilt on change, never grown. Padding
entries sit at the out-of-range coordinate ``(n_rows, n_cols)`` and every
consumer ignores them. JAX ignores them because its scatters and
``segment_*`` reductions drop out-of-range ids and its gathers clamp; torch
raises on the CPU and asserts on the card, so the helpers here mask every
scatter and clamp every gather the same way (:func:`segment_sum`,
:func:`segment_min`, :func:`segment_max`, :func:`take`).

Torch has no ``lexsort``: a row-major order is two stable argsorts, by
column and then by row, which is ``jnp.lexsort((cols, rows))``'s order, ties
included.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources, ensure_resources

#: the dtypes JAX keeps without x64: 64-bit host arrays become 32-bit
_CANON = {torch.float64: torch.float32, torch.int64: torch.int32, torch.uint64: torch.uint32}


def target_device(x, res: Optional[Resources] = None, device=None) -> torch.device:
    """Where an entry point puts its tensors: ``res``'s or ``device`` when
    given, else a tensor input's own device, else ``cuda``."""
    if res is None and device is None and isinstance(x, torch.Tensor):
        return x.device
    return ensure_resources(res, device).device


def as_input(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or anything numpy takes) on ``device`` in the dtype
    ``jnp.asarray`` gives it (float64 -> float32, int64 -> int32)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    x = x.to(device)
    return x.to(_CANON[x.dtype]) if x.dtype in _CANON else x


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 with ``idx`` clamped into range, as a JAX
    gather clamps."""
    return x[torch.clamp(idx.to(torch.int64), 0, x.shape[0] - 1)]


def _in_range(ids: torch.Tensor, n: int) -> torch.Tensor:
    return (ids >= 0) & (ids < n)


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: out-of-range ids drop, empty segments are
    0. ``vals`` may carry trailing dimensions."""
    keep = _in_range(ids, n)
    safe = torch.where(keep, ids, torch.zeros_like(ids)).to(torch.int64)
    mask = keep.reshape(keep.shape + (1,) * (vals.ndim - 1))
    v = torch.where(mask, vals, torch.zeros_like(vals))
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, safe, v)


def _segment_extreme(vals: torch.Tensor, ids: torch.Tensor, n: int, largest: bool) -> torch.Tensor:
    if vals.dtype.is_floating_point:
        init = float("-inf") if largest else float("inf")
    else:
        info = torch.iinfo(vals.dtype)
        init = info.min if largest else info.max
    keep = _in_range(ids, n)
    # a dropped entry goes to an extra segment that is cut off
    safe = torch.where(keep, ids, torch.full_like(ids, n)).to(torch.int64)
    out = torch.full((n + 1,), init, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, safe, vals, reduce="amax" if largest else "amin", include_self=True)
    return out[:n]


def segment_min(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_min``: an empty segment is the dtype's max
    (``inf`` for floats)."""
    return _segment_extreme(vals, ids, n, largest=False)


def segment_max(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max``: an empty segment is the dtype's min
    (``-inf`` for floats)."""
    return _segment_extreme(vals, ids, n, largest=True)


def lexsort_rows_cols(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((cols, rows))``: the row-major order, stable."""
    order = torch.argsort(cols, stable=True)
    return order[torch.argsort(rows[order], stable=True)]


@dataclasses.dataclass
class COO:
    """Coordinate-format sparse matrix (``sparse/detail/coo.cuh``)."""

    rows: torch.Tensor  # [nnz] i32
    cols: torch.Tensor  # [nnz] i32
    vals: torch.Tensor  # [nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    def to_dense(self) -> torch.Tensor:
        """``sparse/convert/dense.cuh``. Out-of-range coordinates (the
        padding convention: row == n_rows) are dropped."""
        n_rows, n_cols = self.shape
        keep = _in_range(self.rows, n_rows) & _in_range(self.cols, n_cols)
        flat = torch.where(keep, self.rows.to(torch.int64) * n_cols + self.cols.to(torch.int64),
                           torch.full_like(self.rows, n_rows * n_cols, dtype=torch.int64))
        out = torch.zeros(n_rows * n_cols + 1, dtype=self.vals.dtype, device=self.vals.device)
        out.index_add_(0, flat, torch.where(keep, self.vals, torch.zeros_like(self.vals)))
        return out[:-1].reshape(n_rows, n_cols)

    def sorted_by_row(self) -> "COO":
        """Row-major sort (``sparse/op/sort.cuh`` coo_sort)."""
        order = lexsort_rows_cols(self.rows, self.cols)
        return COO(self.rows[order], self.cols[order], self.vals[order], self.shape)


@dataclasses.dataclass
class CSR:
    """Compressed-sparse-row matrix (``sparse/detail/csr.cuh``)."""

    indptr: torch.Tensor  # [n_rows + 1] i32
    indices: torch.Tensor  # [nnz] i32
    vals: torch.Tensor  # [nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    def row_ids(self) -> torch.Tensor:
        """One row id per nnz (``sparse/convert/coo.cuh`` csr_to_coo): a
        searchsorted over the static nnz axis; entries past ``indptr[-1]``
        get ``n_rows``."""
        pos = torch.arange(self.nnz, dtype=self.indptr.dtype, device=self.indptr.device)
        return torch.searchsorted(self.indptr, pos, right=True, out_int32=True) - 1

    def to_coo(self) -> COO:
        return COO(self.row_ids(), self.indices, self.vals, self.shape)

    def to_dense(self) -> torch.Tensor:
        return self.to_coo().to_dense()


def _host_matrix(x) -> np.ndarray:
    x_np = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    expects(x_np.ndim == 2, "expects a matrix")
    return x_np


def coo_from_dense(x, nnz: Optional[int] = None, res: Optional[Resources] = None,
                   device=None) -> COO:
    """Built on the host (``sparse/convert`` analog). ``nnz`` pads or
    truncates to a static size; padding entries sit at ``(n_rows,
    n_cols)``. The matrix lands on ``res``'s or ``device``, else on a
    tensor input's device, else on ``cuda``."""
    dev = target_device(x, res, device)
    x_np = _host_matrix(x)
    r, c = np.nonzero(x_np)
    v = x_np[r, c]
    if nnz is not None:
        if len(v) > nnz:
            r, c, v = r[:nnz], c[:nnz], v[:nnz]
        elif len(v) < nnz:
            pad = nnz - len(v)
            r = np.concatenate([r, np.full(pad, x_np.shape[0], r.dtype)])
            c = np.concatenate([c, np.full(pad, x_np.shape[1], c.dtype)])
            v = np.concatenate([v, np.zeros(pad, v.dtype)])
    return COO(as_input(r.astype(np.int32), dev), as_input(c.astype(np.int32), dev),
               as_input(v, dev), tuple(x_np.shape))


def csr_from_dense(x, res: Optional[Resources] = None, device=None) -> CSR:
    """``sparse/convert/csr.cuh`` analog, built on the host; placed as
    :func:`coo_from_dense` places its matrix."""
    dev = target_device(x, res, device)
    x_np = _host_matrix(x)
    r, c = np.nonzero(x_np)
    v = x_np[r, c]
    indptr = np.zeros(x_np.shape[0] + 1, np.int32)
    np.add.at(indptr, r + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return CSR(as_input(indptr, dev), as_input(c.astype(np.int32), dev), as_input(v, dev),
               tuple(x_np.shape))


def coo_to_csr(coo: COO) -> CSR:
    """``sparse/convert/csr.cuh`` sorted_coo_to_csr (padding entries, at
    ``n_rows``, stay past ``indptr[-1]``)."""
    s = coo.sorted_by_row()
    counts = segment_sum(torch.ones_like(s.rows, dtype=torch.int32), s.rows, coo.shape[0])
    zero = torch.zeros(1, dtype=torch.int32, device=s.rows.device)
    return CSR(torch.cat([zero, torch.cumsum(counts, 0, dtype=torch.int32)]), s.cols, s.vals,
               coo.shape)
