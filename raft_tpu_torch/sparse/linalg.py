"""Sparse linear algebra (``raft_tpu.sparse.linalg`` counterpart; reference
``raft/sparse/linalg/{spmm,sddmm,transpose,degree,norm,symmetrize,add}.cuh``).

The JAX package leaves these to XLA, so they are plain PyTorch here too:
SpMV and SpMM are a gather and a segment sum over the static nnz axis,
SDDMM a row and column gather and a dot. Every function runs on the
device of its inputs.
"""
from __future__ import annotations

import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.sparse.types import (
    COO,
    CSR,
    as_input,
    coo_to_csr,
    lexsort_rows_cols,
    segment_max,
    segment_sum,
    take,
)


def spmv(a: CSR, x) -> torch.Tensor:
    """CSR @ vector."""
    x = as_input(x, a.vals.device)
    expects(tuple(x.shape) == (a.shape[1],), "spmv shape mismatch")
    contrib = a.vals * take(x, a.indices)
    return segment_sum(contrib, a.row_ids(), a.shape[0])


def spmm(a: CSR, b) -> torch.Tensor:
    """CSR @ dense (``sparse/linalg/spmm.hpp``): a per-nnz gather of B's
    rows scaled by the values, segment-summed by output row."""
    b = as_input(b, a.vals.device)
    expects(b.ndim == 2 and b.shape[0] == a.shape[1], "spmm shape mismatch")
    contrib = a.vals[:, None] * take(b, a.indices)  # [nnz, k]
    return segment_sum(contrib, a.row_ids(), a.shape[0])


def sddmm(a, b, mask: COO, alpha: float = 1.0, beta: float = 0.0) -> COO:
    """Sampled dense-dense matmul (``sparse/linalg/sddmm.hpp``):
    ``out[i, j] = alpha * (A @ B)[i, j] + beta * mask[i, j]`` at the mask's
    entries only."""
    dev = mask.vals.device
    a = as_input(a, dev).to(torch.float32)
    b = as_input(b, dev).to(torch.float32)
    expects(a.shape[1] == b.shape[0], "sddmm inner dim mismatch")
    dots = torch.sum(take(a, mask.rows) * take(b.T, mask.cols), dim=1)
    vals = alpha * dots + beta * mask.vals
    return COO(mask.rows, mask.cols, vals, mask.shape)


def transpose(a: CSR) -> CSR:
    """``sparse/linalg/transpose.cuh``: swap the roles and re-sort."""
    coo = a.to_coo()
    return coo_to_csr(COO(coo.cols, coo.rows, coo.vals, (a.shape[1], a.shape[0])))


def degree(coo: COO) -> torch.Tensor:
    """Row degrees (``sparse/linalg/degree.cuh``), int32."""
    return segment_sum(torch.ones_like(coo.rows, dtype=torch.int32), coo.rows, coo.shape[0])


def row_norm_csr(a: CSR, norm_type: str = "l2") -> torch.Tensor:
    """``sparse/linalg/norm.cuh`` rowNormCsr (``l2`` is the squared norm;
    ``linf`` of an empty row is ``-inf``, as JAX's ``segment_max``)."""
    rows = a.row_ids()
    if norm_type == "l1":
        contrib = torch.abs(a.vals)
    elif norm_type == "l2":
        contrib = a.vals * a.vals
    elif norm_type == "linf":
        return segment_max(torch.abs(a.vals), rows, a.shape[0])
    else:
        raise ValueError(f"unknown norm {norm_type}")
    return segment_sum(contrib, rows, a.shape[0])


def symmetrize(coo: COO, op: str = "max") -> COO:
    """Graph symmetrization (``sparse/linalg/symmetrize.cuh``): A and Aᵀ
    combined entrywise with ``op`` (``"max"``, or ``"mean"`` with a missing
    direction counting as 0).

    Duplicate (i, j) entries are summed first (COO semantics, as
    :meth:`COO.to_dense`). The output keeps a static nnz of twice the
    input's: each distinct (i, j) carries the combined value at its first
    occurrence in row-major order and its later copies are zeroed."""
    expects(coo.shape[0] == coo.shape[1], "symmetrize expects square")
    e = coo.nnz
    dev = coo.vals.device
    rows = torch.cat([coo.rows, coo.cols])
    cols = torch.cat([coo.cols, coo.rows])
    vals = torch.cat([coo.vals, coo.vals]).to(torch.float32)
    from_a = torch.cat([torch.ones(e, dtype=torch.bool, device=dev),
                        torch.zeros(e, dtype=torch.bool, device=dev)])
    order = lexsort_rows_cols(rows, cols)
    rs, cs, vs, fa = rows[order], cols[order], vals[order], from_a[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       (rs[1:] != rs[:-1]) | (cs[1:] != cs[:-1])])
    group = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1  # distinct-key id
    m = 2 * e
    zero = torch.zeros_like(vs)
    fwd = segment_sum(torch.where(fa, vs, zero), group, m)
    rev = segment_sum(torch.where(fa, zero, vs), group, m)
    if op == "max":
        combined = torch.maximum(fwd, rev)
    elif op == "mean":
        combined = 0.5 * (fwd + rev)
    else:
        raise ValueError(f"unknown op {op}")
    out_v = torch.where(first, take(combined, group), zero)
    return COO(rs, cs, out_v, coo.shape)


def add(a: COO, b: COO) -> COO:
    """Entrywise sum (``sparse/linalg/add.cuh``): the two entry lists side
    by side, nnz ``a.nnz + b.nnz`` (duplicates fold in consumers)."""
    expects(tuple(a.shape) == tuple(b.shape), "shape mismatch")
    return COO(torch.cat([a.rows, b.rows]), torch.cat([a.cols, b.cols]),
               torch.cat([a.vals, b.vals]), a.shape)
