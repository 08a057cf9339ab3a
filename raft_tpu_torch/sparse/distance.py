"""Sparse pairwise distances and sparse brute-force kNN
(``raft_tpu.sparse.distance`` counterpart; reference
``raft/sparse/distance/distance.cuh:69`` and
``raft/sparse/neighbors/brute_force.cuh``).

Two regimes, as in the JAX package:

* **Block densification** (moderate ``n_cols``): CSR row blocks become
  dense blocks and go through the dense engine
  (:func:`raft_tpu_torch.ops.distance.pairwise_distance`).
* **Native CSR** (a feature axis too wide to densify): each row is padded
  to the widest row's nnz and every (x row, y row) intersection is found by
  a batched ``torch.searchsorted`` of x's columns in y's sorted columns
  (``side`` left, as JAX). The gram family (inner product, cosine, L2,
  Hellinger, Jaccard, Dice) needs only ``X @ Y^T`` and row statistics; the
  union family (L1, Linf, Canberra, Lp, unexpanded L2, Hamming, Bray-Curtis,
  KL, Jensen-Shannon) adds the y entries that x does not match, found by a
  second search the other way.

A pair block's ``[mi, nj, r]`` search and gather tensors are int32 and
bounded by :data:`PAIR_ELEMS`: a block whose rows are wide runs in slices
of y rows. Both paths read ``indptr`` on the host once a matrix: the
native one for the padded width, the densify one to slice its row blocks.
The JAX package leaves all of this to XLA, so it is plain PyTorch here
too.
"""
from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.ops.distance import (
    DistanceType,
    is_min_close,
    js_term,
    kl_term,
    pairwise_distance,
    resolve_metric,
)
from raft_tpu_torch.ops.select_k import running_merge, select_k, worst_value
from raft_tpu_torch.sparse.types import CSR, segment_sum

#: metrics expressible as f(gram, row stats): the native gram set
_NATIVE_GRAM = frozenset(
    {
        DistanceType.InnerProduct,
        DistanceType.CosineExpanded,
        DistanceType.L2Expanded,
        DistanceType.L2SqrtExpanded,
        DistanceType.HellingerExpanded,
        DistanceType.JaccardExpanded,
        DistanceType.DiceExpanded,
    }
)
#: metrics over the union of nonzero columns (the |a - b| family)
_NATIVE_UNION = frozenset(
    {
        DistanceType.L1,
        DistanceType.Linf,
        DistanceType.Canberra,
        DistanceType.LpUnexpanded,
        DistanceType.L2Unexpanded,
        DistanceType.L2SqrtUnexpanded,
        DistanceType.HammingUnexpanded,
        DistanceType.BrayCurtis,
        DistanceType.KLDivergence,
        DistanceType.JensenShannon,
    }
)
_NATIVE = _NATIVE_GRAM | _NATIVE_UNION

#: elements of a pair block's ``[mi, nj, r]`` search tensors; a wider
#: block runs in slices of y rows
PAIR_ELEMS = 1 << 25


def _plan_sparse(n_cols: int, metric) -> str:
    """``mode="auto"``: densify or native, costed by the planner (the gate
    off restores the width threshold)."""
    from raft_tpu_torch import plan as _plan

    native_ok = metric in _NATIVE
    if _plan.is_enabled():
        return _plan.plan_sparse_mode(n_cols, native_ok=native_ok).choice
    return "native" if n_cols > (1 << 18) and native_ok else "densify"


def _densify_rows(a: CSR, start: int, count: int, rows=None, indptr=None) -> torch.Tensor:
    """Dense [count, n_cols] block of CSR rows [start, start + count);
    ``rows`` is ``a.row_ids()`` and ``indptr`` ``a.indptr`` on the host,
    hoisted out of block loops. The block's entries are the slice
    ``indptr[start]:indptr[start + count]``: JAX masks every entry instead,
    and the masked entries sent to one dropped slot would serialize the
    accumulating scatter on the card."""
    if rows is None:
        rows = a.row_ids()
    if indptr is None:
        indptr = a.indptr.cpu()
    lo, hi = int(indptr[start]), int(indptr[start + count])
    r = rows[lo:hi].to(torch.int64) - start
    out = torch.zeros((count, a.shape[1]), dtype=a.vals.dtype, device=a.vals.device)
    out.index_put_((r, a.indices[lo:hi].to(torch.int64)), a.vals[lo:hi], accumulate=True)
    return out


def _csr_padded_rows(a: CSR, pad_sentinel: int):
    """CSR -> (col ids [m, r] i32, vals [m, r] f32), padded to the widest
    row; padding columns get ``pad_sentinel`` (past every real column, so
    rows stay sorted and a sentinel never matches)."""
    m = a.shape[0]
    counts = torch.diff(a.indptr.cpu())  # the one host read of the call
    r = max(1, int(counts.max()) if m else 1)
    dev = a.vals.device
    rows = a.row_ids().to(torch.int64)
    keep = rows < m
    within = torch.arange(a.nnz, device=dev) - a.indptr[torch.clamp(rows, max=m)].to(torch.int64)
    flat = torch.where(keep, rows * r + within, torch.full_like(rows, m * r))
    idx = torch.full((m * r + 1,), pad_sentinel, dtype=torch.int32, device=dev)
    val = torch.zeros(m * r + 1, dtype=torch.float32, device=dev)
    idx[flat] = a.indices.to(torch.int32)
    val[flat] = a.vals.to(torch.float32)
    return idx[:-1].reshape(m, r), val[:-1].reshape(m, r)


def _y_slices(mi: int, r: int, nj: int):
    """Slices of a block's ``nj`` y rows that keep ``[mi, slice, r]`` within
    :data:`PAIR_ELEMS`."""
    step = max(1, PAIR_ELEMS // max(1, mi * r))
    return [slice(s, min(nj, s + step)) for s in range(0, nj, step)]


def _match(xi, yi):
    """For every (y row j, x row i, x entry a): the position of x's column
    in y's sorted row and whether it is there. ``xi`` [mi, r1], ``yi``
    [nj, r2] -> (pos, hit), each [nj, mi, r1]."""
    mi, r1 = xi.shape
    nj, r2 = yi.shape
    vals = xi.reshape(1, mi * r1).expand(nj, mi * r1).contiguous()
    pos = torch.searchsorted(yi, vals, out_int32=True).clamp_(0, r2 - 1)
    hit = torch.gather(yi, 1, pos.to(torch.int64)) == vals
    return pos.reshape(nj, mi, r1), hit.reshape(nj, mi, r1)


def _gram_block(xi, xv, yi, yv) -> torch.Tensor:
    """Sparse-sparse gram of padded row blocks: ``[mi, nj]`` of
    ``sum_a xv[i, a] * yv[j, pos]``, ``pos`` the binary-search match of x's
    column in y's row."""
    parts = []
    for sl in _y_slices(xi.shape[0], xi.shape[1], yi.shape[0]):
        pos, hit = _match(xi, yi[sl])
        nj = pos.shape[0]
        yg = torch.gather(yv[sl], 1, pos.reshape(nj, -1).to(torch.int64)).reshape(pos.shape)
        prod = torch.where(hit, xv[None] * yg, torch.zeros_like(yg))
        parts.append(torch.sum(prod, dim=2))  # [nj, mi]
    return torch.cat(parts, dim=0).T


def _term(kind: str, a, b, p: float):
    ad = torch.abs(a - b)
    if kind in ("l1", "linf"):
        return ad
    if kind == "lp":
        return ad ** p
    if kind == "canberra":
        den = torch.abs(a) + torch.abs(b)
        return torch.where(den > 0.0, ad / torch.where(den > 0.0, den, torch.ones_like(den)),
                           torch.zeros_like(ad))
    if kind == "kl":
        # (0, b) terms vanish, so the union's y-only side is free
        return kl_term(a, b)
    if kind == "js":
        return js_term(a, b)
    return (a != b).to(torch.float32)  # hamming


def _union_block(xi, xv, yi, yv, kind: str, use_max: bool, p: float) -> torch.Tensor:
    """Union-of-nonzeros accumulation over padded row blocks: ``[mi, nj]``
    of ``reduce_c term(x[i, c], y[j, c])`` over every column where either
    row is nonzero (``[mi, nj, 2]`` for Bray-Curtis: both sums of one
    merge). Terms vanish at (0, 0), so the union is x's entries against the
    matched-or-zero y, plus y's unmatched entries against zero; padding
    sentinels never match and their (0, 0) terms are 0."""
    mi, r1 = xi.shape
    parts = []
    for sl in _y_slices(mi, max(r1, yi.shape[1]), yi.shape[0]):
        ys_i, ys_v = yi[sl], yv[sl]
        nj, r2 = ys_i.shape
        pos, hit = _match(xi, ys_i)  # [nj, mi, r1]
        yg = torch.gather(ys_v, 1, pos.reshape(nj, -1).to(torch.int64)).reshape(pos.shape)
        b = torch.where(hit, yg, torch.zeros_like(yg))
        # y entries with no x match: one search a (x row, y entry)
        yflat = ys_i.reshape(1, nj * r2).expand(mi, nj * r2).contiguous()
        pos2 = torch.searchsorted(xi, yflat, out_int32=True).clamp_(0, r1 - 1)
        hit2 = (torch.gather(xi, 1, pos2.to(torch.int64)) == yflat).reshape(mi, nj, r2)
        hit2 = hit2.transpose(0, 1)  # [nj, mi, r2]
        zero2 = torch.zeros((), dtype=torch.float32, device=xv.device)
        if kind == "bc":
            only_y = torch.sum(torch.where(hit2, zero2, torch.abs(ys_v)[:, None, :]), dim=2)
            num = torch.sum(torch.abs(xv[None] - b), dim=2) + only_y
            den = torch.sum(torch.abs(xv[None] + b), dim=2) + only_y
            parts.append(torch.stack([num, den], dim=2))  # [nj, mi, 2]
            continue
        left = _term(kind, xv[None], b, p)  # [nj, mi, r1]
        right = torch.where(hit2, zero2, _term(kind, torch.zeros_like(ys_v), ys_v, p)[:, None, :])
        if use_max:
            parts.append(torch.maximum(torch.amax(left, dim=2), torch.amax(right, dim=2)))
        else:
            parts.append(torch.sum(left, dim=2) + torch.sum(right, dim=2))
    out = torch.cat(parts, dim=0)
    return out.transpose(0, 1)  # [mi, nj] (or [mi, nj, 2])


def _blocked(x: CSR, y: CSR, block_fn, pair_block: int, transform=None) -> torch.Tensor:
    """``block_fn`` over ``pair_block`` square blocks of the padded rows."""
    expects(x.shape[1] == y.shape[1], "feature dim mismatch")
    xi, xv = _csr_padded_rows(x, x.shape[1] + 2)  # distinct sentinels never match
    yi, yv = _csr_padded_rows(y, x.shape[1] + 1)
    if transform is not None:
        xv, yv = transform(xv), transform(yv)
    m, n = x.shape[0], y.shape[0]
    outs = []
    for s in range(0, m, pair_block):
        row = [block_fn(xi[s : s + pair_block], xv[s : s + pair_block],
                        yi[t : t + pair_block], yv[t : t + pair_block])
               for t in range(0, n, pair_block)]
        outs.append(torch.cat(row, dim=1) if len(row) > 1 else row[0])
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]


def _union_accumulate(x: CSR, y: CSR, kind: str, use_max: bool = False, p: float = 2.0,
                      pair_block: int = 512) -> torch.Tensor:
    """Blocked [m, n] union accumulation (see :func:`_union_block`)."""
    return _blocked(x, y, lambda a, b, c, d: _union_block(a, b, c, d, kind, use_max, float(p)),
                    pair_block)


def sparse_gram(x: CSR, y: CSR, transform=None, pair_block: int = 512) -> torch.Tensor:
    """Dense [m, n] gram ``X @ Y^T`` of two CSR matrices without densifying
    the feature axis. ``transform`` maps the values first (``torch.sqrt``
    for Hellinger)."""
    return _blocked(x, y, _gram_block, pair_block, transform)


def _row_stat(a: CSR, fn) -> torch.Tensor:
    """Per-row reduction over CSR values (no densify)."""
    return segment_sum(fn(a.vals.to(torch.float32)), a.row_ids(), a.shape[0])


def _safe(denom):
    return torch.where(denom == 0.0, torch.ones_like(denom), denom)


def pairwise_distance_sparse_native(
    x: CSR,
    y: CSR,
    metric=DistanceType.L2Expanded,
    pair_block: int = 512,
    metric_arg: float = 2.0,
) -> torch.Tensor:
    """Native-CSR metrics (``sparse/distance/distance.cuh:69``): no dense
    feature axis, so any width works. The gram family reduces to
    :func:`sparse_gram` plus row statistics; the union family accumulates
    over the union of nonzeros (``detail/lp_distance.cuh``)."""
    metric = resolve_metric(metric)
    expects(metric in _NATIVE, "metric %s has no native CSR path", metric)
    if metric in _NATIVE_UNION:
        d_cols = x.shape[1]
        if metric == DistanceType.L1:
            return _union_accumulate(x, y, "l1", pair_block=pair_block)
        if metric == DistanceType.Linf:
            return _union_accumulate(x, y, "linf", use_max=True, pair_block=pair_block)
        if metric == DistanceType.Canberra:
            return _union_accumulate(x, y, "canberra", pair_block=pair_block)
        if metric == DistanceType.LpUnexpanded:
            acc = _union_accumulate(x, y, "lp", p=metric_arg, pair_block=pair_block)
            return acc ** (1.0 / metric_arg)
        if metric in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
            acc = _union_accumulate(x, y, "lp", p=2.0, pair_block=pair_block)
            return torch.sqrt(acc) if metric == DistanceType.L2SqrtUnexpanded else acc
        if metric == DistanceType.HammingUnexpanded:
            return _union_accumulate(x, y, "hamming", pair_block=pair_block) / d_cols
        if metric == DistanceType.KLDivergence:
            return _union_accumulate(x, y, "kl", pair_block=pair_block)
        if metric == DistanceType.JensenShannon:
            acc = _union_accumulate(x, y, "js", pair_block=pair_block)
            return torch.sqrt(torch.clamp(0.5 * acc, min=0.0))
        bc = _union_accumulate(x, y, "bc", pair_block=pair_block)  # Bray-Curtis
        num, den = bc[..., 0], bc[..., 1]
        return torch.where(den == 0.0, torch.zeros_like(num), num / _safe(den))
    if metric == DistanceType.HellingerExpanded:
        g = sparse_gram(x, y, transform=torch.sqrt, pair_block=pair_block)
        return torch.sqrt(torch.clamp(1.0 - g, min=0.0))
    dot = sparse_gram(x, y, pair_block=pair_block)
    if metric == DistanceType.InnerProduct:
        return dot
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        xn = _row_stat(x, torch.square)
        yn = _row_stat(y, torch.square)
        d2 = torch.clamp(xn[:, None] + yn[None, :] - 2.0 * dot, min=0.0)
        return torch.sqrt(d2) if metric == DistanceType.L2SqrtExpanded else d2
    if metric == DistanceType.CosineExpanded:
        xn = torch.sqrt(_row_stat(x, torch.square))
        yn = torch.sqrt(_row_stat(y, torch.square))
        return 1.0 - dot / _safe(xn[:, None] * yn[None, :])
    sx = _row_stat(x, lambda v: v)
    sy = _row_stat(y, lambda v: v)
    if metric == DistanceType.JaccardExpanded:
        union = sx[:, None] + sy[None, :] - dot
        return 1.0 - torch.where(union == 0.0, torch.zeros_like(dot), dot / _safe(union))
    denom = sx[:, None] + sy[None, :]  # Dice
    return 1.0 - torch.where(denom == 0.0, torch.zeros_like(dot), 2.0 * dot / _safe(denom))


def pairwise_distance_sparse(
    x: CSR,
    y: CSR,
    metric=DistanceType.L2Expanded,
    metric_arg: float = 2.0,
    block: int = 1024,
    mode: str = "auto",
) -> torch.Tensor:
    """The [m, n] distance matrix between CSR row sets
    (``sparse/distance/distance.cuh:69``): every metric of the dense engine
    through block densification, and the native CSR path. ``mode``:
    ``"auto"`` (the planner's choice), ``"densify"`` or ``"native"``."""
    metric = resolve_metric(metric)
    expects(x.shape[1] == y.shape[1], "feature dim mismatch")
    expects(mode in ("auto", "densify", "native"), "bad mode %r", mode)
    if mode == "auto":
        mode = _plan_sparse(x.shape[1], metric)
    if mode == "native":
        return pairwise_distance_sparse_native(x, y, metric, metric_arg=metric_arg)
    m = x.shape[0]
    xs, ys = (x.row_ids(), x.indptr.cpu()), (y.row_ids(), y.indptr.cpu())
    yd = _densify_rows(y, 0, y.shape[0], *ys) if y.shape[0] <= block else None
    outs = []
    for s in range(0, m, block):
        xb = _densify_rows(x, s, min(block, m - s), *xs)
        if yd is not None:
            outs.append(pairwise_distance(xb, yd, metric, metric_arg))
            continue
        outs.append(torch.cat([
            pairwise_distance(xb, _densify_rows(y, t, min(block, y.shape[0] - t), *ys),
                              metric, metric_arg)
            for t in range(0, y.shape[0], block)], dim=1))
    return torch.cat(outs, dim=0)


def knn_sparse(
    x: CSR,
    y: CSR,
    k: int,
    metric=DistanceType.L2Expanded,
    metric_arg: float = 2.0,
    block: int = 1024,
    mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse brute-force kNN (``sparse/neighbors/brute_force.cuh``): block
    distances and a running top-k merge. Returns ``(dists, ids)`` of the y
    rows nearest each x row; ``mode`` as in
    :func:`pairwise_distance_sparse`."""
    metric = resolve_metric(metric)
    select_min = is_min_close(metric)
    n, m = y.shape[0], x.shape[0]
    expects(0 < k <= n, "k out of range")
    worst = worst_value(torch.float32, select_min)
    expects(mode in ("auto", "densify", "native"), "bad mode %r", mode)
    if mode == "auto":
        mode = _plan_sparse(x.shape[1], metric)
    if mode == "native":
        d = pairwise_distance_sparse_native(x, y, metric, metric_arg=metric_arg)
        return select_k(d, k, select_min=select_min)
    dev = x.vals.device
    xs, ys = (x.row_ids(), x.indptr.cpu()), (y.row_ids(), y.indptr.cpu())
    out_v, out_i = [], []
    for s in range(0, m, block):
        cnt = min(block, m - s)
        xb = _densify_rows(x, s, cnt, *xs)
        acc_v = torch.full((cnt, k), worst, dtype=torch.float32, device=dev)
        acc_i = torch.full((cnt, k), -1, dtype=torch.int32, device=dev)
        for t in range(0, n, block):
            ycnt = min(block, n - t)
            d = pairwise_distance(xb, _densify_rows(y, t, ycnt, *ys), metric, metric_arg)
            ids = (t + torch.arange(ycnt, dtype=torch.int32, device=dev))[None, :].expand(cnt, ycnt)
            if ycnt >= k:
                dv, di = select_k(d, k, select_min=select_min, indices=ids)
            else:
                dv, di = d, ids
            acc_v, acc_i = running_merge(acc_v, acc_i, dv, di, select_min=select_min)
        out_v.append(acc_v)
        out_i.append(acc_i)
    return torch.cat(out_v, dim=0), torch.cat(out_i, dim=0)
