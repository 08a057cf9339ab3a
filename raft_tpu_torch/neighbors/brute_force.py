"""Brute-force (exact) kNN index (``raft_tpu.neighbors.brute_force``
counterpart).

The index holds the dataset and f32 squared norms; :func:`search` walks
the dataset in tiles, computes each [query_batch, tile] distance block as
an f32 matmul plus epilogue and folds it into a running top-k
(:func:`raft_tpu_torch.ops.select_k.running_merge`), so peak memory is
O(batch * tile). It is the ground truth of the port's recall checks and
the distance core of :mod:`raft_tpu_torch.neighbors.refine`. Every
computable metric but ``Haversine`` searches (the accumulation metrics
broadcast ``[batch, tile, d]`` blocks, so their tile divides by ``d`` and
by :func:`~raft_tpu_torch.ops.distance.accum_live_blocks`).

``mode="approx"`` keeps the JAX package's contract (the matmul metrics
only, any ``recall_target`` in (0, 1]) and runs the exact tile loop: the
port's :func:`~raft_tpu_torch.ops.select_k.approx_select_k` is an exact
selection, which meets any recall target. JAX materializes the
``[block, n]`` block whole; the tile loop bounds it (a 4,096-query block
of 1M rows would be 16 GB). :class:`BatchKQuery` pages through a query's
neighbours lazily.
"""
from __future__ import annotations

import dataclasses
import io
from typing import BinaryIO, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.ops.distance import (
    EXPANDED,
    DistanceType,
    accum_live_blocks,
    is_min_close,
    resolve_metric,
    row_norms,
    tile_distances,
)
from raft_tpu_torch.ops.select_k import running_merge, worst_value

NORM_METRICS = frozenset(
    {DistanceType.L2Expanded, DistanceType.L2SqrtExpanded, DistanceType.CosineExpanded}
)


@dataclasses.dataclass
class BruteForceIndex:
    """Persistent exact-kNN index."""

    dataset: torch.Tensor  # [n_rows, dim]
    norms: Optional[torch.Tensor]  # [n_rows] f32 squared norms, or None
    metric: DistanceType
    metric_arg: float

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]


def build(dataset, metric=DistanceType.L2SqrtExpanded, metric_arg: float = 2.0,
          res: Optional[Resources] = None) -> BruteForceIndex:
    """Store the dataset on ``res``'s device (default ``cuda``) and
    precompute squared norms for the norm metrics."""
    res = ensure_resources(res)
    metric = resolve_metric(metric)
    dataset = ser.as_tensor(dataset, res.device)
    expects(dataset.ndim == 2, "dataset must be [n_rows, dim]")
    norms = row_norms(dataset) if metric in NORM_METRICS else None
    return BruteForceIndex(dataset=dataset, norms=norms, metric=metric, metric_arg=float(metric_arg))


def _search_batch(index: BruteForceIndex, queries, filter_mask, *, k: int, tile: int):
    """One query batch over the dataset in tiles, folded into a running
    top-k (a slot that found only the worst sentinel keeps id -1)."""
    metric = index.metric
    select_min = is_min_close(metric)
    worst = worst_value(torch.float32, select_min)
    n = index.size
    qb = queries.shape[0]
    q_sqnorm = row_norms(queries) if metric in NORM_METRICS else None
    acc_v = torch.full((qb, k), worst, dtype=torch.float32, device=queries.device)
    acc_i = torch.full((qb, k), -1, dtype=torch.int32, device=queries.device)
    for s in range(0, n, tile):
        yt = index.dataset[s : s + tile]
        ynt = index.norms[s : s + tile] if index.norms is not None else None
        dist = tile_distances(queries, q_sqnorm, yt, ynt, metric, index.metric_arg).to(torch.float32)
        ids = torch.arange(s, s + yt.shape[0], dtype=torch.int32, device=queries.device)
        if filter_mask is not None:
            dist = torch.where(filter_mask[s : s + tile][None, :], dist, torch.full_like(dist, worst))
        ids = ids[None, :].expand_as(dist)
        acc_v, acc_i = running_merge(acc_v, acc_i, dist, ids, select_min=select_min)
    return acc_v, acc_i


def search(
    index: BruteForceIndex,
    queries,
    k: int,
    prefilter: Optional[Bitset] = None,
    query_batch: int = 4096,
    dataset_tile: Optional[int] = None,
    mode: str = "exact",
    recall_target: float = 0.99,
    res: Optional[Resources] = None,
    dataset=None,
    refine_ratio: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-nearest-neighbour search. Returns best-first ``(distances
    [nq, k] f32, indices [nq, k] i32)``; ``prefilter`` is a keep-bitset
    over dataset rows. ``mode="exact"`` (default) or ``"approx"`` (the
    matmul metrics only; exact on the card, see the module docstring).
    ``dataset`` + ``refine_ratio > 1`` re-ranks ``k * refine_ratio``
    candidates against ``dataset``.

    With :mod:`raft_tpu_torch.obs` enabled the call records a synced
    ``brute_force.search`` span with an ``exact_batch`` child a query
    batch (``approx``: one ``brute_force.search.approx`` child), or a
    ``brute_force.search.refine`` span, and counts
    ``brute_force.search.calls{mode}`` and ``.queries``."""
    dev = index.dataset.device
    queries = ser.as_tensor(queries, dev)
    if dataset is not None and refine_ratio > 1:
        from raft_tpu_torch.neighbors.refine import check_refine_dataset, refine, refine_source

        check_refine_dataset(dataset, index.size, "brute_force")
        kk = min(k * refine_ratio, index.size)
        _, cand = search(index, queries, kk, prefilter=prefilter, query_batch=query_batch,
                         dataset_tile=dataset_tile, mode=mode, recall_target=recall_target,
                         res=res)
        with obs.span("brute_force.search.refine", k=k, candidates=int(kk)) as sp:
            return sp.sync(refine(refine_source(dataset, dev), queries, cand, k,
                                  metric=index.metric, metric_arg=index.metric_arg))
    args = (index, queries, k, prefilter, query_batch, dataset_tile, mode, recall_target, res)
    if not obs.is_enabled():
        return _search_dispatch(*args)
    with obs.span("brute_force.search", k=k, nq=len(queries), mode=mode) as sp:
        return sp.sync(_search_dispatch(*args))


def _search_dispatch(index: BruteForceIndex, queries, k: int, prefilter: Optional[Bitset],
                     query_batch: int, dataset_tile: Optional[int], mode: str,
                     recall_target: float,
                     res: Optional[Resources]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The search behind :func:`search`, in query batches."""
    dev = index.dataset.device
    expects(queries.ndim == 2, "queries must be [n_queries, dim]")
    expects(queries.shape[1] == index.dim, "query dim %d != index dim %d", queries.shape[1], index.dim)
    n = index.size
    expects(0 < k <= n, "k=%d out of range for index of size %d", k, n)
    if prefilter is not None:
        expects(prefilter.size == n, "prefilter size %d != index size %d", prefilter.size, n)
    # JAX fails inside its scan (an AssertionError); the port says so up front
    expects(index.metric != DistanceType.Haversine,
            "brute_force cannot search Haversine (not a matmul or accumulation metric)")
    nq = queries.shape[0]
    if obs.is_enabled():
        obs.inc("brute_force.search.calls", mode=mode)
        obs.inc("brute_force.search.queries", float(nq))
    approx = mode == "approx"
    if approx:
        expects(index.metric in EXPANDED,
                "approx mode needs a matmul-shaped (expanded) metric, got %s", index.metric)
        expects(0.0 < recall_target <= 1.0, "recall_target must be in (0, 1], got %s",
                recall_target)
    else:
        expects(mode == "exact", "mode must be 'exact' or 'approx', got %r", mode)
    if dataset_tile is None:
        # per-tile temporaries within the workspace budget; an accumulation
        # metric holds accum_live_blocks [batch, tile, d] f32 blocks, so its
        # budget divides by d and by that count
        workspace = res.workspace_bytes if res is not None else 1 << 30
        qb = min(query_batch, nq)
        per_elem = 8 if index.metric in EXPANDED else 4 * accum_live_blocks(index.metric) * index.dim
        dataset_tile = max(512, min(n, workspace // (per_elem * max(qb, 1))))
    dataset_tile = int(min(dataset_tile, n))
    filter_mask = prefilter.to_mask().to(dev) if prefilter is not None else None
    out_v, out_i = [], []
    if approx:
        with obs.span("brute_force.search.approx", nq=nq, k=k) as sp:
            for start in range(0, nq, query_batch):
                v, i = _search_batch(index, queries[start : start + query_batch], filter_mask,
                                     k=k, tile=dataset_tile)
                out_v.append(v)
                out_i.append(i)
            sp.sync(out_v[-1])
    else:
        for start in range(0, nq, query_batch):
            qc = queries[start : start + query_batch]
            with obs.span("brute_force.search.exact_batch", nq=qc.shape[0], k=k,
                          tile=dataset_tile) as sp:
                v, i = sp.sync(_search_batch(index, qc, filter_mask, k=k, tile=dataset_tile))
            out_v.append(v)
            out_i.append(i)
    if len(out_v) == 1:
        return out_v[0], out_i[0]
    return torch.cat(out_v, dim=0), torch.cat(out_i, dim=0)


def knn(dataset, queries, k: int, metric=DistanceType.L2SqrtExpanded, metric_arg: float = 2.0,
        res: Optional[Resources] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot build + search."""
    idx = build(dataset, metric=metric, metric_arg=metric_arg, res=res)
    return search(idx, queries, k, res=res)


def from_numpy(arrays: dict, metric, metric_arg: float = 2.0, device=None) -> BruteForceIndex:
    """An index from numpy arrays: keys ``dataset`` and optionally
    ``norms``. ``device=None`` means ``cuda``."""
    dev = ensure_resources(device=device if device is not None else "cuda").device
    norms = arrays.get("norms")
    return BruteForceIndex(
        dataset=ser.from_numpy(np.asarray(arrays["dataset"]), dev),
        norms=None if norms is None else ser.from_numpy(np.asarray(norms), dev),
        metric=resolve_metric(metric),
        metric_arg=float(metric_arg),
    )


# -- serialization (same bytes as the JAX package) --------------------------

_KIND = "brute_force"
_VERSION = 1


def _write_body(index: BruteForceIndex, stream: BinaryIO) -> None:
    ser.serialize_scalar(stream, int(index.metric), "int32")
    ser.serialize_scalar(stream, float(index.metric_arg), "float64")
    ser.serialize_scalar(stream, int(index.norms is not None), "int32")
    ser.serialize_array(stream, index.dataset)
    if index.norms is not None:
        ser.serialize_array(stream, index.norms)


def save(index: BruteForceIndex, stream: BinaryIO) -> None:
    body = io.BytesIO()
    _write_body(index, body)
    ser.save_stream(stream, _KIND, _VERSION, body.getvalue())


def load(stream: BinaryIO, res: Optional[Resources] = None, device=None) -> BruteForceIndex:
    dev = ensure_resources(res, device).device
    _version, body = ser.load_stream(stream, _KIND)
    metric = DistanceType(ser.deserialize_scalar(body, "int32"))
    metric_arg = float(ser.deserialize_scalar(body, "float64"))
    has_norms = bool(ser.deserialize_scalar(body, "int32"))
    dataset = ser.deserialize_array(body, dev)
    norms = ser.deserialize_array(body, dev) if has_norms else None
    return BruteForceIndex(dataset=dataset, norms=norms, metric=metric, metric_arg=metric_arg)


def save_path(index: BruteForceIndex, path: str) -> str:
    return ser.atomic_write(path, lambda f: save(index, f))


def load_path(path: str, res: Optional[Resources] = None, device=None) -> BruteForceIndex:
    with open(path, "rb") as f:
        return load(f, res=res, device=device)


class BatchKQuery:
    """Lazy batched-k query iterator (JAX's ``BatchKQuery``; reference
    ``knn_brute_force_batch_k_query.cuh``): pages through each query's
    neighbours ``batch_size`` at a time, searching again with a k that
    grows 1.5x ahead of the page asked for, never past the index size.

    >>> for page in BatchKQuery(index, queries, batch_size=32):
    ...     ids, dists = page.indices, page.distances   # [nq, <= 32] each
    """

    class Batch:
        def __init__(self, distances, indices, offset):
            self.distances = distances
            self.indices = indices
            self.offset = offset

    def __init__(self, index: BruteForceIndex, queries, batch_size: int, mode: str = "exact"):
        expects(batch_size >= 1, "batch_size must be >= 1")
        self.index = index
        self.queries = ser.as_tensor(queries, index.dataset.device)
        self.batch_size = int(batch_size)
        self.mode = mode
        self._k = 0  # neighbours fetched so far
        self._dists = None
        self._ids = None

    def _ensure(self, k: int) -> None:
        if k <= self._k:
            return
        k_fetch = min(self.index.size, max(k, int(1.5 * k)))
        self._dists, self._ids = search(self.index, self.queries, k_fetch, mode=self.mode)
        self._k = k_fetch

    def batch(self, i: int) -> "BatchKQuery.Batch":
        """The i-th page of neighbours: ranks ``[i * bs, (i + 1) * bs)``."""
        lo = i * self.batch_size
        hi = min(lo + self.batch_size, self.index.size)
        expects(lo < self.index.size, "batch %d past index size", i)
        self._ensure(hi)
        return BatchKQuery.Batch(self._dists[:, lo:hi], self._ids[:, lo:hi], lo)

    def __iter__(self):
        i = 0
        while i * self.batch_size < self.index.size:
            yield self.batch(i)
            i += 1
