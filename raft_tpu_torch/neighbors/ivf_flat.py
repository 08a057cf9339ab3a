"""IVF-Flat index (``raft_tpu.neighbors.ivf_flat`` counterpart).

Lists live in one dense padded tensor ``list_data [n_lists, max_list, d]``
with ``list_indices [n_lists, max_list]`` (int32, -1 = empty slot),
``list_sizes [n_lists]`` and f32 squared ``list_norms`` — the layout and
the serialized form (kind ``ivf_flat``, version 3) of the JAX package, so
an index saved by either package loads in the other.

Search modes:

* ``"fused"`` — the fused probed-list scan
  (:func:`raft_tpu_torch.ops.ivf_scan.ivf_flat_fused_search`, the Hopper
  kernel on the card). It computes the exact top-k whatever
  ``fused_merge`` says (the JAX ``bank*``/``seg*`` merges approximate it).
* ``"scan"`` — the dense masked scan (:func:`flat_scan_core`): every list
  chunk scored by one f32 matmul, unprobed lists and empty slots masked,
  an exact top-k; the per-shard core of
  :func:`raft_tpu_torch.parallel.sharded_ivf_flat_search`.
* ``"probe"`` — per-probe gather + running merge (the latency path).
* ``"auto"`` — from 128 queries, fused on a CUDA index when the metric is
  supported and scan on any other device (the JAX package's choice off a
  TPU); else probe (:func:`raft_tpu_torch.neighbors.ivf_common.auto_search_mode`).

Supported metrics: L2Expanded, L2SqrtExpanded, InnerProduct,
CosineExpanded.
"""
from __future__ import annotations

import dataclasses
import io
from typing import BinaryIO, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import BalancedKMeansParams
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.neighbors import ivf_common
from raft_tpu_torch.neighbors.ivf_common import pack_rows, topk_labels
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric, row_norms
from raft_tpu_torch.ops.fused_1nn import normalize_rows
from raft_tpu_torch.ops.ivf_scan import (
    ivf_flat_fused_search,
    spatial_center_rank,
    supported_metric,
)
from raft_tpu_torch.ops.select_k import select_k, worst_value

#: The fused scan's unit of ``group`` adjacent lists is clamped so that
#: ``group * max_list * d * (2 * itemsize + cast bytes)`` stays within this
#: budget — the JAX package's TPU VMEM figure (``ivf_flat.py:718-729``).
#: The group decides which lists a tile scans, so the port keeps the same
#: rule to scan the same units; retuning it for the H100 changes recall.
FUSED_GROUP_BUDGET_BYTES = 12 * 1024 * 1024


@dataclasses.dataclass
class IvfFlatIndexParams:
    """``ivf_flat::index_params`` analog."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    seed: int = 0
    list_cap_factor: float = 2.0


@dataclasses.dataclass
class IvfFlatSearchParams:
    """``ivf_flat::search_params`` analog; every field and default of the
    JAX package. In the port ``fused_merge`` and ``fused_precision`` do not
    change the result: the kernel keeps the exact top-k with f32 dot
    products. ``fused_extract_every`` and ``fused_col_chunk`` tune the TPU
    kernel only."""

    n_probes: int = 20
    fused_qt: int = 128
    fused_probe_factor: int = 32
    fused_group: int = 8
    fused_merge: str = "bank8"
    fused_precision: str = "highest"
    fused_extract_every: int = 0
    fused_col_chunk: int = 1024
    refine_ratio: int = 1


@dataclasses.dataclass
class IvfFlatIndex:
    """Dense-padded inverted-file index."""

    centers: torch.Tensor  # [n_lists, d] f32
    list_data: torch.Tensor  # [n_lists, max_list, d]
    list_indices: torch.Tensor  # [n_lists, max_list] i32, -1 = empty
    list_sizes: torch.Tensor  # [n_lists] i32
    list_norms: Optional[torch.Tensor]  # [n_lists, max_list] f32
    metric: DistanceType
    size: int
    list_cap_factor: float = 2.0
    center_rank: Optional[torch.Tensor] = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def max_list(self) -> int:
        return self.list_data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centers.device


def build_with_centers(dataset, centers, params: Optional[IvfFlatIndexParams] = None,
                       res: Optional[Resources] = None, **kwargs) -> IvfFlatIndex:
    """Pack the inverted lists around given centers — the second half of
    :func:`build`. ``centers`` must already be in spatial order (as a
    built index's centers are); the lists keep that order and
    ``center_rank`` is the identity."""
    res = ensure_resources(res)
    if params is None:
        params = IvfFlatIndexParams(**kwargs)
    metric = resolve_metric(params.metric)
    dataset = ser.as_tensor(dataset, res.device)
    centers = ser.as_tensor(centers, res.device).to(torch.float32)
    n, d = dataset.shape
    n_lists = centers.shape[0]
    assign_data = dataset.to(torch.float32)
    if metric == DistanceType.CosineExpanded:
        assign_data = normalize_rows(assign_data)
    cand = topk_labels(assign_data, centers, k=8)
    list_data, list_indices, list_sizes, _ = pack_rows(
        dataset, torch.arange(n, dtype=torch.int32, device=res.device), cand, n_lists,
        params.list_cap_factor,
    )
    list_norms = None
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded, DistanceType.CosineExpanded):
        list_norms = row_norms(list_data.reshape(-1, d)).reshape(list_data.shape[:2])
    return IvfFlatIndex(
        centers=centers,
        list_data=list_data,
        list_indices=list_indices,
        list_sizes=list_sizes,
        list_norms=list_norms,
        metric=metric,
        size=n,
        list_cap_factor=params.list_cap_factor,
        center_rank=torch.arange(n_lists, dtype=torch.int32, device=res.device),
    )


def build(
    dataset,
    params: Optional[IvfFlatIndexParams] = None,
    res: Optional[Resources] = None,
    **kwargs,
) -> IvfFlatIndex:
    """Train centers with balanced k-means, order the lists by the
    PCA-bisection rank of their centers, and pack the lists
    (``ivf_flat::build``). The trainset sample is numpy
    ``default_rng(seed)``'s permutation, as in the JAX package."""
    res = ensure_resources(res)
    if params is None:
        params = IvfFlatIndexParams(**kwargs)
    metric = resolve_metric(params.metric)
    expects(supported_metric(metric), "IVF-Flat does not support metric %s", metric)
    dataset = ser.as_tensor(dataset, res.device)
    expects(dataset.ndim == 2, "dataset must be [n_rows, dim]")
    n, d = dataset.shape
    n_lists = min(params.n_lists, n)

    train_n = max(n_lists, int(n * params.kmeans_trainset_fraction))
    ds_f32 = dataset.to(torch.float32)
    trainset = ds_f32
    if train_n < n:
        rng = np.random.default_rng(params.seed)
        perm = torch.from_numpy(rng.permutation(n)[:train_n]).to(res.device)
        trainset = ds_f32[perm]
    if metric == DistanceType.CosineExpanded:
        trainset = normalize_rows(trainset)

    centers = kmeans_balanced.fit(
        trainset,
        BalancedKMeansParams(
            n_clusters=n_lists,
            n_iters=params.kmeans_n_iters,
            metric=DistanceType.L2Expanded,
            seed=params.seed,
        ),
    )
    rank = spatial_center_rank(centers.cpu().numpy())
    centers = centers[torch.from_numpy(np.argsort(rank)).to(res.device)]
    return build_with_centers(dataset, centers, dataclasses.replace(params, metric=metric), res)


def extend(index: IvfFlatIndex, new_vectors, new_ids=None,
           cap_factor: Optional[float] = None) -> IvfFlatIndex:
    """Add vectors (centers fixed): valid rows are gathered, concatenated
    with the new ones and re-packed on the index's device."""
    if cap_factor is None:
        cap_factor = index.list_cap_factor
    dev = index.device
    new_vectors = ser.as_tensor(new_vectors, dev)
    expects(new_vectors.ndim == 2 and new_vectors.shape[1] == index.dim, "bad extend shape")
    n_new = new_vectors.shape[0]
    if new_ids is None:
        new_ids = torch.arange(index.size, index.size + n_new, dtype=torch.int32, device=dev)
    else:
        new_ids = ser.as_tensor(new_ids, dev).to(torch.int32)
    d = index.dim
    flat_ids = index.list_indices.reshape(-1)
    keep_order = torch.argsort((flat_ids < 0).to(torch.int32), stable=True)[: int(index.size)]
    old_data = index.list_data.reshape(-1, d)[keep_order]
    old_ids = flat_ids[keep_order]
    all_data = torch.cat([old_data, new_vectors.to(index.list_data.dtype)], dim=0)
    all_ids = torch.cat([old_ids, new_ids])
    assign = all_data.to(torch.float32)
    if index.metric == DistanceType.CosineExpanded:
        assign = normalize_rows(assign)
    cand = topk_labels(assign, index.centers, k=8)
    list_data, list_indices, list_sizes, _ = pack_rows(all_data, all_ids, cand, index.n_lists, cap_factor)
    list_norms = None
    if index.list_norms is not None:
        list_norms = row_norms(list_data.reshape(-1, d)).reshape(list_data.shape[:2])
    return IvfFlatIndex(
        centers=index.centers,
        list_data=list_data,
        list_indices=list_indices,
        list_sizes=list_sizes,
        list_norms=list_norms,
        metric=index.metric,
        size=index.size + n_new,
        list_cap_factor=cap_factor,
        center_rank=index.center_rank,
    )


def _probe_search(index: IvfFlatIndex, queries, filter_bits, *, k: int, n_probes: int):
    """Per-probe gather + running merge (``ivf_flat.py:461-537``), several
    probes a merge (:func:`ivf_common.merge_probes`)."""
    metric = index.metric
    nq = queries.shape[0]
    qf = queries.to(torch.float32)
    if metric == DistanceType.CosineExpanded:
        qf = normalize_rows(qf)
    q_dot_c = qf @ index.centers.T
    if metric == DistanceType.InnerProduct:
        coarse = -q_dot_c
    else:
        coarse = torch.sum(index.centers * index.centers, dim=1)[None, :] - 2.0 * q_dot_c
    _, probes = select_k(coarse, n_probes, select_min=True)
    probes = probes.to(torch.int64)
    q_sqnorm = torch.sum(qf * qf, dim=1)
    select_min = metric != DistanceType.InnerProduct
    worst = worst_value(torch.float32, select_min)

    def tiles():
        for p in range(n_probes):
            list_id = probes[:, p]
            data_p = index.list_data[list_id].to(torch.float32)  # [nq, max_list, d]
            ids_p = index.list_indices[list_id]
            dots = torch.bmm(data_p, qf[:, :, None])[:, :, 0]
            if metric == DistanceType.InnerProduct:
                dist = dots
            elif metric == DistanceType.CosineExpanded:
                dist = 1.0 - dots * torch.rsqrt(torch.clamp(index.list_norms[list_id], min=1e-24))
            else:
                dist = torch.clamp(q_sqnorm[:, None] + index.list_norms[list_id] - 2.0 * dots,
                                   min=0.0)
            valid = ids_p >= 0
            if filter_bits is not None:
                ids = torch.clamp(ids_p, min=0).to(torch.int64)
                bit = (filter_bits[ids // 32] >> (ids % 32).to(torch.int32)) & 1
                valid = valid & (bit == 1)
            dist = torch.where(valid, dist, torch.full_like(dist, worst))
            ids_masked = torch.where(valid, ids_p, torch.full_like(ids_p, -1))
            yield dist, ids_masked

    acc_v, acc_i = ivf_common.merge_probes(tiles(), nq=nq, k=k, n_probes=n_probes,
                                           cols=index.list_indices.shape[1],
                                           select_min=select_min, device=qf.device)
    if metric == DistanceType.L2SqrtExpanded:
        acc_v = torch.where(acc_i >= 0, torch.sqrt(torch.clamp(acc_v, min=0.0)), acc_v)
    return acc_v, acc_i


def scan_chunk_lists(n_lists: int, max_list: int) -> int:
    """Lists per chunk of the dense scan: about 512k rows, rounded down to a
    divisor of ``n_lists``."""
    g = max(1, 524288 // max(max_list, 1))
    while n_lists % g:
        g -= 1
    return g


def probe_mask(centers, qf, n_probes: int, metric: DistanceType) -> torch.Tensor:
    """``[nq, n_lists]`` bool: the lists each query probes. For cosine,
    ``qf`` must already be unit-normalized."""
    return ivf_common.probe_selection(centers, qf, n_probes, metric)[1]


def flat_scan_core(list_data, list_indices, list_norms, qf, probed, filter_bits, *, k: int,
                   metric: DistanceType, has_filter: bool,
                   chunk_lists: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked dense scan over (a shard of) the padded lists
    (``ivf_flat.py:366-459``). ``probed`` is ``[nq, n_lists_local]``;
    ``list_indices`` carry global row ids, so per-shard results merge
    directly. Each chunk of ``chunk_lists`` lists is scored by one f32
    matmul (the score is the negated distance up to the query norm), empty
    or filtered slots and unprobed lists get ``-inf`` added, a ``max(2k,
    16)`` shortlist is selected and merged into the running top-k. The
    selection is exact, with ``lax.top_k``'s tie order (the JAX package's
    ``approx_max_k`` is exact on the CPU). ``filter_bits`` is read only
    when ``has_filter``, as in the JAX package. Returns ``(distances, ids)``."""
    nq = qf.shape[0]
    if not has_filter:
        filter_bits = None
    n_lists, max_list = list_indices.shape
    d = list_data.shape[-1]
    G, M = chunk_lists, max_list
    expects(n_lists % G == 0, "chunk_lists %d does not divide %d lists", G, n_lists)
    dev = qf.device
    acc_v = torch.full((nq, k), float("-inf"), dtype=torch.float32, device=dev)
    acc_i = torch.zeros((nq, k), dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    for c in range(n_lists // G):
        lo, hi = c * G, (c + 1) * G
        rows = list_data[lo:hi].reshape(G * M, d).to(torch.float32)
        score = qf @ rows.T
        if metric == DistanceType.CosineExpanded:
            nrm = list_norms[lo:hi].reshape(G * M)
            score.mul_(torch.rsqrt(torch.clamp(nrm, min=1e-24))[None, :])
        elif metric != DistanceType.InnerProduct:
            nrm = list_norms[lo:hi].reshape(G * M)
            score.mul_(2.0).sub_(nrm[None, :])  # max == min L2
        valid = ivf_common.valid_slots(list_indices[lo:hi].reshape(G * M), filter_bits)
        score.add_(torch.where(valid, 0.0, neg_inf)[None, :])
        score.view(nq, G, M).add_(torch.where(probed[:, lo:hi], 0.0, neg_inf)[:, :, None])
        kk = min(max(2 * k, 16), G * M)
        v, i = select_k(score, kk, select_min=False)
        del score
        nv, ni = select_k(torch.cat([acc_v, v], dim=1), k, select_min=False)
        acc_i = torch.gather(torch.cat([acc_i, i + c * G * M], dim=1), 1, ni.to(torch.int64))
        acc_v = nv
    idx = list_indices.reshape(-1)[acc_i.to(torch.int64).reshape(-1)].reshape(nq, k)
    idx = torch.where(torch.isfinite(acc_v), idx, -1).to(torch.int32)
    if metric == DistanceType.InnerProduct:
        return acc_v, idx
    if metric == DistanceType.CosineExpanded:
        return torch.where(idx >= 0, 1.0 - acc_v, float("inf")), idx
    qn = torch.sum(qf * qf, dim=1)
    out = torch.clamp(qn[:, None] - acc_v, min=0.0)
    if metric == DistanceType.L2SqrtExpanded:
        out = torch.sqrt(out)
    return torch.where(idx >= 0, out, float("inf")), idx


def _ivf_flat_scan_impl(centers, list_data, list_indices, list_norms, queries, filter_bits, *,
                        k: int, n_probes: int, metric: DistanceType, chunk_lists: int):
    """The dense scan of one query batch (``ivf_flat.py:302-345``): probe
    mask, then :func:`flat_scan_core` over every list."""
    qf = queries.to(torch.float32)
    if metric == DistanceType.CosineExpanded:
        qf = normalize_rows(qf)
    probed = probe_mask(centers, qf, n_probes, metric)
    return flat_scan_core(list_data, list_indices, list_norms, qf, probed, filter_bits, k=k,
                          metric=metric, has_filter=filter_bits is not None,
                          chunk_lists=chunk_lists)


def fused_group(index: IvfFlatIndex, params: IvfFlatSearchParams) -> int:
    """Lists per fused-scan unit: ``params.fused_group`` clamped by
    :data:`FUSED_GROUP_BUDGET_BYTES`, 1 for a legacy (non-identity)
    ``center_rank``, rounded down to a divisor of ``n_lists``."""
    itemsize = index.list_data.element_size()
    cast_bytes = 4 if itemsize < 2 else 0
    per_group = index.max_list * index.dim * (2 * itemsize + cast_bytes)
    cap = max(1, FUSED_GROUP_BUDGET_BYTES // max(1, per_group))
    group = max(1, min(params.fused_group, index.n_lists, cap))
    rank = index.center_rank
    if rank is not None and not bool(torch.equal(
            rank.cpu().to(torch.int64), torch.arange(rank.shape[0]))):
        group = 1
    while index.n_lists % group:
        group -= 1
    return group


def _batched(run, queries, query_batch: int):
    """Run per batch; the tail batch is zero-padded to ``query_batch`` rows
    when there is more than one batch, as in the JAX package (padding
    rows join the fused path's query tiles, so this keeps results equal)."""
    nq = queries.shape[0]
    out_v, out_i = [], []
    for start in range(0, nq, query_batch):
        qc = queries[start : start + query_batch]
        bpad = query_batch - qc.shape[0] if nq > query_batch else 0
        if bpad:
            qc = torch.nn.functional.pad(qc, (0, 0, 0, bpad))
        v, i = run(qc)
        if bpad:
            v, i = v[:-bpad], i[:-bpad]
        out_v.append(v)
        out_i.append(i)
    if len(out_v) == 1:
        return out_v[0], out_i[0]
    return torch.cat(out_v, dim=0), torch.cat(out_i, dim=0)


def search(
    index: IvfFlatIndex,
    queries,
    k: int,
    params: Optional[IvfFlatSearchParams] = None,
    prefilter: Optional[Bitset] = None,
    query_batch: int = 1024,
    mode: str = "auto",
    res: Optional[Resources] = None,
    dataset=None,
    **kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search over probed lists. Returns best-first ``(distances
    [nq, k] f32, indices [nq, k] i32)`` on the index's device; unfilled
    slots get id -1. With ``dataset`` and ``params.refine_ratio > 1`` the
    scan keeps ``k * refine_ratio`` candidates and re-ranks them exactly
    against ``dataset`` (with :mod:`raft_tpu_torch.obs` enabled, in an
    ``ivf_flat.search.refine`` span, observing
    ``ivf_flat.search.refine_candidates_per_query``)."""
    if params is None:
        params = IvfFlatSearchParams(**kwargs)
    dev = index.device
    queries = ser.as_tensor(queries, dev)
    expects(queries.ndim == 2 and queries.shape[1] == index.dim, "bad query shape")
    expects(k >= 1, "k must be >= 1")
    if dataset is not None and params.refine_ratio > 1:
        from raft_tpu_torch.neighbors.refine import check_refine_dataset, refine, refine_source

        check_refine_dataset(dataset, index.size, "ivf_flat")
        inner = dataclasses.replace(params, refine_ratio=1)
        kk = min(k * params.refine_ratio, index.size)
        _, cand = search(index, queries, kk, inner, prefilter=prefilter,
                         query_batch=query_batch, mode=mode, res=res)
        if obs.is_enabled():
            obs.observe("ivf_flat.search.refine_candidates_per_query", float(kk))
        with obs.span("ivf_flat.search.refine", k=k, candidates=int(kk)) as sp:
            return sp.sync(refine(refine_source(dataset, dev), queries, cand, k,
                                  metric=index.metric))
    if prefilter is not None:
        expects(prefilter.size >= index.size, "prefilter smaller than index")
    filter_bits = prefilter.bits.to(dev) if prefilter is not None else None
    n_probes = min(params.n_probes, index.n_lists)
    nq = queries.shape[0]
    if mode == "auto":
        mode = ivf_common.auto_search_mode(dev, nq, supported_metric(index.metric),
                                           algo="ivf_flat")
    expects(mode in ("scan", "probe", "fused"), "mode must be auto|scan|probe|fused, got %r",
            mode)
    if mode == "scan":
        expects(supported_metric(index.metric), "scan mode: unsupported metric")
        g = scan_chunk_lists(index.n_lists, index.max_list)

        def run_scan(qc):
            return _ivf_flat_scan_impl(index.centers, index.list_data, index.list_indices,
                                       index.list_norms, qc, filter_bits, k=k, n_probes=n_probes,
                                       metric=index.metric, chunk_lists=g)

        return _batched(run_scan, queries, query_batch)
    if mode == "fused":
        expects(supported_metric(index.metric), "fused mode: unsupported metric")
        rank = index.center_rank
        if rank is None:
            rank = torch.from_numpy(spatial_center_rank(index.centers.cpu().numpy())).to(dev)
        group = fused_group(index, params)

        def run(qc):
            return ivf_flat_fused_search(
                index.centers, rank, index.list_data, index.list_indices, index.list_norms,
                qc, filter_bits, k=k, n_probes=n_probes, metric=index.metric,
                qt=params.fused_qt, probe_factor=params.fused_probe_factor, group=group,
                merge=params.fused_merge, precision=params.fused_precision,
            )

        return _batched(run, queries, query_batch)

    def run_probe(qc):
        return _probe_search(index, qc, filter_bits, k=k, n_probes=n_probes)

    return _batched(run_probe, queries, query_batch)


# -- carrying an index across packages -------------------------------------


def from_numpy(arrays: dict, metric, size: int, list_cap_factor: float = 2.0,
               device=None) -> IvfFlatIndex:
    """An index from numpy arrays (e.g. a JAX index's fields through
    ``np.asarray``): keys ``centers``, ``list_data``, ``list_indices``,
    ``list_sizes`` and optionally ``list_norms``, ``center_rank``.
    ``device=None`` means ``cuda``."""
    dev = ensure_resources(device=device if device is not None else "cuda").device

    def get(name):
        a = arrays.get(name)
        return None if a is None else ser.from_numpy(np.asarray(a), dev)

    return IvfFlatIndex(
        centers=get("centers").to(torch.float32),
        list_data=get("list_data"),
        list_indices=get("list_indices").to(torch.int32),
        list_sizes=get("list_sizes").to(torch.int32),
        list_norms=get("list_norms"),
        metric=resolve_metric(metric),
        size=int(size),
        list_cap_factor=float(list_cap_factor),
        center_rank=get("center_rank"),
    )


# -- serialization (same bytes as the JAX package) --------------------------

_KIND = "ivf_flat"
_VERSION = 3


def _write_body(index: IvfFlatIndex, stream: BinaryIO) -> None:
    ser.serialize_scalar(stream, int(index.metric), "int32")
    ser.serialize_scalar(stream, int(index.size), "int64")
    ser.serialize_scalar(stream, float(index.list_cap_factor), "float64")
    ser.serialize_scalar(stream, int(index.list_norms is not None), "int32")
    ser.serialize_scalar(stream, int(index.center_rank is not None), "int32")
    ser.serialize_array(stream, index.centers)
    ser.serialize_array(stream, index.list_data)
    ser.serialize_array(stream, index.list_indices)
    ser.serialize_array(stream, index.list_sizes)
    if index.list_norms is not None:
        ser.serialize_array(stream, index.list_norms)
    if index.center_rank is not None:
        ser.serialize_array(stream, index.center_rank)


def save(index: IvfFlatIndex, stream: BinaryIO) -> None:
    body = io.BytesIO()
    _write_body(index, body)
    ser.save_stream(stream, _KIND, _VERSION, body.getvalue())


def load(stream: BinaryIO, res: Optional[Resources] = None, device=None) -> IvfFlatIndex:
    """Load an index saved by either package onto ``res``/``device``
    (default ``cuda``)."""
    dev = ensure_resources(res, device).device
    version, stream = ser.load_stream(stream, _KIND)
    metric = DistanceType(ser.deserialize_scalar(stream, "int32"))
    size = int(ser.deserialize_scalar(stream, "int64"))
    cap_factor = float(ser.deserialize_scalar(stream, "float64")) if version >= 2 else 2.0
    has_norms = bool(ser.deserialize_scalar(stream, "int32"))
    has_rank = bool(ser.deserialize_scalar(stream, "int32")) if version >= 3 else False
    centers = ser.deserialize_array(stream, dev)
    list_data = ser.deserialize_array(stream, dev)
    list_indices = ser.deserialize_array(stream, dev)
    list_sizes = ser.deserialize_array(stream, dev)
    list_norms = ser.deserialize_array(stream, dev) if has_norms else None
    center_rank = ser.deserialize_array(stream, dev) if has_rank else None
    return IvfFlatIndex(
        centers=centers,
        list_data=list_data,
        list_indices=list_indices,
        list_sizes=list_sizes,
        list_norms=list_norms,
        metric=metric,
        size=size,
        list_cap_factor=cap_factor,
        center_rank=center_rank,
    )


def save_path(index: IvfFlatIndex, path: str) -> str:
    """Atomic (temp-then-rename) checksummed snapshot at ``path``."""
    return ser.atomic_write(path, lambda f: save(index, f))


def load_path(path: str, res: Optional[Resources] = None, device=None) -> IvfFlatIndex:
    with open(path, "rb") as f:
        return load(f, res=res, device=device)
