"""Candidate re-ranking with exact distances (``raft_tpu.neighbors.refine``
counterpart; reference ``neighbors/refine-inl.cuh:70``).

Gathers each query's candidate vectors, computes exact f32 distances and
keeps the best k. Two gather tiers share one re-rank core
(:func:`_exact_rerank`):

* a device-resident ``dataset``: the gather is ``dataset[ids]`` on the
  dataset's device;
* a host-resident ``dataset`` (a :class:`raft_tpu_torch.tiered.HostVectorStore`):
  the store gathers the rows on the host into a staging slab
  (:meth:`~raft_tpu_torch.tiered.HostVectorStore.gather_to`), which is
  copied to the queries' device and re-ranked there.

Both run the same f32 arithmetic on the same gathered values (an invalid
id, ``-1``, takes row 0 in either), so a tiered re-rank gives the resident
one's bits at the same batch shape.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.ops.distance import (
    EXPANDED,
    DistanceType,
    accum_finalize,
    accum_step,
    expanded_epilogue,
    is_min_close,
    resolve_metric,
)
from raft_tpu_torch.ops.select_k import select_k, worst_value


def is_host_dataset(dataset) -> bool:
    """True for host-tier vector stores (duck-typed, so this module never
    imports :mod:`raft_tpu_torch.tiered`, which imports it)."""
    return getattr(dataset, "is_host_tier", False)


def refine_source(dataset, device):
    """``dataset`` as the refine gather reads it: a host-tier store as it
    is, anything else as a tensor on ``device``."""
    return dataset if is_host_dataset(dataset) else ser.as_tensor(dataset, device)


def check_refine_dataset(dataset, index_size: int, algo: str = "index") -> None:
    """Validate a refine ``dataset`` before any scan runs."""
    shape = tuple(dataset.shape) if hasattr(dataset, "shape") else np.shape(dataset)
    expects(len(shape) == 2, "%s refine dataset must be [n_rows, dim], got shape %s", algo, shape)
    expects(
        int(shape[0]) >= index_size,
        "%s refine dataset has %d rows but the index holds %d vectors — every "
        "stored id must be gatherable; pass the full build dataset (or a HostVectorStore "
        "over it)",
        algo, int(shape[0]), index_size,
    )


def _exact_rerank(cand_vecs, queries, candidates, valid, *, k: int, metric: DistanceType,
                  metric_arg: float = 2.0):
    """Exact per-candidate distances + top-k. ``cand_vecs`` [nq, n_cand, d].
    The distances are brute force's for each query against its own
    candidates: a batched matmul and the same epilogue for the matmul
    metrics, the same step broadcast per query for the others."""
    qf = queries.to(torch.float32)
    cf = cand_vecs.to(torch.float32)
    select_min = is_min_close(metric)
    worst = worst_value(torch.float32, select_min)
    if metric in EXPANDED:
        qs, cs = (torch.sqrt(qf), torch.sqrt(cf)) if metric == DistanceType.HellingerExpanded else (qf, cf)
        dot = torch.bmm(cs, qs[:, :, None])[:, :, 0]  # [nq, n_cand]
        dists = expanded_epilogue(dot, qf, cf, metric, lambda v: v[:, None], lambda v: v)
    else:
        dists = accum_finalize(accum_step(qf[:, None, :], cf, metric, metric_arg), metric,
                               metric_arg, qf.shape[1])
    dists = torch.where(valid, dists, torch.full_like(dists, worst))
    vals, pos = select_k(dists, k, select_min=select_min)
    pos = pos.to(torch.int64)
    idx = torch.gather(candidates, 1, pos)
    idx = torch.where(torch.gather(valid, 1, pos), idx, torch.full_like(idx, -1))
    return vals, idx


def refine(
    dataset,
    queries,
    candidates,
    k: int,
    metric=DistanceType.L2SqrtExpanded,
    metric_arg: float = 2.0,
    query_batch: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank ``candidates`` [nq, n_cand] (int32 ids into ``dataset``,
    -1 = invalid) down to the best ``k`` by exact distance. ``query_batch``
    0 caps the gathered [batch, n_cand, d] f32 slab at about 1 GB. With
    :mod:`raft_tpu_torch.obs` enabled: a synced ``refine.refine`` span,
    ``refine.refine.calls``, ``.queries`` and the
    ``.candidates_per_query`` histogram."""
    if not obs.is_enabled():
        return _refine_dispatch(dataset, queries, candidates, k, metric, metric_arg, query_batch)
    nq = len(queries)
    shape = np.shape(candidates)
    n_cand = int(shape[1]) if len(shape) == 2 else 0
    obs.inc("refine.refine.calls")
    obs.inc("refine.refine.queries", float(nq))
    obs.observe("refine.refine.candidates_per_query", float(n_cand))
    with obs.span("refine.refine", k=k, nq=nq, candidates=n_cand) as sp:
        return sp.sync(_refine_dispatch(dataset, queries, candidates, k, metric, metric_arg,
                                        query_batch))


def _refine_dispatch(dataset, queries, candidates, k: int, metric, metric_arg: float,
                     query_batch: int):
    """The re-rank behind :func:`refine`, in query batches; a host-tier
    ``dataset`` gathers each batch's rows on the host (its candidates come
    to the host for it) and re-ranks them on the queries' device."""
    metric = resolve_metric(metric)
    # JAX fails inside its jit (an AssertionError); the port says so up front
    expects(metric != DistanceType.Haversine,
            "refine cannot re-rank under Haversine (not a matmul or accumulation metric)")
    host_tier = is_host_dataset(dataset)
    if host_tier:
        dev = queries.device if isinstance(queries, torch.Tensor) else torch.device("cpu")
    else:
        dataset = torch.as_tensor(dataset)
        dev = dataset.device
    queries = torch.as_tensor(queries).to(dev)
    candidates = torch.as_tensor(candidates).to(device=dev, dtype=torch.int32)
    expects(candidates.ndim == 2, "candidates must be [n_queries, n_candidates]")
    expects(candidates.shape[0] == queries.shape[0], "queries/candidates row mismatch")
    n_cand = candidates.shape[1]
    expects(0 < k <= n_cand, "k=%d out of range for %d candidates", k, n_cand)
    nq = queries.shape[0]
    if query_batch <= 0:
        query_batch = max(256, (1 << 30) // max(1, n_cand * dataset.shape[1] * 4))
    out_v, out_i = [], []
    for s in range(0, nq, query_batch):
        c = candidates[s : s + query_batch]
        valid = c >= 0
        if host_tier:
            cand_vecs = dataset.gather_to(c.cpu().numpy(), dev)
        else:
            cand_vecs = dataset[torch.where(valid, c, torch.zeros_like(c)).to(torch.int64)]
        v, i = _exact_rerank(cand_vecs, queries[s : s + query_batch], c, valid, k=k, metric=metric,
                             metric_arg=float(metric_arg))
        out_v.append(v)
        out_i.append(i)
    if len(out_v) == 1:
        return out_v[0], out_i[0]
    return torch.cat(out_v, dim=0), torch.cat(out_i, dim=0)
