"""Lists-sharded ANN search (``raft_tpu.parallel.sharded_ann`` counterpart,
the search half).

The inverted lists are split into equal slices, one per shard; the coarse
centers (and IVF-PQ's rotation and codebooks) are replicated. Each shard
probes against the replicated centers, keeps the probe columns of its own
lists and runs the dense scan over its slice
(:func:`raft_tpu_torch.neighbors.ivf_flat.flat_scan_core`,
:func:`raft_tpu_torch.neighbors.ivf_pq.pq_scan_core`); list ids are global
rows, so the per-shard ``[nq, k]`` candidates merge directly, through the
ring top-k (``merge_mode="ring"``, kernel B6 on a CUDA mesh), the scan ring
(``"fused_ring"``, B7) or the gather merge (``"gather"``, the reference
engine). All three give the same ids and values bit for bit. This is how
an index larger than one card's memory is served.

The lists are split once per (index, mesh) and cached on the index (a
plain attribute; a shard on the index's device gets a view). A ``health``
mask demotes unhealthy shards' candidates to ``(worst, -1)``, which lose
every fold as they lose the gather merge (degraded-mode search).

Differences from the JAX package: no planner (``auto`` is ring for more
than one shard, else gather), and no fallback: a ring that fails raises
(the JAX package re-runs it on gather). The distributed builds, the
query-sharded CAGRA search and the tiered sharded index are not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.neighbors import ivf_common
from raft_tpu_torch.neighbors import ivf_flat as ivf_flat_mod
from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod
from raft_tpu_torch.ops.distance import DistanceType
from raft_tpu_torch.ops.fused_1nn import normalize_rows
from raft_tpu_torch.ops.select_k import worst_value
from raft_tpu_torch.parallel import comms

#: candidate-exchange engines of the sharded searches
_MERGE_MODES = ("auto", "ring", "fused_ring", "gather")


def _health_array(health, n_shards: int) -> Tuple[bool, ...]:
    """The per-shard health mask as a tuple of bools."""
    h = tuple(bool(x) for x in (health.tolist() if torch.is_tensor(health) else health))
    expects(len(h) == n_shards, "health mask has %d entries for %d shards", len(h), n_shards)
    return h


def _resolve_merge_mode(merge_mode: str, n_shards: int, k=None) -> str:
    """``auto`` is the ring for more than one shard (exact parity with
    gather, ~0.4 n times fewer wire bytes), else gather, through
    :func:`raft_tpu_torch.plan.plan_merge_mode` when the planner's gate is
    on; ``fused_ring`` on one shard has nothing to exchange and is
    gather."""
    expects(merge_mode in _MERGE_MODES, "merge_mode %r (want one of %s)", merge_mode, _MERGE_MODES)
    if merge_mode == "auto":
        from raft_tpu_torch import plan

        if plan.is_enabled():
            return plan.plan_merge_mode(n_shards, k).choice
        return "ring" if n_shards > 1 else "gather"
    if merge_mode == "fused_ring" and n_shards == 1:
        return "gather"
    return merge_mode


def _exchange_merge(mesh, vs, is_, k: int, select_min: bool, merge_mode: str):
    """Cross-shard exchange and merge of the per-shard candidates; returns
    one replicated ``(vals, ids)`` pair per shard, as two lists."""
    # lazy: ops.ring_topk imports parallel.comms
    from raft_tpu_torch.ops.ring_topk import gather_merge, ring_topk, scan_ring_topk

    if merge_mode == "fused_ring":
        return scan_ring_topk(mesh, vs, is_, k, select_min=select_min)
    if merge_mode == "ring":
        return ring_topk(mesh, vs, is_, k, select_min=select_min)
    return gather_merge(mesh, vs, is_, k, select_min)


def _demote(v, i, select_min: bool):
    """An unhealthy shard's candidates: worst values and id -1."""
    return (torch.full_like(v, worst_value(v.dtype, select_min)), torch.full_like(i, -1))


def _shards_of(index, mesh, axis: str, replicated: dict, sharded: dict) -> dict:
    """Per-shard tensors, split once per (index, mesh) and cached on the
    index: ``replicated`` ones copied to each shard's device, ``sharded``
    ones cut into equal row blocks."""
    cache = index.__dict__.setdefault("_shard_cache", {})
    key = (mesh.key(), axis)
    if key not in cache:
        parts = {name: comms.replicated(mesh, t) for name, t in replicated.items()}
        parts.update({name: comms.row_sharded(mesh, t) for name, t in sharded.items()})
        cache[key] = parts
    return cache[key]


def sharded_ivf_flat_search(mesh, index, queries, k: int,
                            params: Optional["ivf_flat_mod.IvfFlatSearchParams"] = None,
                            axis: str = comms.DEFAULT_AXIS, health=None,
                            merge_mode: str = "auto",
                            **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-Flat search with the lists sharded over ``mesh``. Returns
    ``(distances [nq, k], indices [nq, k])`` on the first shard's device,
    drawn from the same probed candidate set as the single-device
    ``search(mode="scan")``. ``health`` (one bool per shard) excludes
    unhealthy shards from the merge; ``merge_mode`` picks the exchange
    (``"ring"``, ``"fused_ring"``, ``"gather"`` or ``"auto"``)."""
    if params is None:
        params = ivf_flat_mod.IvfFlatSearchParams(**kwargs)
    n_shards = comms.comm_size(mesh, axis)
    L = index.n_lists
    expects(L % n_shards == 0, "n_lists %d not divisible by %d shards", L, n_shards)
    expects(ivf_flat_mod.supported_metric(index.metric), "sharded IVF-Flat: unsupported metric %s",
            index.metric)
    l_local = L // n_shards
    n_probes = min(params.n_probes, L)
    metric = index.metric
    g = ivf_flat_mod.scan_chunk_lists(l_local, index.max_list)
    healthy = _health_array(health, n_shards) if health is not None else None
    mode = _resolve_merge_mode(merge_mode, n_shards, k)
    ln = index.list_norms
    if ln is None:
        ln = torch.zeros(index.list_indices.shape, dtype=torch.float32, device=index.device)
    parts = _shards_of(index, mesh, axis, {"centers": index.centers},
                       {"data": index.list_data, "ids": index.list_indices, "norms": ln})
    queries = ser.as_tensor(queries, mesh.devices[0]).to(torch.float32)
    qs = comms.replicated(mesh, queries)
    select_min = metric != DistanceType.InnerProduct
    mesh.fork()
    vs, is_ = [], []
    for r in range(n_shards):
        with mesh.on(r):
            qf = qs[r]
            if metric == DistanceType.CosineExpanded:
                qf = normalize_rows(qf)
            probed = ivf_flat_mod.probe_mask(parts["centers"][r], qf, n_probes, metric)
            v, i = ivf_flat_mod.flat_scan_core(
                parts["data"][r], parts["ids"][r], parts["norms"][r], qf,
                probed[:, r * l_local:(r + 1) * l_local], None, k=k, metric=metric, chunk_lists=g)
            if healthy is not None and not healthy[r]:
                v, i = _demote(v, i, select_min)
            vs.append(v)
            is_.append(i)
    vals, ids = _exchange_merge(mesh, vs, is_, k, select_min, mode)
    return vals[0], ids[0]


def sharded_ivf_pq_lists_search(mesh, index, queries, k: int,
                                params: Optional["ivf_pq_mod.IvfPqSearchParams"] = None,
                                axis: str = comms.DEFAULT_AXIS, health=None,
                                merge_mode: str = "auto",
                                **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ search with the code lists sharded over ``mesh`` (replicated
    coarse centers, rotation and codebooks): each shard holds ``1 /
    n_shards`` of the codes. Returns ``(distances, indices)`` on the first
    shard's device from the same probed candidate set as the single-device
    ``search(mode="scan")`` (no refine). ``health`` and ``merge_mode`` as in
    :func:`sharded_ivf_flat_search`."""
    if params is None:
        params = ivf_pq_mod.IvfPqSearchParams(**kwargs)
    expects(index.codebook_kind == ivf_pq_mod.PER_SUBSPACE and not index.rabitq,
            "lists-sharded PQ needs per_subspace codebooks (per_cluster books would shard too)")
    n_shards = comms.comm_size(mesh, axis)
    L = index.n_lists
    expects(L % n_shards == 0, "n_lists %d not divisible by %d shards", L, n_shards)
    l_local = L // n_shards
    n_probes = min(params.n_probes, L)
    metric = index.metric
    g = ivf_pq_mod.scan_chunk_lists(l_local, index.max_list)
    bf16 = ivf_pq_mod.scan_bf16(params.lut_dtype, mesh.devices[0])
    healthy = _health_array(health, n_shards) if health is not None else None
    mode = _resolve_merge_mode(merge_mode, n_shards, k)
    parts = _shards_of(index, mesh, axis,
                       {"centers": index.centers, "rotation": index.rotation,
                        "pq_centers": index.pq_centers},
                       {"codes": index.codes_unpacked(), "ids": index.list_indices,
                        "sqn": index.rot_sqnorms})
    queries = ser.as_tensor(queries, mesh.devices[0]).to(torch.float32)
    qs = comms.replicated(mesh, queries)
    select_min = metric != DistanceType.InnerProduct
    mesh.fork()
    vs, is_ = [], []
    for r in range(n_shards):
        with mesh.on(r):
            qf = qs[r]
            centers = parts["centers"][r]
            q_dot_c = qf @ centers.T
            probed = ivf_common.probed_from_coarse(
                ivf_common.coarse_from_dots(q_dot_c, centers, metric), n_probes)
            sl = slice(r * l_local, (r + 1) * l_local)
            q_rot = qf @ parts["rotation"][r].T
            v, i = ivf_pq_mod.pq_scan_core(
                parts["pq_centers"][r], parts["codes"][r], parts["ids"][r], parts["sqn"][r],
                q_rot, q_dot_c[:, sl], probed[:, sl], None, k=k, metric=metric,
                per_cluster=False, chunk_lists=g, bf16=bf16)
            if healthy is not None and not healthy[r]:
                v, i = _demote(v, i, select_min)
            vs.append(v)
            is_.append(i)
    vals, ids = _exchange_merge(mesh, vs, is_, k, select_min, mode)
    return vals[0], ids[0]
