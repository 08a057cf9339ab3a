"""Sharded ANN search and the distributed IVF-PQ build
(``raft_tpu.parallel.sharded_ann`` counterpart).

Lists-sharded search: the inverted lists are split into equal slices, one
per shard; the coarse centers (and IVF-PQ's rotation and codebooks) are
replicated. Each shard probes against the replicated centers, keeps the
probe columns of its own lists and runs the dense scan over its slice
(:func:`raft_tpu_torch.neighbors.ivf_flat.flat_scan_core`,
:func:`raft_tpu_torch.neighbors.ivf_pq.pq_scan_core`); list ids are global
rows, so the per-shard ``[nq, k]`` candidates merge directly, through the
ring top-k (``merge_mode="ring"``, kernel B6 on a CUDA mesh), the scan ring
(``"fused_ring"``, B7) or the gather merge (``"gather"``, the reference
engine). All three give the same ids and values bit for bit. This is how
an index larger than one card's memory is served. The lists are split once
per (index, mesh) and cached on the index (a plain attribute; a shard on the
index's device gets a view). A ``health`` mask demotes unhealthy shards'
candidates to ``(worst, -1)``, which lose every fold as they lose the gather
merge (degraded-mode search).

On a mesh of several axes the lists shard along ``axis`` and replicate over
the other axes (JAX's ``P(axis, None)``), and the merge runs along ``axis``
in each group. On a process mesh
(:func:`raft_tpu_torch.parallel.bootstrap.global_mesh`) every process
passes the whole index, as the JAX package's processes do, and keeps its
local shards' slices; the per-shard loops run over ``mesh.local_ranks``
and every process returns the merged, replicated answer.

Query-sharded search (:func:`sharded_ivf_pq_search`,
:func:`sharded_cagra_search`): the index replicated, the queries split along
``axis`` into one block a coordinate (replicated over the other axes, JAX's
``P(axis)``); each shard's rows are the single-device search of the same
rows. On one controller the answer is the blocks in coordinate order on the
first shard's device; on a process mesh every process returns the whole
answer on its first device (one gather of the blocks along ``axis``).

The distributed build (:func:`sharded_ivf_pq_build`): the rows split along
``axis``, distributed Lloyd for the coarse centers and distributed codebook
updates, their sums exchanged along ``axis`` in full or by the
communication-avoiding exchange (:func:`_ca_exchange`), then an index
replicated in every process (exact fixed-point sums added in rank order, so
its bits do not depend on how the shards lie over axes or processes).
Every entry point of this module takes both kinds of mesh and any number of
axes.

Differences from the JAX package: no fallback (a ring that fails raises;
the JAX package re-runs it on gather); random CAGRA seeds come from a
``torch.Generator`` a shard seeded from ``(seed, coordinate along axis)``;
the build's draws are made by the process of global rank 0 and broadcast
(the JAX package draws them from one key); ``comms.build.*`` count once a
call in each process (the JAX package counts while it traces); the codebook step
assigns in row blocks and sums by ``(subspace, code)`` instead of building a
``[rows, pq_dim, ksub]`` one-hot (the same codes and sums); the build's
draws come from a ``torch.Generator``; a RaBitQ index is rejected by the
sharded PQ searches, where the JAX package scores its sign bits as PQ codes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.cluster.kmeans import (
    flash_min_cluster_and_distance,
    flash_norm_cache,
    make_generator,
    segment_sum,
)
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.neighbors import cagra as cagra_mod
from raft_tpu_torch.neighbors import ivf_common
from raft_tpu_torch.neighbors import ivf_flat as ivf_flat_mod
from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod
from raft_tpu_torch.ops.distance import DistanceType, resolve_metric
from raft_tpu_torch.ops.fused_1nn import normalize_rows
from raft_tpu_torch.ops.select_k import select_k, worst_value
from raft_tpu_torch.parallel import comms
from raft_tpu_torch.parallel.wire_model import (  # noqa: F401  (re-exported, as in JAX)
    ca_exchange_cap,
    codebook_wire_bytes_per_iter,
    lloyd_wire_bytes_per_iter,
    wire_bytes,
)

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


def _exchange_merge(mesh, vs, is_, k: int, select_min: bool, merge_mode: str, axis=None):
    """Cross-shard exchange and merge of the per-shard candidates along
    ``axis``; returns one replicated ``(vals, ids)`` pair per local shard,
    as two lists."""
    # lazy: ops.ring_topk imports parallel.comms
    from raft_tpu_torch.ops.ring_topk import gather_merge, ring_topk, scan_ring_topk

    if merge_mode == "fused_ring":
        return scan_ring_topk(mesh, vs, is_, k, select_min=select_min, axis=axis)
    if merge_mode == "ring":
        return ring_topk(mesh, vs, is_, k, select_min=select_min, axis=axis)
    return gather_merge(mesh, vs, is_, k, select_min, axis=axis)


def _demote(v, i, select_min: bool):
    """An unhealthy shard's candidates: worst values and id -1."""
    return (torch.full_like(v, worst_value(v.dtype, select_min)), torch.full_like(i, -1))


def _shards_of(index, mesh, axis: str, replicated: dict, sharded: dict,
               layout: str = "") -> dict:
    """Per-local-shard tensors, split once per (index, mesh, layout) and
    cached on the index: ``replicated`` ones copied to each shard's device,
    ``sharded`` ones cut into equal row blocks along ``axis``, each shard
    keeping its coordinate's. ``layout`` names a split other than the
    lists-sharded one (``""``), so the two never share an entry."""
    cache = index.__dict__.setdefault("_shard_cache", {})
    key = (mesh.key(), axis) + ((layout,) if layout else ())
    if key not in cache:
        parts = {name: comms.replicated(mesh, t) for name, t in replicated.items()}
        parts.update({name: comms.row_sharded(mesh, t, axis) for name, t in sharded.items()})
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
    ``search(mode="scan")``. ``health`` (one bool per shard along ``axis``)
    excludes unhealthy shards from the merge; ``merge_mode`` picks the
    exchange (``"ring"``, ``"fused_ring"``, ``"gather"`` or ``"auto"``). The
    lists shard along ``axis`` (replicated over a mesh's other axes)."""
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
    for j, r in enumerate(mesh.local_ranks):
        with mesh.on(j):
            a = mesh.coord(r, axis)
            qf = qs[j]
            if metric == DistanceType.CosineExpanded:
                qf = normalize_rows(qf)
            probed = ivf_flat_mod.probe_mask(parts["centers"][j], qf, n_probes, metric)
            v, i = ivf_flat_mod.flat_scan_core(
                parts["data"][j], parts["ids"][j], parts["norms"][j], qf,
                probed[:, a * l_local:(a + 1) * l_local], None, k=k, metric=metric,
                has_filter=False, chunk_lists=g)
            if healthy is not None and not healthy[a]:
                v, i = _demote(v, i, select_min)
            vs.append(v)
            is_.append(i)
    vals, ids = _exchange_merge(mesh, vs, is_, k, select_min, mode, axis)
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
    expects(not index.rabitq, "lists-sharded PQ search does not take a RaBitQ index: the JAX "
            "package scores its sign bits as PQ codes, which is not RaBitQ's estimator")
    expects(index.codebook_kind == ivf_pq_mod.PER_SUBSPACE,
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
    for j, r in enumerate(mesh.local_ranks):
        with mesh.on(j):
            a = mesh.coord(r, axis)
            qf = qs[j]
            centers = parts["centers"][j]
            q_dot_c = qf @ centers.T
            probed = ivf_common.probed_from_coarse(
                ivf_common.coarse_from_dots(q_dot_c, centers, metric), n_probes)
            sl = slice(a * l_local, (a + 1) * l_local)
            q_rot = qf @ parts["rotation"][j].T
            v, i = ivf_pq_mod.pq_scan_core(
                parts["pq_centers"][j], parts["codes"][j], parts["ids"][j], parts["sqn"][j],
                q_rot, q_dot_c[:, sl], probed[:, sl], None, k=k, metric=metric,
                per_cluster=False, has_filter=False, chunk_lists=g, bf16=bf16)
            if healthy is not None and not healthy[a]:
                v, i = _demote(v, i, select_min)
            vs.append(v)
            is_.append(i)
    vals, ids = _exchange_merge(mesh, vs, is_, k, select_min, mode, axis)
    return vals[0], ids[0]


# -- query-sharded search: replicated index, the queries split ----------------------


def _query_blocks(mesh, queries, axis: str):
    """The queries on the first local shard's device, cut into one equal
    row block a coordinate along ``axis`` (the JAX package's divisibility
    check and message): one block a local shard."""
    n_shards = comms.comm_size(mesh, axis)
    queries = ser.as_tensor(queries, mesh.devices[0]).to(torch.float32)
    nq = queries.shape[0]
    expects(nq % n_shards == 0, "n_queries %d not divisible by %d shards", nq, n_shards)
    return comms.row_sharded(mesh, queries, axis)


def _assemble(mesh, vs, is_, axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row blocks of the results in coordinate order along ``axis`` as
    one pair on the first local shard's device (the JAX package's
    query-sharded output). One controller: the blocks of the first group
    along ``axis``; a process mesh: one gather of every local shard's
    ``(values, ids)`` block along ``axis`` (int32 lanes, so the bits
    travel), every process keeping the whole answer."""
    if mesh.is_process:
        packed = []
        for j, (v, i) in enumerate(zip(vs, is_)):
            with mesh.on(j):
                packed.append(torch.stack([v.view(torch.int32), i]))
        whole = comms._allgather(mesh, packed, axis=axis)[0]  # [n, 2, nq / n, k]
        k = whole.shape[-1]
        return (whole[:, 0].reshape(-1, k).view(torch.float32), whole[:, 1].reshape(-1, k))
    _, slots = mesh.along(axis)[0]
    mesh.join(vs + is_)
    dev = mesh.devices[0]
    return (torch.cat([vs[s].to(dev) for s in slots], dim=0),
            torch.cat([is_[s].to(dev) for s in slots], dim=0))


def sharded_ivf_pq_search(mesh, index, queries, k: int,
                          params: Optional["ivf_pq_mod.IvfPqSearchParams"] = None,
                          axis: str = comms.DEFAULT_AXIS,
                          **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ search with the queries split over ``mesh`` and the index
    replicated (``sharded_ann.py:799-853``): shard ``r`` runs the dense
    decode scan (``ivf_pq._ivf_pq_scan_impl``) over its block of the
    queries. The number of queries must divide by the number of shards.
    Returns ``(distances [nq, k], indices [nq, k])`` on the first shard's
    device, each block the single-device ``search(mode="scan")`` of the same
    rows (no refine). A RaBitQ index is rejected, as by
    :func:`sharded_ivf_pq_lists_search`."""
    if params is None:
        params = ivf_pq_mod.IvfPqSearchParams(**kwargs)
    expects(not index.rabitq, "query-sharded PQ search does not take a RaBitQ index: the JAX "
            "package scores its sign bits as PQ codes, which is not RaBitQ's estimator")
    qs = _query_blocks(mesh, queries, axis)
    n_probes = min(params.n_probes, index.n_lists)
    g = ivf_pq_mod.scan_chunk_lists(index.n_lists, index.max_list)
    per_cluster = index.codebook_kind == ivf_pq_mod.PER_CLUSTER
    bf16 = ivf_pq_mod.scan_bf16(params.lut_dtype, mesh.devices[0])
    parts = _shards_of(index, mesh, axis,
                       {"centers": index.centers, "rotation": index.rotation,
                        "pq_centers": index.pq_centers, "codes": index.codes_unpacked(),
                        "ids": index.list_indices, "sqn": index.rot_sqnorms}, {},
                       layout="replicated")
    mesh.fork()
    vs, is_ = [], []
    for j in range(len(mesh.devices)):
        with mesh.on(j):
            v, i = ivf_pq_mod._ivf_pq_scan_impl(
                parts["centers"][j], parts["rotation"][j], parts["pq_centers"][j],
                parts["codes"][j], parts["ids"][j], parts["sqn"][j], qs[j], None, k=k,
                n_probes=n_probes, metric=index.metric, per_cluster=per_cluster, chunk_lists=g,
                bf16=bf16)
            vs.append(v)
            is_.append(i)
    return _assemble(mesh, vs, is_, axis)


def _rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The generator of random CAGRA seeds of the shards at coordinate
    ``rank`` along the search's axis, seeded from ``(seed, rank)`` (the JAX
    package folds ``lax.axis_index(axis)`` into its key)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1)[0]))
    return gen


def sharded_cagra_search(mesh, index, queries, k: int,
                         params: Optional["cagra_mod.CagraSearchParams"] = None,
                         axis: str = comms.DEFAULT_AXIS,
                         **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """CAGRA beam search with the queries split over ``mesh`` and the graph
    and dataset (or the VPQ arrays) replicated (``sharded_ann.py:234-311``):
    shard ``r`` runs the unfused beam loop (``cagra._cagra_search_impl``,
    the ``xla`` path, as the JAX package does) over its block of the
    queries. With ``init_sample > 0`` every shard seeds from the strided
    sample, so each block is the single-device ``search(mode="xla")`` of the
    same rows; with ``init_sample == 0`` the shard at coordinate ``a`` along
    ``axis`` draws its random seeds from a ``torch.Generator`` seeded from
    ``(params.seed, a)``, so shards that differ only on another axis draw
    the same. The number of queries must divide by the number of shards
    along ``axis``. Returns ``(distances, indices)`` on the first local
    shard's device."""
    if params is None:
        params = cagra_mod.CagraSearchParams(**kwargs)
    qs = _query_blocks(mesh, queries, axis)
    itopk, width, iters, n_init = cagra_mod.derive_search_config(params, k, index.size)
    use_vpq = index.dataset is None
    if use_vpq:
        expects(index.vpq is not None, "index has neither dataset nor vpq data")
        v = index.vpq
        rep = {"sqnorms": v.sqnorms, "graph": index.graph, "vq_centers": v.vq_centers,
               "vq_labels": v.vq_labels, "pq_centers": v.pq_centers, "codes": v.codes}
    else:
        rep = {"sqnorms": index.sqnorms, "graph": index.graph, "dataset": index.dataset}
    parts = _shards_of(index, mesh, axis, rep, {}, layout="replicated")
    mesh.fork()
    vs, is_ = [], []
    for j, r in enumerate(mesh.local_ranks):
        with mesh.on(j):
            dev = mesh.devices[j]
            if params.init_sample > 0:
                init_ids = cagra_mod.strided_seed_ids(index.size, params.init_sample, dev)
            else:
                gen = _rank_generator(params.seed, mesh.coord(r, axis), dev)
                init_ids = torch.randint(0, index.size, (qs[j].shape[0], n_init), generator=gen,
                                         device=dev, dtype=torch.int32)
            vpq_arrays = (tuple(parts[n][j] for n in ("vq_centers", "vq_labels", "pq_centers",
                                                      "codes")) if use_vpq else None)
            v, i = cagra_mod._cagra_search_impl(
                None if use_vpq else parts["dataset"][j], parts["sqnorms"][j], parts["graph"][j],
                qs[j], init_ids, None, vpq_arrays, k=k, itopk=itopk, width=width, iters=iters,
                metric=index.metric, has_filter=False, use_vpq=use_vpq)
            vs.append(v)
            is_.append(i)
    return _assemble(mesh, vs, is_, axis)


# -- the distributed IVF-PQ build -----------------------------------------------------

#: cross-shard accumulator-exchange engines of the distributed build
_COMM_MODES = ("auto", "full", "ca")

#: scratch of one row block of the codebook step's assignment: the
#: ``[rows, pq_dim, ksub]`` f32 products and distances
CODEBOOK_BLOCK_BYTES = 256 << 20


def _resolve_comm_mode(comm_mode: str, n_shards: int, n_rows=None, d=None, ca_cap=None) -> str:
    """``auto`` is the communication-avoiding exchange for more than one
    shard, else ``full``; with the planner's gate on and the accumulator's
    shape known (``n_rows``, ``d``) :func:`raft_tpu_torch.plan.plan_comm_mode`
    prices the two from the wire model."""
    expects(comm_mode in _COMM_MODES, "comm_mode %r (want one of %s)", comm_mode, _COMM_MODES)
    if comm_mode == "auto":
        from raft_tpu_torch import plan

        if plan.is_enabled() and n_rows is not None and d is not None:
            return plan.plan_comm_mode(n_rows, d, n_shards, ca_cap=ca_cap).choice
        return "ca" if n_shards > 1 else "full"
    return comm_mode


def _ca_cap(n_rows: int, ca_cap) -> int:
    """Exchanged-row budget of the CA exchange
    (:func:`~raft_tpu_torch.parallel.wire_model.ca_exchange_cap`)."""
    return ca_exchange_cap(n_rows, ca_cap)


def _note_build_comms(mesh, phase: str, payload_bytes: float, axis: str,
                      verb: str = "allreduce", launches: int = 1) -> None:
    """The build's comms accounting: ``comms.build.launches`` and the wire
    model's bytes at the size of ``axis`` (``comms.build.bytes``), labelled
    with the build ``phase``; once a call in each process."""
    if not obs.is_enabled():
        return
    obs.inc("comms.build.launches", float(launches), phase=phase)
    obs.inc("comms.build.bytes", wire_bytes(verb, payload_bytes, comms.comm_size(mesh, axis)),
            phase=phase)


def _ca_exchange(mesh, rows_local, changed_local, gsums, cap: int, phase: str, axis: str):
    """The communication-avoiding accumulator exchange along ``axis``:
    allreduce each shard's per-row changed counts, select the ``cap`` rows
    of most global churn (``lax.top_k``'s order: ties to the lower row),
    allreduce only those rows' fresh partials and patch them into the
    carried global accumulator. A row whose assignments changed on no shard
    has the same partials as before (exact fixed-point sums of the same
    rows), so under the cap the result is the full exchange's bit for bit."""
    gchanged = comms.allreduce(mesh, changed_local, axis=axis)
    sel, picked = [], []
    for j in range(len(mesh.devices)):
        with mesh.on(j):
            sel.append(select_k(gchanged[j][None, :], cap, select_min=False)[1][0].to(torch.int64))
            picked.append(rows_local[j][sel[j]])
    block = comms.allreduce(mesh, picked, axis=axis)
    _note_build_comms(mesh, phase, changed_local[0].numel() * 4 + block[0].numel() * 4, axis,
                      launches=2)
    out = []
    for j in range(len(mesh.devices)):
        with mesh.on(j):
            g = gsums[j].clone()
            g[sel[j]] = block[j]
            out.append(g)
    return out


def _means(packed, old):
    """New centers from packed ``[..., d + 1]`` sums and counts; an empty
    row keeps its old center."""
    gs, gc = packed[..., :-1], packed[..., -1:]
    return torch.where(gc > 0, gs / torch.clamp(gc, min=1e-9), old)


def _each(mesh, fn, *per_shard) -> list:
    """``fn(*args)`` on each local shard inside ``mesh.on``, the args
    that shard's entries of ``per_shard``."""
    out = []
    for j in range(len(mesh.devices)):
        with mesh.on(j):
            out.append(fn(*(a[j] for a in per_shard)))
    return out


def dist_lloyd_step(mesh, centers, x_local, n_lists: int, axis: str = comms.DEFAULT_AXIS,
                    caches=None, fuse_comms: bool = True, comm_mode: str = "full", carry=None,
                    ca_cap=None):
    """One distributed Lloyd iteration over per-shard lists
    (``sharded_ann.py:500-571``), one tensor a local shard, the rows split
    along ``axis``: each shard assigns its rows
    (``kmeans.flash_min_cluster_and_distance``, with ``caches`` from
    ``kmeans.flash_norm_cache`` kept across iterations) and sums them by
    label (exact fixed-point sums, the same bits in any order); the
    ``[n_lists, d]`` sums and ``[n_lists]`` counts ride one packed
    allreduce along ``axis`` (``fuse_comms=False``: two). Returns
    ``(centers, labels)``, one tensor a local shard each.

    ``comm_mode="ca"`` carries ``(labels, packed global sums)`` across
    iterations and exchanges only the ``ca_cap`` most-churned lists
    (:func:`_ca_exchange`); it returns ``(centers, labels, carry)``, and
    ``carry=None`` (the first iteration) pays one full exchange."""
    labs, rows = [], []
    for j in range(len(mesh.devices)):
        with mesh.on(j):
            lab, _ = flash_min_cluster_and_distance(
                x_local[j], centers[j], metric=DistanceType.L2Expanded,
                cache=caches[j] if caches is not None else None)
            ones = torch.ones(lab.shape, dtype=torch.float32, device=lab.device)
            labs.append(lab)
            rows.append((segment_sum(x_local[j], lab, n_lists), segment_sum(ones, lab, n_lists)))
    if comm_mode == "ca":
        local = _each(mesh, lambda r: torch.cat([r[0], r[1][:, None]], dim=1), rows)
        if carry is None:
            packed = comms.allreduce(mesh, local, axis=axis)
            _note_build_comms(mesh, "kmeans_full", local[0].numel() * 4, axis)
        else:
            prev_lab, gsums = carry

            def changed(lab, prev):
                moved = (lab != prev).to(torch.float32)
                return segment_sum(moved, lab, n_lists) + segment_sum(moved, prev, n_lists)

            packed = _ca_exchange(mesh, local, _each(mesh, changed, labs, prev_lab), gsums,
                                  _ca_cap(n_lists, ca_cap), "kmeans_ca", axis)
        return _each(mesh, _means, packed, centers), labs, (labs, packed)
    packed = _exchange_sums(mesh, rows, fuse_comms, "kmeans_full", axis)
    return _each(mesh, _means, packed, centers), labs


def _exchange_sums(mesh, rows, fuse_comms: bool, phase: str, axis: str):
    """The full exchange of per-shard ``(sums [..., d], counts [...])``
    along ``axis``: one packed allreduce, or (``fuse_comms=False``) one
    each; returns the packed global ``[..., d + 1]`` per local shard."""
    if fuse_comms:
        local = _each(mesh, lambda r: torch.cat([r[0], r[1][..., None]], dim=-1), rows)
        packed = comms.allreduce(mesh, local, axis=axis)
        _note_build_comms(mesh, phase, packed[0].numel() * 4, axis)
        return packed
    sums = comms.allreduce(mesh, [s for s, _ in rows], axis=axis)
    cnts = comms.allreduce(mesh, [c for _, c in rows], axis=axis)
    _note_build_comms(mesh, phase, sums[0].numel() * 4 + cnts[0].numel() * 4, axis, launches=2)
    return _each(mesh, lambda s_, c_: torch.cat([s_, c_[..., None]], dim=-1), sums, cnts)


def _assign_codes(resid, books) -> torch.Tensor:
    """Nearest code per subspace of ``resid [n, pq_dim, pq_len]`` against
    ``books [pq_dim, ksub, pq_len]`` -> ``[n, pq_dim]`` int64 (first index on
    ties), over row blocks: a block of ``b`` rows costs ``8 b pq_dim ksub``
    bytes (its products and distances), kept under
    :data:`CODEBOOK_BLOCK_BYTES`; the ``[n, pq_dim, ksub]`` one-hot is never
    built."""
    n, pq_dim, _ = resid.shape
    ksub = books.shape[1]
    block = max(1, CODEBOOK_BLOCK_BYTES // (8 * pq_dim * ksub))
    parts = [ivf_pq_mod._encode_chunk(resid[s : s + block], None, books, False).to(torch.int64)
             for s in range(0, n, block)]
    if not parts:
        return torch.zeros((0, pq_dim), dtype=torch.int64, device=resid.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def dist_codebook_step(mesh, books, resid, ksub: int, axis: str = comms.DEFAULT_AXIS,
                       fuse_comms: bool = True, comm_mode: str = "full", carry=None,
                       ca_cap=None):
    """One distributed per-subspace codebook update over per-shard lists
    (``sharded_ann.py:574-632``), one tensor a local shard, the rows split
    along ``axis``: each shard assigns its residual sub-vectors ``resid
    [n_local, pq_dim, pq_len]`` (:func:`_assign_codes`, in row blocks) and
    sums them by ``(subspace, code)`` (exact fixed-point sums over
    ``[n_local pq_dim, pq_len]``, 16 B a value of scratch); the ``[pq_dim,
    ksub, pq_len]`` sums and ``[pq_dim, ksub]`` counts ride one packed
    allreduce along ``axis`` (``fuse_comms=False``: two). Returns the books,
    one a local shard. ``comm_mode="ca"`` exchanges the flattened ``[pq_dim
    ksub, pq_len + 1]`` rows as :func:`dist_lloyd_step` does and returns
    ``(books, carry)`` with ``carry = (codes, packed rows)``."""
    pq_dim, _, pq_len = books[0].shape
    n_rows = pq_dim * ksub

    def keyed(code):
        return (torch.arange(pq_dim, device=code.device)[None, :] * ksub + code).reshape(-1)

    codes, keys, rows = [], [], []
    for j in range(len(mesh.devices)):
        with mesh.on(j):
            code = _assign_codes(resid[j], books[j])
            key = keyed(code)
            ones = torch.ones(key.shape, dtype=torch.float32, device=key.device)
            codes.append(code)
            keys.append(key)
            rows.append((segment_sum(resid[j].reshape(-1, pq_len), key, n_rows)
                         .reshape(pq_dim, ksub, pq_len),
                         segment_sum(ones, key, n_rows).reshape(pq_dim, ksub)))
    if comm_mode == "ca":
        local = _each(mesh, lambda r: torch.cat([r[0], r[1][..., None]], dim=-1)
                      .reshape(n_rows, pq_len + 1), rows)
        if carry is None:
            packed = comms.allreduce(mesh, local, axis=axis)
            _note_build_comms(mesh, "pq_codebook_full", local[0].numel() * 4, axis)
        else:
            prev_code, grows = carry

            def changed(code, key, prev):
                moved = (code != prev).to(torch.float32).reshape(-1)
                return segment_sum(moved, key, n_rows) + segment_sum(moved, keyed(prev), n_rows)

            packed = _ca_exchange(mesh, local, _each(mesh, changed, codes, keys, prev_code),
                                  grows, _ca_cap(n_rows, ca_cap), "pq_codebook_ca", axis)
        out = _each(mesh, lambda p_, b: _means(p_.reshape(pq_dim, ksub, pq_len + 1), b), packed,
                    books)
        return out, (codes, packed)
    packed = _exchange_sums(mesh, rows, fuse_comms, "pq_codebook_full", axis)
    return _each(mesh, _means, packed, books)


def sharded_ivf_pq_build(mesh, dataset, params: Optional["ivf_pq_mod.IvfPqIndexParams"] = None,
                         axis: str = comms.DEFAULT_AXIS, fuse_comms: bool = True,
                         comm_mode: str = "auto", ca_cap=None, ca_warmup: int = 2,
                         **kwargs) -> "ivf_pq_mod.IvfPqIndex":
    """Distributed IVF-PQ build (``sharded_ann.py:651-797``): the rows split
    along ``axis`` (replicated over a mesh's other axes), the coarse centers
    trained by distributed Lloyd (:func:`dist_lloyd_step`) and the
    per-subspace codebooks by :func:`dist_codebook_step` (seeded from a
    strided sample of every shard's residuals, one allgather), then every
    row encoded and packed into a replicated index on the first local
    shard's device (``PER_SUBSPACE`` books, one code a byte, no spatial
    list order). On a process mesh every process passes the whole dataset
    and returns the same index.

    ``comm_mode``: ``"full"`` (the packed allreduce each iteration),
    ``"ca"`` (the changed-rows exchange after ``ca_warmup`` full ones; bit
    for bit the full trajectory while the churn fits ``ca_cap``) or
    ``"auto"`` (:func:`_resolve_comm_mode`). The initial centers are
    ``n_lists`` rows drawn by ``torch.randperm`` from a ``torch.Generator``
    seeded with ``params.seed``, which then draws the rotation
    (the JAX package draws both from its key); on a process mesh the
    process of global rank 0 draws them and broadcasts them."""
    if params is None:
        params = ivf_pq_mod.IvfPqIndexParams(**kwargs)
    dev = mesh.devices[0]
    dataset = ser.as_tensor(dataset, dev).to(torch.float32)
    n, d = dataset.shape
    n_lists = min(params.n_lists, n)
    pq_dim = params.pq_dim or ivf_pq_mod._default_pq_dim(d)
    rot_dim = -(-d // pq_dim) * pq_dim
    gen = make_generator(params.seed, dev)
    init_centers = dataset[torch.randperm(n, generator=gen, device=dev)[:n_lists]]
    rotation = ivf_pq_mod._make_rotation(gen, rot_dim, d, params.force_random_rotation)
    init_centers, rotation = mesh.from_first(init_centers), mesh.from_first(rotation)
    return _sharded_ivf_pq_build_from(mesh, dataset, params, init_centers, rotation, axis=axis,
                                      fuse_comms=fuse_comms, comm_mode=comm_mode, ca_cap=ca_cap,
                                      ca_warmup=ca_warmup)


def _sharded_ivf_pq_build_from(mesh, dataset, params, init_centers, rotation, *,
                               axis: str = comms.DEFAULT_AXIS, fuse_comms: bool = True,
                               comm_mode: str = "auto", ca_cap=None, ca_warmup: int = 2):
    """:func:`sharded_ivf_pq_build` from given draws: ``init_centers
    [n_lists, d]`` and ``rotation [rot_dim, d]`` (how the tests feed both
    packages the JAX package's draws)."""
    n_shards = comms.comm_size(mesh, axis)
    dev = mesh.devices[0]
    dataset = ser.as_tensor(dataset, dev).to(torch.float32)
    n, d = dataset.shape
    expects(n % n_shards == 0, "rows %d not divisible by %d shards", n, n_shards)
    init_centers = ser.as_tensor(init_centers, dev).to(torch.float32)
    rotation = ser.as_tensor(rotation, dev).to(torch.float32)
    n_lists = init_centers.shape[0]
    pq_dim = params.pq_dim or ivf_pq_mod._default_pq_dim(d)
    ksub = 1 << params.pq_bits
    mode = _resolve_comm_mode(comm_mode, n_shards, n_rows=n_lists, d=d, ca_cap=ca_cap)

    xs = comms.row_sharded(mesh, dataset, axis)
    centers = comms.replicated(mesh, init_centers)
    rots = comms.replicated(mesh, rotation)
    mesh.fork()
    caches = _each(mesh, lambda x: flash_norm_cache(x, DistanceType.L2Expanded), xs)
    if mode == "ca":
        carry = None
        for it in range(params.kmeans_n_iters):
            if it < ca_warmup - 1:
                # warm-up: full width while the churn is heavy (the first CA
                # call exchanges full width too, so ca_warmup counts both)
                centers, _ = dist_lloyd_step(mesh, centers, xs, n_lists, axis, caches=caches)
                continue
            centers, _, carry = dist_lloyd_step(mesh, centers, xs, n_lists, axis, caches=caches,
                                                comm_mode="ca", carry=carry, ca_cap=ca_cap)
        labs = _each(mesh, lambda x, c, cache: flash_min_cluster_and_distance(
            x, c, metric=DistanceType.L2Expanded, cache=cache)[0], xs, centers, caches)
    else:
        for _ in range(params.kmeans_n_iters):
            centers, _ = dist_lloyd_step(mesh, centers, xs, n_lists, axis, caches=caches,
                                         fuse_comms=fuse_comms)
        _, labs = dist_lloyd_step(mesh, centers, xs, n_lists, axis, caches=caches,
                                  fuse_comms=fuse_comms)

    # codebooks on the local residuals, seeded from a strided sample of
    # every shard's residuals along the axis
    nl = n // n_shards
    per = -(-ksub // n_shards)
    stride = max(1, nl // per)
    resid = _each(mesh, lambda x, c, lab, rot: ((x - c[lab.to(torch.int64)]) @ rot.T)
                  .reshape(nl, pq_dim, -1), xs, centers, labs, rots)
    picks = _each(mesh, lambda rr: rr[torch.clamp(torch.arange(per, device=rr.device) * stride,
                                                  max=nl - 1)], resid)
    pool = comms.allgather(mesh, picks, axis=axis)  # [n_shards, per, pq_dim, pq_len] a shard
    _note_build_comms(mesh, "seed", pool[0][0].numel() * 4, axis, verb="allgather")
    n_seed = min(ksub, n_shards * nl)

    def seed_books(p):
        b = p.transpose(0, 1).reshape(n_shards * per, pq_dim, -1)[:n_seed].permute(1, 0, 2)
        if n_seed < ksub:
            b = b.repeat(1, -(-ksub // n_seed), 1)[:, :ksub, :]
        return b.contiguous()

    books = _each(mesh, seed_books, pool)
    if mode == "ca":
        bcarry = None
        for _ in range(max(4, params.kmeans_n_iters)):
            books, bcarry = dist_codebook_step(mesh, books, resid, ksub, axis, comm_mode="ca",
                                               carry=bcarry, ca_cap=ca_cap)
    else:
        for _ in range(max(4, params.kmeans_n_iters)):
            books = dist_codebook_step(mesh, books, resid, ksub, axis, fuse_comms=fuse_comms)
    centers, books = centers[0], books[0]
    mesh.join([centers, books])

    # encode and pack every row (a replicated index on the first local
    # shard's device; every process encodes the whole dataset)
    cand = ivf_common.topk_labels(dataset, centers, k=8)
    max_list = ivf_common.choose_max_list(cand[:, 0], n, n_lists, params.list_cap_factor)
    slot = ivf_common.assign_slots(cand, n_lists=n_lists, max_list=max_list)
    final_labels = slot // max_list
    codes_rows = ivf_pq_mod._encode_all(dataset, final_labels, centers, rotation, books, pq_dim,
                                        False)
    codes, list_indices, list_sizes = ivf_common.scatter_rows(
        codes_rows, torch.arange(n, dtype=torch.int32, device=dev), slot, n_lists=n_lists,
        max_list=max_list)
    centers_rot = centers @ rotation.T
    return ivf_pq_mod.IvfPqIndex(
        centers=centers, centers_rot=centers_rot, rotation=rotation, pq_centers=books,
        codes=codes, list_indices=list_indices, list_sizes=list_sizes,
        rot_sqnorms=ivf_pq_mod._sqnorms_for(codes, centers_rot, books, False),
        metric=resolve_metric(params.metric), codebook_kind=ivf_pq_mod.PER_SUBSPACE,
        pq_bits=params.pq_bits, size=n, list_cap_factor=params.list_cap_factor,
        center_rank=None)
