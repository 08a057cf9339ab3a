"""Degraded-mode sharded search: lose a shard, keep serving
(``raft_tpu.robust.degrade`` counterpart).

Lists-sharded search (IVF-Flat / IVF-PQ) holds ``1/n_shards`` of the index
per shard; a lost shard removes that slice of the candidate pool, and the
other shards still cover ``(n-1)/n`` of the lists. This module serves the
rest instead of failing the query:

* per-shard health is probed through the ``sharded_ann.shard_scan`` fault
  point (the chaos hook; a deployment wires its device-health callbacks
  into the same mask),
* failed shards are excluded from the exchange through the ``health`` mask
  of :func:`raft_tpu_torch.parallel.sharded_ann.sharded_ivf_flat_search` /
  ``sharded_ivf_pq_lists_search``, which demotes their candidates to
  ``(worst, -1)``: they lose every ring fold as they lose the gather merge,
  so the answer does not depend on ``merge_mode``,
* results carry a ``coverage`` fraction and a ``degraded`` flag, and the
  event shows in ``obs`` (``robust.degraded_queries{algo}``,
  ``robust.shard_failures{algo,shard}``, ``robust.queries_failed{algo}``,
  gauge ``robust.shards_healthy{algo}``, span ``robust.degraded_search``).

With every shard healthy the unmasked search runs (``health=None``), so
its bits are those of the plain sharded search.

The mask is indexed by the coordinate along the search's ``axis`` on a
mesh of any number of axes. On a process mesh each process probes the
coordinates of its own shards and the processes agree on one mask (one
gather of every process's probes, ANDed): a fault or a slow probe in the
process that holds a shard downs that shard in every process, so every
process merges the same candidates and returns the same answer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import ShardFailure, expects
from raft_tpu_torch.robust import faults

_ALGOS = ("ivf_flat", "ivf_pq_lists")


@dataclasses.dataclass(frozen=True)
class DegradedResult:
    """Search output and the health picture it was computed under."""

    distances: torch.Tensor  # [nq, k]
    indices: torch.Tensor  # [nq, k]
    #: fraction of shards (= fraction of inverted lists) that answered
    coverage: float
    degraded: bool
    failed_shards: Tuple[int, ...]

    def __iter__(self):  # unpack like the undegraded (distances, indices)
        return iter((self.distances, self.indices))


def agreed_health(mesh, axis: str, probe) -> Tuple[bool, ...]:
    """The health mask along ``axis``: ``probe(s)`` of each coordinate this
    process holds a shard at (every coordinate on one controller; True for
    the others), ANDed over the mesh's processes
    (:meth:`raft_tpu_torch.parallel.comms.Mesh.agreed`)."""
    mine = {mesh.coord(r, axis) for r in mesh.local_ranks}
    return mesh.agreed([probe(s) if s in mine else True for s in range(mesh.shape[axis])])


def probe_shard_health(mesh, axis: str = "data", algo: str = "ivf_flat") -> Tuple[bool, ...]:
    """Per-shard health mask of ``mesh`` along ``axis``: each shard is
    probed through the ``sharded_ann.shard_scan`` fault point, and a
    :class:`ShardFailure` raised there marks it unhealthy (counted in
    ``robust.shard_failures{algo,shard}``). Other errors propagate. On a
    process mesh each process probes its own shards and the processes
    agree (:func:`agreed_health`)."""

    def probe(s: int) -> bool:
        try:
            faults.fire("sharded_ann.shard_scan", shard=s, algo=algo, axis=axis)
            return True
        except ShardFailure:
            obs.inc("robust.shard_failures", algo=algo, shard=str(s))
            return False

    return agreed_health(mesh, axis, probe)


def sharded_search_degraded(
    mesh,
    index,
    queries,
    k: int,
    *,
    algo: str = "ivf_flat",
    params=None,
    axis: str = "data",
    health: Optional[Sequence[bool]] = None,
    min_coverage: float = 0.0,
    merge_mode: str = "auto",
    **kwargs,
) -> DegradedResult:
    """Lists-sharded search that tolerates failed shards.

    ``algo`` picks the sharded search (``"ivf_flat"`` or
    ``"ivf_pq_lists"``); ``health`` overrides the probe (``None``: probe
    through the fault point). Raises :class:`ShardFailure` (and counts
    ``robust.queries_failed``) when no shard is healthy or the coverage is
    below ``min_coverage``; else returns a :class:`DegradedResult` whose
    candidates come from the healthy shards only. ``merge_mode`` is the
    sharded search's (``"auto"``, ``"ring"``, ``"fused_ring"``,
    ``"gather"``)."""
    from raft_tpu_torch.parallel import sharded_ann  # lazy: it imports the indexes

    expects(algo in _ALGOS, "unknown degraded-search algo %r (want one of %s)", algo, _ALGOS)
    n_shards = mesh.shape[axis]
    if health is None:
        health = probe_shard_health(mesh, axis, algo)
    health = tuple(bool(h) for h in health)
    expects(len(health) == n_shards, "health mask has %d entries for %d shards",
            len(health), n_shards)

    n_healthy = sum(health)
    coverage = n_healthy / n_shards
    failed = tuple(s for s, ok in enumerate(health) if not ok)
    if n_healthy == 0:
        obs.inc("robust.queries_failed", algo=algo)
        raise ShardFailure(f"all {n_shards} shards unhealthy", shard=-1)
    if coverage < min_coverage:
        obs.inc("robust.queries_failed", algo=algo)
        raise ShardFailure(f"coverage {coverage:.2f} below required {min_coverage:.2f} "
                           f"(failed shards: {failed})", shard=failed[0])

    degraded = n_healthy < n_shards
    obs.set_gauge("robust.shards_healthy", n_healthy, algo=algo)
    if degraded:
        obs.inc("robust.degraded_queries", algo=algo)
    search = (sharded_ann.sharded_ivf_flat_search if algo == "ivf_flat"
              else sharded_ann.sharded_ivf_pq_lists_search)
    with obs.span("robust.degraded_search", algo=algo, coverage=coverage,
                  n_healthy=n_healthy) as sp:
        d, i = sp.sync(search(mesh, index, queries, k, params=params, axis=axis,
                              health=health if degraded else None, merge_mode=merge_mode,
                              **kwargs))
    return DegradedResult(distances=d, indices=i, coverage=coverage, degraded=degraded,
                          failed_shards=failed)
