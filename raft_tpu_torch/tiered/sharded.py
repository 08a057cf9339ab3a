"""Tiered sharded search: each shard's codes on the device, each shard's raw
rows in its own host tier (``raft_tpu.tiered.sharded`` counterpart).

The composition of the lists-sharded search
(:mod:`raft_tpu_torch.parallel.sharded_ann`, merged through the ring top-k
or the gather merge) and the tiered re-rank (:mod:`raft_tpu_torch.tiered.index`):
only the merged global winners' rows are fetched, each from the host tier
of the shard whose lists hold it. A micro-batch runs::

    sharded scan (per shard) --ring/gather merge--> kk global candidate ids
                                                         | (the one sync)
    per-shard host gather: owner[id] routes each id to its shard's
    HostVectorStore; each store reads its rows once into ONE staging slab
    [nq, kk, dim] (pinned on a card, copied with non_blocking=True)
                                                         |
    _exact_rerank(slab) --> (distances, indices)[:k]

The schedule is :func:`raft_tpu_torch.tiered.index.run_overlapped`: the host
gather of batch *i* runs while the card scans batch *i+1*
(``tiered.overlap_efficiency``). A micro-batch's results are the resident
sharded path's bits (the sharded search for ``k * refine_ratio`` candidates,
then the device refine) for the same batch: the merge engines agree bit for
bit, an invalid id's row is never read (the re-rank masks it), and the
re-rank is the same core.

Failures compose. A scan-side ``health`` mask demotes a shard inside the
merge, as :mod:`raft_tpu_torch.robust.degrade` does; a tier-side failure (a
typed :class:`~raft_tpu_torch.core.errors.HostFetchError` from one shard's
store, after its retries) masks that shard's candidates to ``-1`` before the
re-rank, so the merge never waits on a dead host and the healthy shards keep
their ids. The result is a :class:`~raft_tpu_torch.robust.degrade.DegradedResult`
with the combined coverage. Each store fires the ``host.fetch`` fault seam
with ``shard=s``, so a spec can kill one host's tier with ``match={"shard":
s}``. A kernel failure of the scan (``KernelFailure``) or an error injected at
``comms.ring_topk`` propagates: nothing falls back.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import HostFetchError, ShardFailure, expects
from raft_tpu_torch.neighbors.refine import _exact_rerank
from raft_tpu_torch.ops.distance import resolve_metric
from raft_tpu_torch.tiered.index import _collect, _to_host, run_overlapped
from raft_tpu_torch.tiered.store import HostVectorStore, _Slab

#: sharded scan families whose list layout carries global row ids
ALGOS = ("ivf_flat", "ivf_pq_lists")


class ShardedHostTier:
    """Per-shard host tiers behind one global-id gather.

    ``stores[s]`` holds the raw rows that shard ``s`` scans (the rows of its
    slice of the inverted lists) at local positions; ``owner[global_id]``
    names the shard and ``local[global_id]`` the position. A gather fans the
    candidate ids out by owner, reads each store once (deduplicated,
    depth-budgeted, read-ahead hinted: :meth:`HostVectorStore.gather_rows`)
    and scatters the rows into one staging slab, two slabs a shape used in
    turn (pinned for a CUDA destination, each guarded by the event of its
    last copy)."""

    def __init__(self, stores: Sequence[HostVectorStore], owner, local):
        expects(len(stores) >= 1, "sharded tier needs at least one store")
        dims = {s.dim for s in stores}
        expects(len(dims) == 1, "per-shard stores disagree on dim: %s", dims)
        self.stores = list(stores)
        self.owner = np.ascontiguousarray(owner, dtype=np.int32)
        self.local = np.ascontiguousarray(local, dtype=np.int32)
        expects(self.owner.shape == self.local.shape and self.owner.ndim == 1,
                "owner/local must be matching 1-D row maps")
        self._staging = self.stores[0]._new_staging()

    @classmethod
    def from_lists(cls, index, data, n_shards: int, *, fetch_depth_rows: Optional[int] = None,
                   readahead: bool = True, retry_policy=None) -> "ShardedHostTier":
        """Split ``data [n_rows, dim]`` into per-shard stores by the
        lists-sharded ownership: shard ``s`` owns the rows of lists ``[s
        l_local, (s+1) l_local)``, the slice its device scans, so every
        candidate a shard can return lives on that shard's host. Rows the
        padded layout dropped belong to no shard (owner -1); no scan can
        return them."""
        li = ser.to_numpy(index.list_indices)
        L = int(li.shape[0])
        expects(L % n_shards == 0, "n_lists %d not divisible by %d shards", L, n_shards)
        l_local = L // n_shards
        bf16 = isinstance(data, torch.Tensor) and data.dtype == torch.bfloat16
        data = ser.to_numpy(data) if isinstance(data, torch.Tensor) else np.asarray(data)
        expects(data.ndim == 2, "sharded tier needs [n_rows, dim] data")
        n_rows = int(data.shape[0])
        owner = np.full(n_rows, -1, np.int32)
        local = np.zeros(n_rows, np.int32)
        kw = {} if retry_policy is None else {"retry_policy": retry_policy}
        stores = []
        for s in range(n_shards):
            ids = li[s * l_local:(s + 1) * l_local].reshape(-1)
            ids = ids[ids >= 0].astype(np.int64)
            owner[ids] = s
            local[ids] = np.arange(ids.size, dtype=np.int32)
            stores.append(HostVectorStore(np.ascontiguousarray(data[ids]),
                                          fetch_depth_rows=fetch_depth_rows, readahead=readahead,
                                          fault_context={"shard": s}, bf16=bf16, **kw))
        return cls(stores, owner, local)

    @property
    def n_shards(self) -> int:
        return len(self.stores)

    @property
    def dim(self) -> int:
        return self.stores[0].dim

    @property
    def dtype(self) -> torch.dtype:
        return self.stores[0].dtype

    @property
    def n_rows(self) -> int:
        return int(self.owner.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.stores)

    def _fill(self, candidates, pinned: bool) -> Tuple[_Slab, np.ndarray, Tuple[int, ...]]:
        c = np.asarray(candidates.cpu() if isinstance(candidates, torch.Tensor) else candidates,
                       np.int32)
        expects(c.ndim == 2, "candidates must be [nq, n_cand]")
        valid = c >= 0
        safe = np.where(valid, c, 0)
        own = self.owner[safe]
        loc = self.local[safe]
        slab = self._staging.next(c.shape + (self.dim,), pinned)
        slab.array[...] = 0
        cand = c.copy()
        failed = []
        for s, store in enumerate(self.stores):
            mask = valid & (own == s)
            if not mask.any():
                continue
            try:
                slab.array[mask] = store.gather_rows(loc[mask])
            except HostFetchError:
                failed.append(s)
                cand[mask] = -1
                obs.inc("tiered.tier_failures", shard=str(s))
        return slab, cand, tuple(failed)

    def gather_masked(self, candidates) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...]]:
        """Gather candidate rows (global ids, ``-1`` invalid) from their
        shards' tiers. Returns ``(slab [nq, n_cand, dim], cand [nq, n_cand]
        i32, failed_shards)``: the candidates of a shard whose fetch failed
        (typed :class:`HostFetchError` after retries) come back as ``-1``
        and that shard is reported, so one dead host costs coverage, not the
        query. The slab is a numpy array (uint16 bit patterns for
        bfloat16)."""
        slab, cand, failed = self._fill(candidates, pinned=False)
        return slab.array, cand, failed

    def gather_to(self, candidates, device) -> Tuple[torch.Tensor, np.ndarray, Tuple[int, ...]]:
        """:meth:`gather_masked` with the slab as a tensor on ``device``: on
        a card a ``non_blocking`` copy of the pinned slab, the slab's event
        recorded after it."""
        device = torch.device(device)
        slab, cand, failed = self._fill(candidates, pinned=device.type == "cuda")
        return self._staging.to_device(slab, device), cand, failed


class TieredShardedIndex:
    """One lists-sharded index and its per-shard host tiers.

    ``algo`` picks the sharded scan (``"ivf_flat"`` or ``"ivf_pq_lists"``,
    the lists-sharded engines whose candidates are global row ids); ``index``
    is the built index that :func:`~raft_tpu_torch.parallel.sharded_ann.
    sharded_ivf_pq_lists_search` (or ``sharded_ivf_flat_search``) splits over
    ``mesh``'s ``axis``; ``tier`` is the matching :class:`ShardedHostTier`.
    :meth:`search` returns a :class:`~raft_tpu_torch.robust.degrade.DegradedResult`.

    ``mesh`` is of either kind and any number of axes. On a process mesh
    every process passes the whole index and the whole tier, as it passes
    the whole index to the sharded search, and reads the merged winners'
    rows itself; the shards whose tier failed are agreed between the
    processes (a shard counts as failed when its read failed in any
    process), so every process returns the same answer."""

    def __init__(self, mesh, algo: str, index, tier: ShardedHostTier, *, axis: str = "data",
                 refine_ratio: int = 8, micro_batch: int = 256, search_params=None,
                 merge_mode: str = "auto", metric_arg: float = 2.0):
        expects(algo in ALGOS, "tiered sharded algo must be one of %s, got %r", ALGOS, algo)
        expects(refine_ratio >= 1, "refine_ratio must be >= 1")
        expects(micro_batch >= 1, "micro_batch must be >= 1")
        n_shards = mesh.shape[axis]
        expects(tier.n_shards == n_shards, "tier has %d shards for a %d-shard mesh",
                tier.n_shards, n_shards)
        expects(tier.n_rows >= int(index.size), "tier row map covers %d rows for an index of "
                "size %d", tier.n_rows, int(index.size))
        self.mesh = mesh
        self.algo = algo
        self.index = index
        self.tier = tier
        self.axis = axis
        self.refine_ratio = int(refine_ratio)
        self.micro_batch = int(micro_batch)
        self.search_params = search_params
        self.merge_mode = merge_mode
        self.metric_arg = float(metric_arg)

    @property
    def size(self) -> int:
        return int(self.index.size)

    @property
    def dim(self) -> int:
        return self.tier.dim

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def metric(self):
        return resolve_metric(self.index.metric)

    @property
    def device(self) -> torch.device:
        """Where results come back: the first shard's device."""
        return self.mesh.devices[0]

    # the label of the robust.* degradation metrics
    @property
    def _robust_algo(self) -> str:
        return f"tiered_{self.algo}"

    # the label of the tiered.search.* metrics (one value a configured algo)
    @property
    def _search_algo(self) -> str:
        return f"sharded_{self.algo}"

    def _scan(self, queries, kk: int, merge_mode: str, health):
        """Enqueue the sharded scan for ``kk`` global candidates; returns
        tensors on the first shard's device without a sync."""
        from raft_tpu_torch.parallel import sharded_ann

        search = (sharded_ann.sharded_ivf_flat_search if self.algo == "ivf_flat"
                  else sharded_ann.sharded_ivf_pq_lists_search)
        return search(self.mesh, self.index, queries, kk, self.search_params, axis=self.axis,
                      health=health, merge_mode=merge_mode)

    def _agree_failed(self, masked: np.ndarray, failed: Tuple[int, ...]):
        """The tier failures of every process (one gather of each process's
        failed shards): candidates owned by a shard that failed anywhere
        become ``-1`` here too."""
        ok = self.mesh.agreed([s not in failed for s in range(self.n_shards)])
        agreed = tuple(s for s, good in enumerate(ok) if not good)
        extra = [s for s in agreed if s not in failed]
        if extra:
            valid = masked >= 0
            own = self.tier.owner[np.where(valid, masked, 0)]
            masked = np.where(valid & np.isin(own, extra), -1, masked).astype(np.int32)
        return masked, agreed

    def search(self, queries, k: int, *, overlap: bool = True, micro_batch: Optional[int] = None,
               merge_mode: Optional[str] = None, health: Optional[Sequence[bool]] = None,
               min_coverage: float = 0.0):
        """Tiered sharded search -> :class:`DegradedResult`.

        ``health`` masks scan-side shards as
        :func:`raft_tpu_torch.robust.degrade.sharded_search_degraded` does
        (``None``: all healthy, no probe; the serving engine probes); a
        tier-side failure is found by the gather itself. Raises
        :class:`ShardFailure` when no shard is healthy or the combined scan
        and tier coverage falls below ``min_coverage``. ``overlap=False``
        runs scan, fetch and re-rank in turn for each micro-batch; the
        results are the same."""
        from raft_tpu_torch.robust.degrade import DegradedResult

        queries = ser.as_tensor(queries, self.device).to(torch.float32)
        expects(queries.ndim == 2 and queries.shape[1] == self.dim, "bad query shape")
        expects(1 <= k <= self.size, "k=%d out of range for index of size %d", k, self.size)
        kk = min(k * self.refine_ratio, self.size)
        mode = merge_mode if merge_mode is not None else self.merge_mode
        n_shards = self.n_shards

        if health is not None:
            health = tuple(bool(h) for h in health)
            expects(len(health) == n_shards, "health mask has %d entries for %d shards",
                    len(health), n_shards)
        n_scan_ok = n_shards if health is None else sum(health)
        scan_failed = () if health is None else tuple(s for s, ok in enumerate(health) if not ok)
        if n_scan_ok == 0:
            obs.inc("robust.queries_failed", algo=self._robust_algo)
            raise ShardFailure(f"all {n_shards} shards unhealthy", shard=-1)
        if n_scan_ok / n_shards < min_coverage:
            obs.inc("robust.queries_failed", algo=self._robust_algo)
            raise ShardFailure(f"coverage {n_scan_ok / n_shards:.2f} below required "
                               f"{min_coverage:.2f} (failed shards: {scan_failed})",
                               shard=scan_failed[0])
        # all healthy: the unmasked search, the plain sharded search's bits
        scan_health = health if n_scan_ok < n_shards else None

        mb = int(micro_batch or self.micro_batch)
        nq = queries.shape[0]
        spans = [(s, min(s + mb, nq)) for s in range(0, nq, mb)]
        failed_tiers = set()

        if obs.is_enabled():
            obs.inc("tiered.search.calls", algo=self._search_algo)
            obs.inc("tiered.search.queries", float(nq))

        def consume(i, cand, cand_host):
            s, e = spans[i]
            t0 = time.perf_counter()
            slab, masked, failed = self.tier.gather_to(cand_host, self.device)
            dt = time.perf_counter() - t0
            if self.mesh.is_process:
                masked, failed = self._agree_failed(masked, failed)
            failed_tiers.update(failed)
            cand = cand if not failed else torch.from_numpy(masked).to(self.device)
            # the span measures the enqueue only: the pipeline owns the sync
            with obs.span("tiered.refine", nq=int(e - s), k=int(k)):
                out = _exact_rerank(slab, queries[s:e], cand, cand >= 0, k=k, metric=self.metric,
                                    metric_arg=self.metric_arg)
            return out, dt

        def scan(i):
            return self._scan(queries[spans[i][0]:spans[i][1]], kk, mode, scan_health)

        with obs.span("tiered.sharded.search", algo=self.algo, nq=int(nq), k=int(k),
                      n_shards=int(n_shards)):
            if not overlap or len(spans) == 1:
                outs = []
                for i in range(len(spans)):
                    # the sequential schedule: the card idles during the gather
                    _, cand = scan(i)
                    outs.append(consume(i, cand, _to_host(cand, None))[0])
                eff = 0.0
            else:
                outs, eff = run_overlapped(len(spans), scan, consume)
            if obs.is_enabled():
                obs.set_gauge("tiered.overlap_efficiency", eff)
        d, ids = _collect(outs)

        ok = [s for s in range(n_shards)
              if (health is None or health[s]) and s not in failed_tiers]
        coverage = len(ok) / n_shards
        failed = tuple(sorted(set(scan_failed) | failed_tiers))
        if coverage < min_coverage:
            obs.inc("robust.queries_failed", algo=self._robust_algo)
            raise ShardFailure(f"coverage {coverage:.2f} below required {min_coverage:.2f} "
                               f"(failed shards: {failed})", shard=failed[0] if failed else -1)
        degraded = coverage < 1.0
        obs.set_gauge("robust.shards_healthy", len(ok), algo=self._robust_algo)
        if degraded:
            obs.inc("robust.degraded_queries", algo=self._robust_algo)
        return DegradedResult(distances=d, indices=ids, coverage=coverage, degraded=degraded,
                              failed_shards=failed)
