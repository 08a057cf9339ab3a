"""Online query-serving engine (``raft_tpu.serve.engine`` counterpart,
reduced).

:class:`ServingEngine` turns a stream of small requests into the
power-of-two micro-batches the search paths want: requests enter through
:meth:`~ServingEngine.submit` / :meth:`~ServingEngine.submit_many` into a
bounded :class:`~raft_tpu_torch.serve.batcher.MicroBatcher`, each
micro-batch is zero-padded to its bucket, dispatched through a
:class:`~raft_tpu_torch.serve.bucketing.ProgramCache` closure on the
engine's device, un-padded, and every request's future completes with a
:class:`ServeResult`. The engine is synchronous: :meth:`~ServingEngine.step`
processes at most one micro-batch on the caller's thread.

It serves ``brute_force``, ``ivf_flat``, ``ivf_pq`` and ``cagra`` indexes,
lists-sharded ``sharded_ivf_flat`` and ``sharded_ivf_pq_lists`` indexes over
a :class:`~raft_tpu_torch.parallel.Mesh`, and
:class:`~raft_tpu_torch.mutable.MutableIndex` registrations
(:meth:`~ServingEngine.register_mutable`): each micro-batch runs against one
snapshot, the generation joins the program key and the result, and
:meth:`~ServingEngine.step` ticks the registrations' background compactors.

A sharded batch goes through
:func:`raft_tpu_torch.robust.degrade.sharded_search_degraded` behind a
timed per-shard health probe (:meth:`~ServingEngine._probe_health_timed`):
a shard that fails its probe, or answers it slower than ``slow_shard_s``,
is left out, and the batch's results carry ``coverage < 1.0``,
``degraded`` and ``failed_shards``; below the registration's
``min_coverage`` the batch fails with ``ShardFailure``. :meth:`health`
reports queue, cache, obs and per-index state. The ``serve.*`` counters
and gauges (``serve.coverage``, ``serve.slow_shards``), the
``serve.dispatch`` span and fault seam, and the request traces (a
``trace_id`` a request, one ``obs.trace_scope`` a batch, a ``serve.queue``
span a request) are the JAX engine's.

Placement: with ``hbm_budget_bytes`` set, a ``brute_force``, ``ivf_flat`` or
``ivf_pq`` registration's device residency
(:func:`raft_tpu_torch.ops.hbm_model.residency_for_index`, the port's
kernel caches included) joins the engine's fleet plan
(:func:`~raft_tpu_torch.ops.hbm_model.plan_placement`). A refine
``dataset`` that does not fit is rewrapped as a
:class:`~raft_tpu_torch.tiered.HostVectorStore` (``serve.tiered_degrades``):
the scan stays on the card and each batch's winners' rows come from host
RAM, with the resident results' bits. Scan components that do not fit fail
the registration typed. ``algo="tiered"`` registers a pre-built
:class:`~raft_tpu_torch.tiered.TieredIndex`. A sharded registration with a
dataset is planned per shard (``plan_placement_sharded``): a refine slab
that cannot stay on each shard's device converts the registration to
``tiered_sharded``, a :class:`~raft_tpu_torch.tiered.TieredShardedIndex`
whose per-shard host tiers follow the lists' ownership
(``serve.tiered_degrades``); ``algo="tiered_sharded"`` registers a pre-built
one. Its batches run behind the timed shard-health probe, and a dead host
tier costs coverage as a failed shard does.

The sharded registrations take a mesh of either kind and any number of
axes (their lists split along ``axis``). On a process mesh every process
runs its own engine, registers the same index, submits the same requests
in the same order and drives :meth:`~ServingEngine.run_until_idle` (or
``step(force=True)``), so its batches form from the queue alone, never
from the host clock (no ``max_wait_ms`` flush, no deadlines); each batch's
health mask is agreed between the processes, so every process serves the
same answer.

Planning: with the planner's gate on (``RAFT_TPU_PLAN``, on by default)
every registration carries a :class:`~raft_tpu_torch.plan.RegistrationPlan`
(the engine of each bucket, the merge engine, the tier label), which
:meth:`~ServingEngine.plan_explain` prints. The planned engine joins the
``ProgramKey``; :meth:`~ServingEngine.maintenance_tick` re-plans a
registration whose corpus or traffic drifted (``plan.build`` and
``plan.flip`` spans, ``plan.decisions``, ``serve.plan_flips``,
``serve.plan.recosts``, ``serve.plan.epoch``). The planner chooses what the
searches' inline ``auto`` rules choose, so serving gives the same bits with
the gate on or off.

SLOs and the replica layer: :meth:`~ServingEngine.set_slo` declares a
latency/availability objective an index (a
:class:`~raft_tpu_torch.obs.SloTracker` on the engine's clock, which
``clock=`` injects for the batcher and the trackers alike); every completed,
failed or expired request records against it, :meth:`~ServingEngine.health`
reports its status and :meth:`~ServingEngine.slo_burn` its fast-window burn.
:meth:`~ServingEngine.evict_queued` evacuates the queue of a replica
declared dead (:class:`raft_tpu_torch.replica.ReplicaGroup`). The
maintenance tick samples the installed flight recorder
(:mod:`raft_tpu_torch.obs.recorder`) and a plan flip notes itself there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import ShardFailure, expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.robust import faults
from raft_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    QueueFull,
    Request,
    ServeFuture,
)
from raft_tpu_torch.serve.bucketing import (
    ProgramCache,
    ProgramKey,
    bucket_for,
    bucket_sizes,
    pad_rows,
    params_key,
)

#: algo name -> default dispatch mode at registration ("tiered": a pre-built
#: TieredIndex, the device scan and the host-tier re-rank; "tiered_sharded":
#: a TieredShardedIndex, pre-built or converted at registration)
_DEFAULT_MODES = {"brute_force": "exact", "ivf_flat": "auto", "ivf_pq": "auto", "cagra": "auto",
                  "sharded_ivf_flat": "sharded", "sharded_ivf_pq_lists": "sharded",
                  "tiered": "auto", "tiered_sharded": "sharded"}

#: algos the placement planner models (and whose refine dataset can spill
#: to the host tier)
_TIERABLE_ALGOS = ("ivf_pq", "ivf_flat", "brute_force")

#: sharded algos whose refine dataset can move to per-shard host tiers (the
#: registration converts to "tiered_sharded"): the residency model each
#: uses and its TieredShardedIndex scan
_SHARDED_TIERABLE = {"sharded_ivf_flat": ("ivf_flat", "ivf_flat"),
                     "sharded_ivf_pq_lists": ("ivf_pq", "ivf_pq_lists")}


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One request's response."""

    distances: np.ndarray  # [m, k]
    indices: np.ndarray  # [m, k]
    #: fraction of the index that answered (1.0 on non-sharded paths)
    coverage: float = 1.0
    degraded: bool = False
    failed_shards: Tuple[int, ...] = ()
    time_in_queue_ms: float = 0.0
    #: arrival -> results on the host, on the engine clock
    latency_ms: float = 0.0
    bucket: int = 0
    batch_rows: int = 0
    #: mutable-index generation the answer was computed against (0 for
    #: immutable registrations)
    generation: int = 0
    #: obs request trace ID ("" with the gate off)
    trace_id: str = ""

    def __iter__(self):  # unpack like a plain (distances, indices)
        return iter((self.distances, self.indices))


@dataclasses.dataclass
class _Registration:
    index_id: str
    algo: str
    index: object
    params: object
    mode: str
    dataset: object = None
    mesh: object = None
    axis: str = "data"
    #: the sharded algos' coverage floor (below it a batch fails typed)
    min_coverage: float = 0.0
    merge_mode: str = "auto"
    search_kwargs: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: background compactor of a mutable registration (None when
    #: auto-compaction is not armed)
    compactor: object = None
    #: generation of the last dispatched batch (-1 before the first);
    #: crossing a flip bumps the ``serve.generation_flips`` counter
    last_generation: int = -1
    #: active :class:`raft_tpu_torch.plan.RegistrationPlan` (None with the
    #: planner's gate off); swapped in one assignment by the re-plan tick
    plan: object = None
    #: batches a bucket since the last plan (the live batch-size histogram)
    bucket_counts: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: dispatched rows/s EWMA, the traffic model's arrival-rate input
    ewma_rows_per_s: float = 0.0
    last_dispatch_t: float = -1.0
    #: k of the latest dispatch: what a plan flip warms programs for
    last_k: int = 10


class ServingEngine:
    """Dynamic micro-batching serving engine over registered indexes.

    >>> eng = ServingEngine(max_batch=128, max_wait_ms=2.0)
    >>> eng.register("sift", "ivf_flat", index, params=params)
    >>> fut = eng.submit("sift", query_rows, k=10)
    >>> eng.run_until_idle()
    >>> res = fut.result()          # ServeResult
    """

    def __init__(self, max_batch: int = 64, max_wait_ms: float = 2.0,
                 queue_capacity: int = 1024, res: Optional[Resources] = None,
                 maintenance_interval_ms: float = 10.0,
                 slow_shard_s: Optional[float] = 0.25,
                 hbm_budget_bytes: Optional[int] = None,
                 host_budget_bytes: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 cache_capacity: int = 64):
        self.max_batch = int(max_batch)
        self.res = ensure_resources(res)
        #: device-memory budget of the placement planner (None: unplanned,
        #: every registration keeps its dataset where the caller put it)
        self.hbm_budget_bytes = hbm_budget_bytes
        #: per-shard host-RAM budget of the sharded planner (None:
        #: unconstrained, nothing plans to disk)
        self.host_budget_bytes = host_budget_bytes
        self._residencies: Dict[str, object] = {}
        #: the planner's last verdict (an ``hbm_model.Placement``)
        self.placement = None
        #: per-registration sharded verdicts (``hbm_model.ShardedPlacement``)
        self.sharded_placements: Dict[str, object] = {}
        self.batcher = MicroBatcher(max_batch=max_batch, max_wait_ms=max_wait_ms,
                                    capacity=queue_capacity, clock=clock)
        self.cache = ProgramCache(capacity=cache_capacity)
        #: a health probe slower than this marks the shard unhealthy: serve
        #: degraded coverage now rather than wait out a slow shard (None: no
        #: latency budget)
        self.slow_shard_s = slow_shard_s
        #: floor between maintenance ticks driven from :meth:`step`
        self.maintenance_interval_ms = float(maintenance_interval_ms)
        self._last_maint = -float("inf")
        self._indexes: Dict[str, _Registration] = {}
        #: per-index SLO trackers (see :meth:`set_slo` / :meth:`health`)
        self._slos: Dict[str, obs.SloTracker] = {}

    # -- registration ------------------------------------------------------

    def register(self, index_id: str, algo: str, index, *, params=None,
                 mode: Optional[str] = None, dataset=None, mesh=None, axis: str = "data",
                 min_coverage: float = 0.0, merge_mode: str = "auto",
                 **search_kwargs) -> None:
        """Register ``index`` (``algo`` = ``brute_force`` | ``ivf_flat`` |
        ``ivf_pq`` | ``cagra`` | ``sharded_ivf_flat`` |
        ``sharded_ivf_pq_lists`` | ``tiered`` | ``tiered_sharded``).
        ``params``/``mode``/``search_kwargs`` are pinned at registration; ``dataset`` enables
        integrated refine (for ``ivf_pq`` at the params' ``refine_ratio``, 8
        by default). The sharded algos need ``mesh`` (their lists are split
        over its ``axis``), take ``min_coverage`` as their floor (below it a
        batch fails with ``ShardFailure`` rather than return near-empty
        results) and pin ``merge_mode`` (``"auto"`` | ``"ring"`` |
        ``"fused_ring"`` | ``"gather"``).

        ``algo="tiered"`` registers a pre-built
        :class:`raft_tpu_torch.tiered.TieredIndex` (its store, refine ratio
        and params travel with it). With the engine's ``hbm_budget_bytes``
        set, a ``dataset`` the placement planner cannot fit beside the
        registered indexes is rewrapped as a
        :class:`~raft_tpu_torch.tiered.HostVectorStore`, so the registration
        serves tiered instead of overfilling the card; scan components that
        do not fit raise ``LogicError``.

        ``algo="tiered_sharded"`` registers a pre-built
        :class:`raft_tpu_torch.tiered.TieredShardedIndex` (``mesh`` and
        ``axis`` default to the index's own). A sharded registration with a
        ``dataset`` under the budget runs the per-shard planner instead: a
        refine slab that cannot stay on each shard's device converts the
        registration to ``tiered_sharded`` over per-shard
        :class:`~raft_tpu_torch.tiered.ShardedHostTier` stores, so the
        merged winners re-rank from the host of the shard that scanned
        them."""
        expects(algo in _DEFAULT_MODES, "unknown serving algo %r (want one of %s)",
                algo, ", ".join(sorted(_DEFAULT_MODES)))
        if algo == "tiered_sharded" and mesh is None:
            mesh, axis = index.mesh, index.axis
        if algo.startswith("sharded_") or algo == "tiered_sharded":
            expects(mesh is not None, "sharded algo %r needs mesh=", algo)
        if algo in _SHARDED_TIERABLE:
            algo, index, dataset = self._plan_tier_sharded(
                index_id, algo, index, dataset, mesh=mesh, axis=axis, merge_mode=merge_mode,
                params=params, search_kwargs=search_kwargs)
        else:
            dataset = self._plan_tier(index_id, algo, index, dataset)
        reg = _Registration(
            index_id=index_id, algo=algo, index=index, params=params,
            mode=mode if mode is not None else _DEFAULT_MODES[algo],
            dataset=dataset, mesh=mesh, axis=axis, min_coverage=min_coverage,
            merge_mode=merge_mode, search_kwargs=dict(search_kwargs),
        )
        reg.plan = self._plan_registration(reg)
        self._indexes[index_id] = reg

    def _plan_tier(self, index_id: str, algo: str, index, dataset):
        """Ask the placement planner about this registration. With no
        budget, or an algo the model does not cover, the dataset passes
        through. Otherwise the index's residency joins the fleet plan: its
        scan components must fit (else ``LogicError``), and a refine
        dataset the plan spills comes back as a ``HostVectorStore``."""
        if self.hbm_budget_bytes is None or algo not in _TIERABLE_ALGOS:
            return dataset
        from raft_tpu_torch.neighbors.refine import is_host_dataset
        from raft_tpu_torch.ops.hbm_model import plan_placement, residency_for_index

        refine_rows = 0
        if dataset is not None and not is_host_dataset(dataset):
            refine_rows = int(dataset.shape[0])
        res = residency_for_index(index_id, algo, index, refine_rows=refine_rows)
        fleet = [r for iid, r in self._residencies.items() if iid != index_id]
        placement = plan_placement(fleet + [res], hbm_budget=self.hbm_budget_bytes)
        expects(
            placement.feasible,
            "registering %r needs %d B of scan-resident device memory against a budget of "
            "%d B — required components cannot tier to the host; shard or shrink the index",
            index_id, sum(r.required_bytes for r in fleet) + res.required_bytes,
            self.hbm_budget_bytes,
        )
        self._residencies[index_id] = res
        self.placement = placement
        if refine_rows and placement.tier(index_id, "raw_vectors") == "host":
            from raft_tpu_torch.tiered import HostVectorStore

            dataset = HostVectorStore(dataset)
            obs.inc("serve.tiered_degrades", index_id=index_id, algo=algo)
        return dataset

    def _plan_tier_sharded(self, index_id: str, algo: str, index, dataset, *, mesh, axis: str,
                           merge_mode: str, params, search_kwargs: dict):
        """Per-shard placement of a lists-sharded registration; returns the
        (possibly converted) ``(algo, index, dataset)``. With no budget, no
        refine ``dataset`` or a host store the registration passes as it
        is. Otherwise the index's residency runs through
        :func:`~raft_tpu_torch.ops.hbm_model.plan_placement_sharded`: scan
        components that do not fit a shard's device raise ``LogicError``, and
        a refine slab the plan moves off the device converts the
        registration to a :class:`~raft_tpu_torch.tiered.TieredShardedIndex`
        (``refine_ratio``, ``micro_batch``, ``metric_arg`` and
        ``fetch_depth_rows`` move from ``search_kwargs`` to it)."""
        if self.hbm_budget_bytes is None or dataset is None:
            return algo, index, dataset
        from raft_tpu_torch.neighbors.refine import is_host_dataset

        if is_host_dataset(dataset):
            return algo, index, dataset
        from raft_tpu_torch.ops.hbm_model import plan_placement_sharded, residency_for_index

        res_algo, scan_algo = _SHARDED_TIERABLE[algo]
        n_shards = mesh.shape[axis]
        res = residency_for_index(index_id, res_algo, index, refine_rows=int(dataset.shape[0]))
        placement = plan_placement_sharded(
            [res], n_shards, hbm_budget_per_shard=self.hbm_budget_bytes,
            host_budget_per_shard=self.host_budget_bytes,
        )
        expects(
            placement.feasible,
            "registering %r needs %d B/shard of scan-resident device memory over %d shards "
            "against a per-shard budget of %d B — required components cannot tier to the "
            "host; add shards or shrink the index",
            index_id, placement.device_bytes_per_shard - placement.staging_device_bytes,
            n_shards, self.hbm_budget_bytes,
        )
        self.sharded_placements[index_id] = placement
        if placement.tier(index_id, "raw_vectors") == "device":
            return algo, index, dataset
        from raft_tpu_torch.tiered import ShardedHostTier, TieredShardedIndex

        tier_kw = {key: search_kwargs.pop(key) for key in ("refine_ratio", "micro_batch",
                                                           "metric_arg") if key in search_kwargs}
        tier = ShardedHostTier.from_lists(index, dataset, n_shards,
                                          fetch_depth_rows=search_kwargs.pop("fetch_depth_rows",
                                                                             None))
        tiered = TieredShardedIndex(mesh, scan_algo, index, tier, axis=axis, search_params=params,
                                    merge_mode=merge_mode, **tier_kw)
        obs.inc("serve.tiered_degrades", index_id=index_id, algo=algo)
        return "tiered_sharded", tiered, None

    def register_mutable(self, index_id: str, mutable, *, params=None, policy=None,
                         compactor=None, **search_kwargs) -> None:
        """Register a :class:`raft_tpu_torch.mutable.MutableIndex`.

        Each micro-batch is dispatched against one immutable
        :meth:`~raft_tpu_torch.mutable.MutableIndex.snapshot` taken at
        dispatch time, so concurrent insert/delete/upsert (and
        compaction's generation flips) are atomic with respect to
        serving — a batch sees the whole mutation or none of it. The
        snapshot's generation joins the :class:`ProgramKey`.

        ``policy`` (a :class:`raft_tpu_torch.mutable.CompactionPolicy`)
        arms auto-compaction: the engine starts a background
        :class:`~raft_tpu_torch.mutable.Compactor` for the index and
        drives its watchdog/trigger tick from :meth:`step`, so a churning
        index rebuilds itself off-thread while this engine keeps serving
        snapshots. Pass a pre-built ``compactor`` instead to control retry
        policy, seed, or resources; :meth:`shutdown` stops engine-owned
        workers either way.
        """
        old = self._indexes.get(index_id)
        if old is not None and old.compactor is not None:
            old.compactor.stop()
        if compactor is None and policy is not None:
            from raft_tpu_torch.mutable.maintenance import Compactor

            compactor = Compactor(mutable, policy=policy, name=index_id)
        if compactor is not None:
            compactor.start()
        reg = _Registration(
            index_id=index_id, algo="mutable", index=mutable, params=params,
            mode="snapshot", search_kwargs=dict(search_kwargs), compactor=compactor,
        )
        # no engine pick for snapshot dispatch, but the plan carries the
        # corpus and traffic anchors the re-plan tick tracks
        reg.plan = self._plan_registration(reg)
        self._indexes[index_id] = reg

    def registered(self) -> List[str]:
        return list(self._indexes)

    # -- submission --------------------------------------------------------

    def submit(self, index_id: str, queries, k: int, deadline_ms: Optional[float] = None,
               trace_id: Optional[str] = None) -> ServeFuture:
        """Enqueue one request (``queries`` [m, dim] or one [dim] row) and
        return its future. Raises ``QueueFull`` / ``DeadlineExceeded`` at
        admission. With obs enabled the request gets a trace ID (``trace_id``
        adopts an existing one) that tags every span of its batch."""
        reg = self._reg(index_id)
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        expects(q.ndim == 2, "queries must be [m, dim] (or one [dim] row)")
        expects(q.shape[0] <= self.max_batch,
                "request has %d rows > max_batch %d — use submit_many to split",
                q.shape[0], self.max_batch)
        now = self.batcher.now()
        req = Request(
            queries=q, k=int(k), group=(index_id, int(k)), t_arrival=now,
            deadline_s=(now + deadline_ms / 1e3) if deadline_ms is not None else None,
        )
        if obs.is_enabled():
            # minted at admission: the synthetic serve.queue span starts here
            req.trace_id = trace_id or obs.new_trace_id()
            req.t_submit_us = obs.registry().now_us()
        try:
            self.batcher.offer(req)
        except QueueFull:
            obs.inc("serve.rejections", reason="queue_full", index_id=index_id)
            raise
        except DeadlineExceeded:
            obs.inc("serve.rejections", reason="deadline_admission", index_id=index_id)
            raise
        if obs.is_enabled():
            obs.inc("serve.requests", index_id=index_id, algo=reg.algo)
            obs.set_gauge("serve.queue_depth", self.batcher.depth_rows())
        return req.future

    def submit_many(self, index_id: str, queries, k: int,
                    deadline_ms: Optional[float] = None, request_rows: int = 1) -> List[ServeFuture]:
        """Split ``queries`` [n, dim] into requests of ``request_rows`` rows
        and submit them all; one future per request."""
        q = np.asarray(queries)
        expects(q.ndim == 2, "queries must be [n, dim]")
        expects(1 <= request_rows <= self.max_batch, "request_rows must be in [1, max_batch]")
        return [self.submit(index_id, q[s : s + request_rows], k, deadline_ms=deadline_ms)
                for s in range(0, q.shape[0], request_rows)]

    # -- the synchronous loop driver ---------------------------------------

    def step(self, force: bool = False) -> int:
        """Process at most one micro-batch; returns requests completed
        (deadline rejections included). At most every
        ``maintenance_interval_ms`` it first runs :meth:`maintenance_tick`."""
        now = self.batcher.now()
        if now - self._last_maint >= self.maintenance_interval_ms / 1e3:
            self._last_maint = now
            self.maintenance_tick()
        if not self.batcher.ready(now) and not (force and self.batcher.depth_requests()):
            return 0
        batch, expired = self.batcher.next_batch(now)
        for r in expired:
            obs.inc("serve.rejections", reason="deadline_expired", index_id=r.group[0])
            tracker = self._slos.get(r.group[0])
            if tracker is not None:
                tracker.record(ok=False)  # shed work burns the budget
        if batch:
            self._dispatch(batch, now)
        if obs.is_enabled():
            obs.set_gauge("serve.queue_depth", self.batcher.depth_rows())
        return len(expired) + len(batch)

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Drive :meth:`step` until the queue is empty."""
        total = 0
        for _ in range(max_steps):
            if not self.batcher.depth_requests():
                break
            total += self.step(force=True)
        return total

    def queue_depth(self) -> int:
        return self.batcher.depth_rows()

    def evict_queued(self) -> List[Request]:
        """Evacuate every queued request without completing its future
        (:meth:`~raft_tpu_torch.serve.batcher.MicroBatcher.drain_requests`).
        The replica layer calls this when this engine's replica is declared
        dead, then submits the evicted work again on a healthy replica."""
        out = self.batcher.drain_requests()
        if obs.is_enabled():
            obs.set_gauge("serve.queue_depth", self.batcher.depth_rows())
        return out

    # -- SLOs and health ---------------------------------------------------

    def set_slo(self, index_id: str, *, latency_ms: Optional[float] = None,
                target: float = 0.999, window_s: float = 3600.0,
                fast_window_s: float = 60.0, slow_window_s: float = 300.0,
                burn_threshold: float = 10.0) -> obs.SloTracker:
        """Declare a latency/availability objective for a registered index.
        Every completed request records against it: a request is bad when it
        fails, is shed past its deadline, or (with ``latency_ms``) finishes
        slower than the threshold, arrival to completion on the engine
        clock. The tracker shares that clock. Returns the tracker;
        :meth:`health` reports its :meth:`~raft_tpu_torch.obs.SloTracker.evaluate`."""
        self._reg(index_id)  # must be registered
        tracker = obs.SloTracker(
            obs.SLO(index_id=index_id, latency_ms=latency_ms, target=target,
                    window_s=window_s, fast_window_s=fast_window_s,
                    slow_window_s=slow_window_s, burn_threshold=burn_threshold),
            clock=self.batcher.now,
        )
        self._slos[index_id] = tracker
        return tracker

    def slo_burn(self, index_id: str) -> Optional[float]:
        """The index's fast-window SLO burn rate now (None without an SLO):
        what the replica autoscaler holds against its scale-up threshold."""
        tracker = self._slos.get(index_id)
        if tracker is None:
            return None
        return tracker.evaluate().burn_fast

    def health(self) -> Dict[str, object]:
        """Health snapshot: queue and program-cache pressure, the obs gate
        and dropped spans, and per-index registration state with its SLO
        status (``slo``: :meth:`~raft_tpu_torch.obs.SloTracker.evaluate` as a
        dict, None for an index without an SLO)."""
        cache_stats = self.cache.stats()
        out: Dict[str, object] = {
            "queue": {
                "depth_rows": self.batcher.depth_rows(),
                "depth_requests": self.batcher.depth_requests(),
                "capacity": self.batcher.capacity,
            },
            "cache": {
                "hits": cache_stats.hits,
                "misses": cache_stats.misses,
                "evictions": cache_stats.evictions,
                "size": cache_stats.size,
            },
            "obs": {
                "enabled": obs.is_enabled(),
                "spans_dropped": obs.registry().spans_dropped,
            },
            "indexes": {},
        }
        for index_id, reg in self._indexes.items():
            out["indexes"][index_id] = {
                "algo": reg.algo,
                "mode": reg.mode,
                "generation": max(reg.last_generation, 0),
            }
            tracker = self._slos.get(index_id)
            out["indexes"][index_id]["slo"] = tracker.evaluate().as_dict() if tracker else None
        return out

    # -- maintenance -------------------------------------------------------

    def maintenance_tick(self) -> None:
        """One watchdog + auto-compaction pass over every registration
        that carries a :class:`~raft_tpu_torch.mutable.Compactor`, then the
        planner's drift check (:meth:`_replan_tick`). Driven from
        :meth:`step` (rate-limited by ``maintenance_interval_ms``);
        callable directly by deployments with their own schedulers. Last, the
        flight recorder's sampler tick (a no-op unless a recorder is installed
        and obs is on): it keeps the serving time series and drains a dump a
        fault latched."""
        for reg in list(self._indexes.values()):
            if reg.compactor is not None:
                reg.compactor.tick()
        self._replan_tick()
        obs.recorder.tick()

    def shutdown(self, wait: bool = True) -> None:
        """Stop every engine-owned background compactor. Queued requests
        stay queued — this only halts maintenance threads."""
        for reg in self._indexes.values():
            if reg.compactor is not None:
                reg.compactor.stop(wait=wait)

    def warmup(self, index_id: str, k: int, run: bool = True) -> List[ProgramKey]:
        """Build (and with ``run=True`` run once on zero queries, which
        builds the kernels) every bucket's program for ``(index_id, k)``."""
        reg = self._reg(index_id)
        snap = reg.index.snapshot() if reg.algo == "mutable" else None
        generation = snap.generation if snap is not None else 0
        keys = [ProgramKey(index_id, reg.algo, b, int(k), self._program_params(reg, b), generation)
                for b in bucket_sizes(self.max_batch)]
        built = self.cache.warmup(keys, lambda key: (lambda: self._build_program(reg, key.bucket, key.k)))
        if run:
            for key in keys:
                prog = self.cache.get(key, lambda: self._build_program(reg, key.bucket, key.k))
                zeros = torch.zeros((key.bucket, int(reg.index.dim)), device=self.res.device)
                out = tuple(prog(zeros, snap) if snap is not None else prog(zeros))
                _host(out[0])  # wait for the run
        return built

    # -- internals ---------------------------------------------------------

    def _reg(self, index_id: str) -> _Registration:
        expects(index_id in self._indexes, "no index registered as %r", index_id)
        return self._indexes[index_id]

    def _probe_health_timed(self, reg: _Registration) -> Tuple[bool, ...]:
        """Per-shard health through the ``sharded_ann.shard_scan`` fault
        point with a latency budget: a probe that raises ``ShardFailure``
        (``robust.shard_failures``) or takes longer than ``slow_shard_s`` on
        the host clock (``serve.slow_shards{index_id,shard}``) marks the
        shard unhealthy, so the batch degrades coverage instead of waiting
        out a slow shard. On a process mesh each process probes and times
        its own shards and the processes agree on one mask
        (:func:`raft_tpu_torch.robust.degrade.agreed_health`)."""
        from raft_tpu_torch.robust.degrade import agreed_health

        mesh, axis, algo = reg.mesh, reg.axis, reg.algo.replace("sharded_", "")

        def probe(s: int) -> bool:
            t0 = time.perf_counter()
            try:
                faults.fire("sharded_ann.shard_scan", shard=s, algo=algo, axis=axis)
            except ShardFailure:
                obs.inc("robust.shard_failures", algo=algo, shard=str(s))
                return False
            if self.slow_shard_s is not None and time.perf_counter() - t0 > self.slow_shard_s:
                obs.inc("serve.slow_shards", index_id=reg.index_id, shard=str(s))
                return False
            return True

        return agreed_health(mesh, axis, probe)

    # -- query planning ----------------------------------------------------

    def _tier_label(self, reg: _Registration) -> str:
        """Placement verdict recorded on the plan ("" = unplanned)."""
        if reg.algo in ("tiered", "tiered_sharded"):
            return reg.algo
        if reg.dataset is not None:
            from raft_tpu_torch.neighbors.refine import is_host_dataset

            if is_host_dataset(reg.dataset):
                return "tiered"
        if reg.index_id in self._residencies or reg.index_id in self.sharded_placements:
            return "resident"
        return ""

    @staticmethod
    def _corpus_rows(reg: _Registration) -> int:
        try:
            return int(getattr(reg.index, "size", 0) or 0)
        except (TypeError, ValueError):
            return 0

    def _plan_registration(self, reg: _Registration, k: Optional[int] = None,
                           traffic=None, epoch: int = 0):
        """Cost this registration's decisions (None with the gate off).

        ``fused_ok`` is passed optimistically: a planned ``fused`` dispatches
        as ``"auto"`` (:meth:`_planned_mode`), so the search's own kernel
        check stays authoritative. ``on_cuda`` and the scan's eligibility
        are the index's (:func:`raft_tpu_torch.plan.on_cuda`,
        :func:`raft_tpu_torch.neighbors.ivf_common.auto_scan`)."""
        from raft_tpu_torch import plan
        from raft_tpu_torch.neighbors.ivf_common import auto_scan

        if not plan.is_enabled():
            return None
        device = getattr(reg.index, "device", self.res.device)
        scan_ok, scan_reason = auto_scan(device)
        n_shards = reg.mesh.shape[reg.axis] if reg.mesh is not None else 0
        with obs.span("plan.build", index_id=reg.index_id, algo=reg.algo, epoch=epoch):
            return plan.plan_registration(
                reg.index_id,
                reg.algo,
                buckets=bucket_sizes(self.max_batch),
                corpus_rows=self._corpus_rows(reg),
                on_cuda=plan.on_cuda(device),
                fused_ok=True,
                scan_ok=scan_ok,
                scan_reason=scan_reason,
                n_shards=n_shards,
                k=int(k if k is not None else reg.last_k),
                tier=self._tier_label(reg),
                mode_pinned=reg.mode != "auto",
                merge_pinned=reg.merge_mode != "auto",
                traffic=traffic,
                epoch=epoch,
            )

    @staticmethod
    def _planned_mode(reg: _Registration, bucket: int, plan=None) -> Optional[str]:
        """The plan's engine for this bucket (None: dispatch on
        ``reg.mode``). A planned ``fused`` dispatches as ``"auto"``: the
        search resolves it again, to the kernel where it can serve."""
        plan = plan if plan is not None else reg.plan
        if plan is None or reg.mode != "auto":
            return None
        m = plan.mode_for(bucket, "")
        if not m:
            return None
        return "auto" if m == "fused" else m

    def _program_params(self, reg: _Registration, bucket: int, plan=None) -> Tuple:
        """Params tuple for the ProgramKey: the registration's params and
        the planned engine where one applies, so a flip that changes a
        bucket's engine builds a new program and one that does not reuses
        the cached one."""
        pk = params_key(reg.params)
        m = self._planned_mode(reg, bucket, plan=plan)
        if m is not None:
            pk = pk + (("planned_mode", m),)
        return pk

    def plan_explain(self, index_id: str) -> Optional[str]:
        """The active plan's full cost breakdown (None with the planner's
        gate off)."""
        reg = self._reg(index_id)
        return reg.plan.explain() if reg.plan is not None else None

    def _warm_plan(self, reg: _Registration, new_plan) -> List[ProgramKey]:
        """Build and run the new plan's warm buckets' programs before the
        swap, so a flip never builds a kernel on the serving path."""
        if reg.mode != "auto" or not new_plan.bucket_modes:
            return []
        keys = [
            ProgramKey(reg.index_id, reg.algo, b, int(reg.last_k),
                       self._program_params(reg, b, plan=new_plan), 0)
            for b in new_plan.warm_buckets
            if new_plan.mode_for(b, "")
        ]
        for key in keys:
            prog = self.cache.get(
                key, lambda: self._build_program(reg, key.bucket, key.k, plan=new_plan))
            zeros = torch.zeros((key.bucket, int(reg.index.dim)), device=self.res.device)
            _host(tuple(prog(zeros))[0])  # wait for the run
        return keys

    def _replan_tick(self) -> None:
        """Re-cost every planned registration whose corpus or traffic
        drifted past the hysteresis thresholds; swap the plan in one
        assignment when a decision changed (``serve.plan_flips``), refresh
        the anchors when none did (``serve.plan.recosts``)."""
        from raft_tpu_torch import plan

        if not plan.is_enabled():
            return
        for reg in list(self._indexes.values()):
            rp = reg.plan
            if rp is None:
                continue
            traffic = plan.traffic_from_counts(reg.bucket_counts, reg.ewma_rows_per_s)
            rows = self._corpus_rows(reg)
            if not plan.needs_replan(rp, rows, traffic):
                continue
            new = self._plan_registration(reg, k=reg.last_k, traffic=traffic,
                                          epoch=rp.epoch + 1)
            if new is None:
                continue
            if rp.same_decisions(new):
                # drift acknowledged, decisions unchanged: re-anchor
                # without an epoch (or a program)
                reg.plan = dataclasses.replace(new, epoch=rp.epoch)
                obs.inc("serve.plan.recosts", index_id=reg.index_id)
                continue
            with obs.span("plan.flip", index_id=reg.index_id, epoch=new.epoch, algo=reg.algo):
                self._warm_plan(reg, new)
                # one assignment: a dispatch reads the old plan or the new
                # one, never a mix
                reg.plan = new
            reg.bucket_counts = {}
            obs.inc("serve.plan_flips", index_id=reg.index_id)
            obs.set_gauge("serve.plan.epoch", float(new.epoch), index_id=reg.index_id)
            # flight-recorder trigger: the swap is complete and no engine
            # lock is held here
            obs.recorder.note_plan_flip(reg.index_id, int(new.epoch))

    def _build_program(self, reg: _Registration, bucket: int, k: int, plan=None) -> Callable:
        from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

        kw = reg.search_kwargs
        # the planner's engine for this bucket ("auto" for a planned fused:
        # the search's own kernel check decides)
        mode = self._planned_mode(reg, bucket, plan=plan) or reg.mode
        if reg.algo == "mutable":
            # the snapshot is not baked into the closure: it arrives per
            # dispatch, so a cached program never serves a stale view
            return lambda q, snap: snap.search(q, k, params=reg.params, **kw)
        if reg.algo == "tiered":
            # "auto" defers to the TieredIndex's own default for its family
            t_mode = None if reg.mode == "auto" else reg.mode
            return lambda q: reg.index.search(q, k, mode=t_mode, **kw)
        if reg.algo == "brute_force":
            return lambda q: brute_force.search(reg.index, q, k, query_batch=bucket,
                                                mode=reg.mode, dataset=reg.dataset, **kw)
        if reg.algo == "cagra":
            return lambda q: cagra.search(reg.index, q, k, reg.params, query_batch=bucket,
                                          mode=mode, **kw)
        if reg.algo == "tiered_sharded":
            # the timed health probe masks the scan side; the gather finds a
            # dead host tier itself; the result carries the combined coverage
            return lambda q: reg.index.search(
                q, k, health=self._probe_health_timed(reg), min_coverage=reg.min_coverage,
                merge_mode=None if reg.merge_mode == "auto" else reg.merge_mode, **kw)
        if reg.algo.startswith("sharded_"):
            # a timed health probe a dispatch; failed and slow shards are
            # left out and the result carries its coverage
            from raft_tpu_torch.robust.degrade import sharded_search_degraded

            algo = reg.algo.replace("sharded_", "")
            return lambda q: sharded_search_degraded(
                reg.mesh, reg.index, q, k, algo=algo, params=reg.params, axis=reg.axis,
                health=self._probe_health_timed(reg), min_coverage=reg.min_coverage,
                merge_mode=reg.merge_mode, **kw)
        algo = ivf_flat if reg.algo == "ivf_flat" else ivf_pq
        return lambda q: algo.search(reg.index, q, k, reg.params, query_batch=bucket,
                                     mode=mode, dataset=reg.dataset, **kw)

    def _dispatch(self, batch: Sequence[Request], now: float) -> None:
        """Pad the batch to its bucket, run its program, complete every
        future. A failure fails this batch's futures and the engine keeps
        serving."""
        reg = self._reg(batch[0].group[0])
        k = batch[0].group[1]
        rows = np.concatenate([r.queries for r in batch], axis=0)
        n = rows.shape[0]
        bucket = bucket_for(n, self.max_batch)
        padded = torch.from_numpy(pad_rows(rows, bucket)).to(self.res.device)
        # one snapshot per micro-batch: every request in the batch sees
        # the same immutable view, and writers never race the dispatch
        snap = reg.index.snapshot() if reg.algo == "mutable" else None
        generation = snap.generation if snap is not None else 0
        if snap is not None:
            # a batch that crosses a background flip lands wholly on one
            # side of it (this snapshot); count the crossing
            if reg.last_generation >= 0 and generation != reg.last_generation:
                obs.inc("serve.generation_flips", index_id=reg.index_id)
            reg.last_generation = generation
        # the traffic model's inputs: the batch-size histogram and the
        # arrival-rate EWMA the re-plan tick measures drift against
        reg.bucket_counts[bucket] = reg.bucket_counts.get(bucket, 0) + 1
        reg.last_k = k
        if reg.last_dispatch_t >= 0.0:
            rate = n / max(now - reg.last_dispatch_t, 1e-6)
            reg.ewma_rows_per_s = 0.25 * rate + 0.75 * reg.ewma_rows_per_s
        reg.last_dispatch_t = now
        key = ProgramKey(reg.index_id, reg.algo, bucket, k, self._program_params(reg, bucket),
                         generation)
        tracker = self._slos.get(reg.index_id)
        # the batch's trace IDs ride the dispatch thread: every span below
        # carries them; NULL_SCOPE keeps the disabled path allocation-free
        scope = (obs.trace_scope(tuple(r.trace_id for r in batch)) if obs.is_enabled()
                 else obs.NULL_SCOPE)
        try:
            program = self.cache.get(key, lambda: self._build_program(reg, bucket, k))
            faults.fire("serve.dispatch", index_id=reg.index_id, algo=reg.algo, bucket=bucket,
                        rows=n)
            t0 = time.perf_counter()
            with scope, obs.span("serve.dispatch", algo=reg.algo, bucket=bucket, rows=n,
                                 k=k) as sp:
                out = program(padded, snap) if snap is not None else program(padded)
                dv, iv = sp.sync(tuple(out))
            # a DegradedResult from the sharded paths carries its health
            coverage = getattr(out, "coverage", 1.0)
            degraded = getattr(out, "degraded", False)
            failed = getattr(out, "failed_shards", ())
            d_np = _host(dv)
            i_np = _host(iv)
            self.batcher.note_service_time(time.perf_counter() - t0)
        except Exception as e:  # the serving loop must survive one bad batch
            obs.inc("serve.dispatch_errors", index_id=reg.index_id, kind=type(e).__name__)
            for r in batch:
                r.future.set_exception(e)
                if tracker is not None:
                    tracker.record(ok=False)
            return
        if obs.is_enabled():
            obs.inc("serve.batches", index_id=reg.index_id, algo=reg.algo)
            obs.observe("serve.batch_fill", n / bucket)
            obs.observe("serve.batch_rows", float(n))
            obs.set_gauge("serve.coverage", float(coverage), index_id=reg.index_id)
            if snap is not None:
                obs.set_gauge("serve.generation", float(generation), index_id=reg.index_id)
        t_done = self.batcher.now()
        off = 0
        for r in batch:
            m = r.n_rows
            tiq_ms = (now - r.t_arrival) * 1e3
            if obs.is_enabled():
                obs.observe("serve.time_in_queue_ms", tiq_ms, trace_id=r.trace_id or None)
                if r.trace_id:
                    # the request's wait as a span on its own track (tid
                    # from req_id): the first hop of its trace
                    obs.registry().record_span(
                        "serve.queue", r.t_submit_us, max(tiq_ms, 0.0) * 1e3,
                        0x40000000 + (r.req_id % 0x3FFFFFFF), 0,
                        {"index_id": reg.index_id, "rows": m}, trace=(r.trace_id,))
            r.future.set_result(ServeResult(
                distances=d_np[off : off + m],
                indices=i_np[off : off + m],
                coverage=float(coverage),
                degraded=bool(degraded),
                failed_shards=tuple(failed),
                time_in_queue_ms=tiq_ms,
                latency_ms=(t_done - r.t_arrival) * 1e3,
                bucket=bucket,
                batch_rows=n,
                generation=generation,
                trace_id=r.trace_id,
            ))
            if tracker is not None:
                tracker.record(latency_ms=(t_done - r.t_arrival) * 1e3)
            off += m


def _host(x) -> np.ndarray:
    """A search output on the host (mutable snapshots already return
    host arrays)."""
    return x if isinstance(x, np.ndarray) else x.cpu().numpy()
