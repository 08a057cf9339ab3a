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
span a request) are the JAX engine's. Its planner, tiering, SLO and
replica hooks are not ported yet.
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

#: algo name -> default dispatch mode at registration
_DEFAULT_MODES = {"brute_force": "exact", "ivf_flat": "auto", "ivf_pq": "auto", "cagra": "auto",
                  "sharded_ivf_flat": "sharded", "sharded_ivf_pq_lists": "sharded"}


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
                 slow_shard_s: Optional[float] = 0.25):
        self.max_batch = int(max_batch)
        self.res = ensure_resources(res)
        self.batcher = MicroBatcher(max_batch=max_batch, max_wait_ms=max_wait_ms,
                                    capacity=queue_capacity)
        self.cache = ProgramCache()
        #: a health probe slower than this marks the shard unhealthy: serve
        #: degraded coverage now rather than wait out a slow shard (None: no
        #: latency budget)
        self.slow_shard_s = slow_shard_s
        #: floor between maintenance ticks driven from :meth:`step`
        self.maintenance_interval_ms = float(maintenance_interval_ms)
        self._last_maint = -float("inf")
        self._indexes: Dict[str, _Registration] = {}

    # -- registration ------------------------------------------------------

    def register(self, index_id: str, algo: str, index, *, params=None,
                 mode: Optional[str] = None, dataset=None, mesh=None, axis: str = "data",
                 min_coverage: float = 0.0, merge_mode: str = "auto",
                 **search_kwargs) -> None:
        """Register ``index`` (``algo`` = ``brute_force`` | ``ivf_flat`` |
        ``ivf_pq`` | ``cagra`` | ``sharded_ivf_flat`` |
        ``sharded_ivf_pq_lists``). ``params``/``mode``/``search_kwargs`` are
        pinned at registration; ``dataset`` enables integrated refine (for
        ``ivf_pq`` at the params' ``refine_ratio``, 8 by default). The
        sharded algos need ``mesh`` (their lists are split over its
        ``axis``), take ``min_coverage`` as their floor (below it a batch
        fails with ``ShardFailure`` rather than return near-empty results)
        and pin ``merge_mode`` (``"auto"`` | ``"ring"`` | ``"fused_ring"`` |
        ``"gather"``)."""
        expects(algo in _DEFAULT_MODES, "unknown serving algo %r (want one of %s)",
                algo, ", ".join(sorted(_DEFAULT_MODES)))
        if algo.startswith("sharded_"):
            expects(mesh is not None, "sharded algo %r needs mesh=", algo)
        self._indexes[index_id] = _Registration(
            index_id=index_id, algo=algo, index=index, params=params,
            mode=mode if mode is not None else _DEFAULT_MODES[algo],
            dataset=dataset, mesh=mesh, axis=axis, min_coverage=min_coverage,
            merge_mode=merge_mode, search_kwargs=dict(search_kwargs),
        )

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
        self._indexes[index_id] = _Registration(
            index_id=index_id, algo="mutable", index=mutable, params=params,
            mode="snapshot", search_kwargs=dict(search_kwargs), compactor=compactor,
        )

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

    def health(self) -> Dict[str, object]:
        """Health snapshot: queue and program-cache pressure, the obs gate
        and dropped spans, and per-index registration state. ``slo`` is
        None: SLO trackers (``set_slo``) are not ported yet, and None is what
        the JAX engine reports for an index without one."""
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
                "slo": None,
            }
        return out

    # -- maintenance -------------------------------------------------------

    def maintenance_tick(self) -> None:
        """One watchdog + auto-compaction pass over every registration
        that carries a :class:`~raft_tpu_torch.mutable.Compactor`. Driven
        from :meth:`step` (rate-limited by ``maintenance_interval_ms``);
        callable directly by deployments with their own schedulers. The
        JAX engine's tick also re-plans registrations and samples its
        flight recorder; the port has neither yet."""
        for reg in list(self._indexes.values()):
            if reg.compactor is not None:
                reg.compactor.tick()

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
        keys = [ProgramKey(index_id, reg.algo, b, int(k), params_key(reg.params), generation)
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
        out a slow shard."""
        mesh, axis, algo = reg.mesh, reg.axis, reg.algo.replace("sharded_", "")
        health = []
        for s in range(mesh.shape[axis]):
            t0 = time.perf_counter()
            try:
                faults.fire("sharded_ann.shard_scan", shard=s, algo=algo, axis=axis)
                ok = True
            except ShardFailure:
                obs.inc("robust.shard_failures", algo=algo, shard=str(s))
                ok = False
            if ok and self.slow_shard_s is not None:
                if time.perf_counter() - t0 > self.slow_shard_s:
                    obs.inc("serve.slow_shards", index_id=reg.index_id, shard=str(s))
                    ok = False
            health.append(ok)
        return tuple(health)

    def _build_program(self, reg: _Registration, bucket: int, k: int) -> Callable:
        from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq

        kw = reg.search_kwargs
        if reg.algo == "mutable":
            # the snapshot is not baked into the closure: it arrives per
            # dispatch, so a cached program never serves a stale view
            return lambda q, snap: snap.search(q, k, params=reg.params, **kw)
        if reg.algo == "brute_force":
            return lambda q: brute_force.search(reg.index, q, k, query_batch=bucket,
                                                dataset=reg.dataset, **kw)
        if reg.algo == "cagra":
            return lambda q: cagra.search(reg.index, q, k, reg.params, query_batch=bucket,
                                          mode=reg.mode, **kw)
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
                                     mode=reg.mode, dataset=reg.dataset, **kw)

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
        key = ProgramKey(reg.index_id, reg.algo, bucket, k, params_key(reg.params), generation)
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
            off += m


def _host(x) -> np.ndarray:
    """A search output on the host (mutable snapshots already return
    host arrays)."""
    return x if isinstance(x, np.ndarray) else x.cpu().numpy()
