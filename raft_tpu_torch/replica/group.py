"""Replicated serving: N engine-backed copies behind one futures API
(``raft_tpu.replica.group`` counterpart).

:class:`ReplicaGroup` owns N :class:`~raft_tpu_torch.serve.engine.
ServingEngine` s, each holding its own copy of every registered index,
and presents the *same* submit/step/run_until_idle surface as a single
engine — callers cannot tell (and should not care) how many replicas
answer them. What the group adds on top:

* **health-routed admission** — every submit consults the
  :class:`~raft_tpu_torch.replica.router.Router`: least-queue-depth replica
  among those whose :class:`~raft_tpu_torch.robust.retry.CircuitBreaker` is
  closed and whose staleness is within the admission floor. A replica
  that keeps failing its pump is quarantined (breaker opens) and takes
  no new work until its half-open probe succeeds.
* **failover that re-queues** — a replica that dies mid-batch (pump
  raises through the ``replica.dispatch`` fault seam, or exceeds
  ``dispatch_timeout_s``) has its queue evacuated and every in-flight
  request **re-submitted on a healthy replica** under the same trace
  ID. The caller's future completes with a normal result; the only
  caller-visible artifact of a replica death is latency (and the
  ``serve.failovers`` counter). Requests that cannot immediately be
  placed are *parked* and retried every step — never errored, never
  dropped.
* **bounded-staleness follower serving** — mutable registrations ride
  :class:`~raft_tpu_torch.replica.shipping.Replication` (leader WAL seal →
  ship → follower replay); the group's maintenance tick drives the
  seal/ship cycle and feeds each follower's record lag into the router
  so reads never land on a replica further behind than
  ``max_staleness_records``.

Drive modes: the default is the repo's synchronous discipline —
:meth:`step` pumps every replica on the caller's thread, so tests are
deterministic. :meth:`start` switches to one pump thread per replica
(what ``chip_smoke.py``'s replica phase measures);
:meth:`stop` returns to synchronous mode.

Lock discipline: ``replica.group`` guards only the in-flight and
parked bookkeeping lists. It is an **edge-free leaf** in
``raft_tpu_torch/utils/lock_order.toml`` — no engine, obs, faults, or other
tracked-lock call ever happens while it is held; every method snapshots
under the lock and acts outside it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.replica.router import Router
from raft_tpu_torch.robust import faults
from raft_tpu_torch.serve.batcher import DeadlineExceeded, QueueFull, ServeFuture
from raft_tpu_torch.serve.engine import ServingEngine
from raft_tpu_torch.utils import lockcheck


@dataclasses.dataclass
class _Flight:
    """One caller request the group is responsible for: the caller's
    future (``gfut``), the engine-level future of its current placement
    (``efut``), and everything needed to re-submit it elsewhere."""

    gfut: ServeFuture
    efut: Optional[ServeFuture]
    replica: int
    index_id: str
    queries: np.ndarray
    k: int
    #: absolute deadline on the group clock (None = no deadline) — kept
    #: absolute so failover re-submission shrinks, never resets, it
    deadline_s: Optional[float]
    trace_id: str
    attempts: int = 1


@lockcheck.guarded_fields
class ReplicaGroup:
    """N replicas of a serving engine behind health-aware routing and
    re-queueing failover.

    >>> group = ReplicaGroup(n_replicas=2)
    >>> group.register("wiki", "cagra", index)   # shared immutable copy
    >>> fut = group.submit("wiki", rows, k=10)
    >>> group.run_until_idle()
    >>> res = fut.result()
    """

    def __init__(
        self,
        engines: Optional[Sequence[ServingEngine]] = None,
        *,
        n_replicas: int = 2,
        engine_factory: Optional[Callable[[int], ServingEngine]] = None,
        failure_threshold: int = 3,
        reset_timeout_s: float = 0.25,
        dispatch_timeout_s: Optional[float] = None,
        max_staleness_records: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
        name: str = "replicas",
        maintenance_interval_ms: float = 10.0,
        res: Optional[Resources] = None,
    ):
        # the default factory's engines share the group's clock and device
        # (``res``; default ``cuda``)
        self._engine_factory = engine_factory or (
            lambda r: ServingEngine(clock=clock, res=res)
        )
        if engines is not None:
            self.engines: List[ServingEngine] = list(engines)
        else:
            self.engines = [self._engine_factory(r) for r in range(int(n_replicas))]
        expects(len(self.engines) >= 1, "a replica group needs >= 1 engine")
        self.name = str(name)
        self.n_replicas = len(self.engines)
        self._clock = clock if clock is not None else time.monotonic
        #: a pump (one engine.step) slower than this declares the
        #: replica failed even though it returned — the slow-replica
        #: analog of the engine's slow-shard policy (None = no bound)
        self.dispatch_timeout_s = dispatch_timeout_s
        self.router = Router(
            self.n_replicas,
            failure_threshold=failure_threshold,
            reset_timeout_s=reset_timeout_s,
            max_staleness_records=max_staleness_records,
            clock=self._clock,
        )
        self.maintenance_interval_ms = float(maintenance_interval_ms)
        self._last_maint = -float("inf")
        #: mutable replication pipelines by index_id (leader on replica
        #: 0, follower j on replica j+1) — see register_mutable_replicated
        self._replications: Dict[str, object] = {}
        # guards _flights/_parked ONLY; everything else (engines, obs,
        # faults, router breakers) is called with it released
        self._lock = lockcheck.tracked(threading.RLock(), "replica.group")
        self._flights: List[_Flight] = []
        self._parked: List[_Flight] = []
        #: how to rebuild each registration on a freshly provisioned
        #: replica (autoscale-up) or after a control-plane promotion
        #: swapped the serving handles — ("immutable", (algo, index,
        #: kwargs)) or ("replicated", kwargs), plus declared SLOs
        self._registrations: Dict[str, tuple] = {}
        self._slo_kwargs: Dict[str, dict] = {}
        # autoscaler state: owned by the maintenance driver (thread 0 in
        # threaded mode, the stepping thread otherwise) — single-owner,
        # like _threads
        self._autoscaler = None
        self._warm_k: Dict[str, int] = {}
        self._draining_rid: Optional[int] = None
        self._pump_interval_s = 0.0005
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # -- registration ------------------------------------------------------

    def register(self, index_id: str, algo: str, indexes, **kwargs) -> None:
        """Register an immutable index on every replica.

        ``indexes`` is either one index object (shared — immutable
        structures are safe to serve from N engines at once) or a
        sequence of ``n_replicas`` per-replica copies. ``kwargs`` pass
        through to each engine's :meth:`~raft_tpu_torch.serve.engine.
        ServingEngine.register` unchanged."""
        per_replica = (
            list(indexes)
            if isinstance(indexes, (list, tuple))
            else [indexes] * self.n_replicas
        )
        expects(
            len(per_replica) == self.n_replicas,
            "need one index per replica (%d), got %d",
            self.n_replicas, len(per_replica),
        )
        for eng, idx in zip(self.engines, per_replica):
            eng.register(index_id, algo, idx, **kwargs)
        with self._lock:
            # immutable structures are safe to share: a scaled-up
            # replica re-registers the first copy
            self._registrations[index_id] = (
                "immutable", (algo, per_replica[0], dict(kwargs))
            )

    def register_mutable_replicated(self, index_id: str, replication, **kwargs) -> None:
        """Register a WAL-shipped mutable replication pipeline: the
        leader :class:`~raft_tpu_torch.mutable.MutableIndex` serves from
        replica 0 and each :class:`~raft_tpu_torch.replica.shipping.Follower`
        from the next replica. The group's maintenance tick drives
        ``replication.tick()`` (seal → ship → replay) and publishes each
        follower's record lag to the router, closing the
        bounded-staleness loop. Requires ``1 + len(followers) ==
        n_replicas``."""
        handles = replication.indexes()
        expects(
            len(handles) == self.n_replicas,
            "replication carries %d indexes (leader + followers) but the "
            "group has %d replicas",
            len(handles), self.n_replicas,
        )
        for eng, idx in zip(self.engines, handles):
            eng.register_mutable(index_id, idx, **kwargs)
        with self._lock:
            self._replications[index_id] = replication
            self._registrations[index_id] = ("replicated", dict(kwargs))

    def registered(self) -> List[str]:
        return self.engines[0].registered()

    # -- submission --------------------------------------------------------

    def submit(
        self,
        index_id: str,
        queries,
        k: int,
        deadline_ms: Optional[float] = None,
    ) -> ServeFuture:
        """Enqueue one request on the best replica and return a
        group-level future. Admission walks replicas in router order —
        a replica rejecting with :class:`QueueFull` (its queue, not the
        group's) falls through to the next; only when *every* admissible
        replica rejects does the caller see the typed rejection."""
        q = np.asarray(queries)
        if q.ndim == 1:
            q = q[None, :]
        now = self._clock()
        deadline_s = now + deadline_ms / 1e3 if deadline_ms is not None else None
        trace_id = obs.new_trace_id() if obs.is_enabled() else ""
        fl = _Flight(
            gfut=ServeFuture(),
            efut=None,
            replica=-1,
            index_id=index_id,
            queries=q,
            k=int(k),
            deadline_s=deadline_s,
            trace_id=trace_id,
        )
        placed, last_exc = self._place(fl, exclude=set())
        if not placed:
            raise last_exc if last_exc is not None else QueueFull(
                f"no admissible replica for {index_id!r} "
                f"({self.n_replicas} replicas, all open/stale)"
            )
        with self._lock:
            self._flights.append(fl)
        return fl.gfut

    def _place(self, fl: _Flight, exclude: Set[int]):
        """Try to land ``fl`` on an admissible replica; mutates
        ``fl.replica``/``fl.efut`` on success. Returns ``(placed,
        last_typed_rejection)``."""
        tried = set(exclude)
        last_exc: Optional[BaseException] = None
        while True:
            depths = [eng.queue_depth() for eng in self.engines]
            rid = self.router.pick(depths, exclude=tried)
            if rid is None:
                return False, last_exc
            now = self._clock()
            remaining_ms: Optional[float] = None
            if fl.deadline_s is not None:
                remaining_ms = max((fl.deadline_s - now) * 1e3, 0.0)
            try:
                # _Flight is single-owner: exactly one thread holds it at a
                # time (submitter until placed, then whichever pump harvests
                # it), with ownership handed off through _flights under
                # self._lock — its fields never need their own guard
                fl.efut = self.engines[rid].submit(
                    fl.index_id, fl.queries, fl.k,
                    deadline_ms=remaining_ms,
                    trace_id=fl.trace_id or None,
                )
            except (QueueFull, DeadlineExceeded) as e:
                last_exc = e
                tried.add(rid)
                continue
            fl.replica = rid
            return True, None

    # -- the loop drivers --------------------------------------------------

    def step(self, force: bool = False) -> int:
        """Pump every replica once on the calling thread (a no-op
        returning 0 while :meth:`start` ed pump threads own the
        engines), retry parked failovers, and run rate-limited
        maintenance. Returns caller futures completed."""
        if self._threads:
            return 0
        done = 0
        for rid in range(self.n_replicas):
            done += self._pump_replica(rid, force)
        done += self._retry_parked()
        if self._maint_due():
            self.maintenance_tick()
        return done

    def _maint_due(self) -> bool:
        """Rate-limit gate for maintenance: check-and-advance
        ``_last_maint`` atomically so concurrent drivers can't both fire
        the same interval (the tick itself runs outside the lock)."""
        now = self._clock()
        with self._lock:
            if now - self._last_maint >= self.maintenance_interval_ms / 1e3:
                self._last_maint = now
                return True
        return False

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Drive :meth:`step` until no flight, parked request, or queued
        row remains; returns caller futures completed. With pump threads
        running this just waits for quiescence."""
        total = 0
        for _ in range(max_steps):
            if not self._busy():
                break
            if self._threads:
                time.sleep(0.0005)
            else:
                total += self.step(force=True)
        return total

    def _busy(self) -> bool:
        with self._lock:
            pending = bool(self._flights or self._parked)
        return pending or any(eng.queue_depth() for eng in self.engines)

    def queue_depth(self) -> int:
        """Queued query rows across all replicas plus parked failovers."""
        with self._lock:
            parked_rows = sum(int(fl.queries.shape[0]) for fl in self._parked)
        return sum(eng.queue_depth() for eng in self.engines) + parked_rows

    # -- the per-replica pump ----------------------------------------------

    def _pump_replica(self, rid: int, force: bool) -> int:
        """One ``engine.step`` for replica ``rid``, wrapped in the
        failure machinery: the ``replica.dispatch`` chaos seam fires
        first (a replica kill is a fault installed here), a raise or a
        too-slow pump fails the replica (breaker + evacuate + failover),
        and a clean pump harvests completed engine futures into the
        caller-facing ones."""
        breaker = self.router.breaker(rid)
        if breaker.state != breaker.CLOSED and not breaker.allow():
            return 0  # quarantined, and no probe is due yet
        err: Optional[BaseException] = None
        t0 = time.perf_counter()
        try:
            faults.fire("replica.dispatch", replica=rid, group=self.name)
            self.engines[rid].step(force=force)
        except Exception as e:
            err = e
        slow = (
            err is None
            and self.dispatch_timeout_s is not None
            and time.perf_counter() - t0 > self.dispatch_timeout_s
        )
        if err is not None or slow:
            self._fail_replica(rid, err, slow)
            return 0
        done = self._harvest(rid)
        breaker.record_success()
        return done

    def _harvest(self, rid: int) -> int:
        """Move completed engine futures on ``rid`` into their caller
        futures; dispatch failures become failovers."""
        with self._lock:
            mine = [fl for fl in self._flights if fl.replica == rid]
        done = 0
        failed: List[_Flight] = []
        for fl in mine:
            if fl.efut is None or not fl.efut.done():
                continue
            with self._lock:
                if fl in self._flights:
                    self._flights.remove(fl)
            exc = fl.efut.exception(timeout=0)
            if exc is None:
                fl.gfut.set_result(fl.efut.result(timeout=0))
                done += 1
            elif isinstance(exc, (QueueFull, DeadlineExceeded)):
                # the engine's own typed verdict (deadline expired in
                # queue) is the caller's verdict — failover can't help
                fl.gfut.set_exception(exc)
                done += 1
            else:
                failed.append(fl)
        if failed:
            self.router.breaker(rid).record_failure()
            for fl in failed:
                self._failover(fl)
        return done

    def _fail_replica(self, rid: int, err: Optional[BaseException], slow: bool) -> None:
        """Declare replica ``rid`` failed: trip its breaker one notch,
        evacuate its queue, and fail over every flight it held. Callers
        see none of this — their futures re-queue elsewhere."""
        kind = "slow" if slow else type(err).__name__
        obs.inc("replica.pump_failures", replica=str(rid), kind=kind)
        self.router.breaker(rid).record_failure()
        # abandon the engine-level futures: the flights below re-submit
        # on a healthy replica and complete their caller futures there
        self.engines[rid].evict_queued()
        with self._lock:
            mine = [fl for fl in self._flights if fl.replica == rid]
            for fl in mine:
                self._flights.remove(fl)
        for fl in mine:
            # a batch the engine completed before the pump died still
            # counts — deliver it rather than recompute
            if fl.efut is not None and fl.efut.done():
                exc = fl.efut.exception(timeout=0)
                if exc is None:
                    fl.gfut.set_result(fl.efut.result(timeout=0))
                    continue
                if isinstance(exc, (QueueFull, DeadlineExceeded)):
                    fl.gfut.set_exception(exc)
                    continue
            self._failover(fl)

    def _failover(self, fl: _Flight) -> None:
        """Re-queue one flight on a healthy replica (excluding the one
        it just failed on), parking it for retry when nowhere is
        admissible right now. The request's trace ID rides along, so
        the obs timeline shows one request crossing replicas."""
        obs.inc("serve.failovers", index_id=fl.index_id, replica=str(fl.replica))
        if fl.trace_id and obs.is_enabled():
            with obs.trace_scope((fl.trace_id,)):
                with obs.span(
                    "replica.failover",
                    index_id=fl.index_id, from_replica=fl.replica,
                    attempt=fl.attempts,
                ):
                    pass
        now = self._clock()
        if fl.deadline_s is not None and now > fl.deadline_s:
            fl.gfut.set_exception(DeadlineExceeded(
                f"request deadline expired during failover off replica "
                f"{fl.replica} (attempt {fl.attempts})"
            ))
            return
        failed_on = fl.replica
        fl.attempts += 1
        placed, _ = self._place(fl, exclude={failed_on})
        if placed:
            with self._lock:
                self._flights.append(fl)
        else:
            # nowhere to go *right now* (breakers open / queues full):
            # park — _retry_parked re-offers it every step until a
            # replica recovers or its deadline truly expires
            with self._lock:
                self._parked.append(fl)

    def _retry_parked(self) -> int:
        """Re-offer every parked flight; expired deadlines become typed
        rejections, the rest either land or park again."""
        with self._lock:
            if not self._parked:
                return 0
            parked, self._parked = self._parked, []
        done = 0
        for fl in parked:
            now = self._clock()
            if fl.deadline_s is not None and now > fl.deadline_s:
                fl.gfut.set_exception(DeadlineExceeded(
                    f"request deadline expired while parked for failover "
                    f"(attempt {fl.attempts})"
                ))
                done += 1
                continue
            placed, _ = self._place(fl, exclude=set())
            if placed:
                with self._lock:
                    self._flights.append(fl)
            else:
                with self._lock:
                    self._parked.append(fl)
        return done

    # -- maintenance, replication, health ----------------------------------

    def maintenance_tick(self) -> None:
        """Drive every replication pipeline one cycle (leader seal →
        ship sealed frames → follower replay — and, when a control
        plane is attached, its renew-or-elect pass), re-register
        engines when a promotion swapped the serving handles, publish
        follower lag to the router's admission floor, and run one
        autoscaler decision."""
        with self._lock:
            replications = list(self._replications.items())
        for index_id, replication in replications:
            replication.tick()
            take = getattr(replication, "take_handles_changed", None)
            if take is not None and take():
                self._reregister(index_id, replication)
            for j in range(len(replication.followers)):
                self.router.set_staleness(j + 1, replication.staleness(j))
        self._autoscale_step()

    def _reregister(self, index_id: str, replication) -> None:
        """A control-plane promotion (or resize) swapped the
        replication's serving handles: point every engine at the new
        ones. Same-length zip by construction — promotions conserve the
        replica count; a mid-resize mismatch self-heals next tick."""
        with self._lock:
            reg = self._registrations.get(index_id)
        kwargs = reg[1] if reg is not None and reg[0] == "replicated" else {}
        for eng, idx in zip(list(self.engines), replication.indexes()):
            eng.register_mutable(index_id, idx, **kwargs)

    # -- SLO-driven autoscaling --------------------------------------------

    def enable_autoscaler(
        self,
        policy,
        *,
        warm_k: Optional[Dict[str, int]] = None,
        autoscaler=None,
    ) -> None:
        """Arm SLO-driven fleet sizing: every maintenance tick feeds the
        worst fast-window burn rate (across replica 0's SLOs) and the
        group-wide queue depth into an :class:`~raft_tpu_torch.replica.
        control.Autoscaler`, and acts on its advice — grow with a
        warmed-up replica, or drain-then-retire the highest one.

        ``policy`` is an :class:`~raft_tpu_torch.replica.control.
        AutoscalePolicy` (ignored when a prebuilt ``autoscaler`` is
        passed). ``warm_k`` maps index ids to the ``k`` each new
        replica builds and runs (:meth:`ServingEngine.warmup` →
        ``ProgramCache.warmup``) *before* it takes traffic."""
        if autoscaler is None:
            from raft_tpu_torch.replica.control import Autoscaler

            autoscaler = Autoscaler(policy, clock=self._clock)
        self._warm_k = dict(warm_k or {})
        self._autoscaler = autoscaler

    def _autoscale_step(self) -> None:
        """One sizing decision per maintenance tick. A drain in
        progress preempts new decisions — the fleet finishes one
        resize before considering the next."""
        a = self._autoscaler
        if a is None:
            return
        if self._draining_rid is not None:
            self._drain_step()
            return
        eng0 = self.engines[0]
        burn = 0.0
        for iid in eng0.registered():
            b = eng0.slo_burn(iid)
            if b is not None:
                burn = max(burn, b)
        decision = a.decide(
            burn=burn, queue_rows=self.queue_depth(),
            n_replicas=self.n_replicas, now=self._clock(),
        )
        if decision > 0:
            self._scale_up()
        elif decision < 0 and self.n_replicas >= 2:
            self._begin_drain()

    def _provision_engine(self, rid: int):
        """Build a fresh engine carrying every current registration
        (replicated ones grow their pipeline by one follower via the
        control plane). Returns None when any registration cannot be
        reproduced — a partially registered replica must never join
        the routable set."""
        eng = self._engine_factory(rid)
        with self._lock:
            regs = dict(self._registrations)
            replications = dict(self._replications)
            slos = {k: dict(v) for k, v in self._slo_kwargs.items()}
        for index_id, (kind, payload) in regs.items():
            if kind == "replicated":
                replication = replications.get(index_id)
                controller = getattr(replication, "controller", None)
                if controller is None:
                    return None  # no control plane: cannot mint a follower
                follower = controller.add_follower()
                eng.register_mutable(index_id, follower.index, **payload)
                # consumed: this path registered the new handle itself
                replication.take_handles_changed()
            else:
                algo, idx, kwargs = payload
                eng.register(index_id, algo, idx, **kwargs)
        for index_id, kwargs in slos.items():
            eng.set_slo(index_id, **kwargs)
        return eng

    def _scale_up(self) -> None:
        rid = self.n_replicas
        eng = self._provision_engine(rid)
        if eng is None:
            return
        # warm BEFORE the replica is routable: build each declared
        # (index, k) so the first real request never pays a kernel build
        for index_id, k in self._warm_k.items():
            try:
                eng.warmup(index_id, int(k), run=True)
            except Exception as e:
                obs.inc("replica.control.errors", kind=type(e).__name__)
        # publish the new follower's true lag before admission opens, so
        # the staleness floor keeps reads off it until it catches up
        lag = 0
        with self._lock:
            replications = list(self._replications.values())
        for replication in replications:
            n_f = len(replication.followers)
            if n_f:
                lag = max(lag, replication.staleness(n_f - 1))
        self.engines = self.engines + [eng]
        self.router.add_replica()
        self.router.set_staleness(rid, lag)
        self.n_replicas = len(self.engines)
        if self._threads:
            t = threading.Thread(
                target=self._pump_loop, args=(rid, self._pump_interval_s),
                name=f"{self.name}-pump{rid}", daemon=True,
            )
            self._threads.append(t)
            t.start()
        obs.inc("serve.autoscale", direction="up")
        obs.recorder.note_scale(self.name, "up", self.n_replicas)

    def _begin_drain(self) -> None:
        """Start retiring the highest replica: stop admitting onto it,
        keep pumping until its queue and flights empty (never replica 0
        — it serves every replication's leader)."""
        rid = self.n_replicas - 1
        if rid == 0:
            return
        self._draining_rid = rid
        self.router.set_draining(rid, True)

    def _drain_step(self) -> None:
        rid = self._draining_rid
        if rid is None:
            return
        with self._lock:
            busy = any(fl.replica == rid for fl in self._flights) or any(
                fl.replica == rid for fl in self._parked
            )
        if busy or self.engines[rid].queue_depth() > 0:
            return  # in-flight work still draining; decide again next tick
        self._retire(rid)

    def _retire(self, rid: int) -> None:
        eng = self.engines[rid]
        with self._lock:
            replications = list(self._replications.values())
        for replication in replications:
            controller = getattr(replication, "controller", None)
            if controller is not None and len(replication.followers) >= 2:
                controller.remove_follower()
                replication.take_handles_changed()  # handles only shrank
        # shrink the routable set first so the retiring pump thread
        # (which exits once rid >= n_replicas) can be joined
        self.n_replicas = rid
        if self._threads:
            t = self._threads.pop()
            t.join(timeout=5.0)
        self.engines = self.engines[:-1]
        self.router.remove_last()
        eng.shutdown(wait=True)
        self._draining_rid = None
        obs.inc("serve.autoscale", direction="down")
        obs.recorder.note_scale(self.name, "down", self.n_replicas)

    def health(self) -> Dict[str, object]:
        """Group health: per-replica breaker/queue/staleness plus the
        in-flight and parked counts. Each replica's full engine health
        snapshot rides under ``engine``; ``cluster`` is the aggregated
        one-line snapshot (worst breaker, max staleness, summed queue
        depth) dashboards and flight-recorder bundles consume."""
        with self._lock:
            in_flight = len(self._flights)
            parked = len(self._parked)
        states = self.router.states()
        replicas = []
        # snapshot the engine list and clip to the router's view so a
        # concurrent autoscale resize can't index past either side
        engines = list(self.engines)[: len(states)]
        for rid, eng in enumerate(engines):
            breaker = self.router.breaker(rid)
            replicas.append({
                "breaker": states[rid],
                "consecutive_failures": breaker.failures,
                "queue_rows": eng.queue_depth(),
                "staleness_records": self.router.staleness(rid),
                "draining": self.router.draining(rid),
                "engine": eng.health(),
            })
        severity = {"closed": 0, "half_open": 1, "open": 2}
        cluster = {
            "replicas": len(replicas),
            "worst_breaker": (
                max(states, key=lambda s: severity.get(s, 0))
                if states else "closed"
            ),
            "open_breakers": sum(1 for s in states if s == "open"),
            "max_staleness_records": max(
                (r["staleness_records"] for r in replicas), default=0
            ),
            "queue_rows": sum(r["queue_rows"] for r in replicas),
            "in_flight": in_flight,
            "parked": parked,
        }
        return {
            "name": self.name,
            "replicas": replicas,
            "cluster": cluster,
            "in_flight": in_flight,
            "parked": parked,
            "threaded": bool(self._threads),
        }

    def warmup(self, index_id: str, k: int, run: bool = True):
        """Build and run every bucket's program on every replica (deploy-time
        warmup)."""
        return [eng.warmup(index_id, k, run=run) for eng in self.engines]

    def set_slo(self, index_id: str, **kwargs):
        """Declare the same SLO on every replica; returns the trackers.
        Remembered, so an autoscaled replica gets the same objective."""
        with self._lock:
            self._slo_kwargs[index_id] = dict(kwargs)
        return [eng.set_slo(index_id, **kwargs) for eng in self.engines]

    def shutdown(self, wait: bool = True) -> None:
        self.stop()
        for eng in self.engines:
            eng.shutdown(wait=wait)

    # -- threaded pump mode ------------------------------------------------

    def start(self, interval_s: float = 0.0005) -> None:
        """Switch to one daemon pump thread per replica (true replica
        parallelism — what ``chip_smoke.py``'s replica phase measures).
        Thread 0 additionally retries parked failovers and drives
        maintenance. :meth:`step` returns 0 while threads run."""
        if self._threads:
            return
        self._stop.clear()
        self._pump_interval_s = float(interval_s)
        for rid in range(self.n_replicas):
            t = threading.Thread(
                target=self._pump_loop, args=(rid, float(interval_s)),
                name=f"{self.name}-pump{rid}", daemon=True,
            )
            self._threads.append(t)
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        """Stop pump threads and return to synchronous :meth:`step`."""
        if not self._threads:
            return
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    def _pump_loop(self, rid: int, interval_s: float) -> None:
        # the loop also exits when its replica is retired (autoscale
        # scale-down shrinks n_replicas, then joins this thread)
        while not self._stop.is_set() and rid < self.n_replicas:
            try:
                self._pump_replica(rid, force=True)
                if rid == 0:
                    self._retry_parked()
                    if self._maint_due():
                        self.maintenance_tick()
            except Exception as e:
                # a pump loop must never die silently: count and keep
                # pumping — the breaker machinery handles the failure
                obs.inc("replica.pump_failures", replica=str(rid),
                        kind=type(e).__name__)
            if interval_s > 0.0:
                time.sleep(interval_s)
