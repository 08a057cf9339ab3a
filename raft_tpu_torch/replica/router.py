"""Health-aware admission routing over a replica set
(``raft_tpu.replica.router`` counterpart).

The router is the per-request decision the :class:`~raft_tpu_torch.replica.
group.ReplicaGroup` delegates to: given the instantaneous queue depths
of N replicas, pick the one to admit a request on. Three filters, then
a tie-break:

* **breaker** — each replica carries a :class:`~raft_tpu_torch.robust.retry.
  CircuitBreaker` (the per-shard health probe generalized to a
  stateful per-replica machine: closed → open on consecutive dispatch
  failures/timeouts → half-open probe). Only CLOSED replicas take new
  admissions; OPEN/HALF_OPEN replicas are quarantined until their probe
  (driven by the group's pump, not by caller traffic) closes them.
* **staleness floor** — a follower replica lagging the leader by more
  than ``max_staleness_records`` WAL records is excluded, so the
  bounded-staleness read contract is enforced
  at admission, not discovered by the caller.
* **exclusion** — failover re-submission excludes the replica the
  request just failed on, closing the race window before the breaker
  has tripped.

Among the survivors, **least queue depth** wins (ties go to the lowest
replica id, which keeps routing deterministic under test). The router
holds no engine references — depths are passed in — so it is trivially
unit-testable and imposes no lock ordering on the serving path: its one
lock guards the staleness array only and is an edge-free leaf in
``raft_tpu_torch/utils/lock_order.toml``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Set

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.robust.retry import CircuitBreaker
from raft_tpu_torch.utils import lockcheck


@lockcheck.guarded_fields
class Router:
    """Least-queue-depth admission over breaker-healthy, fresh-enough
    replicas."""

    def __init__(
        self,
        n_replicas: int,
        *,
        failure_threshold: int = 3,
        reset_timeout_s: float = 0.25,
        max_staleness_records: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        expects(n_replicas >= 1, "need at least one replica, got %d", n_replicas)
        expects(
            max_staleness_records is None or max_staleness_records >= 0,
            "max_staleness_records must be >= 0 when set",
        )
        self.n_replicas = int(n_replicas)
        #: admission floor: a replica further behind the leader than
        #: this many WAL records takes no new requests (None = no floor)
        self.max_staleness_records = max_staleness_records
        self._failure_threshold = int(failure_threshold)
        self._reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._breakers = [
            self._mk_breaker(r) for r in range(self.n_replicas)
        ]
        # guards the staleness array and the draining set only; nothing
        # (locks, obs, faults, engines) is ever called while it is held
        # — an edge-free leaf
        self._lock = lockcheck.tracked(threading.Lock(), "replica.router")
        self._staleness = [0] * self.n_replicas
        self._draining: set = set()

    def _mk_breaker(self, r: int) -> CircuitBreaker:
        return CircuitBreaker(
            f"replica{r}",
            failure_threshold=self._failure_threshold,
            reset_timeout_s=self._reset_timeout_s,
            clock=self._clock,
        )

    # -- dynamic resize (autoscaler) ----------------------------------------

    def add_replica(self) -> int:
        """Grow by one replica (fresh breaker, zero staleness); returns
        its id. Lists are replaced whole so concurrent readers see
        either the old set or the new one, never a half-grown state."""
        rid = self.n_replicas
        self._breakers = self._breakers + [self._mk_breaker(rid)]
        with self._lock:
            self._staleness = self._staleness + [0]
        self.n_replicas = rid + 1
        return rid

    def remove_last(self) -> None:
        """Retire the highest-id replica (the group drained it first)."""
        expects(self.n_replicas >= 2, "cannot retire the last replica")
        rid = self.n_replicas - 1
        self.n_replicas = rid
        self._breakers = self._breakers[:-1]
        with self._lock:
            self._staleness = self._staleness[:-1]
            self._draining.discard(rid)

    def set_draining(self, replica: int, draining: bool = True) -> None:
        """Mark a replica draining: it finishes in-flight work but
        admits nothing new (the scale-down prelude)."""
        with self._lock:
            if draining:
                self._draining.add(int(replica))
            else:
                self._draining.discard(int(replica))

    def draining(self, replica: int) -> bool:
        with self._lock:
            return int(replica) in self._draining

    # -- health inputs -----------------------------------------------------

    def breaker(self, replica: int) -> CircuitBreaker:
        return self._breakers[replica]

    def set_staleness(self, replica: int, records: int) -> None:
        """Publish replica lag (WAL records behind the leader; the
        leader itself stays 0). Fed by the replication maintenance
        tick; an id beyond the current size (resize in flight) is
        dropped — the next tick republishes."""
        with self._lock:
            if replica < len(self._staleness):
                self._staleness[replica] = int(records)

    def staleness(self, replica: int) -> int:
        with self._lock:
            return self._staleness[replica] if replica < len(self._staleness) else 0

    # -- the routing decision ----------------------------------------------

    def admissible(self, replica: int) -> bool:
        """May NEW work be admitted on ``replica`` right now? (The
        half-open probe is the pump's business, not the caller's — see
        :meth:`~raft_tpu_torch.robust.retry.CircuitBreaker.allow`.)"""
        breakers = self._breakers
        if replica >= len(breakers):
            return False  # resize in flight: not admissible until grown
        if breakers[replica].state != CircuitBreaker.CLOSED:
            return False
        with self._lock:
            if replica in self._draining:
                return False
            lag = self._staleness[replica]
        if self.max_staleness_records is None:
            return True
        return lag <= self.max_staleness_records

    def pick(self, depths: Sequence[int], exclude: Set[int] = frozenset()) -> Optional[int]:
        """The replica to admit one request on: least ``depths`` entry
        among admissible replicas not in ``exclude`` (lowest id breaks
        ties); ``None`` when no replica qualifies. ``depths`` may
        briefly disagree with ``n_replicas`` while the autoscaler is
        resizing — only the common prefix is considered."""
        best: Optional[int] = None
        best_depth = 0
        for r in range(min(self.n_replicas, len(depths))):
            if r in exclude or not self.admissible(r):
                continue
            d = int(depths[r])
            if best is None or d < best_depth:
                best, best_depth = r, d
        return best

    def states(self) -> List[str]:
        """Per-replica breaker state, for ``health()`` snapshots."""
        return [b.state for b in self._breakers]
