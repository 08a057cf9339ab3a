"""Control plane: lease-based leader election, fencing, autoscaling.

The shipping pipeline (:mod:`raft_tpu_torch.replica.shipping`) answers *how*
bytes move; this module answers the three questions a production
deployment asks on top (``raft_tpu.replica.control`` counterpart):

* **who ingests** — a :class:`LeaseStore` holds one time-bounded lease
  with a monotonic **epoch counter**. The atomic primitive is
  filesystem CAS: a candidate writes the lease body to a private temp
  file (fsync'd), then ``os.link``\\ s it to ``lease-e{epoch}`` — link
  fails with ``FileExistsError`` when another candidate claimed that
  epoch first, so exactly one acquirer wins and the winning file is
  always complete (content precedes visibility, the repo's usual
  durable-then-visible discipline). Renewal rewrites the holder's own
  epoch file (temp + fsync + ``os.replace``); an *expired* lease is
  never renewable — a new regime requires a new epoch, which is what
  makes fencing sound.
* **what happens when the leader dies** — :class:`ControlPlane` binds
  one :class:`~raft_tpu_torch.replica.shipping.Replication` to one lease.
  Every tick it renews inside the renew window; once the lease has
  expired (a dead leader stops renewing — that *is* the failure
  detector) it elects: the live follower with the **highest shipped
  cursor** ``(generation, applied_records, segment, offset)`` promotes.
  Promotion rebuilds a directory-backed leader from the winner's
  ``live_rows()``, rebases every other slot as a fresh follower of the
  new leader, and **fences** them at the new epoch. The epoch rides
  every seal→ship→apply hop (``Shipper.epoch_source`` →
  ``Follower.apply(epoch=...)``), so a deposed leader that keeps
  shipping gets a typed :class:`~raft_tpu_torch.replica.shipping.FencedError`
  — never a corrupted follower.
* **how the fleet resizes** — :class:`Autoscaler` is the hysteresis
  state machine ``ReplicaGroup.maintenance_tick`` consults: SLO fast
  burn rate or queue depth above the up-thresholds for ``up_ticks``
  consecutive ticks grows the group (the group warms the new replica
  up *before* it takes traffic); both below the down-thresholds for
  ``down_ticks`` shrinks it (the group drains the retiring replica
  first). :meth:`Autoscaler.decide` only ever *advises* — acting
  (spawning engines, draining, registering) is the group's business,
  outside this module's lock.

Chaos seams: ``lease.acquire`` and ``lease.renew`` fire before any
store I/O, ``election.promote`` fires before the winning candidate's
CAS — a fault injected there models a coordinator dying mid-election
(the next tick simply re-runs it; the CAS makes double-promotion
impossible). Control-plane faults are **contained**: :meth:`ControlPlane.
tick` catches everything, counts it as ``replica.control.errors``, and
retries next tick — an election in progress is never a caller-visible
error.

Locking contract (``raft_tpu_torch/utils/lock_order.toml``):
``replica.lease`` guards only the store's last-observed-lease cache and
``replica.autoscaler`` only the hysteresis counters; both are edge-free
leaves — every fault seam, obs emission, and file operation runs with
the lock released. :class:`ControlPlane` itself takes no lock: it is
single-driver by contract (the maintenance tick — thread 0 in the
group's threaded mode, the stepping thread otherwise).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, List, Optional, Set

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.mutable.segments import MutableIndex
from raft_tpu_torch.obs import recorder
from raft_tpu_torch.replica.shipping import Follower, Replication
from raft_tpu_torch.robust import faults
from raft_tpu_torch.utils import lockcheck

_LEASE_PREFIX = "lease-e"


@dataclasses.dataclass(frozen=True)
class Lease:
    """One leadership grant: who holds it, under which fencing epoch,
    and until when (on the store's injectable clock)."""

    holder: str
    epoch: int
    expires_s: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(doc: dict) -> "Lease":
        return Lease(
            holder=str(doc["holder"]),
            epoch=int(doc["epoch"]),
            expires_s=float(doc["expires_s"]),
        )


@lockcheck.guarded_fields
class LeaseStore:
    """File-backed atomic-CAS lease with a monotonic epoch counter.

    One directory holds one lease history: ``lease-e{epoch:016d}``
    files, highest epoch current. :meth:`acquire` claims epoch
    ``current + 1`` via write-temp → fsync → ``os.link`` — the link is
    the CAS, so two racing candidates cannot both win an epoch and a
    visible lease file is always complete. :meth:`renew` extends the
    holder's own live lease in place (atomic ``os.replace``); an
    expired lease is *not* renewable — the holder must re-acquire,
    bumping the epoch, which is exactly what downstream fencing needs.

    ``clock`` is injectable (virtual-clock tests drive expiry
    deterministically). The ``replica.lease`` lock guards only the
    last-observed-lease cache; all file I/O and every chaos seam
    (``lease.acquire`` / ``lease.renew``) run with it released.
    """

    def __init__(
        self,
        directory: str,
        *,
        ttl_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        expects(ttl_s > 0.0, "lease ttl must be positive, got %r", ttl_s)
        self.directory = str(directory)
        self.ttl_s = float(ttl_s)
        self.clock = clock
        os.makedirs(self.directory, exist_ok=True)
        # guards _cached only (lock_order.toml [[guards]]); edge-free
        # leaf — nothing is called while it is held
        self._lock = lockcheck.tracked(threading.Lock(), "replica.lease")
        self._cached: Optional[Lease] = None

    # -- reading -----------------------------------------------------------

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{_LEASE_PREFIX}{epoch:016d}")

    def current(self) -> Optional[Lease]:
        """The highest-epoch lease on disk (live or expired), or None
        when nothing was ever granted."""
        best = -1
        for fname in os.listdir(self.directory):
            if fname.startswith(_LEASE_PREFIX):
                tail = fname[len(_LEASE_PREFIX):]
                if tail.isdigit():
                    best = max(best, int(tail))
        if best < 0:
            return None
        with open(self._path(best), "r", encoding="utf-8") as f:
            lease = Lease.from_dict(json.loads(f.read()))
        with self._lock:
            self._cached = lease
        return lease

    def cached(self) -> Optional[Lease]:
        """The last lease this store observed (no I/O)."""
        with self._lock:
            return self._cached

    def epoch(self) -> int:
        """The current fencing epoch (0 before any grant)."""
        cur = self.current()
        return cur.epoch if cur is not None else 0

    def expired(self, lease: Optional[Lease] = None, now: Optional[float] = None) -> bool:
        if lease is None:
            lease = self.current()
        if lease is None:
            return True
        now = self.clock() if now is None else now
        return now >= lease.expires_s

    # -- the CAS -----------------------------------------------------------

    def acquire(self, holder: str, *, now: Optional[float] = None) -> Optional[Lease]:
        """Claim the lease under a fresh epoch. Succeeds only when no
        *live* lease is held by someone else AND this candidate wins
        the epoch CAS; returns None otherwise (caller retries on a
        later tick). A holder re-acquiring its own expired lease also
        bumps the epoch — any acquisition is a new regime."""
        faults.fire("lease.acquire", holder=holder)
        now = self.clock() if now is None else now
        cur = self.current()
        if cur is not None and now < cur.expires_s and cur.holder != holder:
            return None  # someone else's live lease governs
        epoch = (cur.epoch if cur is not None else 0) + 1
        lease = Lease(holder=str(holder), epoch=epoch, expires_s=now + self.ttl_s)
        tmp = os.path.join(
            self.directory, f".acquire-{os.getpid()}-{threading.get_ident()}"
        )
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(lease.as_dict(), indent=2, sort_keys=True))
            f.flush()
            os.fsync(f.fileno())
        try:
            # the CAS: link fails iff another candidate claimed this
            # epoch first — and a visible lease file is always complete
            os.link(tmp, self._path(epoch))
        except FileExistsError:
            return None
        finally:
            os.unlink(tmp)
        with self._lock:
            self._cached = lease
        if obs.is_enabled():
            obs.inc("replica.lease.acquired", holder=str(holder))
        return lease

    def renew(self, holder: str, *, now: Optional[float] = None) -> Optional[Lease]:
        """Extend the holder's *live* lease to ``now + ttl``. Returns
        None when the holder was deposed (someone else holds a higher
        epoch) or the lease already expired — expiry demands a fresh
        :meth:`acquire` so the epoch advances."""
        faults.fire("lease.renew", holder=holder)
        now = self.clock() if now is None else now
        cur = self.current()
        if cur is None or cur.holder != holder or now >= cur.expires_s:
            return None
        lease = Lease(holder=cur.holder, epoch=cur.epoch, expires_s=now + self.ttl_s)
        path = self._path(cur.epoch)
        tmp = path + f".renew{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(lease.as_dict(), indent=2, sort_keys=True))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        with self._lock:
            self._cached = lease
        return lease

    def release(self, holder: str, *, now: Optional[float] = None) -> bool:
        """Voluntarily end the holder's live lease (expires it *now*),
        letting a successor acquire without waiting out the ttl.
        Returns False when the holder no longer governs."""
        now = self.clock() if now is None else now
        cur = self.current()
        if cur is None or cur.holder != holder or now >= cur.expires_s:
            return False
        ended = Lease(holder=cur.holder, epoch=cur.epoch, expires_s=now)
        path = self._path(cur.epoch)
        tmp = path + f".release{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(ended.as_dict(), indent=2, sort_keys=True))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        with self._lock:
            self._cached = ended
        return True


class ControlPlane:
    """Leader election + fencing coordinator for one replication.

    Construction claims the bootstrap lease for the current leader and
    points the pipeline's ``epoch_source`` at :attr:`epoch`, so every
    shipped chunk carries the live fencing token from the first tick.
    :meth:`tick` (driven by ``Replication.tick``, i.e. the group's
    maintenance cadence) then:

    1. renews the leader's lease once inside the renew window
       (``renew_fraction * ttl`` before expiry);
    2. does nothing while a live lease governs — including a lease held
       by a leader whose *transport* is dead (the partition case: ingest
       pauses, followers serve bounded-stale reads, and election waits
       for honest expiry);
    3. on expiry, elects: the live follower with the highest shipped
       cursor wins, acquires the next epoch by CAS, and promotes.

    Promotion = rebuild a directory-backed leader from the winner's
    ``live_rows()`` under ``root_dir``, rebase every other slot as a
    fresh follower of it, fence everyone at the new epoch, and hand the
    new handle set to the pipeline (``Replication.replace``) — the
    replica group re-registers its engines on the next maintenance
    tick. The deposed leader's serving slot rejoins as a follower, so
    the replica count is conserved.

    Every failure inside a tick (including injected ``lease.*`` /
    ``election.promote`` faults) is contained: counted as
    ``replica.control.errors{kind}`` and retried next tick.
    """

    def __init__(
        self,
        replication: Replication,
        lease_store: LeaseStore,
        *,
        root_dir: str,
        name: str = "control",
        renew_fraction: float = 0.5,
        clock: Optional[Callable[[], float]] = None,
    ):
        expects(0.0 < renew_fraction <= 1.0,
                "renew_fraction must be in (0, 1], got %r", renew_fraction)
        self.replication = replication
        self.lease = lease_store
        self.root_dir = str(root_dir)
        self.name = str(name)
        self.renew_fraction = float(renew_fraction)
        self._clock = clock if clock is not None else lease_store.clock
        os.makedirs(self.root_dir, exist_ok=True)
        self.leader_name = replication.leader.name
        self._dead: Set[str] = set()
        self.elections = 0
        self._spawned = 0
        # bootstrap: the standing leader claims epoch 1 so fencing is
        # armed from the first shipped chunk
        lease = lease_store.acquire(self.leader_name)
        if lease is not None:
            self.epoch = lease.epoch
        else:
            cur = lease_store.current()
            self.epoch = cur.epoch if cur is not None else 0
        if obs.is_enabled():
            obs.set_gauge("replica.leader_epoch", float(self.epoch),
                          group=self.name)
        replication.epoch_source = self.current_epoch
        replication.controller = self

    def current_epoch(self) -> int:
        """The fencing token shippers stamp chunks with right now."""
        return self.epoch

    # -- failure detector inputs -------------------------------------------

    def kill_leader(self) -> None:
        """Declare the current leader dead (test/drill API — the
        in-process stand-in for a crashed ingest node): its renewals
        stop, the pipeline parks, and the lease's honest expiry starts
        the election clock."""
        self._dead.add(self.leader_name)
        self.replication.active = False

    def leader_alive(self) -> bool:
        return self.leader_name not in self._dead

    # -- the tick ----------------------------------------------------------

    def tick(self) -> None:
        """One renew-or-elect pass; every failure is contained and
        retried next tick (an election in progress must never become a
        caller-visible serving error)."""
        try:
            self._tick()
        except Exception as e:
            obs.inc("replica.control.errors", kind=type(e).__name__)

    def _tick(self) -> None:
        now = self._clock()
        cur = self.lease.current()
        if (
            cur is not None
            and cur.holder == self.leader_name
            and self.leader_alive()
            and now < cur.expires_s
        ):
            if cur.expires_s - now <= self.renew_fraction * self.lease.ttl_s:
                renewed = self.lease.renew(self.leader_name, now=now)
                if renewed is not None:
                    self.epoch = renewed.epoch
            return
        if cur is not None and now < cur.expires_s:
            # a live lease governs — even one held by a leader we cannot
            # reach (partition): wait out the ttl, never depose early
            return
        self._elect("expiry" if cur is not None else "bootstrap", now)

    def _cursor(self, f: Follower):
        p = f.position
        return (p.generation, p.applied_records, p.segment, p.offset)

    def _elect(self, reason: str, now: float) -> None:
        candidates = [
            (self._cursor(f), j)
            for j, f in enumerate(self.replication.followers)
            if f.name not in self._dead
        ]
        if not candidates:
            return  # nobody left to promote; keep ticking
        _, j = max(candidates)
        winner = self.replication.followers[j]
        # the coordinator-dies-mid-election seam: fires BEFORE the CAS,
        # so a retried election re-runs the whole decision — the CAS
        # (not this code path) is what makes double-promotion impossible
        faults.fire("election.promote", follower=winner.name, reason=reason)
        lease = self.lease.acquire(winner.name, now=now)
        if lease is None:
            return  # lost the CAS (or a live lease appeared); retry later
        self._promote(j, lease.epoch)
        self.leader_name = winner.name
        self.epoch = lease.epoch
        self.elections += 1
        obs.inc("replica.elections", reason=reason)
        if obs.is_enabled():
            obs.set_gauge("replica.leader_epoch", float(lease.epoch),
                          group=self.name)
        recorder.note_election(self.name, lease.epoch, winner.name, reason)

    def _follower_for(self, leader: MutableIndex, directory: str, name: str) -> Follower:
        f = Follower(
            leader.directory, directory,
            algo=leader.algo, dim=leader.dim,
            index_params=leader.index_params,
            search_params=leader.search_params,
            metric=leader.metric, name=name,
            delta_mode=leader.delta_mode, res=leader.res,
        )
        f.fence(self.epoch)
        return f

    def _promote(self, j: int, epoch: int) -> None:
        """Winner ``j`` becomes the leader of a new directory-backed
        index seeded from its shipped state; every other slot (and the
        deposed leader's) rebases as a fresh follower, fenced at
        ``epoch``."""
        rep = self.replication
        winner = rep.followers[j]
        new_dir = os.path.join(self.root_dir, f"leader-e{epoch:06d}")
        leader = MutableIndex.open(
            new_dir, winner.algo, winner.dim,
            index_params=winner.index_params,
            search_params=winner.search_params,
            metric=winner.metric, name=winner.name,
            delta_mode=winner.delta_mode, res=winner.res,
        )
        ids, vecs = winner.index.live_rows()
        if len(ids):
            leader.upsert(ids, vecs)
        # seal the seed records so the rebased followers catch up on
        # the very next ship, whatever seal_bytes says
        if leader.wal is not None:
            leader.wal.seal()
        self.epoch = epoch  # fence the rebased followers at the new regime
        new_followers: List[Follower] = []
        for f in rep.followers:
            if f is winner:
                continue
            new_followers.append(self._follower_for(
                leader,
                os.path.join(self.root_dir, f"{f.name}-e{epoch:06d}"),
                f.name,
            ))
        # the deposed leader's serving slot rejoins as a follower, so
        # the group's replica count is conserved across the election
        new_followers.append(self._follower_for(
            leader,
            os.path.join(self.root_dir, f"rejoin-e{epoch:06d}"),
            f"{self.leader_name}-rejoined",
        ))
        rep.replace(leader, new_followers)

    # -- autoscaling hooks --------------------------------------------------

    def add_follower(self) -> Follower:
        """Grow the pipeline by one follower of the current leader
        (replica scale-up); the caller registers its in-memory index on
        the new serving engine."""
        self._spawned += 1
        f = self._follower_for(
            self.replication.leader,
            os.path.join(
                self.root_dir,
                f"scale-f{self._spawned:04d}-e{self.epoch:06d}",
            ),
            f"{self.name}-scale{self._spawned}",
        )
        self.replication.add_follower(f)
        return f

    def remove_follower(self) -> Follower:
        """Retire the last follower (replica scale-down, already
        drained by the group)."""
        return self.replication.remove_follower()


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The autoscaler's thresholds and hysteresis.

    Scale **up** when the SLO fast burn rate reaches ``burn_up`` or
    queued rows per replica reach ``queue_up_rows``, sustained for
    ``up_ticks`` consecutive decisions; scale **down** when burn is at
    most ``burn_down`` *and* rows per replica at most
    ``queue_down_rows`` for ``down_ticks``. ``cooldown_s`` spaces
    consecutive scale actions so one incident cannot thrash the fleet.
    """

    min_replicas: int = 1
    max_replicas: int = 4
    burn_up: float = 2.0
    queue_up_rows: int = 64
    burn_down: float = 0.5
    queue_down_rows: int = 4
    up_ticks: int = 2
    down_ticks: int = 4
    cooldown_s: float = 0.0


@lockcheck.guarded_fields
class Autoscaler:
    """Hysteresis state machine advising the replica group's size.

    :meth:`decide` is pure bookkeeping under the ``replica.autoscaler``
    lock (an edge-free leaf — no engine, obs, or fault call is ever
    made while it is held); acting on the advice — spawning, warming,
    draining, retiring — is the group's business, outside this lock.
    """

    def __init__(
        self,
        policy: AutoscalePolicy,
        *,
        clock: Callable[[], float] = time.monotonic,
    ):
        expects(policy.min_replicas >= 1, "min_replicas must be >= 1")
        expects(policy.max_replicas >= policy.min_replicas,
                "max_replicas must be >= min_replicas")
        self.policy = policy
        self._clock = clock
        # guards the hysteresis counters only (lock_order.toml
        # [[guards]]); edge-free leaf
        self._lock = lockcheck.tracked(threading.Lock(), "replica.autoscaler")
        self._over = 0
        self._under = 0
        self._last_scale_t = -float("inf")

    def decide(
        self,
        *,
        burn: float,
        queue_rows: int,
        n_replicas: int,
        now: Optional[float] = None,
    ) -> int:
        """One sizing decision: +1 (grow), -1 (shrink), or 0 (hold)."""
        p = self.policy
        now = self._clock() if now is None else now
        per_replica = float(queue_rows) / max(int(n_replicas), 1)
        hot = burn >= p.burn_up or per_replica >= p.queue_up_rows
        cold = burn <= p.burn_down and per_replica <= p.queue_down_rows
        with self._lock:
            self._over = self._over + 1 if hot else 0
            self._under = self._under + 1 if cold else 0
            if now - self._last_scale_t < p.cooldown_s:
                return 0
            if self._over >= p.up_ticks and n_replicas < p.max_replicas:
                self._over = 0
                self._under = 0
                self._last_scale_t = now
                return 1
            if self._under >= p.down_ticks and n_replicas > p.min_replicas:
                self._over = 0
                self._under = 0
                self._last_scale_t = now
                return -1
        return 0
