"""Background maintenance: serve through rebuilds, never under them
(``raft_tpu.mutable.maintenance`` counterpart).

Foreground :func:`raft_tpu_torch.mutable.compact.compact` holds the index
lock for the whole rebuild — correct, but a writer or fresh snapshot
queued behind it eats the entire build time. This module is the serving
mode: :func:`compact_background` rebuilds against a **pinned snapshot**
while writers and searchers proceed under the existing lock, and
re-enters the lock only twice, briefly:

1. **Pin** (lock held, microseconds): fire ``compact.pin``, copy the
   live rows, record the WAL high-water mark
   (:meth:`~raft_tpu_torch.mutable.wal.WriteAheadLog.position`), and arm
   the in-memory mutation capture. From here on, every
   insert/delete/upsert lands in the *old* generation's WAL (durable)
   and the live delta as usual — nothing blocks.
2. **Rebuild** (no lock, the long part): build the new main segment
   over the pinned rows and write the new generation's artifacts
   through the atomic writers. On a CUDA index the rebuild runs on its
   own ``torch.cuda.Stream`` with the thread's current device set, so
   serving never queues behind it on the default stream; an event
   recorded at its end is waited for before the flip, so the new main
   index is finished before anything can search it, and its tensors are
   marked as used on the serving stream.
3. **Catch-up + flip** (lock held, proportional to the *backlog*, not
   the corpus): fire ``compact.replay``, read every record that landed
   after the pin — from the WAL for a durable index (the disk is the
   source of truth), from the capture list for ``directory=None`` —
   append them to the **new** generation's WAL (fsync'd, so they are
   durable in the new world *before* it becomes visible), fire
   ``compact.flip``, swap the manifest, switch the in-memory segments
   to the rebuilt main, and re-apply the backlog to the fresh delta.

Crash matrix: a kill at ``compact.pin``, during the rebuild, at
``compact.replay``, at ``compact.flip``, or at the inner
``manifest.swap`` leaves the old manifest live — cold recovery replays
the old WAL, which contains every mid-rebuild mutation, so the index
recovers the exact pre-compaction state *including* those mutations.
Only after the rename lands is the new generation visible, and it is
complete by construction: pinned rows + replayed backlog. A retried
attempt reclaims the same generation number (stale catch-up WAL
segments from the dead attempt are cleared before the path goes live).

:class:`Compactor` runs this on a dedicated worker thread with the
seeded backoff of :mod:`raft_tpu_torch.robust.retry`; the
``compact.worker`` seam injects worker-thread death, and
:meth:`Compactor.tick` is the watchdog that restarts a dead worker
without losing the pending request. :class:`CompactionPolicy` turns the
existing counters (WAL bytes, delta rows, tombstone fraction) into
auto-compaction triggers; ``ServingEngine`` calls :meth:`Compactor.tick`
from its step loop so a churning index compacts itself without an
operator call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Callable, Optional

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.mutable import segments as seg
# NB: import names, not the module — the package __init__ rebinds the
# ``compact`` attribute to the function, shadowing the submodule
from raft_tpu_torch.mutable.compact import (
    COMPACT_RETRY_POLICY,
    _cleanup_old_generation,
    _clear_stale_wal,
    _note_compaction,
    _publish,
    _switch_memory,
    _write_generation,
)
from raft_tpu_torch.mutable.wal import WriteAheadLog
from raft_tpu_torch.robust import faults
from raft_tpu_torch.robust.retry import RetryError, RetryPolicy, retry_call
from raft_tpu_torch.utils import lockcheck


@contextlib.contextmanager
def rebuild_stream(device):
    """Run the block on a side stream of a CUDA ``device``, with the
    calling thread's current device set to it, and wait for the stream's
    work to finish on exit (a recorded event, waited for on the host).
    On any other device the block runs as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        yield None
        return
    stream = torch.cuda.Stream(device=device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield stream
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()


def adopt_on_stream(index, device) -> None:
    """Mark every tensor field of a built ``index`` as used on ``device``'s
    default stream (the serving stream), so the caching allocator does not
    hand its memory to the side stream that made it while serving work
    on it may still be queued."""
    device = torch.device(device)
    if index is None or device.type != "cuda":
        return
    stream = torch.cuda.default_stream(device)
    for f in dataclasses.fields(index):
        t = getattr(index, f.name)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(stream)


def compact_background(
    mut: "seg.MutableIndex",
    res=None,
    _mid_rebuild: Optional[Callable[[], None]] = None,
) -> int:
    """One pin → rebuild-off-lock → catch-up+flip compaction of ``mut``
    on the calling thread. Returns the new generation number.

    ``_mid_rebuild`` is a test seam: a callable invoked after the new
    generation's artifacts are written but before the catch-up replay,
    i.e. the deterministic stand-in for "mutations arrive while the
    rebuild runs" that the chaos matrix and the bit-for-bit freshness
    gate drive. Production callers leave it ``None``.
    """
    t0 = time.perf_counter()
    with mut._compact_mutex:
        # -- phase 1: pin (brief lock) ---------------------------------
        with mut._lock:
            faults.fire("compact.pin", generation=mut.generation + 1)
            old_gen = mut.generation
            new_gen = old_gen + 1
            ids, vecs = mut.live_rows()
            old_wal_path = mut.wal.path if mut.wal is not None else None
            wal_pos = mut.wal.position() if mut.wal is not None else None
            mut._capture = []
        try:
            # -- phase 2: rebuild, no lock held ------------------------
            # writers and searchers proceed; their mutations go to the
            # old WAL (durable) and the live delta, and pile up behind
            # the pin for the catch-up below
            faults.fire("compact.merge", generation=new_gen, rows=len(ids))
            # only _compact_mutex is held here (it serializes whole
            # compactions by design); writers/searchers contend on
            # _lock, which is free. The rebuild's device work runs on
            # its own stream and is finished when the block exits.
            build_res = res if res is not None else mut.res
            rows_rel = main_rel = None
            with rebuild_stream(build_res.device):
                index = (
                    seg._build_main(mut.algo, vecs, mut.index_params, mut.metric,
                                    res=build_res)
                    if len(ids)
                    else None
                )
                if mut.directory is not None:
                    rows_rel, main_rel = _write_generation(
                        mut, new_gen, ids, vecs, index
                    )
            adopt_on_stream(index, build_res.device)
            if _mid_rebuild is not None:
                _mid_rebuild()
            # -- phase 3: catch-up + flip (brief lock) -----------------
            with mut._lock:
                faults.fire("compact.replay", generation=new_gen)
                if mut.wal is not None:
                    # durable source of truth: exactly the frames that
                    # landed on disk after the pin
                    records = mut.wal.read_from(wal_pos)
                else:
                    records = list(mut._capture)
                # replay must not re-capture itself
                mut._capture = None
                new_wal = None
                if mut.directory is not None:
                    new_wal_path = os.path.join(
                        mut.directory, seg._wal_name(new_gen)
                    )
                    _clear_stale_wal(new_wal_path)
                    new_wal, _ = WriteAheadLog.open(
                        new_wal_path, max_bytes=mut.max_wal_bytes
                    )
                    for rec in records:
                        # durable in the new world before it is visible:
                        # a crash past the flip recovers these from the
                        # new WAL, a crash before it from the old one
                        new_wal.append(rec)
                faults.fire("compact.flip", generation=new_gen)
                if mut.directory is not None:
                    _publish(mut, new_gen, rows_rel, main_rel)
                pending_cleanup = _switch_memory(
                    mut, new_gen, ids, vecs, index, res=res,
                    old_wal_path=old_wal_path, new_wal=new_wal,
                )
                replayed = 0
                for rec in records:
                    mut._apply(rec)
                    replayed += len(rec.ids)
                mut._snap = None
                if obs.is_enabled():
                    obs.observe(
                        "mutable.compact.replayed_rows", float(replayed),
                        index=mut.name,
                    )
                _note_compaction(mut, "background", len(ids), t0)
            # the old generation is unreferenced once the flip landed;
            # delete it outside _lock so no writer queues behind rmtree
            if pending_cleanup is not None:
                _cleanup_old_generation(*pending_cleanup)
            return new_gen
        finally:
            # on success phase 3 already cleared it; on any failure the
            # index must stop capturing (and drop the backlog copy) —
            # under _lock, or a writer mid-append could capture into the
            # list an instant after this clears it
            with mut._lock:
                mut._capture = None


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Auto-compaction triggers over the counters a
    :class:`~raft_tpu_torch.mutable.segments.MutableIndex` already maintains.
    A threshold of ``None`` disables that trigger; the first one that
    trips names the reason. ``min_interval_s`` rate-limits back-to-back
    compactions regardless of triggers."""

    #: total on-disk WAL bytes (all segments) before a compaction
    wal_bytes: Optional[int] = None
    #: live delta-segment rows before a compaction
    delta_rows: Optional[int] = None
    #: dead/total fraction across both segments before a compaction
    tombstone_fraction: Optional[float] = None
    #: floor between *completed* compactions
    min_interval_s: float = 0.0

    def reason(self, mut: "seg.MutableIndex") -> Optional[str]:
        """The name of the first tripped trigger, or ``None``."""
        if self.delta_rows is not None and mut.delta_rows >= self.delta_rows:
            return "delta_rows"
        if (
            self.tombstone_fraction is not None
            and mut.tombstone_fraction >= self.tombstone_fraction
            and mut.tombstone_fraction > 0.0
        ):
            return "tombstone_fraction"
        if (
            self.wal_bytes is not None
            and mut.wal is not None
            and mut.wal.total_bytes() >= self.wal_bytes
        ):
            return "wal_bytes"
        return None


@lockcheck.guarded_fields
class Compactor:
    """Background compaction worker for one mutable index.

    A dedicated daemon thread waits for requests (explicit
    :meth:`request` or :class:`CompactionPolicy` triggers observed by
    :meth:`tick`) and runs :func:`compact_background` through the
    seeded retry machinery. The worker beats the
    ``mutable.maintenance.heartbeat`` gauge every loop; :meth:`tick` is
    also the watchdog — a worker killed mid-flight (the
    ``compact.worker`` chaos seam) is restarted with its request
    re-armed, so an injected thread death delays a compaction but never
    loses it.

    >>> comp = Compactor(mut, policy=CompactionPolicy(delta_rows=32_768))
    >>> comp.start()
    >>> ...                    # serve; call comp.tick() periodically
    >>> comp.stop()
    """

    def __init__(
        self,
        mut: "seg.MutableIndex",
        *,
        policy: Optional[CompactionPolicy] = None,
        retry_policy: Optional[RetryPolicy] = None,
        res=None,
        seed: int = 0,
        name: Optional[str] = None,
        poll_interval_s: float = 0.05,
        clock: Callable[[], float] = time.monotonic,
    ):
        expects(poll_interval_s > 0, "poll_interval_s must be positive")
        self.mut = mut
        self.policy = policy
        self.name = name or mut.name
        self._retry_policy = (
            retry_policy if retry_policy is not None
            else COMPACT_RETRY_POLICY
        )
        self._res = res
        self._seed = int(seed)
        self._poll_interval_s = float(poll_interval_s)
        self._clock = clock
        # leaf lock (utils/lock_order.toml: "compactor.state"): guards only
        # the pending/busy/thread flags, never held across — nor taken
        # under — the index locks; the lockcheck witness enforces that
        self._state_lock = lockcheck.tracked(
            threading.Lock(), "compactor.state"
        )
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pending = False
        self._busy = False
        self._beats = 0
        #: completed / failed-after-retries compaction runs
        self.completed = 0
        self.failed = 0
        self.worker_restarts = 0
        #: the last run's terminal error (None after a success)
        self.last_error: Optional[BaseException] = None
        self._last_done_t: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Start (or no-op if already running) the worker thread."""
        with self._state_lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"compactor-{self.name}", daemon=True
            )
            self._thread.start()

    def stop(self, wait: bool = True, timeout_s: float = 5.0) -> None:
        """Signal the worker to exit; with ``wait`` join it. A rebuild
        in flight completes (or fails) first — stop never tears a
        compaction."""
        self._stop.set()
        self._wake.set()
        t = self._thread
        if wait and t is not None and t.is_alive():
            t.join(timeout=timeout_s)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- requests ----------------------------------------------------------

    def request(self, reason: str = "manual") -> bool:
        """Ask for one compaction (coalesced: a request while one is
        pending is a no-op). Returns True when newly armed."""
        with self._state_lock:
            if self._pending:
                return False
            self._pending = True
        obs.inc("mutable.compact.requested", index=self.name, reason=reason)
        self._wake.set()
        return True

    def busy(self) -> bool:
        """True while a request is pending or a rebuild is in flight."""
        with self._state_lock:
            return self._pending or self._busy

    def backlog(self) -> int:
        """Pending requests + in-flight rebuilds (0..2)."""
        with self._state_lock:
            return int(self._pending) + int(self._busy)

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Block (polling, ticking the watchdog) until no work is
        pending or in flight; True on idle, False on timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.tick()
            if not self.busy():
                return True
            time.sleep(0.002)
        return False

    # -- the maintenance tick (watchdog + policy) --------------------------

    def tick(self) -> Optional[str]:
        """One maintenance heartbeat, called from the serving loop:
        restart a dead worker (re-arming its interrupted request),
        evaluate the auto-compaction policy, and publish the backlog
        gauge. Returns the policy trigger that fired, if any."""
        restart = False
        with self._state_lock:
            t = self._thread
            if t is not None and not t.is_alive() and not self._stop.is_set():
                # the worker died mid-flight (chaos injection or a bug
                # past the retry net): don't lose the request it held
                if self._busy:
                    self._busy = False
                    self._pending = True
                self._thread = None
                restart = True
        if restart:
            with self._state_lock:
                self.worker_restarts += 1
            obs.inc("mutable.maintenance.worker_restarts", index=self.name)
            # flight-recorder trigger: rides the same outside-lock spot
            # as the restart counter
            obs.recorder.note_worker_death(self.name)
            self.start()
        reason = None
        if self.policy is not None and not self.busy() and not self._stop.is_set():
            with self._state_lock:
                last_done = self._last_done_t
            interval_ok = (
                last_done is None
                or self.policy.min_interval_s <= 0
                or self._clock() - last_done >= self.policy.min_interval_s
            )
            if interval_ok:
                reason = self.policy.reason(self.mut)
                if reason is not None:
                    self.request(reason=reason)
        obs.set_gauge("mutable.compact.backlog", float(self.backlog()), index=self.name)
        return reason

    # -- the worker --------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._state_lock:
                self._beats += 1
                beats = self._beats
            obs.set_gauge(
                "mutable.maintenance.heartbeat", float(beats), index=self.name
            )
            self._wake.wait(self._poll_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                break
            with self._state_lock:
                pending = self._pending
                if pending:
                    self._pending = False
                    self._busy = True
            if not pending:
                continue
            # chaos seam: a raise here escapes the loop and kills the
            # worker thread while it owns the request — tick()'s
            # watchdog must restart it and re-arm the request
            faults.fire("compact.worker", index=self.name)
            try:
                self._run_one()
            finally:
                with self._state_lock:
                    self._busy = False

    def _run_one(self) -> None:
        attempts = {"n": 0}

        def _attempt():
            attempts["n"] += 1
            if attempts["n"] > 1:
                obs.inc("mutable.compact.retries", index=self.name, mode="background")
            return compact_background(self.mut, res=self._res)

        with self._state_lock:
            seed = self._seed + self.completed + self.failed
        try:
            retry_call(
                _attempt,
                policy=self._retry_policy,
                op="mutable.compact.background",
                seed=seed,
            )
            with self._state_lock:
                self.completed += 1
                self.last_error = None
                self._last_done_t = self._clock()
        except RetryError as e:
            with self._state_lock:
                self.failed += 1
                self.last_error = e.last
                self._last_done_t = self._clock()
            obs.inc(
                "mutable.compact.failed", index=self.name,
                error=type(e.last).__name__,
            )


__all__ = ["CompactionPolicy", "Compactor", "adopt_on_stream", "compact_background",
           "rebuild_stream"]
