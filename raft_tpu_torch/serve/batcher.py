"""Bounded request queue with dynamic micro-batching and deadlines
(``raft_tpu.serve.batcher`` counterpart).

Arrivals are held until ``max_batch`` query rows of one group are waiting
or the oldest request has waited ``max_wait_ms``, then one micro-batch
flushes. Overload is a typed rejection: a full queue raises
:class:`QueueFull` at submit; a deadline that is already unmeetable raises
:class:`DeadlineExceeded` at submit; a request that expires while queued
completes with :class:`DeadlineExceeded`. The batcher is synchronous and
clock-injectable; it starts no thread.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch.core.errors import RaftError, expects
from raft_tpu_torch.utils import lockcheck


class QueueFull(RaftError):
    """The serving queue is at capacity."""


class DeadlineExceeded(RaftError):
    """The request's deadline cannot be (or was not) met."""


class ServeFuture:
    """Minimal thread-safe future for one serving request."""

    __slots__ = ("_event", "_result", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, result) -> None:
        self._result = result
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError("serve future not completed")
        return self._exc

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serve future not completed")
        if self._exc is not None:
            raise self._exc
        return self._result


_req_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One enqueued search request."""

    queries: np.ndarray
    k: int
    group: Tuple  # requests batch together only within one group key
    t_arrival: float
    deadline_s: Optional[float] = None
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    future: ServeFuture = dataclasses.field(default_factory=ServeFuture)
    #: obs request trace ("" when the gate is off); t_submit_us is the
    #: registry clock stamp the synthetic ``serve.queue`` span starts at
    trace_id: str = ""
    t_submit_us: float = 0.0

    @property
    def n_rows(self) -> int:
        return int(self.queries.shape[0])

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now > self.deadline_s


@lockcheck.guarded_fields
class MicroBatcher:
    """Bounded FIFO of requests with flush-on-size / flush-on-age
    batching and deadline-aware admission. ``capacity`` bounds queued
    query rows."""

    def __init__(self, max_batch: int = 64, max_wait_ms: float = 2.0,
                 capacity: int = 1024, clock: Optional[Callable[[], float]] = None):
        expects(max_batch >= 1, "max_batch must be >= 1")
        expects(capacity >= max_batch, "capacity %d < max_batch %d", capacity, max_batch)
        expects(max_wait_ms >= 0.0, "max_wait_ms must be >= 0")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.capacity = int(capacity)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = lockcheck.tracked(threading.RLock(), "serve.batcher")
        self._queue: "deque[Request]" = deque()
        self._rows = 0
        self._ewma_service_s = 0.0

    def now(self) -> float:
        return self._clock()

    def depth_rows(self) -> int:
        with self._lock:
            return self._rows

    def depth_requests(self) -> int:
        with self._lock:
            return len(self._queue)

    def note_service_time(self, seconds: float, alpha: float = 0.25) -> None:
        """Feed one observed batch service time into the admission EWMA."""
        with self._lock:
            if self._ewma_service_s == 0.0:
                self._ewma_service_s = float(seconds)
            else:
                self._ewma_service_s += alpha * (float(seconds) - self._ewma_service_s)

    def estimated_wait_s(self) -> float:
        with self._lock:
            if self._ewma_service_s == 0.0:
                return 0.0
            return (1 + self._rows // self.max_batch) * self._ewma_service_s

    def offer(self, req: Request) -> None:
        """Admit ``req`` or raise :class:`QueueFull` /
        :class:`DeadlineExceeded`."""
        now = self.now()
        if req.expired(now):
            raise DeadlineExceeded(
                f"request {req.req_id} dead on arrival "
                f"(deadline {req.deadline_s:.4f} < now {now:.4f})"
            )
        if req.deadline_s is not None:
            est = self.estimated_wait_s()
            if est > 0.0 and now + est > req.deadline_s:
                raise DeadlineExceeded(
                    f"request {req.req_id} unmeetable: estimated queue wait "
                    f"{est * 1e3:.2f} ms overruns the deadline"
                )
        with self._lock:
            if self._rows + req.n_rows > self.capacity:
                raise QueueFull(
                    f"serving queue at capacity ({self._rows}/{self.capacity} "
                    f"query rows); request {req.req_id} rejected"
                )
            self._queue.append(req)
            self._rows += req.n_rows

    def ready(self, now: Optional[float] = None) -> bool:
        """True when a micro-batch should flush."""
        if now is None:
            now = self.now()
        with self._lock:
            if not self._queue:
                return False
            oldest = self._queue[0]
            if now - oldest.t_arrival >= self.max_wait_s or oldest.expired(now):
                return True
            rows_by_group: Dict[Tuple, int] = {}
            for r in self._queue:
                rows_by_group[r.group] = rows_by_group.get(r.group, 0) + r.n_rows
                if rows_by_group[r.group] >= self.max_batch:
                    return True
            return False

    def _drop_expired(self, now: float) -> List[Request]:
        expired = [r for r in self._queue if r.expired(now)]
        if expired:
            self._queue = deque(r for r in self._queue if not r.expired(now))
            self._rows -= sum(r.n_rows for r in expired)
        return expired

    def next_batch(self, now: Optional[float] = None) -> Tuple[List[Request], List[Request]]:
        """Form the next micro-batch: ``(batch, expired)``. ``batch`` is the
        oldest-first run of same-group requests totalling at most
        ``max_batch`` rows; ``expired`` requests were failed with
        :class:`DeadlineExceeded`."""
        if now is None:
            now = self.now()
        batch: List[Request] = []
        with self._lock:
            expired = self._drop_expired(now)
            if self._queue:
                group = self._queue[0].group
                rows = 0
                keep: "deque[Request]" = deque()
                for r in self._queue:
                    if r.group == group and rows + r.n_rows <= self.max_batch:
                        batch.append(r)
                        rows += r.n_rows
                    else:
                        keep.append(r)
                self._queue = keep
                self._rows -= rows
        for r in expired:
            r.future.set_exception(
                DeadlineExceeded(
                    f"request {r.req_id} expired in queue "
                    f"(waited {(now - r.t_arrival) * 1e3:.2f} ms)"
                )
            )
        return batch, expired

    def drain_requests(self) -> List[Request]:
        """Remove and return every queued request without completing its
        future. Replica failover (:mod:`raft_tpu_torch.replica`) evacuates
        a dead replica's queue with it: the requests are submitted again on
        a healthy engine and their group-level futures complete there; the
        engine-level futures drained here are abandoned."""
        with self._lock:
            out = list(self._queue)
            self._queue = deque()
            self._rows = 0
        return out

    def drain_expired(self, now: Optional[float] = None) -> List[Request]:
        """Reject only the expired requests, without forming a batch: each
        one's future fails with :class:`DeadlineExceeded`."""
        if now is None:
            now = self.now()
        with self._lock:
            expired = self._drop_expired(now)
        for r in expired:
            r.future.set_exception(
                DeadlineExceeded(
                    f"request {r.req_id} expired in queue "
                    f"(waited {(now - r.t_arrival) * 1e3:.2f} ms)"
                )
            )
        return expired
