"""Retry with exponential backoff + seeded jitter, and a circuit breaker
(``raft_tpu.robust.retry`` counterpart).

Transient-failure policy for idempotent setup and maintenance work
(compaction retries its attempts through it). The schedule is fully
deterministic given ``(policy, seed)`` so tests can assert the exact
delay sequence — jitter comes from ``random.Random(seed)``, never from
wall-clock entropy, and equals the JAX package's for the same seed.

The query path never retries: a failed kernel raises.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import expects


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff policy: delay before attempt ``i+1`` is
    ``min(base_delay_s * multiplier**i, max_delay_s)`` scaled by a seeded
    jitter factor drawn uniformly from ``[1 - jitter_frac, 1 + jitter_frac]``."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 5.0
    jitter_frac: float = 0.1
    #: overall wall-clock budget; ``None`` means attempts-only
    deadline_s: Optional[float] = None
    retryable: Tuple[Type[BaseException], ...] = (Exception,)

    def schedule(self, seed: int = 0) -> Tuple[float, ...]:
        """The deterministic delay sequence (one entry per retry, i.e.
        ``max_attempts - 1`` entries) for ``seed``."""
        rng = random.Random(seed)
        out = []
        for i in range(max(self.max_attempts - 1, 0)):
            base = min(self.base_delay_s * self.multiplier ** i, self.max_delay_s)
            lo, hi = 1.0 - self.jitter_frac, 1.0 + self.jitter_frac
            out.append(base * rng.uniform(lo, hi))
        return tuple(out)


DEFAULT_POLICY = RetryPolicy()


class RetryError(RuntimeError):
    """All attempts exhausted (or deadline exceeded); ``__cause__`` is the
    last underlying failure."""

    def __init__(self, op: str, attempts: int, last: BaseException):
        super().__init__(f"{op}: gave up after {attempts} attempt(s): {last!r}")
        self.op = op
        self.attempts = attempts
        self.last = last


def retry_call(
    fn: Callable,
    *args,
    policy: RetryPolicy = DEFAULT_POLICY,
    op: str = "op",
    seed: int = 0,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying per ``policy``.

    Non-retryable exceptions propagate immediately. ``sleep``/``clock``
    are injectable for tests (virtual time). Outcomes are counted in
    ``obs``: ``retry.attempts_failed``, ``retry.recovered``,
    ``retry.gave_up`` — all labeled ``op=...``.
    """
    expects(policy.max_attempts >= 1, "max_attempts must be >= 1, got %d",
            policy.max_attempts)
    delays = policy.schedule(seed)
    start = clock()
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            result = fn(*args, **kwargs)
            if attempt > 0:
                obs.inc("retry.recovered", op=op)
            return result
        except policy.retryable as e:
            last = e
            obs.inc("retry.attempts_failed", op=op, error=type(e).__name__)
            if attempt == policy.max_attempts - 1:
                break
            delay = delays[attempt]
            if policy.deadline_s is not None and (
                clock() - start + delay > policy.deadline_s
            ):
                obs.inc("retry.deadline_exceeded", op=op)
                break
            sleep(delay)
    obs.inc("retry.gave_up", op=op)
    raise RetryError(op, policy.max_attempts, last) from last


#: gauge encoding of breaker states (robust.breaker.state{target})
_BREAKER_STATE_VALUES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed → open → half-open).

    A generic dispatch-health state machine (the JAX package's replica
    router runs one per replica): ``failure_threshold`` *consecutive*
    failures trip the
    breaker OPEN; after ``reset_timeout_s`` (on the injectable
    ``clock``) one caller's :meth:`allow` transitions it HALF_OPEN and
    admits exactly one probe; the probe's :meth:`record_success` closes
    the breaker, its :meth:`record_failure` re-opens it and re-arms the
    timer. Any success in CLOSED resets the consecutive-failure count.

    State is exported as the ``robust.breaker.state{target}`` gauge
    (0 = closed, 1 = half_open, 2 = open) and every transition bumps
    ``robust.breaker.transitions{target, to}``. The breaker is
    deliberately lock-free: it is owned by one pump/dispatch thread,
    with :meth:`allow` racing at worst one misrouted admission — which
    the failover path re-queues anyway.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        target: str,
        *,
        failure_threshold: int = 3,
        reset_timeout_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        expects(failure_threshold >= 1, "failure_threshold must be >= 1")
        expects(reset_timeout_s >= 0.0, "reset_timeout_s must be >= 0")
        self.target = str(target)
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._state = self.CLOSED
        self._failures = 0  # consecutive failures since the last success
        self._opened_at = 0.0
        self._emit_state()

    @property
    def state(self) -> str:
        return self._state

    @property
    def failures(self) -> int:
        """Consecutive failures since the last recorded success."""
        return self._failures

    def _emit_state(self) -> None:
        if obs.is_enabled():
            obs.set_gauge(
                "robust.breaker.state",
                _BREAKER_STATE_VALUES[self._state],
                target=self.target,
            )

    def _transition(self, to: str) -> None:
        if to == self._state:
            return
        self._state = to
        obs.inc("robust.breaker.transitions", target=self.target, to=to)
        self._emit_state()

    def allow(self) -> bool:
        """May a dispatch proceed against this target right now?

        CLOSED always admits. OPEN admits nothing until
        ``reset_timeout_s`` has elapsed, then flips HALF_OPEN and admits
        the calling dispatch as the probe. HALF_OPEN admits nothing
        further while the probe is outstanding.
        """
        if self._state == self.CLOSED:
            return True
        if self._state == self.OPEN:
            if self._clock() - self._opened_at >= self.reset_timeout_s:
                self._transition(self.HALF_OPEN)
                return True
            return False
        return False  # HALF_OPEN: the single probe is already out

    def record_success(self) -> None:
        """A dispatch (or the half-open probe) succeeded."""
        self._failures = 0
        if self._state != self.CLOSED:
            self._transition(self.CLOSED)

    def record_failure(self) -> None:
        """A dispatch failed (or timed out). Trips the breaker at
        ``failure_threshold`` consecutive failures; a half-open probe
        failure re-opens immediately and re-arms the reset timer."""
        self._failures += 1
        if self._state == self.HALF_OPEN or (
            self._state == self.CLOSED and self._failures >= self.failure_threshold
        ):
            self._opened_at = self._clock()
            self._transition(self.OPEN)
        elif self._state == self.OPEN:
            # repeated failures while open (e.g. a failed probe window)
            # keep pushing the retry horizon out
            self._opened_at = self._clock()


def retrying(policy: RetryPolicy = DEFAULT_POLICY, op: Optional[str] = None, seed: int = 0):
    """Decorator form of :func:`retry_call`."""

    def deco(fn):
        import functools

        name = op or getattr(fn, "__qualname__", getattr(fn, "__name__", "op"))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, policy=policy, op=name, seed=seed, **kwargs)

        return wrapper

    return deco
