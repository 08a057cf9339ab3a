"""Service-level objectives: sliding error budgets and multi-window
burn-rate alerting for the serving path (``raft_tpu.obs.slo``
counterpart).

The model is the SRE-workbook one. An :class:`SLO` declares, per
registered index, a latency objective ("``target`` of requests complete
within ``latency_ms``") and/or an availability objective (a request that
errors or is shed counts against the same budget). The error budget over
``window_s`` is the ``1 - target`` fraction of requests allowed to miss;
the **burn rate** over a window is::

    burn = bad_fraction(window) / (1 - target)

so burn 1.0 spends the budget exactly at sustainable pace and burn 14
exhausts a 30-day budget in ~2 days. Alerting is **multi-window**: the
alert fires only when both the fast and the slow window burn above
``burn_threshold`` (the fast window gives responsiveness, the slow
window rejects blips), and clears as soon as the fast window recovers —
the standard shape that pages quickly on real incidents without flapping
on a single slow batch.

Trackers are clock-injectable (the serving tests drive them with the
same virtual clock as :class:`raft_tpu_torch.serve.batcher.MicroBatcher`) and
feed the shared obs registry: ``slo.burn_rate{index_id,window}``,
``slo.budget_remaining{index_id}``, ``slo.requests{index_id,outcome}``
and ``slo.alerts{index_id,transition}``. ``ServingEngine.health()``
surfaces :meth:`SloTracker.evaluate` snapshots per index.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.obs import metrics, recorder
from raft_tpu_torch.utils import lockcheck

#: hard cap on retained window events per tracker (memory backstop; the
#: window itself is time-pruned on every record)
_MAX_EVENTS = 262_144


@dataclasses.dataclass(frozen=True)
class SLO:
    """Declared objective for one serving index."""

    index_id: str
    #: per-request latency threshold; ``None`` = availability-only SLO
    latency_ms: Optional[float] = None
    #: fraction of requests that must be good (0 < target < 1)
    target: float = 0.999
    #: error-budget accounting window (seconds)
    window_s: float = 3600.0
    #: fast burn-rate window — responsiveness
    fast_window_s: float = 60.0
    #: slow burn-rate window — blip rejection
    slow_window_s: float = 300.0
    #: both windows must burn at >= this multiple of budget rate to fire
    burn_threshold: float = 10.0

    def __post_init__(self):
        expects(0.0 < self.target < 1.0, "SLO target must be in (0, 1), got %r",
                self.target)
        expects(self.latency_ms is None or self.latency_ms > 0.0,
                "SLO latency_ms must be positive, got %r", self.latency_ms)
        expects(0.0 < self.fast_window_s <= self.slow_window_s <= self.window_s,
                "SLO windows must satisfy fast <= slow <= budget (got %r/%r/%r)",
                self.fast_window_s, self.slow_window_s, self.window_s)
        expects(self.burn_threshold > 0.0,
                "SLO burn_threshold must be positive, got %r",
                self.burn_threshold)


@dataclasses.dataclass(frozen=True)
class SloStatus:
    """One :meth:`SloTracker.evaluate` snapshot."""

    index_id: str
    target: float
    latency_ms: Optional[float]
    requests: int          # events inside window_s
    bad: int               # budget-consuming events inside window_s
    bad_fraction: float
    budget_remaining: float  # 1.0 = untouched, 0.0 = spent, <0 = overspent
    burn_fast: float
    burn_slow: float
    burn_threshold: float
    alerting: bool
    alerts_fired: int
    alerts_cleared: int

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@lockcheck.guarded_fields
class SloTracker:
    """Sliding-window good/bad accounting + burn-rate alert state for
    one :class:`SLO`. Thread-safe; metric emission happens outside the
    tracker lock (see ``lock_order.toml``: ``obs.slo`` is edge-free)."""

    def __init__(self, slo: SLO, clock: Callable[[], float] = time.monotonic):
        self.slo = slo
        self._clock = clock
        self._lock = lockcheck.tracked(threading.RLock(), "obs.slo")
        # (t, bad) sliding window: time-pruned each record; maxlen is the
        # memory backstop under pathological rates — dropping the OLDEST
        # event is the window semantics anyway, just earlier
        self._events: Deque[Tuple[float, bool]] = deque(maxlen=_MAX_EVENTS)
        self._alerting = False
        self._fired = 0
        self._cleared = 0

    # -- recording --------------------------------------------------------

    def record(self, latency_ms: Optional[float] = None, ok: bool = True) -> None:
        """Account one request: ``ok=False`` (error/shed) always consumes
        budget; with a latency objective, a latency above the threshold
        consumes budget too. Re-evaluates alert state so transitions are
        observed at record time, not only when ``health()`` is polled."""
        bad = (not ok) or (
            self.slo.latency_ms is not None
            and latency_ms is not None
            and latency_ms > self.slo.latency_ms
        )
        now = self._clock()
        with self._lock:
            self._events.append((now, bad))
            self._prune(now)
        metrics.inc("slo.requests", index_id=self.slo.index_id,
                    outcome="bad" if bad else "good")
        self.evaluate()

    def _prune(self, now: float) -> None:
        horizon = now - self.slo.window_s
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    def _burn(self, now: float, window_s: float) -> float:
        horizon = now - window_s
        n = bad = 0
        for t, b in reversed(self._events):
            if t < horizon:
                break
            n += 1
            bad += b
        if n == 0:
            return 0.0
        return (bad / n) / (1.0 - self.slo.target)

    # -- evaluation -------------------------------------------------------

    def evaluate(self) -> SloStatus:
        """Prune, compute burn rates, update alert state, emit gauges.

        Fire: both windows burning >= threshold. Clear: fast window back
        under threshold (slow may lag — that is the point)."""
        now = self._clock()
        slo = self.slo
        with self._lock:
            self._prune(now)
            n = len(self._events)
            bad = sum(1 for _, b in self._events if b)
            burn_fast = self._burn(now, slo.fast_window_s)
            burn_slow = self._burn(now, slo.slow_window_s)
            transition = None
            if not self._alerting and (
                burn_fast >= slo.burn_threshold and burn_slow >= slo.burn_threshold
            ):
                self._alerting = True
                self._fired += 1
                transition = "fire"
            elif self._alerting and burn_fast < slo.burn_threshold:
                self._alerting = False
                self._cleared += 1
                transition = "clear"
            status = SloStatus(
                index_id=slo.index_id,
                target=slo.target,
                latency_ms=slo.latency_ms,
                requests=n,
                bad=bad,
                bad_fraction=(bad / n) if n else 0.0,
                budget_remaining=(
                    1.0 - ((bad / n) / (1.0 - slo.target)) if n else 1.0
                ),
                burn_fast=burn_fast,
                burn_slow=burn_slow,
                burn_threshold=slo.burn_threshold,
                alerting=self._alerting,
                alerts_fired=self._fired,
                alerts_cleared=self._cleared,
            )
        # emit OUTSIDE the tracker lock: obs.slo must stay edge-free
        if metrics.is_enabled():
            metrics.set_gauge("slo.burn_rate", burn_fast,
                              index_id=slo.index_id, window="fast")
            metrics.set_gauge("slo.burn_rate", burn_slow,
                              index_id=slo.index_id, window="slow")
            metrics.set_gauge("slo.budget_remaining", status.budget_remaining,
                              index_id=slo.index_id)
            if transition is not None:
                metrics.inc("slo.alerts", index_id=slo.index_id,
                            transition=transition)
                # flight-recorder trigger: rides the same outside-lock
                # emission point, so obs.recorder (like obs.registry
                # here) is never acquired under obs.slo
                recorder.note_slo_transition(
                    slo.index_id, transition, burn_fast, burn_slow
                )
        return status
