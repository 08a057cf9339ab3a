"""Bounded ring-buffer time series over the metrics registry
(``raft_tpu.obs.timeseries`` counterpart).

Everything in :mod:`raft_tpu_torch.obs.metrics` is a point-in-time snapshot:
when an SLO alert fires or a breaker trips, the history that explains
*why* — the burn-rate trajectory, the queue-depth trend, the latency
drift — is already gone. This module retains it, bounded:

* :class:`TimeSeries` / :class:`HistogramSeries` — fixed-capacity rings
  of ``(t, value)`` / ``(t, bucket counts, sum, count)`` samples with
  windowed queries (``rate()``, ``mean()``, ``percentile()``,
  ``delta()``). Capacity bounds memory; the clock is injectable so the
  serving tests drive them with the same virtual clock as the batcher.
* :class:`SeriesBank` — auto-discovers registry instruments matching a
  name-prefix allowlist on every :meth:`SeriesBank.sample` tick (one
  consistent :meth:`~raft_tpu_torch.obs.metrics.Registry.sample` snapshot per
  tick) and appends to the matching series.
* :class:`EwmaDetector` — EWMA-baseline drift detection over the bank.
  :func:`default_detectors` wires the four serving signals: latency
  drift, QPS cliff, coverage drop, burn-rate slope. Detected anomalies
  are returned as :class:`Anomaly` records; the flight recorder
  (:mod:`raft_tpu_torch.obs.recorder`) turns them into ``obs.anomaly
  {signal,index_id}`` events.

Gate discipline mirrors the registry: :meth:`SeriesBank.sample` checks
:func:`raft_tpu_torch.obs.metrics.is_enabled` first and allocates nothing on
the disabled path.

Thread-safety: NONE of these classes lock. The bank and its series are
owned by a single serializer — the :class:`~raft_tpu_torch.obs.recorder.
FlightRecorder` mutates them only under its own ``obs.recorder`` lock
(an edge-free leaf: the registry snapshot is taken *before* the lock is
entered, so sampling never nests ``obs.recorder`` over
``obs.registry``). State lives in deques/dicts mutated in place, never
in rebound attributes, so ownership hand-off needs no per-sample
synchronization.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple

from raft_tpu_torch.obs import metrics

#: registry name prefixes the bank retains by default — the serving
#: signals the drift detectors and the replica autoscaler read
DEFAULT_TRACKED = (
    "serve.",
    "slo.",
    "robust.breaker.",
    "mutable.maintenance.",
    "replica.",
)

#: hard cap on distinct series a bank will materialize (memory backstop
#: against label-cardinality accidents; overflow is counted, not grown)
DEFAULT_MAX_SERIES = 256


class TimeSeries:
    """Fixed-capacity ring of ``(t, value)`` samples for one scalar
    instrument (counter or gauge). Appends evict the oldest sample —
    ``collections.deque(maxlen=...)`` ring semantics."""

    def __init__(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        capacity: int = 512,
        kind: str = "gauge",
    ):
        self.name = name
        self.labels = dict(labels or {})
        self.capacity = int(capacity)
        self.kind = kind
        self._samples: Deque[Tuple[float, float]] = deque(maxlen=self.capacity)

    def append(self, t: float, value: float) -> None:
        self._samples.append((float(t), float(value)))

    def __len__(self) -> int:
        return len(self._samples)

    def latest(self) -> Optional[Tuple[float, float]]:
        return self._samples[-1] if self._samples else None

    def points(self, since: Optional[float] = None) -> List[Tuple[float, float]]:
        if since is None:
            return list(self._samples)
        return [(t, v) for t, v in self._samples if t >= since]

    # -- windowed queries --------------------------------------------------

    def _window(self, window_s: float, now: float) -> List[Tuple[float, float]]:
        return self.points(since=now - window_s)

    def delta(self, window_s: float, now: float) -> float:
        """Last minus first sample value inside the window (0.0 with
        fewer than two samples)."""
        pts = self._window(window_s, now)
        if len(pts) < 2:
            return 0.0
        return pts[-1][1] - pts[0][1]

    def rate(self, window_s: float, now: float) -> float:
        """``delta`` per second over the actual sampled span — for a
        counter this is the event rate, for a gauge the slope."""
        pts = self._window(window_s, now)
        if len(pts) < 2:
            return 0.0
        span = pts[-1][0] - pts[0][0]
        if span <= 0.0:
            return 0.0
        return (pts[-1][1] - pts[0][1]) / span

    def mean(self, window_s: float, now: float) -> float:
        pts = self._window(window_s, now)
        if not pts:
            return 0.0
        return sum(v for _, v in pts) / len(pts)

    def percentile(self, q: float, window_s: float, now: float) -> float:
        """Linear-interpolated percentile (``q`` in [0, 100]) over the
        sample *values* in the window."""
        vals = sorted(v for _, v in self._window(window_s, now))
        if not vals:
            return 0.0
        if len(vals) == 1:
            return vals[0]
        pos = (q / 100.0) * (len(vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "labels": dict(self.labels),
            "kind": self.kind,
            "points": [[t, v] for t, v in self._samples],
        }


class HistogramSeries:
    """Fixed-capacity ring of histogram snapshots ``(t, bucket counts,
    sum, count)``. Windowed queries difference the first and last
    snapshot inside the window, so they describe exactly the
    observations that landed between those two sampler ticks."""

    def __init__(
        self,
        name: str,
        buckets: Sequence[float],
        labels: Optional[Dict[str, str]] = None,
        capacity: int = 512,
    ):
        self.name = name
        self.labels = dict(labels or {})
        self.buckets = tuple(float(b) for b in buckets)
        self.capacity = int(capacity)
        self.kind = "histogram"
        #: (t, counts incl. the +Inf bucket, sum, count)
        self._samples: Deque[Tuple[float, Tuple[int, ...], float, int]] = deque(
            maxlen=self.capacity
        )

    def append(
        self, t: float, counts: Sequence[int], total: float, count: int
    ) -> None:
        self._samples.append((float(t), tuple(counts), float(total), int(count)))

    def __len__(self) -> int:
        return len(self._samples)

    def latest(self) -> Optional[Tuple[float, Tuple[int, ...], float, int]]:
        return self._samples[-1] if self._samples else None

    def points(self, since: Optional[float] = None) -> List[Tuple[float, float]]:
        """The cumulative observation count per sample — the scalar
        shadow of the ring (what the bundle plots as the timeline)."""
        if since is None:
            return [(t, float(c)) for t, _, _, c in self._samples]
        return [(t, float(c)) for t, _, _, c in self._samples if t >= since]

    def _ends(
        self, window_s: float, now: float
    ) -> Optional[Tuple[Tuple[float, Tuple[int, ...], float, int], ...]]:
        horizon = now - window_s
        inside = [s for s in self._samples if s[0] >= horizon]
        if len(inside) < 2:
            return None
        return inside[0], inside[-1]

    def delta(self, window_s: float, now: float) -> float:
        """Observation count that landed inside the window."""
        ends = self._ends(window_s, now)
        if ends is None:
            return 0.0
        return float(ends[1][3] - ends[0][3])

    def rate(self, window_s: float, now: float) -> float:
        ends = self._ends(window_s, now)
        if ends is None:
            return 0.0
        span = ends[1][0] - ends[0][0]
        if span <= 0.0:
            return 0.0
        return (ends[1][3] - ends[0][3]) / span

    def mean(self, window_s: float, now: float) -> float:
        ends = self._ends(window_s, now)
        if ends is None:
            return 0.0
        dcount = ends[1][3] - ends[0][3]
        if dcount <= 0:
            return 0.0
        return (ends[1][2] - ends[0][2]) / dcount

    def percentile(self, q: float, window_s: float, now: float) -> float:
        """Bucket-interpolated percentile over the observations inside
        the window (the Prometheus ``histogram_quantile`` estimate).
        Values landing in the +Inf bucket resolve to the largest finite
        bound — a conservative floor for the true tail."""
        ends = self._ends(window_s, now)
        if ends is None:
            return 0.0
        dcounts = [b - a for a, b in zip(ends[0][1], ends[1][1])]
        total = sum(dcounts)
        if total <= 0:
            return 0.0
        target = (q / 100.0) * total
        cum = 0.0
        for i, dc in enumerate(dcounts):
            if dc <= 0:
                continue
            if cum + dc >= target:
                if i >= len(self.buckets):  # +Inf bucket
                    return self.buckets[-1] if self.buckets else 0.0
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (target - cum) / dc
                return lo + (hi - lo) * frac
            cum += dc
        return self.buckets[-1] if self.buckets else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "labels": dict(self.labels),
            "kind": self.kind,
            "buckets": list(self.buckets),
            "points": [
                [t, list(c), s, n] for t, c, s, n in self._samples
            ],
        }


class SeriesBank:
    """A bounded collection of time series auto-discovered from a
    :class:`~raft_tpu_torch.obs.metrics.Registry`.

    :meth:`sample` takes one consistent registry snapshot (via
    :meth:`Registry.sample`) and appends every instrument whose name
    starts with a tracked prefix to its series, creating series lazily
    up to ``max_series``. Overflow beyond the cap is counted in
    ``stats()["dropped"]`` rather than grown — a label-cardinality
    accident must not turn the retention layer into the leak it exists
    to observe.
    """

    def __init__(
        self,
        tracked: Sequence[str] = DEFAULT_TRACKED,
        capacity: int = 512,
        max_series: int = DEFAULT_MAX_SERIES,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.tracked = tuple(tracked)
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self.clock = clock
        self._series: Dict[str, Any] = {}
        self._stats: Dict[str, int] = {"samples": 0, "dropped": 0}

    def __len__(self) -> int:
        return len(self._series)

    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    def sample(
        self,
        reg: Optional[metrics.Registry] = None,
        now: Optional[float] = None,
    ) -> None:
        """One sampler tick: snapshot matching registry instruments and
        append. Zero-allocation no-op when ``RAFT_TPU_OBS`` is off."""
        if not metrics.is_enabled():
            return
        if reg is None:
            reg = metrics.registry()
        rows = reg.sample(self.tracked)
        self.ingest(rows, self.clock() if now is None else now)

    def ingest(
        self, rows: Sequence[Tuple[str, str, Any, Any]], now: float
    ) -> None:
        """Append one pre-taken :meth:`Registry.sample` snapshot. Split
        from :meth:`sample` so an owner holding its own lock can take
        the registry snapshot *outside* that lock (the flight recorder's
        edge-free discipline) and ingest under it."""
        self._stats["samples"] += 1
        for kind, name, labels, payload in rows:
            key = metrics.Registry._fmt_key(name, labels)
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self._stats["dropped"] += 1
                    continue
                ldict = dict(labels)
                if kind == "histogram":
                    s = HistogramSeries(
                        name, payload[0], labels=ldict, capacity=self.capacity
                    )
                else:
                    s = TimeSeries(
                        name, labels=ldict, capacity=self.capacity, kind=kind
                    )
                self._series[key] = s
            if kind == "histogram":
                _, counts, total, count = payload
                s.append(now, counts, total, count)
            else:
                s.append(now, payload)

    def find(self, name: str) -> List[Any]:
        """Every series for metric ``name``, any label set."""
        return [s for s in self._series.values() if s.name == name]

    def get(self, name: str, **labels) -> Optional[Any]:
        key = metrics.Registry._fmt_key(name, metrics._labels_key(labels))
        return self._series.get(key)

    def series(self) -> Iterator[Any]:
        return iter(self._series.values())

    def as_dict(self) -> Dict[str, Any]:
        return {
            "stats": self.stats(),
            "series": [s.as_dict() for s in self._series.values()],
        }


# -- drift detection ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Anomaly:
    """One drift-detector firing."""

    signal: str      # "latency_drift" | "qps_cliff" | ...
    index_id: str    # per-index signals; "all" for unlabeled ones
    value: float     # the observed windowed value
    baseline: float  # the EWMA baseline it was compared against
    t: float

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class EwmaDetector:
    """EWMA-baseline drift detector over one extracted signal.

    ``extract(bank, now, window_s)`` yields ``(index_id, value)`` pairs;
    each key keeps its own EWMA baseline. After ``warmup`` observations
    a value is anomalous when

    * ``mode="ratio_above"``: ``value > threshold * baseline``
      (and ``baseline > min_baseline`` — tiny baselines never alarm),
    * ``mode="ratio_below"``: ``value < threshold * baseline``
      (same baseline floor — a QPS cliff from ~zero is not a cliff),
    * ``mode="abs_above"``: ``value > threshold`` (baseline reported
      for context only).

    The baseline always folds the new value in, anomalous or not — a
    sustained regime change stops alarming once the baseline catches
    up, which is what keeps a recorder from dumping forever.
    """

    def __init__(
        self,
        signal: str,
        extract: Callable[["SeriesBank", float, float], Sequence[Tuple[str, float]]],
        mode: str = "ratio_above",
        threshold: float = 3.0,
        alpha: float = 0.3,
        warmup: int = 5,
        min_baseline: float = 0.0,
        window_s: float = 30.0,
    ):
        if mode not in ("ratio_above", "ratio_below", "abs_above"):
            raise ValueError(f"unknown detector mode {mode!r}")
        self.signal = signal
        self.mode = mode
        self.threshold = float(threshold)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.min_baseline = float(min_baseline)
        self.window_s = float(window_s)
        self._extract = extract
        #: key -> [ewma, n_observations] (mutated in place)
        self._state: Dict[str, List[float]] = {}

    def check(self, bank: "SeriesBank", now: float) -> List[Anomaly]:
        out: List[Anomaly] = []
        for key, value in self._extract(bank, now, self.window_s):
            value = float(value)
            st = self._state.get(key)
            if st is None:
                self._state[key] = [value, 1.0]
                continue
            ewma, n = st
            if n >= self.warmup and self._anomalous(value, ewma):
                out.append(
                    Anomaly(
                        signal=self.signal, index_id=key,
                        value=value, baseline=ewma, t=now,
                    )
                )
            st[0] = self.alpha * value + (1.0 - self.alpha) * ewma
            st[1] = n + 1.0
        return out

    def _anomalous(self, value: float, baseline: float) -> bool:
        if self.mode == "abs_above":
            return value > self.threshold
        if baseline <= self.min_baseline:
            return False
        if self.mode == "ratio_above":
            return value > self.threshold * baseline
        return value < self.threshold * baseline


# -- the four serving signals ------------------------------------------------


def _latency_p99(bank: SeriesBank, now: float, w: float) -> List[Tuple[str, float]]:
    out = []
    for s in bank.find("serve.time_in_queue_ms"):
        if s.kind != "histogram" or s.delta(w, now) <= 0:
            continue
        out.append((s.labels.get("index_id", "all"), s.percentile(99.0, w, now)))
    return out


def _qps(bank: SeriesBank, now: float, w: float) -> List[Tuple[str, float]]:
    per_index: Dict[str, float] = {}
    for s in bank.find("serve.requests"):
        key = s.labels.get("index_id", "all")
        per_index[key] = per_index.get(key, 0.0) + s.rate(w, now)
    return sorted(per_index.items())


def _coverage(bank: SeriesBank, now: float, w: float) -> List[Tuple[str, float]]:
    out = []
    for s in bank.find("serve.coverage"):
        latest = s.latest()
        if latest is None or latest[0] < now - w:
            continue
        out.append((s.labels.get("index_id", "all"), latest[1]))
    return out


def _burn_slope(bank: SeriesBank, now: float, w: float) -> List[Tuple[str, float]]:
    out = []
    for s in bank.find("slo.burn_rate"):
        if s.labels.get("window") != "fast":
            continue
        out.append((s.labels.get("index_id", "all"), s.rate(w, now)))
    return out


def default_detectors() -> List[EwmaDetector]:
    """The stock serving-signal detector set:

    * ``latency_drift`` — windowed p99 of ``serve.time_in_queue_ms``
      above 3x its EWMA baseline;
    * ``qps_cliff`` — per-index ``serve.requests`` rate below 30% of
      baseline (baselines under 1 req/s never alarm);
    * ``coverage_drop`` — latest ``serve.coverage`` below 90% of
      baseline (degraded sharded responses);
    * ``burn_rate_slope`` — fast-window ``slo.burn_rate`` climbing
      faster than 0.5/s (budget exhaustion on the way, ahead of the
      alert itself).
    """
    return [
        EwmaDetector(
            "latency_drift", _latency_p99,
            mode="ratio_above", threshold=3.0, min_baseline=0.05,
        ),
        EwmaDetector(
            "qps_cliff", _qps,
            mode="ratio_below", threshold=0.3, min_baseline=1.0,
        ),
        EwmaDetector(
            "coverage_drop", _coverage,
            mode="ratio_below", threshold=0.9, min_baseline=0.1, warmup=3,
        ),
        EwmaDetector(
            "burn_rate_slope", _burn_slope,
            mode="abs_above", threshold=0.5, warmup=2,
        ),
    ]
