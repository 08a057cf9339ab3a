"""Process-local metrics registry: counters, gauges, fixed-bucket
histograms, and the span buffer the instrumented layers report into
(``raft_tpu.obs.metrics`` counterpart).

A thread-safe, process-local registry the serving and mutable layers
write into, dumpable as a dict, JSONL, or Prometheus text exposition.

The whole subsystem is gated on one process-wide flag, env
``RAFT_TPU_OBS``, **default off**, and the disabled path allocates
nothing: every recording helper checks :func:`is_enabled` first and
returns before any metric object, label tuple, or span record is
created.

Metric identity is ``(kind, name, sorted labels)``; names are
dot-separated (``mutable.wal.records``), labels are ``str -> str``
pairs (``op="insert"``). The Prometheus dump sanitizes names to the
exposition charset; the dict/JSONL dumps keep them verbatim. Names,
labels and dump formats are the JAX package's.
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.utils import lockcheck

_TRUTHY = ("1", "true", "on", "yes")

_enabled = os.environ.get("RAFT_TPU_OBS", "0").strip().lower() in _TRUTHY


def enable(flag: bool = True) -> None:
    """Turn observability on/off process-wide (``RAFT_TPU_OBS`` analog)."""
    global _enabled
    _enabled = bool(flag)


def disable() -> None:
    enable(False)


def is_enabled() -> bool:
    return _enabled


#: default histogram buckets for millisecond timings (upper bounds)
DEFAULT_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, Any]) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@lockcheck.guarded_fields
class Counter:
    """Monotonically increasing value (``prometheus counter`` semantics)."""

    __slots__ = ("name", "labels", "value", "_lock")
    kind = "counter"

    def __init__(self, name: str, labels: LabelsKey, lock: threading.RLock):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = lock

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self.value += value


@lockcheck.guarded_fields
class Gauge:
    """Last-write-wins value."""

    __slots__ = ("name", "labels", "value", "_lock")
    kind = "gauge"

    def __init__(self, name: str, labels: LabelsKey, lock: threading.RLock):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = lock

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self.value += value


@lockcheck.guarded_fields
class Histogram:
    """Fixed-bucket histogram: ``buckets`` are sorted upper bounds; one
    implicit +Inf bucket catches the tail. Tracks sum and count like the
    Prometheus histogram type.

    ``observe_device(value)`` takes a 0-d tensor without reading it: its
    sum and bucket accumulate on its device (one float64 tensor of
    ``len(buckets) + 2`` a device, whatever the number of observations)
    until the registry is dumped or sampled, which reads each device's
    accumulator in one transfer and folds it into the fields above.

    ``observe(value, trace_id=...)`` additionally keeps one **exemplar**
    per bucket — the worst (largest) value seen with a trace attached —
    so a tail bucket resolves to a concrete request trace instead of an
    anonymous count (the Prometheus/OpenMetrics exemplar idea, but
    max-retaining rather than last-write, because the question the
    serving path asks is "which request made p99").
    """

    __slots__ = (
        "name", "labels", "buckets", "counts", "sum", "count",
        "exemplars", "_pending", "_lock",
    )
    kind = "histogram"

    def __init__(
        self,
        name: str,
        labels: LabelsKey,
        lock: threading.RLock,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        self.name = name
        self.labels = labels
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        #: bucket index -> (value, trace_id); worst value per bucket wins
        self.exemplars: Dict[int, Tuple[float, str]] = {}
        #: device -> (bucket edges, accumulator [sum, counts...], one) of
        #: the observations not read yet; None until the first
        self._pending: Optional[Dict[Any, Tuple[Any, Any, Any]]] = None
        self._lock = lock

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        value = float(value)
        with self._lock:
            bi = bisect.bisect_left(self.buckets, value)
            self.counts[bi] += 1
            self.sum += value
            self.count += 1
            if trace_id:
                prev = self.exemplars.get(bi)
                if prev is None or value > prev[0]:
                    self.exemplars[bi] = (value, trace_id)

    def observe_device(self, value) -> None:
        """Observe the 0-d tensor ``value`` without reading it: it is
        added on its own device, into the accumulator :meth:`_drain`
        reads (no exemplar)."""
        import torch

        v = value.detach().reshape(()).to(torch.float64)
        with self._lock:
            if self._pending is None:
                self._pending = {}
            st = self._pending.get(v.device)
            if st is None:
                # the edges are filled in place: a copy from the host would
                # wait on the device's stream
                edges = torch.empty(len(self.buckets), dtype=torch.float64, device=v.device)
                for i, b in enumerate(self.buckets):
                    edges[i].fill_(b)
                st = self._pending[v.device] = (
                    edges,
                    torch.zeros(len(self.buckets) + 2, dtype=torch.float64, device=v.device),
                    torch.ones(1, dtype=torch.float64, device=v.device),
                )
            edges, acc, one = st
            acc[:1].add_(v)
            # bucketize(right=False) is observe()'s bisect_left
            acc[1:].index_add_(0, torch.bucketize(v, edges).reshape(1), one)

    def _drain(self) -> None:
        """Fold the pending device observations into ``counts``, ``sum``
        and ``count``: one read of each device's accumulator, which then
        restarts at zero. The caller holds the lock."""
        if not self._pending:
            return
        for _, acc, _ in self._pending.values():
            vals = acc.tolist()
            acc.zero_()
            n = int(sum(vals[1:]))
            if n:
                self.sum += vals[0]
                for i, c in enumerate(vals[1:]):
                    self.counts[i] += int(c)
                self.count += n

    def exemplar_rows(self) -> List[Dict[str, Any]]:
        """Exemplars as dicts, largest value first (dump/report shape)."""
        with self._lock:
            items = sorted(
                self.exemplars.items(), key=lambda kv: kv[1][0], reverse=True
            )
        return [
            {"bucket": bi, "value": v, "trace_id": t} for bi, (v, t) in items
        ]


@lockcheck.guarded_fields
class Registry:
    """Thread-safe metric + span store. One process-wide default lives in
    this module (:func:`registry`); tests may construct their own."""

    def __init__(self, max_spans: int = 200_000):
        # one shared (tracked) RLock for the registry and every
        # instrument it hands out; a leaf in utils/lock_order.toml —
        # nothing may be acquired under it
        self._lock = lockcheck.tracked(threading.RLock(), "obs.registry")
        self._metrics: Dict[Tuple[str, str, LabelsKey], Any] = {}
        self._spans: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self.max_spans = max_spans
        self.spans_dropped = 0

    # -- get-or-create ----------------------------------------------------

    def _get(self, cls, name: str, labels: Dict[str, Any], **kwargs):
        key = (cls.kind, name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[2], self._lock, **kwargs)
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(
        self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS, **labels
    ) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    # -- enabled-gated recording (the hot-path API) -----------------------

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        if not _enabled:
            return
        self.counter(name, **labels).inc(value)

    def set(self, name: str, value: float, **labels) -> None:
        if not _enabled:
            return
        self.gauge(name, **labels).set(value)

    def observe(
        self, name: str, value: float, trace_id: Optional[str] = None, **labels
    ) -> None:
        if not _enabled:
            return
        self.histogram(name, **labels).observe(value, trace_id=trace_id)

    def observe_device(self, name: str, value, **labels) -> None:
        """:meth:`Histogram.observe_device` on the histogram ``name``."""
        if not _enabled:
            return
        self.histogram(name, **labels).observe_device(value)

    def _drain(self) -> None:
        """Read every histogram's pending device observations (under the
        lock): the dumps and :meth:`sample` call it first."""
        for m in self._metrics.values():
            if m.kind == "histogram":
                m._drain()

    # -- sampling ----------------------------------------------------------

    def sample(
        self, prefixes: Optional[Sequence[str]] = None
    ) -> List[Tuple[str, str, LabelsKey, Any]]:
        """One consistent snapshot of instrument values for time-series
        retention: ``(kind, name,
        labels, payload)`` rows, where payload is the value for
        counters/gauges and ``(buckets, counts, sum, count)`` for
        histograms. ``prefixes`` filters by name prefix; like the dump
        paths, the whole scan runs under the shared instrument lock so
        a row can never carry a torn sum/count pair."""
        pref = tuple(prefixes) if prefixes else None
        out: List[Tuple[str, str, LabelsKey, Any]] = []
        with self._lock:
            self._drain()
            for m in self._metrics.values():
                if pref is not None and not m.name.startswith(pref):
                    continue
                if m.kind == "histogram":
                    payload: Any = (
                        m.buckets, tuple(m.counts), m.sum, m.count
                    )
                else:
                    payload = m.value
                out.append((m.kind, m.name, m.labels, payload))
        return out

    # -- spans ------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since this registry's epoch (the trace clock)."""
        return (time.perf_counter() - self._t0) * 1e6

    def record_span(
        self,
        name: str,
        ts_us: float,
        dur_us: float,
        tid: int,
        depth: int,
        args: Optional[Dict[str, Any]] = None,
        trace: Sequence[str] = (),
        ts_ns: Optional[int] = None,
    ) -> None:
        """Keep one span: ``ts_us`` on this registry's clock
        (:meth:`now_us`), ``ts_ns`` (optional) its start on
        ``torch.profiler``'s clock (:data:`raft_tpu_torch.obs.spans.profiler_clock_ns`)."""
        rec = {
            "name": name,
            "ts_us": ts_us,
            "dur_us": dur_us,
            "tid": tid,
            "depth": depth,
            "args": args or {},
        }
        if ts_ns is not None:
            rec["ts_ns"] = ts_ns
        if trace:
            rec["trace"] = list(trace)
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.spans_dropped += 1
                # visible drop signal: the plain attribute is easy to miss
                # in dashboards; the counter rides every normal dump. The
                # registry lock is an RLock, so self.inc under it is safe.
                self.inc("obs.spans_dropped")
                return
            self._spans.append(rec)

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            snap = list(self._spans)
        if name is None:
            return snap
        return [s for s in snap if s["name"] == name]

    # -- dumps ------------------------------------------------------------

    @staticmethod
    def _fmt_key(name: str, labels: LabelsKey) -> str:
        if not labels:
            return name
        inner = ",".join(f'{k}="{v}"' for k, v in labels)
        return f"{name}{{{inner}}}"

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        # Every instrument shares this registry's RLock, so reading their
        # fields here IS the writers' critical section — snapshotting the
        # metric list and formatting off-lock would copy counts/sum/count
        # mid-observe (torn histogram totals).
        with self._lock:
            self._drain()
            for m in self._metrics.values():
                key = self._fmt_key(m.name, m.labels)
                if m.kind == "histogram":
                    h = {
                        "buckets": list(m.buckets),
                        "counts": list(m.counts),
                        "sum": m.sum,
                        "count": m.count,
                    }
                    if m.exemplars:
                        h["exemplars"] = m.exemplar_rows()
                    out["histograms"][key] = h
                else:
                    out[m.kind + "s"][key] = m.value
            out["n_spans"] = len(self._spans)
            out["spans_dropped"] = self.spans_dropped
        return out

    def dump_jsonl(self, stream) -> None:
        """One JSON object per line: every metric, then every span — a
        self-contained snapshot."""
        recs: List[Dict[str, Any]] = []
        # build the records under the shared instrument lock (see
        # as_dict); only the stream writes happen off-lock
        with self._lock:
            self._drain()
            for m in self._metrics.values():
                rec: Dict[str, Any] = {
                    "kind": m.kind,
                    "name": m.name,
                    "labels": dict(m.labels),
                }
                if m.kind == "histogram":
                    rec.update(
                        buckets=list(m.buckets), counts=list(m.counts),
                        sum=m.sum, count=m.count,
                    )
                    if m.exemplars:
                        rec["exemplars"] = m.exemplar_rows()
                else:
                    rec["value"] = m.value
                recs.append(rec)
            spans = list(self._spans)
        for rec in recs:
            stream.write(json.dumps(rec) + "\n")
        for s in spans:
            stream.write(json.dumps({"kind": "span", **s}) + "\n")

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (the ``/metrics`` payload)."""
        lines: List[str] = []
        seen_type: set = set()
        # string formatting is cheap; holding the shared instrument lock
        # across it buys consistent bucket/sum/count triples (see as_dict)
        with self._lock:
            self._drain()
            for m in self._metrics.values():
                pname = _prom_name(m.name)
                if pname not in seen_type:
                    seen_type.add(pname)
                    lines.append(f"# TYPE {pname} {m.kind}")
                if m.kind == "histogram":
                    cum = 0
                    for ub, c in zip(m.buckets, m.counts):
                        cum += c
                        lines.append(
                            self._fmt_key(
                                pname + "_bucket", m.labels + (("le", _fmt_float(ub)),)
                            )
                            + f" {cum}"
                        )
                    cum += m.counts[-1]
                    lines.append(
                        self._fmt_key(pname + "_bucket", m.labels + (("le", "+Inf"),))
                        + f" {cum}"
                    )
                    lines.append(self._fmt_key(pname + "_sum", m.labels) + f" {_fmt_float(m.sum)}")
                    lines.append(self._fmt_key(pname + "_count", m.labels) + f" {m.count}")
                else:
                    lines.append(self._fmt_key(pname, m.labels) + f" {_fmt_float(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._spans.clear()
            self.spans_dropped = 0
            self._t0 = time.perf_counter()


def _prom_name(name: str) -> str:
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def _fmt_float(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


_default = Registry()


def registry() -> Registry:
    """The process-wide default registry."""
    return _default


# module-level conveniences bound to the default registry
def inc(name: str, value: float = 1.0, **labels) -> None:
    if not _enabled:
        return
    _default.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    if not _enabled:
        return
    _default.set(name, value, **labels)


def observe(
    name: str, value: float, trace_id: Optional[str] = None, **labels
) -> None:
    if not _enabled:
        return
    _default.observe(name, value, trace_id=trace_id, **labels)


def observe_device(name: str, value, **labels) -> None:
    """Observe the 0-d integer or float tensor ``value`` into the
    histogram ``name`` without reading it (no host sync): the registry
    reads it when it is dumped or sampled. Off, it does nothing."""
    if not _enabled:
        return
    _default.observe_device(name, value, **labels)
