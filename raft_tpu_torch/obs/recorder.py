"""Flight recorder: an always-on "black box" for the serving stack
(``raft_tpu.obs.recorder`` counterpart).

A :class:`FlightRecorder` holds the last ``window_s`` seconds of
evidence in bounded memory — metric time series (a
:class:`~raft_tpu_torch.obs.timeseries.SeriesBank` sampled on the maintenance
tick, rate-limited to ``sample_interval_s``, plus one final at-trigger
sample in every dump), and the incident event stream (anomalies, fault-seam
firings, SLO alert transitions, breaker trips, plan flips, compactor
worker deaths). On a **trigger** it writes one atomic, CRC-framed
diagnostic bundle capturing everything a post-mortem needs:

* the trigger cause and context, and the retained event stream;
* every retained time series with its points (windowed stats are
  recomputed by the reader — ``tools/bundle_report.py``);
* the full registry snapshot, and the slowest exemplar traces with
  their complete span chains (``serve.queue -> serve.dispatch -> ...``);
* ``plan_explain()`` per registered index and ``health()`` for every
  attached engine / replica group (including the cluster aggregate);
* lockcheck witness state and a config/env fingerprint.

Bundles ride :func:`raft_tpu_torch.core.serialize.atomic_write` and the v4
checksummed envelope (kind ``obs_bundle``), so a crash mid-dump — the
``recorder.dump`` chaos seam exists to prove this — leaves either no
file or a CRC-valid one, never a torn bundle.

Locking contract (``lock_order.toml``): ``obs.recorder`` is an
edge-free leaf. The registry snapshot is taken *before* the lock is
entered, bundle assembly (``health()``, ``plan_explain()``, file I/O)
runs after it is released, and — critically — the ``note_*`` hook path
acquires **no lock at all**: events land in a bounded ``deque``
(GIL-atomic appends), because fault seams fire inside other
subsystems' critical sections (e.g. ``wal.append`` under the writer
lock) and the recorder must never insert itself into their ordering.
For the same reason a fault trigger only *latches* a pending dump
(single-slot, last-wins) that the next :meth:`FlightRecorder.tick`
drains; SLO/breaker/plan-flip/worker-death triggers dump inline — their
hook sites sit exactly where registry emission already happens, i.e.
contractually outside every tracked lock.

Gate discipline mirrors :mod:`raft_tpu_torch.obs.metrics`: with
``RAFT_TPU_OBS`` off every entry point returns before allocating, so an
installed recorder costs nothing and gates-off serving stays
bit-identical.
"""
from __future__ import annotations

import io
import json
import os
import platform
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch.core import serialize
from raft_tpu_torch.obs import metrics, request, timeseries
from raft_tpu_torch.utils import lockcheck

BUNDLE_KIND = "obs_bundle"
BUNDLE_VERSION = 1
BUNDLE_SUFFIX = ".raftbundle"

#: trigger causes an auto-dumping recorder reacts to (``manual`` — an
#: explicit :func:`dump` call — is always allowed)
DEFAULT_TRIGGERS = frozenset(
    {"slo", "fault", "breaker", "plan_flip", "worker", "election", "fenced"}
)


@lockcheck.guarded_fields
class FlightRecorder:
    """Bounded black-box recorder over one metrics registry.

    Construction wires a :class:`~raft_tpu_torch.obs.timeseries.SeriesBank`
    (sampled on :meth:`tick`, at most every ``sample_interval_s``
    seconds) and the stock drift detectors; engines and
    replica groups are :meth:`attach_engine`/:meth:`attach_group`-ed so
    bundles can capture their ``health()`` and plans. ``clock`` is
    injectable like the batcher's.
    """

    def __init__(
        self,
        out_dir: str,
        window_s: float = 60.0,
        capacity: int = 512,
        max_events: int = 2048,
        min_dump_interval_s: float = 5.0,
        sample_interval_s: float = 0.25,
        slow_traces: int = 5,
        triggers: Sequence[str] = DEFAULT_TRIGGERS,
        detectors: Optional[List[timeseries.EwmaDetector]] = None,
        tracked: Sequence[str] = timeseries.DEFAULT_TRACKED,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.out_dir = str(out_dir)
        self.window_s = float(window_s)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.sample_interval_s = float(sample_interval_s)
        self.slow_traces = int(slow_traces)
        self.triggers = frozenset(triggers)
        self.tracked = tuple(tracked)
        self._clock = clock
        self._lock = lockcheck.tracked(threading.RLock(), "obs.recorder")
        self._tls = threading.local()
        # lock-free state (see the module docstring's locking contract):
        # the bounded event ring — appended from arbitrary lock contexts
        # via the note_* hooks, GIL-atomic — and the single-slot pending
        # fault-trigger latch the next tick drains (last-wins)
        self._events: Deque[Dict[str, Any]] = deque(maxlen=int(max_events))
        self._pending: List[Optional[Tuple[str, Dict[str, Any], float]]] = [None]
        # lock-free last-sample stamp (GIL-atomic float, last-wins): the
        # interval check runs before the registry snapshot, which itself
        # must precede the recorder lock (edge-free leaf) — a racy
        # double-sample is benign, a lock here is not
        self._last_sample = -float("inf")
        # lock-guarded state (lock_order.toml [[guards]])
        self._bank = timeseries.SeriesBank(
            tracked=tracked, capacity=int(capacity), clock=clock
        )
        self._detectors = (
            detectors if detectors is not None else timeseries.default_detectors()
        )
        self._engines: List[Any] = []
        self._groups: List[Any] = []
        self._dumps: List[str] = []
        self._seq = 0
        self._last_dump_t: Optional[float] = None

    # -- wiring ------------------------------------------------------------

    def attach_engine(self, engine: Any) -> None:
        """Bundle this engine's ``health()`` + per-index plans."""
        with self._lock:
            self._engines.append(engine)

    def attach_group(self, group: Any) -> None:
        """Bundle this replica group's ``health()`` (cluster snapshot)."""
        with self._lock:
            self._groups.append(group)

    # -- the event stream (lock-free; callable under any lock) -------------

    def _record(self, kind: str, **data) -> None:
        if not metrics.is_enabled():
            return
        data["t"] = self._clock()
        data["kind"] = kind
        self._events.append(data)

    def events(self, window_s: Optional[float] = None) -> List[Dict[str, Any]]:
        """Retained events, newest last; ``window_s`` filters by age."""
        evs = list(self._events)
        if window_s is None:
            return evs
        horizon = self._clock() - window_s
        return [e for e in evs if e["t"] >= horizon]

    def note_fault(self, point: str, kind: str) -> None:
        """A fault seam fired. Seams fire inside other subsystems'
        critical sections, so this path must not dump (or lock) inline:
        error faults latch a pending dump for the next tick. Latency
        faults are perf noise, not incidents — event only. The
        recorder's own ``recorder.dump`` seam never re-triggers."""
        self._record("fault", point=point, fault_kind=kind)
        if (
            point != "recorder.dump"
            and kind != "latency"
            and "fault" in self.triggers
            and metrics.is_enabled()
            and self._pending[0] is None
        ):
            self._pending[0] = (
                "fault", {"point": point, "fault_kind": kind}, self._clock()
            )

    def note_slo_transition(
        self,
        index_id: str,
        transition: str,
        burn_fast: Optional[float] = None,
        burn_slow: Optional[float] = None,
    ) -> Optional[str]:
        """An SLO alert fired or cleared (called by
        :meth:`~raft_tpu_torch.obs.slo.SloTracker.evaluate`, outside its
        lock). ``fire`` transitions trigger a dump."""
        self._record(
            "slo", index_id=index_id, transition=transition,
            burn_fast=burn_fast, burn_slow=burn_slow,
        )
        if transition == "fire":
            return self._trigger("slo", {"index_id": index_id})
        return None

    def note_breaker(self, target: str, to: str) -> Optional[str]:
        """A circuit breaker changed state; ``open`` triggers a dump."""
        self._record("breaker", target=target, to=to)
        if to == "open":
            return self._trigger("breaker", {"target": target})
        return None

    def note_plan_flip(self, index_id: str, epoch: int) -> Optional[str]:
        """The planner swapped an index's plan."""
        self._record("plan_flip", index_id=index_id, epoch=epoch)
        return self._trigger("plan_flip", {"index_id": index_id, "epoch": epoch})

    def note_worker_death(self, index: str) -> Optional[str]:
        """A compactor worker died and was restarted by the watchdog."""
        self._record("worker_death", index=index)
        return self._trigger("worker", {"index": index})

    def note_election(
        self, index_id: str, epoch: int, leader: str, reason: str
    ) -> Optional[str]:
        """The control plane elected a new leader (called by
        :meth:`~raft_tpu_torch.replica.control.ControlPlane.tick` with no
        tracked lock held — elections run on the maintenance driver).
        A leader change is always an incident worth a bundle."""
        self._record(
            "election", index_id=index_id, epoch=epoch, leader=leader,
            reason=reason,
        )
        return self._trigger(
            "election",
            {"index_id": index_id, "epoch": epoch, "leader": leader,
             "reason": reason},
        )

    def note_fenced(self, follower: str, epoch: int, fence_epoch: int) -> Optional[str]:
        """A follower rejected a stale-epoch frame — evidence a deposed
        leader is still shipping (called from ``Follower.apply``,
        contractually outside every tracked lock)."""
        self._record(
            "fenced", follower=follower, epoch=epoch, fence_epoch=fence_epoch
        )
        return self._trigger(
            "fenced",
            {"follower": follower, "epoch": epoch, "fence_epoch": fence_epoch},
        )

    def note_scale(self, group: str, direction: str, n_replicas: int) -> None:
        """The autoscaler resized a replica group (event only — scaling
        is routine capacity management, not an incident)."""
        self._record(
            "scale", group=group, direction=direction, n_replicas=n_replicas
        )

    def note_anomaly(self, anomaly: timeseries.Anomaly) -> None:
        """A drift detector fired (event only — detectors inform, the
        SLO/fault/breaker machinery decides)."""
        self._record("anomaly", **anomaly.as_dict())

    def _trigger(self, cause: str, ctx: Dict[str, Any]) -> Optional[str]:
        if cause not in self.triggers or not metrics.is_enabled():
            return None
        return self.dump(cause=cause, ctx=ctx, _auto=True)

    # -- sampling ----------------------------------------------------------

    def tick(self, reg: Optional[metrics.Registry] = None) -> List[timeseries.Anomaly]:
        """One recorder tick (driven from ``ServingEngine.
        maintenance_tick``, or any scheduler): sample the registry into
        the series bank, run the drift detectors, and drain a pending
        fault-triggered dump. Sampling is rate-limited to
        ``sample_interval_s`` — the maintenance tick fires every ~10 ms
        but a 60 s window needs second-scale resolution, and the
        registry scan holds the shared instrument lock the serving hot
        path contends on. The latch drain runs on *every* tick so a
        fault-triggered dump stays prompt. Returns the anomalies
        detected."""
        if not metrics.is_enabled():
            return []
        if reg is None:
            reg = metrics.registry()
        now = self._clock()
        anomalies: List[timeseries.Anomaly] = []
        if now - self._last_sample >= self.sample_interval_s:
            self._last_sample = now
            # snapshot BEFORE taking the recorder lock: obs.recorder must
            # never be held while obs.registry is acquired (edge-free leaf)
            rows = reg.sample(self.tracked)
            with self._lock:
                self._bank.ingest(rows, now)
                for d in self._detectors:
                    anomalies.extend(d.check(self._bank, now))
            for a in anomalies:
                self.note_anomaly(a)
                metrics.inc(
                    "obs.anomaly", signal=a.signal, index_id=a.index_id
                )
        pending = self._pending[0]
        if pending is not None:
            self._pending[0] = None
            cause, ctx, t = pending
            ctx = dict(ctx)
            ctx["latched_t"] = t
            self.dump(cause=cause, ctx=ctx, _auto=True)
        return anomalies

    # -- dumping -----------------------------------------------------------

    def dumps(self) -> List[str]:
        """Paths of every bundle this recorder has written."""
        with self._lock:
            return list(self._dumps)

    def dump(
        self,
        cause: str = "manual",
        ctx: Optional[Dict[str, Any]] = None,
        _auto: bool = False,
    ) -> Optional[str]:
        """Write one diagnostic bundle; returns its path, or None when
        gated off, debounced (auto triggers only), re-entered (bundle
        assembly polls ``health()``, which can re-evaluate SLOs), or
        failed (counted in ``recorder.dump_failures{kind}``)."""
        if not metrics.is_enabled():
            return None
        if getattr(self._tls, "in_dump", False):
            return None
        now = self._clock()
        # one final at-trigger sample so the bundle's series always
        # include the state at the incident, whatever the rate-limited
        # sampler cadence (registry snapshot before the recorder lock —
        # edge-free leaf; discarded if the dump is debounced)
        rows = metrics.registry().sample(self.tracked)
        with self._lock:
            if (
                _auto
                and self._last_dump_t is not None
                and (now - self._last_dump_t) < self.min_dump_interval_s
            ):
                return None
            self._last_dump_t = now
            self._seq += 1
            seq = self._seq
            self._bank.ingest(rows, now)
            self._last_sample = now
            series = self._bank.as_dict()
            engines = tuple(self._engines)
            groups = tuple(self._groups)
        events = self.events(window_s=self.window_s)
        self._tls.in_dump = True
        try:
            body = self._build_body(cause, dict(ctx or {}), now, events,
                                    series, engines, groups)
            payload = json.dumps(body, default=str).encode("utf-8")
            buf = io.BytesIO()
            serialize.save_stream(buf, BUNDLE_KIND, BUNDLE_VERSION, payload)
            blob = buf.getvalue()
            path = os.path.join(
                self.out_dir, f"bundle-{seq:04d}-{cause}{BUNDLE_SUFFIX}"
            )

            def _write(f, _blob=blob, _cause=cause):
                from raft_tpu_torch.robust import faults

                half = len(_blob) // 2
                f.write(_blob[:half])
                # the chaos seam tests/test_recorder.py kills a dump at:
                # atomic_write must leave no bundle or a CRC-valid one
                faults.fire("recorder.dump", cause=_cause)
                f.write(_blob[half:])

            serialize.atomic_write(path, _write)
        except Exception as e:
            metrics.inc("recorder.dump_failures", kind=type(e).__name__)
            return None
        finally:
            self._tls.in_dump = False
        metrics.inc("recorder.dumps", cause=cause)
        with self._lock:
            self._dumps.append(path)
        return path

    # -- bundle assembly (runs with NO recorder lock held) ------------------

    def _build_body(
        self,
        cause: str,
        ctx: Dict[str, Any],
        now: float,
        events: List[Dict[str, Any]],
        series: Dict[str, Any],
        engines: Tuple[Any, ...],
        groups: Tuple[Any, ...],
    ) -> Dict[str, Any]:
        reg = metrics.registry()
        reg_dict = reg.as_dict()
        body: Dict[str, Any] = {
            "format": "raft_tpu.obs_bundle",
            "bundle_version": BUNDLE_VERSION,
            "t": now,
            "wall_time": time.time(),
            "window_s": self.window_s,
            "trigger": {"cause": cause, "ctx": ctx, "t": now},
            "events": events,
            "series": series,
            "metrics": reg_dict,
            "slow_traces": self._slow_traces(reg, reg_dict),
            "plans": {},
            "health": {"engines": [], "groups": []},
            "lockcheck": _lockcheck_state(),
            "fingerprint": _fingerprint(),
        }
        for e in engines:
            try:
                h = e.health()
            except Exception as err:
                h = {"error": f"{type(err).__name__}: {err}"}
            body["health"]["engines"].append(h)
            for index_id in (h.get("indexes") or {}):
                try:
                    body["plans"][index_id] = e.plan_explain(index_id)
                except Exception as err:
                    body["plans"][index_id] = f"error: {err}"
        for g in groups:
            try:
                h = g.health()
            except Exception as err:
                h = {"error": f"{type(err).__name__}: {err}"}
            body["health"]["groups"].append(h)
        return body

    def _slow_traces(
        self, reg: metrics.Registry, reg_dict: Dict[str, Any]
    ) -> List[Dict[str, Any]]:
        """The slowest exemplar-tagged requests with their complete span
        chains — the "which request made p99" evidence, resolved from
        histogram exemplars through the trace-id span index."""
        rows: List[Tuple[float, str, str]] = []
        for key, h in reg_dict.get("histograms", {}).items():
            for ex in h.get("exemplars", ()):
                if ex.get("trace_id"):
                    rows.append((float(ex["value"]), str(ex["trace_id"]), key))
        rows.sort(reverse=True)
        out: List[Dict[str, Any]] = []
        seen: set = set()
        for value, trace_id, metric_key in rows:
            if trace_id in seen:
                continue
            seen.add(trace_id)
            spans = list(request.iter_trace_spans(reg, trace_id))
            out.append({
                "trace_id": trace_id,
                "value": value,
                "metric": metric_key,
                "spans": spans,
            })
            if len(out) >= self.slow_traces:
                break
        return out


def _lockcheck_state() -> Dict[str, Any]:
    exercised, declared = lockcheck.coverage()
    return {
        "enabled": lockcheck.is_enabled(),
        "edges": [
            [a, b, n] for (a, b), n in sorted(lockcheck.edges().items())
        ],
        "violations": list(lockcheck.violations()),
        "coverage": {
            "exercised": sorted(list(e) for e in exercised),
            "declared": sorted(list(e) for e in declared),
        },
        "field_coverage": lockcheck.field_coverage(),
        "field_violations": list(lockcheck.field_violations()),
    }


def _fingerprint() -> Dict[str, Any]:
    env = {
        k: v for k, v in sorted(os.environ.items()) if k.startswith("RAFT_TPU_")
    }
    out: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "pid": os.getpid(),
        "argv0": sys.argv[0] if sys.argv else "",
        "env": env,
    }
    try:
        import torch

        out["torch"] = torch.__version__
        out["cuda"] = torch.version.cuda
        out["device"] = (torch.cuda.get_device_name(0)
                         if torch.cuda.is_available() else "cpu")
    except Exception:
        out["torch"] = None
    return out


# -- bundle reading ----------------------------------------------------------


def load_bundle(path: str) -> Dict[str, Any]:
    """Load + CRC-verify one bundle file (raises
    :class:`~raft_tpu_torch.core.errors.CorruptIndexError` on a damaged
    envelope — which :func:`raft_tpu_torch.core.serialize.atomic_write`
    guarantees can only happen to a file produced by something other
    than a completed :meth:`FlightRecorder.dump`)."""
    with open(path, "rb") as f:
        _, payload = serialize.load_stream(f, BUNDLE_KIND)
        return json.loads(payload.read().decode("utf-8"))


def list_bundles(out_dir: str) -> List[str]:
    """Bundle files under ``out_dir``, oldest first."""
    try:
        names = sorted(
            n for n in os.listdir(out_dir) if n.endswith(BUNDLE_SUFFIX)
        )
    except FileNotFoundError:
        return []
    return [os.path.join(out_dir, n) for n in names]


# -- the process-wide recorder (what the serving hooks talk to) --------------

_active: Optional[FlightRecorder] = None


def install(out_dir: str, **kwargs) -> FlightRecorder:
    """Construct a :class:`FlightRecorder` and make it the process-wide
    active one (what every ``note_*`` hook and ``ServingEngine``'s
    maintenance tick feed). Returns it for attach/dump calls."""
    global _active
    _active = FlightRecorder(out_dir, **kwargs)
    return _active


def installed() -> Optional[FlightRecorder]:
    return _active


def uninstall() -> Optional[FlightRecorder]:
    """Deactivate (and return) the active recorder."""
    global _active
    r = _active
    _active = None
    return r


def tick(reg: Optional[metrics.Registry] = None) -> None:
    r = _active
    if r is not None and metrics.is_enabled():
        r.tick(reg)


def dump(cause: str = "manual", **ctx) -> Optional[str]:
    r = _active
    if r is None:
        return None
    return r.dump(cause=cause, ctx=ctx)


def note_fault(point: str, kind: str) -> None:
    r = _active
    if r is not None and metrics.is_enabled():
        r.note_fault(point, kind)


def note_slo_transition(
    index_id: str,
    transition: str,
    burn_fast: Optional[float] = None,
    burn_slow: Optional[float] = None,
) -> None:
    r = _active
    if r is not None and metrics.is_enabled():
        r.note_slo_transition(index_id, transition, burn_fast, burn_slow)


def note_breaker(target: str, to: str) -> None:
    r = _active
    if r is not None and metrics.is_enabled():
        r.note_breaker(target, to)


def note_plan_flip(index_id: str, epoch: int) -> None:
    r = _active
    if r is not None and metrics.is_enabled():
        r.note_plan_flip(index_id, epoch)


def note_worker_death(index: str) -> None:
    r = _active
    if r is not None and metrics.is_enabled():
        r.note_worker_death(index)


def note_election(index_id: str, epoch: int, leader: str, reason: str) -> None:
    r = _active
    if r is not None and metrics.is_enabled():
        r.note_election(index_id, epoch, leader, reason)


def note_fenced(follower: str, epoch: int, fence_epoch: int) -> None:
    r = _active
    if r is not None and metrics.is_enabled():
        r.note_fenced(follower, epoch, fence_epoch)


def note_scale(group: str, direction: str, n_replicas: int) -> None:
    r = _active
    if r is not None and metrics.is_enabled():
        r.note_scale(group, direction, n_replicas)
