"""Deterministic fault injection (``raft_tpu.robust.faults`` counterpart).

Named **fault points** sit at the real seams of the mutable and serving
layers and fire typed errors (or injected latency) under test control.

One process-wide gate (env ``RAFT_TPU_FAULTS``, **default off**), and the
disabled path allocates nothing: :func:`fire` checks the module flag and
returns before touching the registry, so instrumented call sites cost one
attribute load + branch when injection is off.

Fault points live on the host, outside any kernel launch. The tuple
:data:`FAULT_POINTS` is the JAX package's whole list, so a spec written
for one package installs in the other; the port fires ``wal.append``,
``compact.*``, ``manifest.swap`` and ``serve.dispatch`` so far.

Usage::

    from raft_tpu_torch.robust import faults
    with faults.injected("wal.append", error=OSError("disk"),
                         match={"stage": "pre"}):
        ...  # the next append fails before writing a byte

Trigger policies: ``always`` (default), ``nth=i`` (exactly the i-th
matching call, 0-based), ``first_n=n`` (the first n matching calls — a
transient fault window, what retry tests want), ``probability=p`` with a
seeded PRNG (deterministic chaos). ``latency_s`` sleeps instead of (or
before) raising. Every firing is counted in ``obs``
(``faults.fired{point,kind}``) so degradations stay visible.
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, List, Optional

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.utils import lockcheck

_TRUTHY = ("1", "true", "on", "yes")

_enabled = os.environ.get("RAFT_TPU_FAULTS", "0").strip().lower() in _TRUTHY


def enable(flag: bool = True) -> None:
    """Turn fault injection on/off process-wide (``RAFT_TPU_FAULTS`` analog)."""
    global _enabled
    _enabled = bool(flag)


def disable() -> None:
    enable(False)


def is_enabled() -> bool:
    return _enabled


#: the named seams fault specs may attach to (the JAX package's list; the
#: comments name the JAX package's call sites)
FAULT_POINTS = (
    "comms.all_gather",       # parallel/comms.py allgather verb (trace time)
    "comms.ring_topk",        # ops/pallas/ring_topk.py ring dispatch (trace time)
    "sharded_ann.shard_scan", # robust/degrade.py per-shard health probe
    "pallas.cagra_search",    # neighbors/cagra.py fused dispatch branch
    "pallas.pq_scan",         # neighbors/ivf_pq.py fused dispatch branch
    "serialize.load",         # core/serialize.py load_stream
    "bootstrap.init",         # parallel/bootstrap.py init_distributed attempt
    "serve.dispatch",         # serve/engine.py micro-batch dispatch
    "wal.append",             # mutable/wal.py durable append (stage pre/post)
    "compact.merge",          # mutable/compact.py before any artifact write
    "manifest.swap",          # mutable/manifest.py between durability and rename
    "compact.pin",            # mutable/maintenance.py snapshot pin (lock held)
    "compact.replay",         # mutable/maintenance.py before catch-up replay
    "compact.flip",           # mutable/maintenance.py after replay, pre-swap
    "compact.worker",         # mutable/maintenance.py worker loop (thread death)
    "host.fetch",             # tiered/store.py host-tier candidate gather
    "replica.dispatch",       # replica/group.py per-replica pump (before engine.step)
    "wal.ship",               # replica/shipping.py sealed-frame transfer to a follower
    "replica.apply",          # replica/shipping.py follower replay of a shipped chunk
    "recorder.dump",          # obs/recorder.py mid-bundle-write (torn-dump drill)
    "lease.acquire",          # replica/control.py lease CAS attempt (election)
    "lease.renew",            # replica/control.py leader heartbeat renewal
    "transport.read",         # replica/transport.py socket chunk fetch
    "election.promote",       # replica/control.py follower promotion (pre-CAS)
)


@dataclasses.dataclass
class FaultSpec:
    """One installed fault: where it fires, what it raises, and when."""

    point: str
    error: Optional[BaseException] = None
    latency_s: float = 0.0
    trigger: str = "always"  # "always" | "nth" | "first_n" | "probability"
    nth: int = 0
    first_n: int = 1
    probability: float = 1.0
    seed: int = 0
    match: Optional[Dict[str, object]] = None
    #: calls that matched this spec's point+context so far
    calls: int = 0
    #: times this spec actually fired (raised or slept)
    fired: int = 0
    _rng: Optional[random.Random] = None

    def _matches(self, ctx: Dict[str, object]) -> bool:
        if not self.match:
            return True
        return all(ctx.get(k) == v for k, v in self.match.items())

    def _should_fire(self) -> bool:
        if self.trigger == "always":
            return True
        if self.trigger == "nth":
            return self.calls - 1 == self.nth
        if self.trigger == "first_n":
            return self.calls <= self.first_n
        if self.trigger == "probability":
            if self._rng is None:
                self._rng = random.Random(self.seed)
            return self._rng.random() < self.probability
        return False


@lockcheck.guarded_fields
class FaultRegistry:
    """Thread-safe store of installed :class:`FaultSpec` s."""

    def __init__(self):
        self._lock = lockcheck.tracked(threading.RLock(), "robust.faults")
        self._specs: List[FaultSpec] = []

    def install(self, spec: FaultSpec) -> FaultSpec:
        expects(
            spec.point in FAULT_POINTS, "unknown fault point %r (known: %s)",
            spec.point, ", ".join(FAULT_POINTS),
        )
        expects(spec.trigger in ("always", "nth", "first_n", "probability"),
                "unknown trigger %r", spec.trigger)
        with self._lock:
            self._specs.append(spec)
        return spec

    def remove(self, spec: FaultSpec) -> None:
        with self._lock:
            if spec in self._specs:
                self._specs.remove(spec)

    def clear(self) -> None:
        with self._lock:
            self._specs.clear()

    def specs(self, point: Optional[str] = None) -> List[FaultSpec]:
        with self._lock:
            snap = list(self._specs)
        if point is None:
            return snap
        return [s for s in snap if s.point == point]

    def fire(self, point: str, **ctx) -> None:
        """Evaluate every spec installed at ``point`` against ``ctx``;
        sleep/raise per the first spec whose trigger fires."""
        with self._lock:
            specs = [s for s in self._specs if s.point == point]
        for spec in specs:
            with self._lock:
                if not spec._matches(ctx):
                    continue
                spec.calls += 1
                should = spec._should_fire()
                if should:
                    spec.fired += 1
            if not should:
                continue
            kind = type(spec.error).__name__ if spec.error is not None else "latency"
            obs.inc("faults.fired", point=point, kind=kind)
            if spec.latency_s > 0.0:
                time.sleep(spec.latency_s)
            if spec.error is not None:
                raise spec.error


_default = FaultRegistry()


def registry() -> FaultRegistry:
    """The process-wide default fault registry."""
    return _default


def install(
    point: str,
    error: Optional[BaseException] = None,
    *,
    latency_s: float = 0.0,
    trigger: str = "always",
    nth: int = 0,
    first_n: int = 1,
    probability: float = 1.0,
    seed: int = 0,
    match: Optional[Dict[str, object]] = None,
) -> FaultSpec:
    """Install a fault at ``point`` in the default registry."""
    return _default.install(FaultSpec(
        point=point, error=error, latency_s=latency_s, trigger=trigger,
        nth=nth, first_n=first_n, probability=probability, seed=seed,
        match=dict(match) if match else None,
    ))


def remove(spec: FaultSpec) -> None:
    _default.remove(spec)


def clear() -> None:
    _default.clear()


def fire(point: str, **ctx) -> None:
    """The call sites' hook: no-op (one branch) unless injection is
    enabled AND a matching spec's trigger fires."""
    if not _enabled:
        return
    _default.fire(point, **ctx)


class injected:
    """Context manager for tests: enable injection, install one fault,
    restore the previous state on exit::

        with faults.injected("compact.merge", error=OSError("x")):
            ...
    """

    def __init__(self, point: str, error: Optional[BaseException] = None, **kw):
        self._point, self._error, self._kw = point, error, kw
        self._spec: Optional[FaultSpec] = None
        self._was_enabled = False

    def __enter__(self) -> FaultSpec:
        self._was_enabled = is_enabled()
        enable()
        self._spec = install(self._point, self._error, **self._kw)
        return self._spec

    def __exit__(self, *exc):
        if self._spec is not None:
            remove(self._spec)
        enable(self._was_enabled)
        return False
