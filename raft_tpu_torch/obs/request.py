"""Request-scoped trace identity for the serving path
(``raft_tpu.obs.request`` counterpart).

A trace ID is minted once per request and rides along through batcher
enqueue and micro-batch dispatch. Everything that happens on a thread
while a :func:`trace_scope` is active tags its spans with the active
trace IDs (a micro-batch carries one ID per batched request), so one
slow request can be followed across threads and resolved from histogram
exemplars (:mod:`raft_tpu_torch.obs.metrics`).

With the ``RAFT_TPU_OBS`` gate off, :func:`new_trace_id` returns ``""``
and no thread-local state, tuple, or ID string is ever allocated.

Trace IDs are process-local (``t`` + a monotonic counter in hex): they
identify a request within one registry epoch.
"""
from __future__ import annotations

import itertools
import threading
from typing import Iterator, Sequence, Tuple

from raft_tpu_torch.obs import metrics

_counter = itertools.count(1)
_tls = threading.local()


def new_trace_id() -> str:
    """Mint a fresh trace ID, or ``""`` when obs is disabled."""
    if not metrics.is_enabled():
        return ""
    return f"t{next(_counter):08x}"


def current_trace() -> Tuple[str, ...]:
    """Trace IDs active on this thread (``()`` outside any scope)."""
    return getattr(_tls, "trace", ())


class _NullScope:
    """Reusable no-op scope for the disabled gate — no per-dispatch
    generator frame, no state."""

    __slots__ = ()

    def __enter__(self) -> Tuple[str, ...]:
        return ()

    def __exit__(self, *exc) -> bool:
        return False


NULL_SCOPE = _NullScope()


class trace_scope:
    """Bind ``trace_ids`` to the current thread for the ``with`` body.

    Spans recorded inside the scope (on this thread) carry the IDs; the
    previous binding is restored on exit, so scopes nest with inner-wins
    semantics. Empty / falsy IDs are dropped; an all-empty scope still
    clears any outer binding, which is what a dispatch of untraced
    requests wants.
    """

    __slots__ = ("_ids", "_prev")

    def __init__(self, trace_ids: Sequence[str] = ()):
        self._ids = tuple(t for t in trace_ids if t)
        self._prev: Tuple[str, ...] = ()

    def __enter__(self) -> Tuple[str, ...]:
        self._prev = getattr(_tls, "trace", ())
        _tls.trace = self._ids
        return self._ids

    def __exit__(self, *exc) -> bool:
        _tls.trace = self._prev
        return False


def iter_trace_spans(reg: metrics.Registry, trace_id: str) -> Iterator[dict]:
    """Yield every span in ``reg`` tagged with ``trace_id`` (ts order)."""
    matched = [s for s in reg.spans() if trace_id in (s.get("trace") or ())]
    matched.sort(key=lambda s: s["ts_us"])
    return iter(matched)
