"""Nested, device-sync-aware wall-clock spans (``raft_tpu.obs.spans``
counterpart).

A :func:`span` is a host-side timing scope recorded into the
:mod:`raft_tpu_torch.obs.metrics` registry. Two properties matter on a
GPU:

* **Sync-aware.** CUDA launches are asynchronous: a naive
  ``perf_counter`` delta around a launch measures *enqueue* time, not
  compute. Registering the op's outputs with :meth:`Span.sync` makes the
  span end wait on the stream each output's device is working on, so the
  recorded duration covers the device work. CPU tensors need no wait.

* **Zero-cost when disabled.** With ``RAFT_TPU_OBS`` off (the default)
  ``span()`` yields a shared null object and records nothing — no
  timestamps, no allocation beyond the generator frame, no wait.

Spans nest by wall-clock containment per thread (the Perfetto/Chrome
``ph: "X"`` convention); ``depth`` is tracked explicitly so reporters
need not re-derive it.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Any, Iterator, Optional

from raft_tpu_torch.obs import metrics, request

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _cuda_devices(outputs, found: set) -> None:
    """The CUDA devices of the tensors in ``outputs`` (nested tuples,
    lists and dicts)."""
    import torch

    if isinstance(outputs, torch.Tensor):
        if outputs.is_cuda:
            found.add(outputs.device)
    elif isinstance(outputs, (tuple, list)):
        for o in outputs:
            _cuda_devices(o, found)
    elif isinstance(outputs, dict):
        for o in outputs.values():
            _cuda_devices(o, found)


def _wait_outputs(outputs) -> None:
    """Block until the current stream of every CUDA device that holds a
    tensor of ``outputs`` has finished its queued work."""
    import torch

    found: set = set()
    _cuda_devices(outputs, found)
    for dev in found:
        torch.cuda.current_stream(dev).synchronize()


class Span:
    """Mutable scope handle yielded by :func:`span`."""

    __slots__ = ("name", "args", "_sync")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args
        self._sync: list = []

    def set(self, **kv) -> None:
        """Attach/overwrite trace args (visible in Perfetto's arg pane)."""
        self.args.update(kv)

    def sync(self, outputs):
        """Register ``outputs`` (tensors, or tuples/lists/dicts of them) to
        be waited for at span end; returns ``outputs`` so call sites can
        wrap a return value in place."""
        self._sync.append(outputs)
        return outputs


class _NullSpan:
    """Disabled-path stand-in: same surface, does nothing."""

    __slots__ = ()

    def set(self, **kv) -> None:
        pass

    def sync(self, outputs):
        return outputs


_NULL = _NullSpan()


@contextlib.contextmanager
def span(name: str, **args) -> Iterator[Any]:
    """Record a nested wall-clock span named ``name`` into the default
    registry. ``args`` become Chrome-trace args. Use ``sp.sync(out)`` on
    the yielded handle to include device completion in the duration."""
    if not metrics.is_enabled():
        yield _NULL
        return
    reg = metrics.registry()
    st = _stack()
    depth = len(st)
    s = Span(name, dict(args))
    st.append(s)
    ts = reg.now_us()
    t0 = time.perf_counter()
    try:
        yield s
    finally:
        if s._sync:
            try:
                _wait_outputs(s._sync)
            except Exception:  # timing must never mask the real error
                pass
        dur = (time.perf_counter() - t0) * 1e6
        if st and st[-1] is s:
            st.pop()
        reg.record_span(
            name, ts, dur, threading.get_ident(), depth, s.args,
            trace=request.current_trace(),
        )


def traced(name: Optional[str] = None, sync_result: bool = True):
    """Decorator form: wrap a function in a span, syncing on its return
    value by default."""

    def deco(fn):
        label = name or f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not metrics.is_enabled():
                return fn(*a, **kw)
            with span(label) as s:
                out = fn(*a, **kw)
                if sync_result:
                    s.sync(out)
                return out

        return wrapper

    return deco
