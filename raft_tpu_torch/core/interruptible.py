"""Cooperative cancellation of long-running host loops
(``raft_tpu.core.interruptible`` counterpart; reference
``core/interruptible.hpp:73-170``).

Each thread has a token; :func:`cancel` sets another thread's, and that
thread raises :class:`InterruptedException` at its next :func:`yield_` or
:func:`synchronize`. :func:`synchronize` waits for CUDA work by polling an
event recorded on the current stream and checking the token between polls,
as the reference's spin-wait stream sync does, so a cancelled thread does
not stay blocked in a device wait.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

import torch

from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.utils import lockcheck

#: seconds between polls of the event :func:`synchronize` waits on
POLL_S = 1e-4


class InterruptedException(RaftError):
    """Raised inside a cancelled thread at its next yield or synchronize."""


_tokens: Dict[int, threading.Event] = {}
_lock = lockcheck.tracked(threading.Lock(), "core.interruptible")


def _token(tid: int | None = None) -> threading.Event:
    tid = threading.get_ident() if tid is None else tid
    with _lock:
        ev = _tokens.get(tid)
        if ev is None:
            ev = threading.Event()
            _tokens[tid] = ev
        return ev


def cancel(thread_id: int) -> None:
    """Request cancellation of another thread (``interruptible::cancel``)."""
    _token(thread_id).set()


def yield_() -> None:
    """Check and clear this thread's token, raising if it was set
    (``interruptible::yield``)."""
    ev = _token()
    if ev.is_set():
        ev.clear()
        raise InterruptedException("raft_tpu_torch: computation interrupted")


def yield_no_throw() -> bool:
    """Check and clear; True if a cancellation was pending."""
    ev = _token()
    if ev.is_set():
        ev.clear()
        return True
    return False


def _on_cuda(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, (tuple, list)):
        return any(_on_cuda(v) for v in value)
    if isinstance(value, dict):
        return any(_on_cuda(v) for v in value.values())
    return False


def synchronize(value=None):
    """Cancellation-aware sync point (``interruptible::synchronize``):
    check the token; if ``value`` (a tensor, or a tuple, list or dict of
    them) lies on a card, record an event on the current stream and poll
    it, checking the token between polls. Returns ``value``."""
    yield_()
    if value is not None and _on_cuda(value):
        ev = torch.cuda.Event()
        ev.record()
        while not ev.query():
            yield_()
            time.sleep(POLL_S)
        yield_()
    return value
