"""Library logger (``raft_tpu.core.logging`` counterpart): the reference's
spdlog-backed ``raft::logger`` (``core/logger-inl.hpp:72-140``) with a
settable level, pattern and callback sink, and the
``RAFT_LOG_{TRACE..CRITICAL}`` macros (``core/logger-macros.hpp:81-102``).

One stdlib logger, ``"raft_tpu_torch"``, with the reference's level
numbering (OFF = 0 .. TRACE = 6) and an optional callback sink.
"""
from __future__ import annotations

import logging as _logging
from typing import Callable, Optional

# Reference level numbering (core/logger-macros.hpp): OFF=0 .. TRACE=6.
LEVEL_OFF = 0
LEVEL_CRITICAL = 1
LEVEL_ERROR = 2
LEVEL_WARN = 3
LEVEL_INFO = 4
LEVEL_DEBUG = 5
LEVEL_TRACE = 6

_TO_PY = {
    LEVEL_OFF: _logging.CRITICAL + 10,
    LEVEL_CRITICAL: _logging.CRITICAL,
    LEVEL_ERROR: _logging.ERROR,
    LEVEL_WARN: _logging.WARNING,
    LEVEL_INFO: _logging.INFO,
    LEVEL_DEBUG: _logging.DEBUG,
    LEVEL_TRACE: 5,
}

logger = _logging.getLogger("raft_tpu_torch")
logger.addHandler(_logging.NullHandler())

_callback: Optional[Callable[[int, str], None]] = None


class _CallbackHandler(_logging.Handler):
    def emit(self, record):
        if _callback is not None:
            _callback(record.levelno, self.format(record))


_cb_handler = _CallbackHandler()


def set_level(level: int) -> None:
    """Set verbosity in the reference's 0..6 numbering."""
    logger.setLevel(_TO_PY.get(level, _logging.INFO))


def get_level() -> int:
    eff = logger.getEffectiveLevel()
    for k, v in _TO_PY.items():
        if v == eff:
            return k
    return LEVEL_INFO


def set_callback(cb: Optional[Callable[[int, str], None]]) -> None:
    """Install (or with None remove) a callback sink ``cb(levelno, msg)``
    (``logger::set_callback``)."""
    global _callback
    _callback = cb
    if cb is not None and _cb_handler not in logger.handlers:
        logger.addHandler(_cb_handler)
    if cb is None and _cb_handler in logger.handlers:
        logger.removeHandler(_cb_handler)


def set_pattern(fmt: str) -> None:
    """Set the sink's format string (``logger::set_pattern``)."""
    _cb_handler.setFormatter(_logging.Formatter(fmt))


# RAFT_LOG_* macro analogs
trace = lambda msg, *a: logger.log(5, msg, *a)  # noqa: E731
debug = logger.debug
info = logger.info
warn = logger.warning
error = logger.error
critical = logger.critical
