"""Exception types and check macros (``raft_tpu.core.errors`` counterpart).

Analog of ``core/error.hpp:48,229,245``: ``raft::exception``,
``RAFT_EXPECTS`` and ``RAFT_FAIL``.
"""
from __future__ import annotations


class RaftError(RuntimeError):
    """Base library exception (analog of ``raft::exception``)."""


class LogicError(RaftError):
    """Analog of ``raft::logic_error`` raised by ``RAFT_EXPECTS``."""


class CorruptIndexError(RaftError):
    """A serialized index snapshot failed its integrity check (bad CRC,
    truncated payload). Raised by
    :func:`raft_tpu_torch.core.serialize.load_stream`.

    ``offset`` is the stream position of the failing frame's payload;
    ``expected_crc`` / ``actual_crc`` are set on checksum mismatch (both
    None on truncation)."""

    def __init__(
        self,
        msg: str,
        *,
        offset: int | None = None,
        expected_crc: int | None = None,
        actual_crc: int | None = None,
    ):
        detail = []
        if offset is not None:
            detail.append(f"offset={offset}")
        if expected_crc is not None:
            detail.append(f"expected_crc=0x{expected_crc:08x}")
        if actual_crc is not None:
            detail.append(f"actual_crc=0x{actual_crc:08x}")
        super().__init__(f"{msg} [{', '.join(detail)}]" if detail else msg)
        self.offset = offset
        self.expected_crc = expected_crc
        self.actual_crc = actual_crc


def expects(cond: bool, msg: str, *args) -> None:
    """Runtime check macro analog of ``RAFT_EXPECTS(cond, fmt, ...)``."""
    if not cond:
        raise LogicError(msg % args if args else msg)


def fail(msg: str, *args) -> None:
    """Unconditional failure (``RAFT_FAIL``)."""
    raise LogicError(msg % args if args else msg)
