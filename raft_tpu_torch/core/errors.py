"""Exception types and check macros (``raft_tpu.core.errors`` counterpart).

Analog of ``core/error.hpp:48,229,245``: ``raft::exception``,
``RAFT_EXPECTS`` and ``RAFT_FAIL``.
"""
from __future__ import annotations


class RaftError(RuntimeError):
    """Base library exception (analog of ``raft::exception``)."""


class LogicError(RaftError):
    """Analog of ``raft::logic_error`` raised by ``RAFT_EXPECTS``."""


class ShardFailure(RaftError):
    """One shard of a distributed operation failed (lost device, failed
    collective participant)."""

    def __init__(self, msg: str = "shard failure", shard: int = -1):
        super().__init__(msg)
        self.shard = shard


class KernelFailure(RaftError):
    """A hand-written CUDA kernel failed to build, load or launch
    (:func:`raft_tpu_torch.ops.guard.kernel_guard`). The port raises it and
    never falls back to another path."""


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


class HostFetchError(RaftError):
    """The host-tier vector fetch behind a tiered search failed after
    exhausting its retries. Carries the batch shape so an operator can
    correlate with the fetch metrics and the ``host.fetch`` fault seam."""

    def __init__(self, msg: str, *, rows: int | None = None, attempts: int | None = None):
        detail = []
        if rows is not None:
            detail.append(f"rows={rows}")
        if attempts is not None:
            detail.append(f"attempts={attempts}")
        super().__init__(f"{msg} [{', '.join(detail)}]" if detail else msg)
        self.rows = rows
        self.attempts = attempts


def expects(cond: bool, msg: str, *args) -> None:
    """Runtime check macro analog of ``RAFT_EXPECTS(cond, fmt, ...)``."""
    if not cond:
        raise LogicError(msg % args if args else msg)


def fail(msg: str, *args) -> None:
    """Unconditional failure (``RAFT_FAIL``)."""
    raise LogicError(msg % args if args else msg)
