"""Crash-consistent write-ahead log for mutable indexes
(``raft_tpu.mutable.wal`` counterpart; its files are the JAX package's,
byte for byte, so a log written by either package replays in the other).

Every mutation (insert/delete/upsert) is **durable before it is
visible**: the op is framed, CRC32-checksummed, appended, flushed, and
fsync'd to the generation's WAL *before* the in-memory delta segment or
tombstone bitset changes. A reader recovering after a crash replays
whatever prefix of the log survived: the frame discipline is the same
envelope idea as serialization v4
(:func:`raft_tpu_torch.core.serialize.save_stream`) — length + CRC ahead
of the payload — applied per record, so a torn tail (partial header,
partial payload, or bit rot) truncates cleanly to the last whole record
instead of poisoning the whole log.

Frame layout (little-endian)::

    b"WALR" | u32 payload_len | u32 crc32(payload) | payload

Payload: ``op`` string, ``ids`` int64 array, has-vectors flag, and the
``vectors`` float array when the op carries rows, all via the
:mod:`raft_tpu_torch.core.serialize` primitives.

The chaos seam ``wal.append`` (:mod:`raft_tpu_torch.robust.faults`) fires
twice per append — ``stage="pre"`` before any byte is written (a crash
here loses the mutation entirely: pre-state on recovery) and
``stage="post"`` after the fsync (the mutation is durable but the
caller never saw it applied: post-state on recovery). Both outcomes
are legal; a *mixed* state is not.

Segment rotation (``max_bytes``): when set, :meth:`WriteAheadLog.append`
rotates at a *frame boundary* — the active segment is sealed
(flush + fsync + close) and a fresh ``<path>.NNNNNN`` segment opens —
whenever the next frame would push the segment past the limit (a
single oversized frame still lands whole; frames are never split).
:meth:`WriteAheadLog.open` replays all segments in sequence order.
Only the *last* (active) segment may legally carry a torn tail —
sealed segments were fsync'd before rotation — so a tear found in a
sealed segment orphans every later segment.
"""
from __future__ import annotations

import dataclasses
import io
import os
import struct
import zlib
from typing import BinaryIO, List, Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.robust import faults

_REC_MAGIC = b"WALR"
_HEADER = struct.Struct("<4sII")  # magic, payload_len, crc32

#: mutation kinds a WAL record may carry
OPS = ("insert", "delete", "upsert")


@dataclasses.dataclass(frozen=True)
class WalRecord:
    """One durable mutation: the op kind, the global ids it touches,
    and (for insert/upsert) the rows themselves."""

    op: str
    ids: np.ndarray  # int64[n]
    vectors: Optional[np.ndarray] = None  # float32[n, dim] for insert/upsert

    def encode(self) -> bytes:
        buf = io.BytesIO()
        ser.serialize_string(buf, self.op)
        ser.serialize_array(buf, np.asarray(self.ids, np.int64))
        ser.serialize_scalar(buf, int(self.vectors is not None), "uint32")
        if self.vectors is not None:
            ser.serialize_array(buf, np.asarray(self.vectors, np.float32))
        return buf.getvalue()

    @staticmethod
    def decode(payload: bytes) -> "WalRecord":
        buf = io.BytesIO(payload)
        op = ser.deserialize_string(buf)
        ids = ser.to_numpy(ser.deserialize_array(buf))
        has_vecs = bool(ser.deserialize_scalar(buf, "uint32"))
        vectors = ser.to_numpy(ser.deserialize_array(buf)) if has_vecs else None
        return WalRecord(op=op, ids=ids, vectors=vectors)


def _segment_path(path: str, seq: int) -> str:
    """Segment ``seq`` of the log rooted at ``path``: the base file is
    segment 0 (backwards compatible with pre-rotation logs), rotations
    append ``.000001``, ``.000002``, ..."""
    return path if seq == 0 else f"{path}.{seq:06d}"


def _list_segments(path: str) -> List[Tuple[int, str]]:
    """All on-disk segments of the log at ``path`` in sequence order.
    Always includes segment 0 (even when the file does not exist yet) so
    callers have an active segment to create."""
    seqs = {0}
    parent = os.path.dirname(os.path.abspath(path))
    base = os.path.basename(path)
    if os.path.isdir(parent):
        for name in os.listdir(parent):
            if name.startswith(base + "."):
                suffix = name[len(base) + 1 :]
                if suffix.isdigit():
                    seqs.add(int(suffix))
    return [(s, _segment_path(path, s)) for s in sorted(seqs)]


def segment_paths(path: str) -> List[str]:
    """Existing segment files of the log at ``path`` (for cleanup when a
    generation is superseded)."""
    return [sp for _, sp in _list_segments(path) if os.path.exists(sp)]


def replay(path: str, start: int = 0) -> Tuple[List[WalRecord], int]:
    """Read the longest valid prefix of the log at ``path``.

    Returns ``(records, good_offset)`` where ``good_offset`` is the byte
    offset just past the last whole, CRC-clean frame. Anything beyond it
    is a torn tail (truncated header, truncated payload, magic or bit
    damage) — counted in ``mutable.wal.torn_tail_bytes`` and meant to be
    truncated away by :meth:`WriteAheadLog.open`. A missing file is an
    empty log. ``start`` skips to a byte offset that must sit on a frame
    boundary (e.g. one recorded by :meth:`WriteAheadLog.position`) —
    background compaction uses it to read only the records that landed
    after its pin.
    """
    records: List[WalRecord] = []
    good = start
    if not os.path.exists(path):
        return records, good
    with open(path, "rb") as f:
        data = f.read()
    n = len(data)
    while good < n:
        head = data[good : good + _HEADER.size]
        if len(head) < _HEADER.size:
            break
        magic, length, crc = _HEADER.unpack(head)
        if magic != _REC_MAGIC:
            break
        payload = data[good + _HEADER.size : good + _HEADER.size + length]
        if len(payload) < length or zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break
        try:
            records.append(WalRecord.decode(payload))
        except Exception:
            # a frame whose CRC passes but whose payload cannot decode is
            # still a torn/foreign tail — stop at the last good record
            break
        good += _HEADER.size + length
    torn = max(n - good, 0)
    if torn and obs.is_enabled():
        obs.inc("mutable.wal.torn_tail_bytes", float(torn))
    return records, good


class WriteAheadLog:
    """Append-only durable mutation log (one per index generation).

    Use :meth:`open` — it replays the valid prefix, truncates any torn
    tail, and positions the write cursor for appends.
    """

    def __init__(
        self,
        path: str,
        fh: BinaryIO,
        offset: int,
        max_bytes: Optional[int] = None,
        seq: int = 0,
    ):
        self.path = path  # base path; the active segment is _segment_path(path, seq)
        self._fh = fh
        self._offset = offset  # write cursor within the active segment
        self._max_bytes = max_bytes
        self._seq = seq
        #: durable records in this log (recovered at open + appended since)
        self._records = 0

    @classmethod
    def open(
        cls, path: str, max_bytes: Optional[int] = None
    ) -> Tuple["WriteAheadLog", List[WalRecord]]:
        """Open (creating if missing) the log at ``path``; returns the
        log plus the records recovered from its valid prefix. Rotated
        segments replay in sequence order; only the last may carry a
        torn tail (it is truncated away) — a tear in a *sealed* segment
        stops recovery there and unlinks the later, orphaned segments.
        ``max_bytes`` arms size-triggered rotation for future appends."""
        segments = _list_segments(path)
        records: List[WalRecord] = []
        seq, seg_path, good = segments[0][0], segments[0][1], 0
        for i, (sq, sp) in enumerate(segments):
            recs, sp_good = replay(sp)
            records.extend(recs)
            seq, seg_path, good = sq, sp, sp_good
            size = os.path.getsize(sp) if os.path.exists(sp) else 0
            if sp_good != size and i != len(segments) - 1:
                for _, orphan in segments[i + 1 :]:
                    try:
                        os.unlink(orphan)
                    except OSError:  # orphan cleanup is advisory
                        pass
                break
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        # "a+b" creates when missing; reopen r+b to truncate a torn tail
        fh = open(seg_path, "a+b")
        fh.seek(0, os.SEEK_END)
        if fh.tell() != good:
            fh.close()
            fh = open(seg_path, "r+b")
            fh.truncate(good)
            fh.seek(good)
            fh.flush()
            os.fsync(fh.fileno())
        if obs.is_enabled() and records:
            obs.inc("mutable.wal.replayed", float(len(records)))
        log = cls(path, fh, good, max_bytes=max_bytes, seq=seq)
        log._records = len(records)
        return log, records

    @property
    def offset(self) -> int:
        return self._offset

    @property
    def segment(self) -> int:
        """Sequence number of the active segment."""
        return self._seq

    def segment_paths(self) -> List[str]:
        """Existing segment files of this log, sequence order."""
        return segment_paths(self.path)

    def record_count(self) -> int:
        """Durable records in this log: the valid prefix recovered at
        :meth:`open` plus everything appended since."""
        return self._records

    def seal(self) -> bool:
        """Explicitly seal the active segment so its frames become
        shippable (a log shipper reads only sealed segments, which are
        immutable and end on a frame boundary). A no-op on an empty active segment:
        rotating then would mint empty sealed files. Returns True when
        a rotation actually happened. Counted in ``mutable.wal.seals``."""
        if self._offset == 0:
            return False
        self._rotate()
        if obs.is_enabled():
            obs.inc("mutable.wal.seals")
        return True

    def sealed_segments(self) -> List[Tuple[int, str]]:
        """The immutable ``(seq, path)`` segments of this log — every
        on-disk segment strictly before the active one. Sealed segments
        were flushed + fsync'd at rotation and are never written again,
        so a shipper may read them without racing :meth:`append`; a torn
        frame found in one is transport/storage damage, never an
        in-progress write."""
        return [
            (sq, sp)
            for sq, sp in _list_segments(self.path)
            if sq < self._seq and os.path.exists(sp)
        ]

    def position(self) -> Tuple[int, int]:
        """The durable high-water mark ``(segment, offset)`` — always a
        frame boundary. Background compaction records it at pin time;
        :meth:`read_from` later returns exactly the records appended
        after it."""
        return (self._seq, self._offset)

    def read_from(self, pos: Tuple[int, int]) -> List[WalRecord]:
        """Every record appended after ``pos`` (a :meth:`position`
        result): the tail of that segment plus all later segments, in
        order. The durable source of truth for compaction catch-up —
        what landed on disk is what replays, regardless of what any
        in-memory view saw."""
        seq0, off0 = pos
        records: List[WalRecord] = []
        for sq, sp in _list_segments(self.path):
            if sq < seq0:
                continue
            recs, _ = replay(sp, start=off0 if sq == seq0 else 0)
            records.extend(recs)
        return records

    def total_bytes(self) -> int:
        """Bytes on disk across all segments — the ``wal_bytes``
        auto-compaction trigger reads this."""
        total = 0
        for sp in self.segment_paths():
            try:
                total += os.path.getsize(sp)
            except OSError:  # raced unlink; the size is advisory
                pass
        return total

    def _rotate(self) -> None:
        """Seal the active segment and start the next one. Called only
        at a frame boundary, so the sealed file ends on a whole record;
        the directory entry for the new segment is fsync'd so a crash
        right after rotation recovers the sealed prefix plus an empty
        (or torn-tail-truncated) active segment — never a gap."""
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._seq += 1
        nxt = _segment_path(self.path, self._seq)
        fh = open(nxt, "a+b")
        fh.seek(0, os.SEEK_END)
        dfd = os.open(os.path.dirname(os.path.abspath(nxt)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._fh = fh
        self._offset = fh.tell()
        if obs.is_enabled():
            obs.inc("mutable.wal.rotations")
            obs.set_gauge("mutable.wal.segments", float(self._seq + 1))

    def append(self, record: WalRecord) -> int:
        """Make ``record`` durable (write + flush + fsync); returns the
        offset past the appended frame within the active segment. The
        caller applies the mutation to the in-memory segments only
        after this returns."""
        expects(record.op in OPS, "unknown WAL op %r", record.op)
        payload = record.encode()
        frame = _HEADER.pack(_REC_MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
        # chaos seam: a crash before any byte lands loses the mutation
        # (pre-state on recovery) ...
        faults.fire("wal.append", op=record.op, stage="pre")
        if (
            self._max_bytes is not None
            and self._offset > 0
            and self._offset + len(frame) > self._max_bytes
        ):
            self._rotate()
        self._fh.seek(self._offset)
        self._fh.write(frame)
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._offset += len(frame)
        self._records += 1
        # ... and a crash after the fsync leaves it durable but
        # unacknowledged (post-state on recovery)
        faults.fire("wal.append", op=record.op, stage="post")
        if obs.is_enabled():
            obs.inc("mutable.wal.records", op=record.op)
            obs.inc("mutable.wal.bytes", float(len(frame)))
        return self._offset

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:  # a double close on teardown is benign
            pass
