"""WAL shipping: leader seals segments, followers replay them
(``raft_tpu.replica.shipping`` counterpart).

The mutable-index replication story is log shipping, the oldest trick
in the replicated-database book, recast onto the repo's existing
crash-consistency machinery instead of a new wire protocol:

* the **leader** is an ordinary directory-backed
  :class:`~raft_tpu_torch.mutable.MutableIndex`. Its WAL already frames every
  mutation with a CRC (``b"WALR" | len | crc32 | payload``) and rotates
  segments at frame boundaries; replication adds only an explicit
  :meth:`~raft_tpu_torch.mutable.wal.WriteAheadLog.seal` — sealed segments
  are immutable, end on a whole record, and are therefore safe to read
  without racing ``append``;
* a :class:`Shipper` moves sealed bytes to one follower through a
  pluggable ``transport`` (default: read the segment file — replicas in
  one process or on one shared filesystem; a network hop slots in
  without touching the protocol). Every chunk crosses the ``wal.ship``
  chaos seam;
* the **follower** (:class:`Follower`) verifies every frame — magic,
  length, CRC, decode — *before* anything is applied, persists the
  verified bytes locally (its own crash story), and replays the records
  into an in-memory :class:`~raft_tpu_torch.mutable.MutableIndex` via
  ``upsert``/``delete`` (an ``insert`` of a not-live id and an
  ``upsert`` of it are byte-identical in the delta, so replay is
  idempotent across restarts). A chunk with a damaged frame raises
  :class:`ShipRejected` at the exact clean-prefix offset: the shipper
  **re-requests from there** — a partial or corrupt record is never
  applied, matching the WAL's own longest-valid-prefix recovery;
* generations follow the **leader's manifest**: when compaction flips
  the leader to a new generation, :meth:`Follower.sync_generation`
  rebases — loads the new generation's main-segment artifacts from the
  leader directory, drops the old generation's shipped files, and
  resumes shipping the new WAL from zero. The follower's
  ``MANIFEST``-equivalent is ``FOLLOWER.json`` (generation, segment,
  offset, applied records), swapped with the same temp-fsync-rename
  idiom as everything else persisted in this repo.

**Bounded staleness**: a follower serves the leader's state as of the
last sealed-and-shipped record — records still in the leader's active
segment are the lag. :class:`Replication` (the per-index pipeline the
:class:`~raft_tpu_torch.replica.group.ReplicaGroup` ticks) seals once the
active segment passes ``seal_bytes``, ships to every follower, and
publishes each lag as ``replica.staleness_records``; the router's
``max_staleness_records`` admission floor turns that gauge into a read
contract.
"""
from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Callable, List, Optional

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import RaftError, expects
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.obs import recorder
from raft_tpu_torch.mutable import manifest as man
from raft_tpu_torch.mutable.segments import MutableIndex, _load_main, _load_rows
from raft_tpu_torch.mutable.wal import _HEADER, _REC_MAGIC, WalRecord, WriteAheadLog
from raft_tpu_torch.mutable.wal import replay as wal_replay
from raft_tpu_torch.robust import faults

POSITION_FILE = "FOLLOWER.json"

#: default transfer chunk (bytes) — small enough that chaos tests see
#: multi-chunk segments, large enough to amortize the per-chunk fsync
DEFAULT_CHUNK_BYTES = 1 << 16


class ShipRejected(RaftError):
    """The follower refused a shipped chunk: a frame failed
    verification (magic/CRC/decode) or a sealed segment ended mid-frame.
    ``offset`` is the follower's clean-prefix high-water mark — the
    byte the shipper must re-request from."""

    def __init__(self, msg: str, *, segment: int, offset: int):
        super().__init__(msg)
        self.segment = int(segment)
        self.offset = int(offset)


class FencedError(RaftError):
    """A shipped chunk carried a stale fencing token: the sender's
    lease epoch is below the follower's fence. This is NOT a transport
    or verification failure — the bytes may be pristine — it is a
    *deposed leader* still shipping. Deliberately not a subclass of
    :class:`ShipRejected`: re-requesting the same bytes can never help,
    so the shipper must not retry; the error propagates to the tick,
    where it is counted and the stale pipeline stays parked."""

    def __init__(self, msg: str, *, epoch: int, fence_epoch: int):
        super().__init__(msg)
        self.epoch = int(epoch)
        self.fence_epoch = int(fence_epoch)


@dataclasses.dataclass(frozen=True)
class FollowerPosition:
    """A follower's durable replication cursor: which leader generation
    it mirrors, the sealed segment it is consuming, the verified byte
    offset within it, and the records applied this generation."""

    generation: int
    segment: int
    offset: int
    applied_records: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(doc: dict) -> "FollowerPosition":
        return FollowerPosition(
            generation=int(doc["generation"]),
            segment=int(doc["segment"]),
            offset=int(doc["offset"]),
            applied_records=int(doc["applied_records"]),
        )


def _read_file_chunk(path: str, offset: int, nbytes: int) -> bytes:
    """The default transport: the leader's segment file is directly
    readable (same process / shared filesystem)."""
    with open(path, "rb") as f:
        f.seek(offset)
        return f.read(nbytes)


class Follower:
    """One bounded-staleness replica of a leader mutable index.

    Serves from an **in-memory** :class:`MutableIndex` (``.index`` —
    what a :class:`~raft_tpu_torch.serve.engine.ServingEngine` registers)
    rebuilt from the leader's manifest artifacts and advanced by
    replaying shipped WAL frames. Its own ``directory`` holds the
    verified shipped bytes plus ``FOLLOWER.json``, so a killed follower
    restarts exactly where it stopped — :meth:`sync_generation` replays
    the local files and lands bit-identical to its pre-kill state. The
    serving index and each generation's main segment live on ``res``'s
    device (``device=``, default ``cuda``).
    """

    def __init__(
        self,
        leader_dir: str,
        directory: str,
        *,
        algo: str,
        dim: int,
        index_params=None,
        search_params=None,
        metric=None,
        name: str = "follower",
        delta_mode: str = "auto",
        res: Optional[Resources] = None,
        device=None,
    ):
        self.leader_dir = leader_dir
        self.directory = directory
        self.algo = algo
        self.dim = int(dim)
        self.index_params = index_params
        self.search_params = search_params
        self.metric = metric
        self.name = str(name)
        self.delta_mode = delta_mode
        #: where the replayed index lives: the generation's main segment
        #: loads there and the delta scans run there (default ``cuda``)
        self.res = ensure_resources(res, device)
        os.makedirs(directory, exist_ok=True)
        self.index: Optional[MutableIndex] = None
        self.position = FollowerPosition(
            generation=-1, segment=0, offset=0, applied_records=0
        )
        #: fencing high-water mark: the highest lease epoch this
        #: follower has accepted a frame under (0 = unfenced — every
        #: non-control-plane pipeline ships at epoch 0 and is accepted).
        #: Single-owner like ``position`` (the shipping tick), so no lock.
        self.fence_epoch = 0
        self.sync_generation()

    def fence(self, epoch: int) -> None:
        """Raise the fencing floor: frames stamped with a lease epoch
        below ``epoch`` are rejected typed from now on (a deposed
        leader's ship can no longer advance this follower). Monotonic —
        fencing never lowers."""
        self.fence_epoch = max(self.fence_epoch, int(epoch))

    # -- generation management ---------------------------------------------

    def _seg_file(self, segment: int) -> str:
        """Local store of the verified bytes of leader segment
        ``segment`` for the current generation."""
        return os.path.join(
            self.directory,
            f"shipped-g{self.position.generation:08d}-{segment:06d}",
        )

    def sync_generation(self) -> bool:
        """Follow the leader's manifest: when its generation moved (or
        on first call / restart), rebuild the serving index from the
        generation's artifacts, drop shipped files from dead
        generations, and replay this generation's locally-persisted
        shipped frames. Durable local bytes outrank the persisted
        cursor — a crash between frame fsync and cursor swap recovers
        forward, and replay-by-upsert makes re-application idempotent.
        Returns True when a rebase happened."""
        m = man.read(self.leader_dir)
        expects(m is not None, "leader directory %r has no manifest", self.leader_dir)
        if self.index is not None and m.generation == self.position.generation:
            return False
        expects(m.algo == self.algo, "leader serves %r, follower built for %r",
                m.algo, self.algo)
        expects(m.dim == self.dim, "leader dim %d, follower dim %d", m.dim, self.dim)
        idx = MutableIndex(
            self.algo, self.dim,
            index_params=self.index_params, search_params=self.search_params,
            metric=self.metric, name=f"{self.name}-g{m.generation}",
            delta_mode=self.delta_mode, res=self.res,
        )
        idx.generation = m.generation
        idx.next_id = m.next_id
        if m.rows is not None:
            ids, data = _load_rows(os.path.join(self.leader_dir, m.rows))
            idx._install_main(ids, data, index=None)
            if m.main is not None:
                idx.main_index = _load_main(
                    self.algo, os.path.join(self.leader_dir, m.main), data, res=self.res
                )
        persisted = self._read_position()
        self.index = idx
        self.position = FollowerPosition(
            generation=m.generation, segment=0, offset=0, applied_records=0
        )
        for fname in sorted(os.listdir(self.directory)):
            if fname.startswith("shipped-") and not fname.startswith(
                f"shipped-g{m.generation:08d}-"
            ):
                os.unlink(os.path.join(self.directory, fname))
        self._replay_local()
        if persisted is not None and persisted.generation == m.generation:
            # the cursor may legitimately be ahead of local content in
            # exactly one way: advance_past persisted a segment bump
            # without writing bytes for the next segment yet
            if (persisted.segment, persisted.offset) > (
                self.position.segment, self.position.offset
            ):
                self.position = dataclasses.replace(
                    persisted,
                    applied_records=max(
                        persisted.applied_records, self.position.applied_records
                    ),
                )
        self._persist_position()
        if obs.is_enabled():
            obs.inc("replica.generation_syncs", follower=self.name)
        return True

    def _replay_local(self) -> None:
        """Rebuild replication state from the locally-persisted shipped
        frames of the current generation (restart path)."""
        gen = self.position.generation
        prefix = f"shipped-g{gen:08d}-"
        seqs: List[int] = []
        for fname in os.listdir(self.directory):
            if fname.startswith(prefix) and fname[len(prefix):].isdigit():
                seqs.append(int(fname[len(prefix):]))
        applied = 0
        seg, off = 0, 0
        for sq in sorted(seqs):
            records, good = wal_replay(
                os.path.join(self.directory, f"{prefix}{sq:06d}")
            )
            for rec in records:
                self._replay(rec)
            applied += len(records)
            seg, off = sq, good
        if seqs:
            self.position = FollowerPosition(
                generation=gen, segment=seg, offset=off, applied_records=applied
            )

    # -- the apply path ----------------------------------------------------

    def apply(self, segment: int, offset: int, data: bytes, *, epoch: int = 0) -> int:
        """Verify and apply one shipped chunk.

        Every frame is checked (magic, length, CRC, payload decode)
        before any of the chunk is applied; the verified clean prefix is
        fsync'd to the local segment file, replayed into the serving
        index, and the cursor swapped — in that order, so a kill at any
        instruction recovers to a state replay reconstructs. A chunk
        that merely *ends* mid-frame is normal chunking (the remainder
        re-ships next call); a damaged frame raises
        :class:`ShipRejected` at the clean-prefix offset AFTER the
        clean prefix was applied, so the shipper re-requests only the
        damaged bytes. Returns bytes consumed.

        ``epoch`` is the sender's fencing token (its lease epoch at
        ship time). A token below :attr:`fence_epoch` raises
        :class:`FencedError` before a single byte is considered — a
        deposed leader cannot corrupt a follower, however valid its
        frames. A token *above* the fence advances it: followers learn
        a new leadership regime from the frames themselves."""
        faults.fire("replica.apply", follower=self.name, segment=segment)
        epoch = int(epoch)
        if epoch < self.fence_epoch:
            obs.inc("replica.fenced_frames", follower=self.name)
            recorder.note_fenced(self.name, epoch, self.fence_epoch)
            raise FencedError(
                f"follower {self.name!r} fenced at epoch {self.fence_epoch} "
                f"rejected a frame stamped epoch {epoch} (deposed sender)",
                epoch=epoch, fence_epoch=self.fence_epoch,
            )
        if epoch > self.fence_epoch:
            self.fence_epoch = epoch
        pos = self.position
        expects(segment == pos.segment,
                "chunk for segment %d but follower is at segment %d",
                segment, pos.segment)
        expects(offset == pos.offset,
                "chunk at offset %d but follower is at offset %d",
                offset, pos.offset)
        records: List[WalRecord] = []
        good, n = 0, len(data)
        bad: Optional[str] = None
        while good < n:
            head = data[good : good + _HEADER.size]
            if len(head) < _HEADER.size:
                break  # chunk ends mid-header: benign, await more bytes
            magic, length, crc = _HEADER.unpack(head)
            if magic != _REC_MAGIC:
                bad = "magic"
                break
            payload = data[good + _HEADER.size : good + _HEADER.size + length]
            if len(payload) < length:
                break  # chunk ends mid-payload: benign
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                bad = "crc"
                break
            try:
                records.append(WalRecord.decode(payload))
            except Exception:
                bad = "decode"
                break
            good += _HEADER.size + length
        if good:
            with open(self._seg_file(segment), "ab") as f:
                f.write(data[:good])
                f.flush()
                os.fsync(f.fileno())
            for rec in records:
                self._replay(rec)
            self.position = dataclasses.replace(
                pos,
                offset=pos.offset + good,
                applied_records=pos.applied_records + len(records),
            )
            self._persist_position()
            if obs.is_enabled():
                obs.set_gauge(
                    "replica.applied_records",
                    float(self.position.applied_records), follower=self.name,
                )
        if bad is not None:
            obs.inc("replica.ship.rejected", follower=self.name, reason=bad)
            raise ShipRejected(
                f"follower {self.name!r} rejected segment {segment} at offset "
                f"{self.position.offset}: frame failed {bad} verification",
                segment=segment, offset=self.position.offset,
            )
        return good

    def advance_past(self, segment: int) -> None:
        """The shipper's signal that leader segment ``segment`` is fully
        consumed: move the cursor to the start of the next one."""
        pos = self.position
        expects(segment == pos.segment, "cannot advance past segment %d from %d",
                segment, pos.segment)
        self.position = dataclasses.replace(pos, segment=segment + 1, offset=0)
        self._persist_position()

    def _replay(self, rec: WalRecord) -> None:
        """One record into the serving index. ``insert`` replays as
        ``upsert``: identical bytes in the delta when the id is not
        live, and idempotent when a restart replays it twice."""
        if rec.op in ("insert", "upsert"):
            self.index.upsert(rec.ids, rec.vectors)
        else:
            self.index.delete(rec.ids)

    # -- cursor persistence ------------------------------------------------

    def _position_path(self) -> str:
        return os.path.join(self.directory, POSITION_FILE)

    def _read_position(self) -> Optional[FollowerPosition]:
        path = self._position_path()
        if not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return FollowerPosition.from_dict(json.loads(f.read()))

    def _persist_position(self) -> None:
        path = self._position_path()
        tmp = path + f".tmp{os.getpid()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(self.position.as_dict(), indent=2, sort_keys=True))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def snapshot(self):
        """The follower's current search view (delegates to the serving
        index) — what a reader at this replica sees."""
        return self.index.snapshot()


class Shipper:
    """Moves sealed WAL frames from one leader log to one follower.

    ``wal_source`` is the leader's :class:`WriteAheadLog` or a callable
    returning it — compaction replaces the leader's log object at every
    generation flip, so the pipeline passes ``lambda: leader.wal``.
    ``transport(path, offset, nbytes) -> bytes`` abstracts the byte
    transfer; a rejected chunk (CRC damage in flight) is **re-requested
    from the follower's clean-prefix offset** up to ``max_retries``
    times per segment before the error propagates to the tick.

    ``epoch_source`` is the control plane's fencing hook: a callable
    returning the sender's *current* lease epoch, read per chunk so the
    token is fresh at every seal→ship→apply hop. Without one, chunks
    ship at epoch 0 (the unfenced, pre-control-plane protocol).
    """

    def __init__(
        self,
        wal_source,
        follower: Follower,
        *,
        transport: Optional[Callable[[str, int, int], bytes]] = None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        max_retries: int = 2,
        epoch_source: Optional[Callable[[], int]] = None,
    ):
        self._wal_source = wal_source
        self.follower = follower
        self.transport = transport if transport is not None else _read_file_chunk
        self.chunk_bytes = int(chunk_bytes)
        self.max_retries = int(max_retries)
        self.epoch_source = epoch_source

    def _wal(self) -> WriteAheadLog:
        w = self._wal_source
        return w() if callable(w) else w

    def ship(self) -> int:
        """Ship every sealed frame the follower has not applied yet;
        returns the number of records the follower applied."""
        wal = self._wal()
        before = self.follower.position.applied_records
        for sq, sp in wal.sealed_segments():
            if sq < self.follower.position.segment:
                continue  # fully consumed in an earlier tick
            self._ship_segment(sq, sp)
        return self.follower.position.applied_records - before

    def _ship_segment(self, sq: int, sp: str) -> None:
        size = os.path.getsize(sp)
        rejections = 0
        chunk = self.chunk_bytes
        while self.follower.position.offset < size:
            pos = self.follower.position
            nbytes = min(chunk, size - pos.offset)
            faults.fire(
                "wal.ship",
                segment=sq, offset=pos.offset, nbytes=nbytes,
                follower=self.follower.name,
            )
            data = self.transport(sp, pos.offset, nbytes)
            if obs.is_enabled():
                obs.inc("replica.ship.bytes", float(len(data)),
                        follower=self.follower.name)
            epoch = int(self.epoch_source()) if self.epoch_source is not None else 0
            try:
                consumed = self.follower.apply(sq, pos.offset, data, epoch=epoch)
            except ShipRejected:
                rejections += 1
                if rejections > self.max_retries:
                    raise
                # re-request: the follower applied the clean prefix and
                # its cursor now sits exactly on the damaged byte
                continue
            if consumed == 0:
                if pos.offset + len(data) >= size:
                    # a sealed segment may never end mid-frame — this is
                    # storage/transport truncation, not chunking
                    rejections += 1
                    obs.inc("replica.ship.rejected",
                            follower=self.follower.name, reason="torn_tail")
                    if rejections > self.max_retries:
                        raise ShipRejected(
                            f"sealed segment {sq} of {sp!r} ends mid-frame at "
                            f"offset {pos.offset}",
                            segment=sq, offset=pos.offset,
                        )
                else:
                    # one frame larger than the chunk: widen and re-read
                    chunk *= 2
                continue
        self.follower.advance_past(sq)


class Replication:
    """The per-index replication pipeline: one leader, N followers,
    one :meth:`tick` the serving layer drives.

    Each tick: follow the leader's manifest generation, seal the
    leader's active segment once it passes ``seal_bytes``, ship sealed
    frames to every follower, and publish each follower's record lag
    (``replica.staleness_records``). :meth:`indexes` hands the group
    one serving handle per replica — the leader itself, then each
    follower's in-memory index."""

    def __init__(
        self,
        leader: MutableIndex,
        followers: List[Follower],
        *,
        seal_bytes: int = DEFAULT_CHUNK_BYTES,
        transports: Optional[List[Optional[Callable]]] = None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        max_retries: int = 2,
        epoch_source: Optional[Callable[[], int]] = None,
    ):
        expects(leader.directory is not None and leader.wal is not None,
                "replication needs a directory-backed (WAL-carrying) leader")
        expects(len(followers) >= 1, "replication needs at least one follower")
        expects(seal_bytes >= 1, "seal_bytes must be >= 1")
        self.leader = leader
        self.followers = list(followers)
        self.seal_bytes = int(seal_bytes)
        self._chunk_bytes = int(chunk_bytes)
        self._max_retries = int(max_retries)
        #: the fencing token source every shipper stamps chunks with —
        #: a :class:`~raft_tpu_torch.replica.control.ControlPlane` points this
        #: at its lease epoch; None ships at epoch 0 (unfenced)
        self.epoch_source = epoch_source
        #: attached control plane (lease/election coordinator) — ticked
        #: first on every :meth:`tick` when present
        self.controller = None
        #: False while the leader is known dead and no successor has
        #: been elected yet: the pipeline parks (no seal, no ship)
        #: instead of pumping a corpse's WAL
        self.active = True
        self._handles_changed = False
        if transports is None:
            transports = [None] * len(self.followers)
        self._transports = list(transports)
        self.shippers = [self._mk_shipper(f, t)
                         for f, t in zip(self.followers, self._transports)]

    def _mk_shipper(self, f: Follower, t: Optional[Callable]) -> Shipper:
        return Shipper(
            lambda: self.leader.wal, f,
            transport=t, chunk_bytes=self._chunk_bytes,
            max_retries=self._max_retries, epoch_source=self._epoch,
        )

    def _epoch(self) -> int:
        src = self.epoch_source
        return int(src()) if src is not None else 0

    # -- control-plane reconfiguration --------------------------------------

    def replace(
        self,
        leader: MutableIndex,
        followers: List[Follower],
        *,
        transports: Optional[List[Optional[Callable]]] = None,
    ) -> None:
        """Swap in a whole new leader + follower set (what a promotion
        builds) and rebuild the shippers. Serving handles changed:
        :meth:`take_handles_changed` tells the replica group to
        re-register every engine."""
        expects(leader.directory is not None and leader.wal is not None,
                "replication needs a directory-backed (WAL-carrying) leader")
        expects(len(followers) >= 1, "replication needs at least one follower")
        if transports is None:
            transports = [None] * len(followers)
        self.leader = leader
        self.followers = list(followers)
        self._transports = list(transports)
        self.shippers = [self._mk_shipper(f, t)
                         for f, t in zip(self.followers, self._transports)]
        self.active = True
        self._handles_changed = True

    def add_follower(self, follower: Follower, transport: Optional[Callable] = None) -> None:
        """Grow the pipeline by one follower (replica scale-up)."""
        self.followers = self.followers + [follower]
        self._transports = self._transports + [transport]
        self.shippers = self.shippers + [self._mk_shipper(follower, transport)]
        self._handles_changed = True

    def remove_follower(self) -> Follower:
        """Retire the last follower (replica scale-down); the caller
        has already drained its replica."""
        expects(len(self.followers) >= 2,
                "cannot retire the last follower of a replication")
        f = self.followers[-1]
        self.followers = self.followers[:-1]
        self._transports = self._transports[:-1]
        self.shippers = self.shippers[:-1]
        self._handles_changed = True
        return f

    def take_handles_changed(self) -> bool:
        """True exactly once after a reconfiguration changed
        :meth:`indexes` — the group's cue to re-register engines."""
        changed, self._handles_changed = self._handles_changed, False
        return changed

    def tick(self) -> int:
        """One seal → ship → publish cycle; returns records applied
        across followers. A follower whose ship fails this tick keeps
        its clean prefix and retries next tick — the error (transport,
        verification, or a stale fencing token) is counted, never
        raised into the serving loop."""
        if self.controller is not None:
            self.controller.tick()
        if not self.active:
            return 0
        for f in self.followers:
            f.sync_generation()
        wal = self.leader.wal
        if wal is not None and wal.offset >= self.seal_bytes:
            wal.seal()
        applied = 0
        for f, sh in zip(self.followers, self.shippers):
            try:
                applied += sh.ship()
            except (ShipRejected, FencedError, OSError) as e:
                obs.inc("replica.ship.errors", follower=f.name,
                        kind=type(e).__name__)
        if obs.is_enabled():
            for i, f in enumerate(self.followers):
                obs.set_gauge("replica.staleness_records",
                              float(self.staleness(i)), follower=f.name)
        return applied

    def staleness(self, i: int) -> int:
        """Follower ``i``'s lag in WAL records behind the leader's
        durable high-water mark (a whole generation behind counts as
        the full log)."""
        f = self.followers[i]
        wal = self.leader.wal
        total = wal.record_count() if wal is not None else 0
        if f.position.generation != self.leader.generation:
            return total
        return max(total - f.position.applied_records, 0)

    def indexes(self) -> List[object]:
        """One serving handle per replica: the leader, then each
        follower's in-memory index (replica ``j+1`` serves follower
        ``j`` — the ordering :meth:`~raft_tpu_torch.replica.group.
        ReplicaGroup.register_mutable_replicated` assumes)."""
        return [self.leader] + [f.index for f in self.followers]
