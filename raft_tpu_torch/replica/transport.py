"""A real socket transport behind the ``Shipper.transport`` seam
(``raft_tpu.replica.transport`` counterpart).

The shipping protocol (:mod:`raft_tpu_torch.replica.shipping`) was designed
so "a network hop slots in without touching the protocol" — this module
is that hop. A :class:`SegmentServer` exports a leader's sealed WAL
segment files over length-framed TCP; a :class:`SocketTransport` is the
``transport(path, offset, nbytes) -> bytes`` callable a
:class:`~raft_tpu_torch.replica.shipping.Shipper` plugs in.

**Framing** reuses the WAL's own record envelope — ``b"WALR" | u32 len
| u32 crc32 | payload`` (:data:`raft_tpu_torch.mutable.wal._HEADER`) — for
both the request (a JSON ``{path, offset, nbytes}`` body) and the
response (one status byte + the segment bytes). The client verifies
the envelope CRC before returning, so *wire* damage is caught at the
transport and retried; *content* damage (a corrupted segment file, or
a chaos ``mangle`` hook below) passes the envelope intact and is
caught by the follower's per-frame verification — surfacing as the
existing :class:`~raft_tpu_torch.replica.shipping.ShipRejected`
clean-prefix/re-request path, now exercised over a wire that can
actually drop, truncate, and reorder.

**Failure containment**: every fetch crosses the ``transport.read``
chaos seam, runs under a seeded-backoff :func:`~raft_tpu_torch.robust.retry.
retry_call` (injectable ``sleep`` — virtual-clock tests assert the
schedule), and is gated by a per-peer :class:`~raft_tpu_torch.robust.retry.
CircuitBreaker` so a dead peer costs one connection attempt per reset
window, not one per chunk. Terminal failures raise
:class:`TransportError` — an ``OSError`` subclass *by contract*:
``Replication.tick`` catches ``(ShipRejected, FencedError, OSError)``
and counts them, so a dead wire degrades to bounded staleness, never
into the serving loop. Socket timeouts bound every blocking call — a
slow peer is a typed timeout, never a hang.

The server's accept loop is one daemon thread, joined by
:meth:`SegmentServer.close`; requests are one-shot (one frame in, one
frame out, close), so the server holds no per-client state and needs
no lock. The client is lock-free by the same single-owner discipline
as the shipper that calls it.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Optional

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.mutable.wal import _HEADER, _REC_MAGIC
from raft_tpu_torch.robust import faults
from raft_tpu_torch.robust.retry import CircuitBreaker, RetryError, RetryPolicy, retry_call

#: response status bytes (first payload byte)
_ST_OK = b"\x00"
_ST_ERR = b"\x01"

#: cap on a single framed payload crossing the wire — a request is tiny
#: and a response is at most one ship chunk (chunk-widening doubles from
#: 64 KiB), so anything near this is a corrupt length field, not data
_MAX_FRAME = 1 << 28


class TransportError(OSError):
    """A segment fetch failed terminally (retries exhausted, breaker
    open, torn frame, or peer timeout). Subclasses :class:`OSError`
    so ``Replication.tick``'s existing catch contains it — a transport
    death is bounded staleness, not a serving error."""


def _frame(payload: bytes) -> bytes:
    return _HEADER.pack(_REC_MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise: a peer that hangs up mid-frame
    is a torn wire, typed — never silently short."""
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise TransportError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)"
            )
        buf.extend(chunk)
    return bytes(buf)


def _read_frame(conn: socket.socket) -> bytes:
    """One CRC-verified framed payload off the socket."""
    head = _recv_exact(conn, _HEADER.size)
    try:
        magic, length, crc = _HEADER.unpack(head)
    except struct.error as e:  # pragma: no cover - _recv_exact guarantees size
        raise TransportError(f"unreadable frame header: {e}")
    if magic != _REC_MAGIC:
        raise TransportError(f"bad frame magic {magic!r}")
    if length > _MAX_FRAME:
        raise TransportError(f"frame length {length} exceeds cap {_MAX_FRAME}")
    payload = _recv_exact(conn, length)
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise TransportError("frame CRC mismatch (damaged in flight)")
    return payload


class SegmentServer:
    """Serves chunk reads of files under ``root`` over TCP.

    One request per connection: a framed JSON ``{path, offset,
    nbytes}`` in, a framed ``status + bytes`` out. Paths are validated
    to resolve under ``root`` — the server never reads outside the
    leader directory it was built for.

    The chaos hooks exist for the transport's own test matrix:
    ``mangle`` rewrites the segment bytes *before* framing (content
    damage the client's envelope CRC cannot see — the follower's frame
    verification must catch it), ``truncate_wire`` cuts the response
    off mid-frame (a torn wire the client retries), and ``delay_s``
    stalls before replying (a slow peer the client times out on).
    """

    def __init__(self, root: str, *, host: str = "127.0.0.1"):
        self.root = os.path.realpath(root)
        #: test hooks (see class docstring); None/0 = healthy server
        self.mangle: Optional[Callable[[bytes], bytes]] = None
        self.truncate_wire: Optional[int] = None
        self.delay_s: float = 0.0
        self._sock = socket.create_server((host, 0))
        self._sock.settimeout(0.1)  # bounded accept wait → prompt close()
        self.host, self.port = self._sock.getsockname()[:2]
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name=f"segment-server:{self.port}", daemon=True
        )
        self._thread.start()

    def address(self):
        return self.host, self.port

    def close(self) -> None:
        """Stop accepting and join the accept loop."""
        self._stopped.set()
        self._thread.join(timeout=5.0)
        self._sock.close()

    # -- the accept loop ----------------------------------------------------

    def _serve(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # socket closed under us during shutdown
            try:
                with conn:
                    conn.settimeout(2.0)
                    self._handle(conn)
            except Exception as e:
                # a broken client must never kill the accept loop; count
                # it — the client side surfaces its own typed error
                # (label is the constant "server": ports are ephemeral
                # and would mint unbounded series)
                obs.inc(
                    "replica.transport.errors",
                    peer="server", kind=type(e).__name__,
                )

    def _handle(self, conn: socket.socket) -> None:
        req = json.loads(_read_frame(conn).decode("utf-8"))
        path = os.path.realpath(str(req["path"]))
        offset = int(req["offset"])
        nbytes = int(req["nbytes"])
        if path != self.root and not path.startswith(self.root + os.sep):
            conn.sendall(_frame(_ST_ERR + b"path outside served root"))
            return
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(nbytes)
        except OSError as e:
            conn.sendall(_frame(_ST_ERR + str(e).encode("utf-8")))
            return
        if self.mangle is not None:
            data = self.mangle(data)
        if self.delay_s > 0.0:
            time.sleep(self.delay_s)
        wire = _frame(_ST_OK + data)
        if self.truncate_wire is not None:
            wire = wire[: self.truncate_wire]
        conn.sendall(wire)


class SocketTransport:
    """The ``transport(path, offset, nbytes) -> bytes`` callable that
    fetches from a :class:`SegmentServer` peer.

    One fetch = chaos seam → breaker gate → retried framed
    request/response. ``policy``/``seed``/``sleep`` make the backoff
    schedule deterministic (tests assert it); ``timeout_s`` bounds
    every socket operation so a slow or silent peer is a typed error,
    never a hang.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        timeout_s: float = 2.0,
        policy: Optional[RetryPolicy] = None,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        breaker: Optional[CircuitBreaker] = None,
        name: Optional[str] = None,
    ):
        expects(timeout_s > 0.0, "timeout_s must be positive")
        self.host = str(host)
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.policy = policy if policy is not None else RetryPolicy(
            max_attempts=3, base_delay_s=0.01, retryable=(OSError,)
        )
        self.seed = int(seed)
        self.sleep = sleep
        self.name = name or f"transport:{self.host}:{self.port}"
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            self.name, failure_threshold=3, reset_timeout_s=0.25
        )
        self.fetches = 0

    def _fetch(self, path: str, offset: int, nbytes: int) -> bytes:
        with socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        ) as conn:
            conn.settimeout(self.timeout_s)
            body = json.dumps(
                {"path": path, "offset": int(offset), "nbytes": int(nbytes)}
            ).encode("utf-8")
            conn.sendall(_frame(body))
            payload = _read_frame(conn)
        if not payload or payload[:1] != _ST_OK:
            detail = payload[1:].decode("utf-8", "replace") if payload else "empty"
            raise TransportError(f"peer {self.name} refused read: {detail}")
        return payload[1:]

    def __call__(self, path: str, offset: int, nbytes: int) -> bytes:
        faults.fire("transport.read", peer=self.name, offset=int(offset),
                    nbytes=int(nbytes))
        if not self.breaker.allow():
            raise TransportError(
                f"breaker open for {self.name}: peer quarantined"
            )
        self.fetches += 1
        try:
            data = retry_call(
                self._fetch, path, offset, nbytes,
                policy=self.policy, op="transport.read",
                seed=self.seed, sleep=self.sleep,
            )
        except RetryError as e:
            self.breaker.record_failure()
            obs.inc("replica.transport.errors", peer=self.name,
                    kind=type(e.last).__name__ if e.last is not None else "unknown")
            raise TransportError(
                f"fetch from {self.name} failed terminally: {e}"
            ) from e
        self.breaker.record_success()
        if obs.is_enabled():
            obs.inc("replica.transport.bytes", float(len(data)), peer=self.name)
        return data
