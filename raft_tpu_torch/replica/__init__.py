"""Replicated serving: health-routed replica groups with WAL shipping.

The pieces (``raft_tpu.replica`` counterpart, every module of it):

* :class:`~raft_tpu_torch.replica.group.ReplicaGroup` — N engine-backed
  copies of every registered index behind the single-engine futures
  API, with circuit-breaker health routing and failover that
  **re-queues** in-flight work instead of erroring it;
* :class:`~raft_tpu_torch.replica.router.Router` — least-queue-depth
  admission over breaker-closed, staleness-bounded, non-draining
  replicas;
* :mod:`~raft_tpu_torch.replica.shipping` — leader WAL seal → CRC-verified
  segment shipping → follower replay, with bounded-staleness
  accounting and per-hop fencing tokens (:class:`Replication`,
  :class:`Shipper`, :class:`Follower`, :class:`ShipRejected`,
  :class:`FencedError`);
* :mod:`~raft_tpu_torch.replica.control` — the control plane: file-CAS
  lease with epoch counter (:class:`LeaseStore`), highest-cursor
  leader election with fenced promotion (:class:`ControlPlane`), and
  SLO-driven fleet sizing (:class:`Autoscaler`,
  :class:`AutoscalePolicy`);
* :mod:`~raft_tpu_torch.replica.transport` — the real wire: a length-framed
  TCP segment server plus the retrying, breaker-gated transport
  callable (:class:`SegmentServer`, :class:`SocketTransport`,
  :class:`TransportError`).
"""
from raft_tpu_torch.replica.control import (
    Autoscaler,
    AutoscalePolicy,
    ControlPlane,
    Lease,
    LeaseStore,
)
from raft_tpu_torch.replica.group import ReplicaGroup
from raft_tpu_torch.replica.router import Router
from raft_tpu_torch.replica.shipping import (
    DEFAULT_CHUNK_BYTES,
    FencedError,
    Follower,
    FollowerPosition,
    Replication,
    Shipper,
    ShipRejected,
)
from raft_tpu_torch.replica.transport import SegmentServer, SocketTransport, TransportError

__all__ = [
    "DEFAULT_CHUNK_BYTES",
    "Autoscaler",
    "AutoscalePolicy",
    "ControlPlane",
    "FencedError",
    "Follower",
    "FollowerPosition",
    "Lease",
    "LeaseStore",
    "ReplicaGroup",
    "Replication",
    "Router",
    "SegmentServer",
    "ShipRejected",
    "Shipper",
    "SocketTransport",
    "TransportError",
]
