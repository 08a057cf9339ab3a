"""raft_tpu_torch.mutable — crash-consistent mutability over the port's
indexes (``raft_tpu.mutable`` counterpart).

Segmented architecture (:mod:`~raft_tpu_torch.mutable.segments`): a
generation-numbered main segment (any index type, tombstones masked
in-scan) plus a small brute-force delta segment for fresh rows, scanned
by kernel B1 on the card; every mutation is WAL-durable before it is
visible (:mod:`~raft_tpu_torch.mutable.wal`); compaction rebuilds and
atomically publishes the next generation — foreground under the lock
(:mod:`~raft_tpu_torch.mutable.compact`) or pinned-snapshot background
with catch-up replay (:mod:`~raft_tpu_torch.mutable.maintenance`), both
through :mod:`~raft_tpu_torch.mutable.manifest`. A directory written by
the JAX package opens here, and the reverse.
"""
from raft_tpu_torch.mutable.compact import compact
from raft_tpu_torch.mutable.maintenance import (
    CompactionPolicy,
    Compactor,
    compact_background,
)
from raft_tpu_torch.mutable.manifest import Manifest
from raft_tpu_torch.mutable.segments import MutableIndex, Snapshot
from raft_tpu_torch.mutable.wal import WalRecord, WriteAheadLog, replay, segment_paths

__all__ = [
    "CompactionPolicy",
    "Compactor",
    "Manifest",
    "MutableIndex",
    "Snapshot",
    "WalRecord",
    "WriteAheadLog",
    "compact",
    "compact_background",
    "replay",
    "segment_paths",
]
