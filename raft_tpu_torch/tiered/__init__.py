"""Tiered serving: device-resident codes, host-resident vectors
(``raft_tpu.tiered`` counterpart).

The scan (PQ or RaBitQ codes, coarse centers, id maps; or IVF-Flat lists,
or a brute-force copy) stays on the card, while the raw vectors that only
the ``refine`` re-rank reads live in host RAM, or memory-mapped from a
snapshot file, and are fetched a batch at a time as the top candidates'
gather, overlapped with the next micro-batch's scan.

* :class:`HostVectorStore`: the host tier, a double-buffered pinned
  staging gather with duplicate-id coalescing, madvise read-ahead and a
  fetch-depth budget on the mmap path, the ``host.fetch`` fault seam under
  a retry, the ``tiered.fetch.*`` metrics.
* :class:`TieredIndex`: an ``ivf_pq`` / ``ivf_flat`` / ``brute_force``
  index with the scan -> fetch -> re-rank pipeline; a micro-batch's results
  are the resident ``search(dataset=...)``'s bits.
* :class:`ShardedHostTier` / :class:`TieredShardedIndex`: the lists-sharded
  composition, each shard's codes on the device behind the ring or gather
  merge, the merged winners re-ranked from the host tier of the shard that
  holds them, a micro-batch the resident sharded path's bits; a dead host's
  tier costs coverage instead of the query.
* :func:`raft_tpu_torch.ops.hbm_model.plan_placement` (and the per-shard
  ``plan_placement_sharded``) decides which components spill to this tier;
  :class:`raft_tpu_torch.serve.ServingEngine` asks it at ``register()``
  under ``hbm_budget_bytes``, so a registration that would overfill the card
  serves tiered (or ``tiered_sharded``) instead.
"""
from raft_tpu_torch.tiered.index import TieredIndex
from raft_tpu_torch.tiered.sharded import ShardedHostTier, TieredShardedIndex
from raft_tpu_torch.tiered.store import HostVectorStore

__all__ = ["HostVectorStore", "ShardedHostTier", "TieredIndex", "TieredShardedIndex"]
