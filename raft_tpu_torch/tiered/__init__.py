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
* :func:`raft_tpu_torch.ops.hbm_model.plan_placement` decides which
  components spill to this tier; :class:`raft_tpu_torch.serve.ServingEngine`
  asks it at ``register()`` under ``hbm_budget_bytes``, so a registration
  that would overfill the card serves tiered instead.

The JAX package's sharded tier (``ShardedHostTier``, ``TieredShardedIndex``)
is not ported yet; a sharded registration that would need it fails typed.
"""
from raft_tpu_torch.tiered.index import TieredIndex
from raft_tpu_torch.tiered.store import HostVectorStore

__all__ = ["HostVectorStore", "TieredIndex"]
