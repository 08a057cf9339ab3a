"""raft_tpu_torch.robust — fault injection, retries and degraded sharded
search (``raft_tpu.robust`` counterpart). The port never falls back from
a failed kernel: it raises ``KernelFailure``, so ``robust/fallback.py`` and
its ``fallbacks{algo,reason}`` counter are not ported.

* :mod:`raft_tpu_torch.robust.faults` — deterministic fault-injection
  registry (env gate ``RAFT_TPU_FAULTS``, named points at the real seams,
  trigger policies, latency injection).
* :mod:`raft_tpu_torch.robust.retry` — ``RetryPolicy`` with exponential
  backoff + seeded jitter, ``retry_call`` / ``retrying``, and the
  ``CircuitBreaker`` state machine.
* :mod:`raft_tpu_torch.robust.degrade` — ``sharded_search_degraded``: a
  per-shard health probe, failed shards excluded from the merge, results
  with a ``coverage`` fraction (``DegradedResult``).
"""
from raft_tpu_torch.robust import faults
from raft_tpu_torch.robust.degrade import (
    DegradedResult,
    probe_shard_health,
    sharded_search_degraded,
)
from raft_tpu_torch.robust.retry import (
    DEFAULT_POLICY,
    CircuitBreaker,
    RetryError,
    RetryPolicy,
    retry_call,
    retrying,
)

__all__ = [
    "CircuitBreaker",
    "DEFAULT_POLICY",
    "DegradedResult",
    "RetryError",
    "RetryPolicy",
    "faults",
    "probe_shard_health",
    "retry_call",
    "retrying",
    "sharded_search_degraded",
]
