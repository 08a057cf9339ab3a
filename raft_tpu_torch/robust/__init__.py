"""raft_tpu_torch.robust — fault injection and retries
(``raft_tpu.robust`` counterpart; degraded sharded search and the
fallback counters are not ported yet, and the port never falls back
from a failed kernel: it raises ``KernelFailure``).

* :mod:`raft_tpu_torch.robust.faults` — deterministic fault-injection
  registry (env gate ``RAFT_TPU_FAULTS``, named points at the real seams,
  trigger policies, latency injection).
* :mod:`raft_tpu_torch.robust.retry` — ``RetryPolicy`` with exponential
  backoff + seeded jitter, ``retry_call`` / ``retrying``, and the
  ``CircuitBreaker`` state machine.
"""
from raft_tpu_torch.robust import faults
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
    "RetryError",
    "RetryPolicy",
    "faults",
    "retry_call",
    "retrying",
]
