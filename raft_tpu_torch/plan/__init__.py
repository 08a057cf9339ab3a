"""Cost-model query planner (``raft_tpu.plan`` counterpart): one dispatcher
over the port's shared-memory, device-memory, wire and traffic models.

Every ``"auto"`` the port resolves goes through here when the gate is on:
the IVF search engine (``neighbors/ivf_common.auto_search_mode``, for
IVF-Flat and IVF-PQ), the CAGRA beam engine (``cagra.search``), the
cross-shard merge engine (``sharded_ann._resolve_merge_mode``), the mutable
delta engine (``segments._delta_route``), the PQ code family
(``ivf_pq._resolve_kind``), the distributed build's accumulator exchange
(``sharded_ann._resolve_comm_mode``) and the serving engine's
per-registration plan. The sparse pairwise engine
(:func:`plan_sparse_mode`) is a resolver whose call site comes with the
sparse module, not ported yet. Each resolver
enumerates the eligible candidates, prices them
(:mod:`raft_tpu_torch.plan.cost`) and returns an explainable :class:`Plan`.

Gate: ``RAFT_TPU_PLAN=0`` (or ``false``/``off``/``no``), read at each call,
turns the planner off; every call site then runs its inline rule. With the
gate on, the JAX package's cost constants make the planner choose what the
inline rules choose, so results are the same bits either way.
"""
from __future__ import annotations

import os

from raft_tpu_torch.plan.cost import CostTerm
from raft_tpu_torch.plan.planner import (
    Candidate,
    Plan,
    on_cuda,
    plan_cagra_mode,
    plan_comm_mode,
    plan_delta_mode,
    plan_merge_mode,
    plan_pq_kind,
    plan_search_mode,
    plan_sparse_mode,
)
from raft_tpu_torch.plan.registration import (
    GROWTH_REPLAN_FACTOR,
    TRAFFIC_MIN_SAMPLES,
    WARM_BUCKETS,
    RegistrationPlan,
    TrafficSnapshot,
    needs_replan,
    plan_registration,
    traffic_from_counts,
)

_OFF = ("0", "false", "off", "no")


def is_enabled() -> bool:
    """Planner gate: on by default; ``RAFT_TPU_PLAN=0`` restores every call
    site's inline rule."""
    return os.environ.get("RAFT_TPU_PLAN", "1").strip().lower() not in _OFF


__all__ = [
    "Candidate",
    "CostTerm",
    "GROWTH_REPLAN_FACTOR",
    "Plan",
    "RegistrationPlan",
    "TRAFFIC_MIN_SAMPLES",
    "TrafficSnapshot",
    "WARM_BUCKETS",
    "is_enabled",
    "needs_replan",
    "on_cuda",
    "plan_cagra_mode",
    "plan_comm_mode",
    "plan_delta_mode",
    "plan_merge_mode",
    "plan_pq_kind",
    "plan_registration",
    "plan_search_mode",
    "plan_sparse_mode",
    "traffic_from_counts",
]
