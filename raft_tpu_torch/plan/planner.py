"""Candidate enumeration and costed selection for every dispatch decision
(``raft_tpu.plan.planner`` counterpart).

Each ``plan_*`` resolver enumerates the legal candidates for one decision,
prices each from :mod:`raft_tpu_torch.plan.cost`, and returns a
:class:`Plan`: the choice, with the per-term breakdown of every candidate
(the ones that lost, and the ineligible ones and why). The ``choice`` is
what the call site dispatches on; :meth:`Plan.explain` is the audit trail.

Selection is deterministic: candidates are priced in a fixed order and the
first strictly cheapest eligible one wins, so a tie goes to the earlier
(more conservative) engine.

Where the port differs from the JAX package by design:

* ``on_tpu`` is ``on_cuda`` (:func:`on_cuda`): the kernels' candidate is
  eligible on a CUDA device of compute capability 9.x;
* :func:`plan_search_mode` takes the eligibility of ``scan``: ``auto`` on
  a CUDA index leaves the dense scan to an explicit ``mode="scan"`` (where
  the kernel cannot serve, the probe path runs), as the port's inline rule
  does.

Parity: with the gate off (``RAFT_TPU_PLAN=0``) every call site runs its
inline rule; with it on, the JAX package's coefficients make each resolver
select what the rule does (held in ``tests/test_torch_plan.py``), so
results are the same bits either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.plan import cost as _cost
from raft_tpu_torch.plan.cost import CostTerm


#: why a kernel candidate is ineligible off the card the kernels are built for
_NOT_CUDA = "index is not on a compute capability 9.x CUDA device"


def on_cuda(device) -> bool:
    """Whether the hand kernels can serve an index on ``device``: a CUDA
    device of compute capability 9.x, the build target of ``csrc/``
    (``sm_90a``). Without a CUDA runtime no index can live on a card, and
    the device's type alone decides (a test describing a CUDA index)."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    if not torch.cuda.is_available():
        return True
    return torch.cuda.get_device_capability(device)[0] == 9


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One enumerated configuration for a decision, with its price."""

    name: str
    terms: Tuple[CostTerm, ...] = ()
    eligible: bool = True
    reason: str = ""  # why ineligible (shown in explain)

    @property
    def cost(self) -> float:
        if not self.eligible:
            return math.inf
        return sum(t.value for t in self.terms)

    def render(self) -> str:
        if not self.eligible:
            return f"x {self.name:<12} ineligible: {self.reason}"
        breakdown = " + ".join(t.render() for t in self.terms)
        return f"- {self.name:<12} {self.cost:10.2f} cu  [{breakdown}]"


@dataclasses.dataclass(frozen=True)
class Plan:
    """A resolved dispatch decision: the choice, every candidate's cost
    breakdown, and the inputs the costing read."""

    decision: str
    choice: str
    candidates: Tuple[Candidate, ...]
    inputs: Tuple[Tuple[str, object], ...] = ()

    @property
    def cost(self) -> float:
        for c in self.candidates:
            if c.name == self.choice:
                return c.cost
        return math.inf

    def candidate(self, name: str) -> Optional[Candidate]:
        for c in self.candidates:
            if c.name == name:
                return c
        return None

    def explain(self) -> str:
        lines = [f"plan {self.decision}: {self.choice}  ({self.cost:.2f} cu)"]
        if self.inputs:
            lines.append("  inputs: " + " ".join(f"{k}={v}" for k, v in self.inputs))
        for c in sorted(self.candidates, key=lambda c: c.cost):
            lines.append("  " + c.render())
        return "\n".join(lines)


def _decide(decision: str, candidates, inputs) -> Plan:
    """First strictly-cheapest eligible candidate wins (stable ties)."""
    cands = tuple(candidates)
    best = None
    for c in cands:
        if c.eligible and (best is None or c.cost < best.cost):
            best = c
    if best is None:  # caller enumerated no eligible engine — a bug
        raise ValueError(f"plan {decision}: no eligible candidate")
    if obs.is_enabled():
        obs.inc("plan.decisions", decision=decision, choice=best.name)
    return Plan(decision=decision, choice=best.name, candidates=cands,
                inputs=tuple(inputs))


# ---------------------------------------------------------------------------
# per-decision resolvers
# ---------------------------------------------------------------------------


def plan_search_mode(algo: str, nq: int, *, on_cuda: bool, fused_ok: bool,
                     wants_f32_lut: bool = False, scan_ok: bool = True,
                     scan_reason: str = "no dense scan for this index") -> Plan:
    """IVF engine pick (``probe`` | ``scan`` | ``fused``) for one batch
    of ``nq`` queries. ``fused_ok`` is the call site's kernel-eligibility
    verdict (metric and codebook support); ``wants_f32_lut`` is the
    explicit-precision demand the bf16 fused LUT cannot honor. ``scan_ok``
    (the port's addition) is whether ``auto`` may take the dense scan,
    ``scan_reason`` why not; with ``scan_ok=True`` the choice and costs
    are the JAX resolver's."""
    reasons = []
    if not on_cuda:
        reasons.append(_NOT_CUDA)
    if not fused_ok:
        reasons.append("kernel infeasible (metric/codebook)")
    if wants_f32_lut:
        reasons.append("explicit f32 LUT demand (bf16 kernel LUT)")
    return _decide(
        f"{algo}.search_mode",
        [
            Candidate("probe", _cost.search_mode_terms("probe", nq)),
            Candidate("scan", _cost.search_mode_terms("scan", nq),
                      eligible=scan_ok, reason=scan_reason),
            Candidate("fused", _cost.search_mode_terms("fused", nq),
                      eligible=not reasons, reason="; ".join(reasons)),
        ],
        [("nq", nq), ("on_cuda", on_cuda), ("fused_ok", fused_ok)],
    )


def plan_cagra_mode(nq: int, *, on_cuda: bool, fused_ok: bool) -> Plan:
    """CAGRA beam engine pick (``xla`` | ``fused``) for ``nq`` queries."""
    reasons = []
    if not on_cuda:
        reasons.append(_NOT_CUDA)
    if not fused_ok:
        reasons.append("needs raw dataset, init_sample>0, dedup='post', "
                       "no prefilter, graph_degree<=dim")
    return _decide(
        "cagra.search_mode",
        [
            Candidate("xla", _cost.cagra_mode_terms("xla", nq)),
            Candidate("fused", _cost.cagra_mode_terms("fused", nq),
                      eligible=not reasons, reason="; ".join(reasons)),
        ],
        [("nq", nq), ("on_cuda", on_cuda), ("fused_ok", fused_ok)],
    )


def plan_merge_mode(n_shards: int, k: Optional[int] = None,
                    tile_width: Optional[int] = None) -> Plan:
    """Cross-shard merge engine pick (``gather`` | ``ring`` |
    ``fused_ring``). ``tile_width`` is the per-shard candidate width
    entering the merge (defaults to ``k`` — the classic call sites,
    where the scan has already folded to k)."""
    k = int(k) if k else 10  # nominal: the winner is k-independent
    width = int(tile_width) if tile_width else k
    single = n_shards <= 1
    return _decide(
        "merge_mode",
        [
            Candidate("gather", _cost.merge_mode_terms("gather", n_shards, k, width)),
            Candidate("ring", _cost.merge_mode_terms("ring", n_shards, k, width),
                      eligible=not single, reason="single shard: nothing to exchange"),
            Candidate("fused_ring",
                      _cost.merge_mode_terms("fused_ring", n_shards, k, width),
                      eligible=not single, reason="single shard: nothing to exchange"),
        ],
        [("n_shards", n_shards), ("k", k), ("tile_width", width)],
    )


def plan_comm_mode(n_rows: int, d: int, n_shards: int, ca_cap=None) -> Plan:
    """Distributed-build accumulator exchange pick (``full`` | ``ca``)
    over ``[n_rows, d+1]`` f32 accumulator rows per iteration."""
    return _decide(
        "comm_mode",
        [
            Candidate("full", _cost.comm_mode_terms("full", n_rows, d, n_shards)),
            Candidate("ca", _cost.comm_mode_terms("ca", n_rows, d, n_shards,
                                                  ca_cap=ca_cap)),
        ],
        [("n_rows", n_rows), ("d", d), ("n_shards", n_shards)],
    )


def plan_delta_mode(*, eligible: bool, on_cuda: bool) -> Plan:
    """Mutable delta-scan engine pick (``exact`` | ``fused``).
    ``eligible`` is ``segments._delta_fused_eligible``'s verdict (metric
    window, banked row cap, k width)."""
    reasons = []
    if not eligible:
        reasons.append("metric/cap/k outside the lossless banked window")
    if not on_cuda:
        reasons.append(_NOT_CUDA)
    return _decide(
        "delta_mode",
        [
            Candidate("exact", _cost.delta_mode_terms("exact")),
            Candidate("fused", _cost.delta_mode_terms("fused"),
                      eligible=not reasons, reason="; ".join(reasons)),
        ],
        [("eligible", eligible), ("on_cuda", on_cuda)],
    )


def plan_pq_kind(pq_bits: int, per_subspace: bool, pq_dim: int = 16) -> Plan:
    """PQ code-family pick (``rabitq`` | ``nibble`` | ``kmeans``) at
    build time. Representability is eligibility; among representable
    families the decode-throughput terms decide."""
    pq_dim = max(1, int(pq_dim))
    return _decide(
        "pq_kind",
        [
            Candidate("rabitq", _cost.pq_kind_terms("rabitq", pq_dim, 1),
                      eligible=pq_bits == 1,
                      reason="1 bit/dim only (pq_bits != 1)"),
            Candidate("nibble", _cost.pq_kind_terms("nibble", pq_dim, pq_bits),
                      eligible=pq_bits == 8 and per_subspace,
                      reason="needs pq_bits=8 and per_subspace codebooks"),
            # kmeans is the fallback family: it stays eligible for
            # out-of-range pq_bits so the call site's own validation
            # raises the canonical error, not the planner
            Candidate("kmeans", _cost.pq_kind_terms("kmeans", pq_dim, pq_bits),
                      eligible=pq_bits != 1,
                      reason="1 bit/dim is rabitq's encoding"),
        ],
        [("pq_bits", pq_bits), ("per_subspace", per_subspace)],
    )


def plan_sparse_mode(n_cols: int, *, native_ok: bool) -> Plan:
    """Sparse pairwise engine pick (``densify`` | ``native``) at feature
    width ``n_cols``."""
    return _decide(
        "sparse_mode",
        [
            Candidate("densify", _cost.sparse_mode_terms("densify", n_cols)),
            Candidate("native", _cost.sparse_mode_terms("native", n_cols),
                      eligible=native_ok,
                      reason="metric has no sort-merge gram path"),
        ],
        [("n_cols", n_cols), ("native_ok", native_ok)],
    )
