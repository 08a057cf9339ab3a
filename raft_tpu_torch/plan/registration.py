"""Registration-level plans for the serving engine, with live re-planning
(``raft_tpu.plan.registration`` counterpart).

:func:`plan_registration` rolls the per-decision plans of one
:class:`~raft_tpu_torch.serve.engine.ServingEngine` registration into one
immutable :class:`RegistrationPlan`: the engine resolved for each shape
bucket, the cross-shard merge engine, the placement's tier label, and the
traffic and corpus anchors the re-planner measures drift against.

Re-planning (driven from the engine's maintenance tick) goes by
generations: :func:`needs_replan` watches corpus rows and the engine's
per-bucket batch counts against hysteresis thresholds; past one the engine
re-costs, and if a *decision* changed it warms the new plan's buckets
through the program cache and swaps the plan in one assignment (``epoch``
bumped, ``serve.plan_flips`` counted). A re-cost that lands on the same
decisions refreshes the anchors only (``serve.plan.recosts``). The
resolved bucket mode joins the ``ProgramKey``, so programs stay bounded by
engines x buckets.

Hysteresis knobs, the JAX package's values:

* :data:`GROWTH_REPLAN_FACTOR`: corpus rows must grow (or shrink) by this
  factor past the planned anchor before a re-cost;
* :data:`TRAFFIC_MIN_SAMPLES`: batches observed before the dominant bucket
  is trusted;
* :data:`WARM_BUCKETS`: how many of the most-trafficked buckets a flip
  warms.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from raft_tpu_torch.plan.planner import Plan, plan_cagra_mode, plan_merge_mode, plan_search_mode

#: corpus-size drift (x grow or /x shrink) that triggers a re-cost
GROWTH_REPLAN_FACTOR = 1.5
#: dispatched batches before the bucket histogram can drive a flip
TRAFFIC_MIN_SAMPLES = 16
#: top-N trafficked buckets precompiled on a plan flip
WARM_BUCKETS = 2

#: registration algos whose per-bucket search engine the planner picks
_MODE_PLANNED = ("ivf_flat", "ivf_pq", "cagra")


@dataclasses.dataclass(frozen=True)
class TrafficSnapshot:
    """What the engine measured since the last plan: per-bucket batch
    counts (the live batch-size histogram) and the rows/s EWMA."""

    bucket_counts: Tuple[Tuple[int, int], ...] = ()
    ewma_rows_per_s: float = 0.0

    @property
    def samples(self) -> int:
        return sum(n for _, n in self.bucket_counts)

    @property
    def dominant_bucket(self) -> int:
        best, best_n = 0, 0
        for b, n in self.bucket_counts:
            if n > best_n or (n == best_n and b < best):
                best, best_n = b, n
        return best

    def warm_buckets(self, limit: int = WARM_BUCKETS) -> Tuple[int, ...]:
        ranked = sorted(self.bucket_counts, key=lambda bn: (-bn[1], bn[0]))
        return tuple(sorted(b for b, _ in ranked[:limit]))


@dataclasses.dataclass(frozen=True)
class RegistrationPlan:
    """The active plan of one serving registration: every resolved
    decision plus the drift anchors it was costed against."""

    index_id: str
    algo: str
    epoch: int
    #: (bucket, resolved engine) pairs; empty when the registration's
    #: mode is caller-pinned (not "auto") or the algo has no engine pick
    bucket_modes: Tuple[Tuple[int, str], ...] = ()
    #: resolved cross-shard merge engine ("" when not sharded)
    merge_mode: str = ""
    #: HBM placement verdict label ("resident" | "tiered" |
    #: "tiered_sharded" | "" when unplanned)
    tier: str = ""
    #: corpus rows at planning time — the growth-hysteresis anchor
    corpus_rows: int = 0
    #: dominant shape bucket at planning time — the traffic anchor
    dominant_bucket: int = 0
    ewma_rows_per_s: float = 0.0
    #: traffic-chosen precompile set for the next flip
    warm_buckets: Tuple[int, ...] = ()
    #: the underlying costed decisions, for explain
    decisions: Tuple[Plan, ...] = ()

    def mode_for(self, bucket: int, default: str = "") -> str:
        for b, m in self.bucket_modes:
            if b == bucket:
                return m
        return default

    def same_decisions(self, other: "RegistrationPlan") -> bool:
        """True when flipping to ``other`` would change no dispatch
        decision (anchors may still differ — a re-cost, not a flip)."""
        return (
            self.bucket_modes == other.bucket_modes
            and self.merge_mode == other.merge_mode
            and self.tier == other.tier
            and self.warm_buckets == other.warm_buckets
        )

    def explain(self) -> str:
        head = (
            f"plan[{self.index_id}] epoch={self.epoch} algo={self.algo}"
            + (f" tier={self.tier}" if self.tier else "")
            + f" corpus_rows={self.corpus_rows}"
        )
        lines = [head]
        lines.append(
            f"  traffic: dominant_bucket={self.dominant_bucket} "
            f"ewma_rows_per_s={self.ewma_rows_per_s:.1f} "
            f"warm={self.warm_buckets or '()'}"
        )
        if self.bucket_modes:
            lines.append("  bucket modes: " + " ".join(
                f"{b}→{m}" for b, m in self.bucket_modes))
        if self.merge_mode:
            lines.append(f"  merge_mode: {self.merge_mode}")
        for p in self.decisions:
            lines.extend("  " + ln for ln in p.explain().splitlines())
        return "\n".join(lines)


def plan_registration(
    index_id: str,
    algo: str,
    *,
    buckets: Sequence[int],
    corpus_rows: int = 0,
    on_cuda: bool = False,
    fused_ok: bool = False,
    scan_ok: bool = True,
    n_shards: int = 0,
    k: Optional[int] = None,
    tier: str = "",
    mode_pinned: bool = False,
    merge_pinned: bool = False,
    traffic: Optional[TrafficSnapshot] = None,
    epoch: int = 0,
    scan_reason: str = "no dense scan for this index",
) -> RegistrationPlan:
    """Cost one registration's full decision set.

    ``mode_pinned``/``merge_pinned`` mark decisions the caller fixed at
    registration ("auto" was not requested) — the planner records them
    as unplanned rather than second-guess an explicit pin. ``fused_ok``
    is the registration-time kernel-eligibility verdict for the fused
    engine; ``scan_ok`` and ``scan_reason`` say whether ``auto`` may take
    the dense scan (:func:`~raft_tpu_torch.plan.planner.plan_search_mode`)."""
    traffic = traffic or TrafficSnapshot()
    decisions = []
    bucket_modes: Tuple[Tuple[int, str], ...] = ()
    if algo in _MODE_PLANNED and not mode_pinned:
        modes = []
        for b in buckets:
            if algo == "cagra":
                p = plan_cagra_mode(int(b), on_cuda=on_cuda, fused_ok=fused_ok)
            else:
                p = plan_search_mode(algo, int(b), on_cuda=on_cuda, fused_ok=fused_ok,
                                     scan_ok=scan_ok, scan_reason=scan_reason)
            modes.append((int(b), p.choice))
            decisions.append(p)
        bucket_modes = tuple(modes)
    merge = ""
    if n_shards and not merge_pinned:
        p = plan_merge_mode(n_shards, k)
        merge = p.choice
        decisions.append(p)
    return RegistrationPlan(
        index_id=index_id,
        algo=algo,
        epoch=epoch,
        bucket_modes=bucket_modes,
        merge_mode=merge,
        tier=tier,
        corpus_rows=int(corpus_rows),
        dominant_bucket=traffic.dominant_bucket,
        ewma_rows_per_s=traffic.ewma_rows_per_s,
        warm_buckets=traffic.warm_buckets(),
        decisions=tuple(decisions),
    )


def needs_replan(plan: RegistrationPlan, corpus_rows: int,
                 traffic: TrafficSnapshot) -> bool:
    """Hysteresis check: has the live state drifted far enough from the
    plan's anchors that a re-cost is warranted?"""
    anchor = max(plan.corpus_rows, 1)
    rows = max(int(corpus_rows), 1)
    if rows >= anchor * GROWTH_REPLAN_FACTOR or rows * GROWTH_REPLAN_FACTOR <= anchor:
        return True
    if traffic.samples >= TRAFFIC_MIN_SAMPLES:
        if traffic.dominant_bucket != plan.dominant_bucket:
            return True
        if plan.warm_buckets and traffic.warm_buckets() != plan.warm_buckets:
            return True
    return False


def traffic_from_counts(bucket_counts: Dict[int, int],
                        ewma_rows_per_s: float) -> TrafficSnapshot:
    """Snapshot the engine's mutable per-registration traffic state."""
    return TrafficSnapshot(
        bucket_counts=tuple(sorted(bucket_counts.items())),
        ewma_rows_per_s=float(ewma_rows_per_s),
    )
