"""Load generation for the serving engine (``raft_tpu.bench.loadgen``
counterpart): open-loop (Poisson) and closed-loop generators that report
latency percentiles.

Open loop is the honest serving benchmark: arrivals follow a seeded
Poisson process whose rate does not slow down when the system falls
behind, so queueing delay shows in the percentiles instead of hiding as
coordinated omission. Latency runs from the intended arrival, not from
when the generator got round to submitting. Closed loop keeps a fixed number
of requests in flight: throughput at a concurrency.

Both drive the engine's synchronous loop on the calling thread (no
background thread, deterministic under test), or anything else with
``submit``, ``step`` and ``run_until_idle`` (a ``ReplicaGroup``), and
report throughput and p50/p95/p99 latency.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.serve.batcher import DeadlineExceeded, QueueFull


def percentile(samples, q: float) -> float:
    """p``q`` of ``samples`` (nearest-rank on the sorted list; 0 when
    empty) — tiny, dependency-free, and stable run-to-run."""
    if len(samples) == 0:
        return 0.0
    s = sorted(samples)
    rank = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[rank])


def poisson_arrivals(rate_qps: float, n: int, seed: int = 0) -> np.ndarray:
    """``n`` arrival offsets (seconds from start) of a Poisson process
    with mean rate ``rate_qps`` requests/s, seeded for reproducibility."""
    expects(rate_qps > 0, "rate_qps must be > 0")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_qps, size=n))


@dataclasses.dataclass
class LoadReport:
    """One load-generation run's scorecard."""

    mode: str  # "open" | "closed"
    n_requests: int
    completed: int
    #: rejection reason -> count (queue_full / deadline_* / dispatch errors)
    rejected: Dict[str, int]
    duration_s: float
    #: completed query rows per second of wall clock
    throughput_qps: float
    latency_ms_mean: float
    latency_ms_p50: float
    latency_ms_p95: float
    latency_ms_p99: float
    latency_ms_max: float
    #: raw per-request latencies (ms), completion order
    latencies_ms: List[float] = dataclasses.field(repr=False, default_factory=list)
    #: trace IDs aligned with ``latencies_ms`` ("" with obs off) — what
    #: lets the p99 sample resolve to a concrete request trace
    trace_ids: List[str] = dataclasses.field(repr=False, default_factory=list)

    def worst_trace(self) -> str:
        """Trace ID of the slowest completed request ("" when untraced)."""
        if not self.latencies_ms:
            return ""
        return self.trace_ids[self.latencies_ms.index(self.latency_ms_max)]

    def row(self) -> Dict[str, float]:
        """The bench-row projection (what lands in results.json)."""
        return {
            "qps": round(self.throughput_qps, 1),
            "completed": self.completed,
            "rejected": int(sum(self.rejected.values())),
            "p50_ms": round(self.latency_ms_p50, 3),
            "p95_ms": round(self.latency_ms_p95, 3),
            "p99_ms": round(self.latency_ms_p99, 3),
        }


def _report(mode, n_requests, completed, rejected, duration_s, rows_done,
            lats_ms, trace_ids=None):
    trace_ids = trace_ids if trace_ids is not None else [""] * len(lats_ms)
    report = LoadReport(
        mode=mode,
        n_requests=n_requests,
        completed=completed,
        rejected=rejected,
        duration_s=duration_s,
        throughput_qps=rows_done / duration_s if duration_s > 0 else 0.0,
        latency_ms_mean=float(np.mean(lats_ms)) if lats_ms else 0.0,
        latency_ms_p50=percentile(lats_ms, 50),
        latency_ms_p95=percentile(lats_ms, 95),
        latency_ms_p99=percentile(lats_ms, 99),
        latency_ms_max=max(lats_ms) if lats_ms else 0.0,
        latencies_ms=lats_ms,
        trace_ids=trace_ids,
    )
    if obs.is_enabled():
        obs.set_gauge("loadgen.throughput_qps", report.throughput_qps, mode=mode)
        obs.set_gauge("loadgen.p50_ms", report.latency_ms_p50, mode=mode)
        obs.set_gauge("loadgen.p99_ms", report.latency_ms_p99, mode=mode)
        for v, t in zip(lats_ms, trace_ids):
            # exemplar-enabled: the tail bucket keeps the worst request's
            # trace, so "what made p99" is answerable after the run
            obs.observe("loadgen.latency_ms", v, trace_id=t or None, mode=mode)
    return report


def run_open_loop(
    engine,
    index_id: str,
    query_pool: np.ndarray,
    k: int,
    *,
    rate_qps: float,
    n_requests: int,
    request_rows: int = 1,
    deadline_ms: Optional[float] = None,
    seed: int = 0,
    collect: bool = False,
) -> Tuple[LoadReport, List[Tuple[np.ndarray, np.ndarray]]]:
    """Open-loop run: submit ``n_requests`` requests of ``request_rows``
    query rows each (drawn round-robin from ``query_pool``) at seeded
    Poisson arrival times, driving ``engine.step()`` between arrivals.

    Latency is intended-arrival → completion (coordinated-omission
    safe). With ``collect=True`` the returned list holds
    ``(pool_row_ids, result_indices)`` per completed request so callers
    can score recall.
    """
    expects(query_pool.ndim == 2, "query_pool must be [n, dim]")
    offsets = poisson_arrivals(rate_qps, n_requests, seed)
    pool_n = query_pool.shape[0]

    pending: List[Tuple[float, object, np.ndarray]] = []  # (t_arrival, future, row_ids)
    rejected: Dict[str, int] = {}
    lats_ms: List[float] = []
    trace_ids: List[str] = []
    results: List[Tuple[np.ndarray, np.ndarray]] = []
    rows_done = 0
    completed = 0

    t0 = time.perf_counter()
    submitted = 0
    while submitted < n_requests or pending:
        now = time.perf_counter() - t0
        # release every arrival that is due (open loop: never waits for
        # the system — lateness becomes queueing latency)
        while submitted < n_requests and offsets[submitted] <= now:
            start = (submitted * request_rows) % pool_n
            ids = (np.arange(request_rows) + start) % pool_n
            q = query_pool[ids]
            try:
                fut = engine.submit(index_id, q, k, deadline_ms=deadline_ms)
                pending.append((float(offsets[submitted]), fut, ids))
            except (QueueFull, DeadlineExceeded) as e:
                rejected[type(e).__name__] = rejected.get(type(e).__name__, 0) + 1
            submitted += 1
        engine.step()
        if submitted >= n_requests:
            engine.run_until_idle()
        done_at = time.perf_counter() - t0
        still = []
        for t_arr, fut, ids in pending:
            if not fut.done():
                still.append((t_arr, fut, ids))
                continue
            exc = fut.exception()
            if exc is not None:
                rejected[type(exc).__name__] = rejected.get(type(exc).__name__, 0) + 1
                continue
            res = fut.result()
            lats_ms.append((done_at - t_arr) * 1e3)
            trace_ids.append(res.trace_id)
            rows_done += res.indices.shape[0]
            completed += 1
            if collect:
                results.append((ids, res.indices))
        pending = still
    duration = time.perf_counter() - t0
    return _report("open", n_requests, completed, rejected, duration, rows_done,
                   lats_ms, trace_ids), results


def run_closed_loop(
    engine,
    index_id: str,
    query_pool: np.ndarray,
    k: int,
    *,
    concurrency: int,
    n_requests: int,
    request_rows: int = 1,
    deadline_ms: Optional[float] = None,
    collect: bool = False,
) -> Tuple[LoadReport, List[Tuple[np.ndarray, np.ndarray]]]:
    """Closed-loop run: keep ``concurrency`` requests outstanding until
    ``n_requests`` have been submitted; classic throughput-at-concurrency.
    Latency is submit → completion."""
    expects(query_pool.ndim == 2, "query_pool must be [n, dim]")
    expects(concurrency >= 1, "concurrency must be >= 1")
    pool_n = query_pool.shape[0]

    pending: List[Tuple[float, object, np.ndarray]] = []
    rejected: Dict[str, int] = {}
    lats_ms: List[float] = []
    trace_ids: List[str] = []
    results: List[Tuple[np.ndarray, np.ndarray]] = []
    rows_done = 0
    completed = 0
    submitted = 0

    t0 = time.perf_counter()
    while submitted < n_requests or pending:
        while submitted < n_requests and len(pending) < concurrency:
            start = (submitted * request_rows) % pool_n
            ids = (np.arange(request_rows) + start) % pool_n
            try:
                fut = engine.submit(index_id, query_pool[ids], k, deadline_ms=deadline_ms)
                pending.append((time.perf_counter(), fut, ids))
            except (QueueFull, DeadlineExceeded) as e:
                rejected[type(e).__name__] = rejected.get(type(e).__name__, 0) + 1
            submitted += 1
        # a full window cannot grow — force the flush instead of waiting
        # out max_wait_ms with nothing to do
        engine.step(force=len(pending) >= concurrency or submitted >= n_requests)
        t_done = time.perf_counter()
        still = []
        for t_sub, fut, ids in pending:
            if not fut.done():
                still.append((t_sub, fut, ids))
                continue
            exc = fut.exception()
            if exc is not None:
                rejected[type(exc).__name__] = rejected.get(type(exc).__name__, 0) + 1
                continue
            res = fut.result()
            lats_ms.append((t_done - t_sub) * 1e3)
            trace_ids.append(res.trace_id)
            rows_done += res.indices.shape[0]
            completed += 1
            if collect:
                results.append((ids, res.indices))
        pending = still
    duration = time.perf_counter() - t0
    return _report("closed", n_requests, completed, rejected, duration, rows_done,
                   lats_ms, trace_ids), results
