"""Replicated serving (``raft_tpu_torch.replica``), each case against
raft_tpu's.

The router's five cases give the same choice in both packages. Replica
groups over one brute-force index run the same submission schedule and the
same fault specs on the same virtual clock in both packages, and give equal
results (ids equal, distances allclose at rtol 1e-5), the same replica for
every request, the same parked counts and the same ``serve.failovers`` and
``replica.*`` counters. Failover re-queues: a replica killed at the
``replica.dispatch`` seam is invisible to callers; a deadline that runs
out during failover is typed.

Where the port's no-fallback rule gives another outcome, the case is named
``..._no_fallback_difference``: JAX's fused kernel falls back inside the
search and the request completes there; the port's batch fails typed and
the group fails the request over between its replicas until the fault
clears, then serves it.

Threaded pumps start cold on one shared index (the fused CAGRA and IVF-PQ
caches fill on first use) and every answer equals the bare engine's; the
lock witness holds a threaded group run to the port's manifest.
"""
import json
import os
import subprocess
import sys
import types
import warnings

import jax
import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu.core import errors as jerrors
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.replica import ReplicaGroup as JGroup
from raft_tpu.replica import Router as JRouter
from raft_tpu.robust import faults as jfaults
from raft_tpu.robust.retry import CircuitBreaker as JBreaker
from raft_tpu.serve import DeadlineExceeded as JDeadline
from raft_tpu.serve import QueueFull as JQueueFull
from raft_tpu.serve import ServingEngine as JEngine
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core import errors as terrors
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.replica import ReplicaGroup as TGroup
from raft_tpu_torch.replica import Router as TRouter
from raft_tpu_torch.robust import faults as tfaults
from raft_tpu_torch.robust.retry import CircuitBreaker as TBreaker
from raft_tpu_torch.serve import DeadlineExceeded as TDeadline
from raft_tpu_torch.serve import QueueFull as TQueueFull
from raft_tpu_torch.serve import ServingEngine as TEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = Resources(device="cpu")

J = types.SimpleNamespace(name="jax", obs=jobs, faults=jfaults, errors=jerrors, Router=JRouter,
                          Breaker=JBreaker, Deadline=JDeadline, QueueFull=JQueueFull,
                          group=lambda **kw: JGroup(**kw),
                          engine=lambda **kw: JEngine(**kw))
T = types.SimpleNamespace(name="torch", obs=tobs, faults=tfaults, errors=terrors, Router=TRouter,
                          Breaker=TBreaker, Deadline=TDeadline, QueueFull=TQueueFull,
                          group=lambda **kw: TGroup(res=CPU, **kw),
                          engine=lambda **kw: TEngine(res=CPU, **kw))
BOTH = (J, T)


def _reset():
    for p in BOTH:
        p.faults.disable()
        p.faults.clear()
        p.obs.disable()
        p.obs.registry().reset()


@pytest.fixture(autouse=True)
def _pristine_gates():
    _reset()
    yield
    _reset()


@pytest.fixture
def obs_on():
    for p in BOTH:
        p.obs.enable()
    yield
    for p in BOTH:
        p.obs.disable()


class VClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _data(rng, n, d, nc=8, scale=0.25):
    c = rng.standard_normal((nc, d)).astype(np.float32)
    return (c[rng.integers(0, nc, n)] + scale * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(13)
    return _data(rng, 256, 16), _data(rng, 64, 16)


@pytest.fixture(scope="module")
def indexes(corpus):
    X, _ = corpus
    return {"jax": jbf.build(X), "torch": tbf.build(X, res=CPU)}


def _counters(p, prefixes=("serve.failovers", "replica.", "serve.autoscale")):
    return {k: v for k, v in p.obs.registry().as_dict()["counters"].items()
            if k.startswith(prefixes)}


def assert_same_results(jres, tres):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        if isinstance(a, BaseException) or isinstance(b, BaseException):
            assert type(a).__name__ == type(b).__name__
            continue
        np.testing.assert_array_equal(np.asarray(a.indices), b.indices)
        np.testing.assert_allclose(np.asarray(a.distances), b.distances, rtol=1e-5, atol=1e-6)
        assert (a.coverage, a.degraded, a.generation) == (b.coverage, b.degraded, b.generation)


def outcome(fut):
    exc = fut.exception(timeout=0)
    return exc if exc is not None else fut.result(timeout=0)


def run_both(scenario, *args, **kw):
    """``scenario(p, *args)`` in each package; returns ``(jax, torch)``."""
    return [scenario(p, *args, **kw) for p in BOTH]


# -- the router ----------------------------------------------------------------


def _router_least_depth(p):
    r = p.Router(3)
    return [r.pick([5, 2, 9]), r.pick([4, 4, 4])]


def _router_exclusion(p):
    r = p.Router(2)
    return [r.pick([0, 10], exclude={0}), r.pick([0, 10], exclude={0, 1})]


def _router_open_breaker(p):
    clk = VClock()
    r = p.Router(2, failure_threshold=1, reset_timeout_s=1.0, clock=clk)
    r.breaker(1).record_failure()
    out = [r.breaker(1).state, r.pick([10, 0])]
    r.breaker(0).record_failure()
    return out + [r.pick([0, 0])]


def _router_half_open(p):
    clk = VClock()
    r = p.Router(1, failure_threshold=1, reset_timeout_s=0.5, clock=clk)
    r.breaker(0).record_failure()
    clk.advance(1.0)
    return [r.breaker(0).allow(), r.breaker(0).state, r.pick([0])]


def _router_staleness(p):
    r = p.Router(2, max_staleness_records=5)
    r.set_staleness(1, 10)
    out = [r.admissible(1), r.pick([99, 0])]
    r.set_staleness(1, 5)
    return out + [r.pick([99, 0]), p.Router(2).admissible(1), r.staleness(1), r.states()]


@pytest.mark.parametrize("case,want", [
    (_router_least_depth, [1, 0]),
    (_router_exclusion, [1, None]),
    (_router_open_breaker, ["open", 0, None]),
    (_router_half_open, [True, "half_open", None]),
    (_router_staleness, [False, 0, 1, True, 5, ["closed", "closed"]]),
], ids=["least_depth", "exclusion", "open_breaker", "half_open", "staleness_floor"])
def test_router_chooses_as_jax(case, want):
    assert run_both(case) == [want, want]


def test_router_resize_and_draining_as_jax():
    def case(p):
        r = p.Router(2)
        rid = r.add_replica()
        r.set_draining(1)
        out = [rid, r.n_replicas, r.pick([0, 0, 5]), r.draining(1)]
        r.set_draining(1, False)
        r.remove_last()
        return out + [r.n_replicas, r.pick([3, 0, 0]), len(r.states())]

    assert run_both(case) == [[2, 3, 0, True, 2, 1, 2]] * 2


# -- replica groups: parity, spreading, typed admission, health ----------------


def test_one_replica_group_is_bit_equal_to_the_bare_engine(corpus, indexes):
    _, Q = corpus
    eng = T.engine()
    eng.register("t", "brute_force", indexes["torch"])
    f1 = eng.submit("t", Q[:8], 5)
    eng.run_until_idle()

    def case(p):
        grp = p.group(n_replicas=1)
        grp.register("t", "brute_force", indexes[p.name])
        f = grp.submit("t", Q[:8], 5)
        grp.run_until_idle()
        return f.result(0)

    jr, tr = run_both(case)
    r1 = f1.result(0)
    assert np.array_equal(r1.distances, tr.distances) and np.array_equal(r1.indices, tr.indices)
    assert (r1.coverage, r1.degraded, r1.generation) == (tr.coverage, tr.degraded, tr.generation)
    assert_same_results([jr], [tr])


def _spread(p, Q, idx):
    grp = p.group(n_replicas=3)
    grp.register("t", "brute_force", idx[p.name])
    landed = []
    for i in range(7):
        grp.submit("t", Q[i : i + 1 + i % 3], 5)
        landed.append(grp._flights[-1].replica)
    depths = [e.queue_depth() for e in grp.engines]
    grp.run_until_idle()
    return landed, depths


def test_submission_spreads_by_queue_depth_as_jax(corpus, indexes):
    _, Q = corpus
    j, t = run_both(_spread, Q, indexes)
    assert j == t and t[1] == [4, 5, 4]


def _queue_full(p, Q, idx):
    grp = p.group(engine_factory=lambda r: p.engine(max_batch=4, queue_capacity=4),
                  n_replicas=2)
    grp.register("t", "brute_force", idx[p.name])
    grp.submit("t", Q[:4], 5)
    grp.submit("t", Q[:4], 5)
    with pytest.raises(p.QueueFull):
        grp.submit("t", Q[:4], 5)
    grp.run_until_idle()
    return [e.queue_depth() for e in grp.engines]


def test_queue_full_falls_through_then_surfaces_typed(corpus, indexes):
    _, Q = corpus
    assert run_both(_queue_full, Q, indexes) == [[0, 0], [0, 0]]


def _health(p, Q, idx):
    grp = p.group(n_replicas=2, name="pair")
    grp.register("t", "brute_force", idx[p.name])
    grp.set_slo("t", latency_ms=50.0, target=0.9)
    grp.submit("t", Q[:4], 5)
    h = grp.health()
    grp.run_until_idle()
    reps = [{k: v for k, v in r.items() if k != "engine"} for r in h["replicas"]]
    slo = [r["engine"]["indexes"]["t"]["slo"]["requests"] for r in h["replicas"]]
    return {k: v for k, v in h.items() if k != "replicas"}, reps, slo, sorted(h["replicas"][0]
                                                                           ["engine"])


def test_health_reports_per_replica_state_as_jax(corpus, indexes):
    _, Q = corpus
    j, t = run_both(_health, Q, indexes)
    assert j == t
    assert t[0]["cluster"]["queue_rows"] == 4 and t[0]["in_flight"] == 1


# -- failover -----------------------------------------------------------------------


def _kill_replica_1(p, Q, idx):
    p.faults.enable()
    p.faults.install("replica.dispatch", error=RuntimeError("chaos kill"), match={"replica": 1})
    grp = p.group(n_replicas=2, failure_threshold=2, reset_timeout_s=30.0, clock=VClock())
    grp.register("t", "brute_force", idx[p.name])
    futs, landed = [], []
    for i in range(32):
        futs.append(grp.submit("t", Q[i % len(Q)][None, :], 5))
        landed.append(grp._flights[-1].replica)
    grp.run_until_idle()
    return ([f.result(0) for f in futs], landed, grp.router.states(), _counters(p),
            grp.health()["parked"])


def test_a_killed_replica_is_invisible_to_callers_as_jax(obs_on, corpus, indexes):
    _, Q = corpus
    j, t = run_both(_kill_replica_1, Q, indexes)
    assert_same_results(j[0], t[0])
    assert j[1:] == t[1:]
    assert t[2] == ["closed", "open"]
    assert t[3]['serve.failovers{index_id="t",replica="1"}'] >= 1
    assert t[3]['replica.pump_failures{kind="RuntimeError",replica="1"}'] >= 2
    assert all(r.coverage == 1.0 for r in t[0])


def _failover_trace(p, Q, idx):
    p.faults.enable()
    p.faults.install("replica.dispatch", error=RuntimeError("one kill"), match={"replica": 0},
                     trigger="first_n", first_n=1)
    grp = p.group(n_replicas=2, failure_threshold=1, reset_timeout_s=30.0)
    grp.register("t", "brute_force", idx[p.name])
    fut = grp.submit("t", Q[:1], 5)
    grp.run_until_idle()
    res = fut.result(0)
    spans = p.obs.registry().spans("replica.failover")
    assert res.trace_id and spans and res.trace_id in spans[0]["trace"]
    return res, spans[0]["args"], _counters(p)


def test_failover_keeps_the_request_trace_as_jax(obs_on, corpus, indexes):
    _, Q = corpus
    j, t = run_both(_failover_trace, Q, indexes)
    assert_same_results([j[0]], [t[0]])
    assert j[1:] == t[1:] and t[1]["from_replica"] == 0


def _half_open_recovery(p, Q, idx):
    clk = VClock()
    p.faults.enable()
    p.faults.install("replica.dispatch", error=RuntimeError("transient"), match={"replica": 1},
                     trigger="first_n", first_n=2)
    grp = p.group(n_replicas=2, failure_threshold=2, reset_timeout_s=0.01, clock=clk)
    grp.register("t", "brute_force", idx[p.name])
    futs = [grp.submit("t", Q[i : i + 1], 5) for i in range(4)]
    grp.run_until_idle()
    states = [grp.router.breaker(1).state]
    clk.advance(0.02)
    for _ in range(3):
        grp.step(force=True)
        states.append(grp.router.breaker(1).state)
    fut = grp.submit("t", Q[:1], 5)
    landed = grp._flights[-1].replica
    grp.run_until_idle()
    return [f.result(0) for f in futs] + [fut.result(0)], states, landed


def test_a_killed_replica_recovers_through_its_half_open_probe(corpus, indexes):
    _, Q = corpus
    j, t = run_both(_half_open_recovery, Q, indexes)
    assert_same_results(j[0], t[0])
    assert j[1:] == t[1:]
    assert t[1][0] == "open" and t[1][-1] == "closed"


def _total_outage(p, Q, idx):
    clk = VClock()
    p.faults.enable()
    spec = p.faults.install("replica.dispatch", error=RuntimeError("outage"))
    grp = p.group(n_replicas=2, failure_threshold=1, reset_timeout_s=0.01, clock=clk)
    grp.register("t", "brute_force", idx[p.name])
    futs = [grp.submit("t", Q[i : i + 1], 5) for i in range(4)]
    for _ in range(6):
        grp.step(force=True)
    parked = (grp.health()["parked"], grp.queue_depth(), [f.done() for f in futs])
    p.faults.remove(spec)
    clk.advance(0.02)
    grp.run_until_idle()
    return [f.result(0) for f in futs], parked, spec.calls


def test_a_total_outage_parks_work_instead_of_erroring(corpus, indexes):
    _, Q = corpus
    j, t = run_both(_total_outage, Q, indexes)
    assert_same_results(j[0], t[0])
    assert j[1:] == t[1:] and t[1] == (4, 4, [False] * 4)


def _deadline_in_failover(p, Q, idx):
    clk = VClock()
    p.faults.enable()
    p.faults.install("replica.dispatch", error=RuntimeError("outage"))
    grp = p.group(n_replicas=2, failure_threshold=1, reset_timeout_s=5.0, clock=clk)
    grp.register("t", "brute_force", idx[p.name])
    fut = grp.submit("t", Q[:1], 5, deadline_ms=1.0)
    steps = 0
    while not fut.done() and steps < 20:
        grp.step(force=True)
        clk.advance(0.0005)
        steps += 1
    exc = fut.exception(0)
    assert isinstance(exc, p.Deadline)
    return steps, str(exc).split(" (")[0], grp.health()["parked"]


def test_deadline_expiry_during_failover_is_typed(corpus, indexes):
    _, Q = corpus
    j, t = run_both(_deadline_in_failover, Q, indexes)
    assert j == t


def _mid_run_kill(p, Q, idx):
    """An open-loop stream at 3,000 requests/s on the virtual clock: replica
    1 is killed for good the first time it holds queued work after 8
    submissions, as the JAX package's chaos drill does."""
    clk = VClock()
    p.faults.enable()
    grp = p.group(n_replicas=2, failure_threshold=2, reset_timeout_s=30.0, clock=clk)
    grp.register("t", "brute_force", idx[p.name])
    rng = np.random.default_rng(11)
    futs, landed, killed_at = [], [], None
    for i in range(64):
        clk.advance(float(rng.exponential(1.0 / 3000.0)))
        futs.append(grp.submit("t", Q[int(rng.integers(0, len(Q)))][None, :], 5))
        landed.append(grp._flights[-1].replica)
        if killed_at is None and i >= 7 and grp.engines[1].queue_depth() > 0:
            killed_at = i
            p.faults.install("replica.dispatch", error=RuntimeError("chaos kill"),
                             match={"replica": 1})
        grp.step()
    grp.run_until_idle()
    return [outcome(f) for f in futs], landed, killed_at, _counters(p)


def test_a_kill_mid_stream_loses_no_request_as_jax(obs_on, corpus, indexes):
    _, Q = corpus
    j, t = run_both(_mid_run_kill, Q, indexes)
    assert not any(isinstance(r, BaseException) for r in t[0])
    assert_same_results(j[0], t[0])
    assert j[1:] == t[1:]
    assert t[2] is not None and t[3]['serve.failovers{index_id="t",replica="1"}'] >= 1


def _slow_replica(p, Q, idx):
    p.faults.enable()
    p.faults.install("replica.dispatch", latency_s=0.05, match={"replica": 1})
    grp = p.group(n_replicas=2, failure_threshold=1, reset_timeout_s=30.0,
                  dispatch_timeout_s=0.02, clock=VClock())
    grp.register("t", "brute_force", idx[p.name])
    grp.warmup("t", 5)
    futs = [grp.submit("t", Q[i : i + 1], 5) for i in range(4)]
    grp.run_until_idle()
    return [f.result(0) for f in futs], grp.router.states(), _counters(p)


def test_a_pump_slower_than_the_dispatch_timeout_fails_its_replica(obs_on, corpus, indexes):
    _, Q = corpus
    j, t = run_both(_slow_replica, Q, indexes)
    assert_same_results(j[0], t[0])
    assert j[1:] == t[1:]
    assert t[2]['replica.pump_failures{kind="slow",replica="1"}'] == 1


def test_replica_dispatch_seam_fires_with_jax_s_context(corpus, indexes):
    """The seam fires once a pump, before ``engine.step``, with ``replica``
    and ``group`` as its context: a spec matching both counts the same
    calls in both packages."""
    _, Q = corpus

    def case(p):
        p.faults.enable()
        spec = p.faults.install("replica.dispatch", latency_s=0.0,
                                match={"replica": 1, "group": "g"})
        grp = p.group(n_replicas=2, name="g")
        grp.register("t", "brute_force", indexes[p.name])
        grp.submit("t", Q[:3], 5)
        grp.run_until_idle()
        return spec.calls, spec.fired

    j, t = run_both(case)
    assert j == t and t[0] >= 1


def test_group_set_slo_and_warmup_as_jax(corpus, indexes):
    _, Q = corpus

    def case(p):
        clk = VClock()
        grp = p.group(n_replicas=2, clock=clk)
        grp.register("t", "brute_force", indexes[p.name])
        trackers = grp.set_slo("t", latency_ms=1.0, target=0.9, burn_threshold=2.0)
        warmed = [len(keys) for keys in grp.warmup("t", 5)]
        for i in range(6):
            grp.submit("t", Q[i : i + 1], 5)
            clk.advance(0.005)
            grp.run_until_idle()
        return (len(trackers), warmed, [e.slo_burn("t") for e in grp.engines],
                [r["engine"]["indexes"]["t"]["slo"]["bad"] for r in grp.health()["replicas"]])

    j, t = run_both(case)
    assert j == t and sum(t[3]) == 6


# -- the no-fallback difference ------------------------------------------------------


def test_a_kernel_failure_in_a_replica_is_the_no_fallback_difference(corpus, monkeypatch):
    """The ``pallas.cagra_search`` seam fails every fused batch. JAX ("on a
    TPU", ``auto``) falls back to ``xla`` inside the search and the request
    completes on its first replica. The port (``fused``, what ``auto`` runs
    on a CUDA index) fails the batch typed; the group fails the request
    over, parks it when both breakers are open, and serves it once the
    fault clears: the caller sees latency, never the error."""
    X, Q = corpus
    graph = np.random.default_rng(3).integers(0, X.shape[0], (X.shape[0], 16)).astype(np.int32)
    jc, tc = jcagra.from_graph(X, graph), tcagra.from_graph(X, graph, device="cpu")
    _, want = tcagra.search(tc, Q[:2], 5, mode="xla")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for p in BOTH:
        p.faults.enable()
        p.faults.install("pallas.cagra_search", error=p.errors.KernelFailure("chaos"))

    jgrp = JGroup(n_replicas=2, failure_threshold=1, reset_timeout_s=0.01, clock=VClock())
    jgrp.register("c", "cagra", jc)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jf = jgrp.submit("c", Q[:2], 5)
        jgrp.run_until_idle()
    jres = jf.result(0)
    np.testing.assert_array_equal(np.asarray(jres.indices), want)
    assert jgrp.health()["parked"] == 0 and jgrp.router.states() == ["closed", "closed"]

    tobs.enable()
    tgrp = TGroup(n_replicas=2, failure_threshold=1, reset_timeout_s=0.01, clock=VClock(),
                  res=CPU)
    tgrp.register("c", "cagra", tc, mode="fused")
    tf = tgrp.submit("c", Q[:2], 5)
    for _ in range(3):
        tgrp.step(force=True)
    # each pump fails the batch (a failover, the breaker opens) and then
    # closes its breaker (the pump itself answered): the request moves
    # between the replicas, never errors and never parks
    assert not tf.done() and tgrp.health()["in_flight"] == 1
    assert tgrp.health()["parked"] == 0
    assert _counters(T)['serve.failovers{index_id="c",replica="0"}'] == 3.0
    assert _counters(T)['serve.failovers{index_id="c",replica="1"}'] == 3.0
    tfaults.clear()
    tgrp.run_until_idle()
    tres = tf.result(0)
    _, fused = tcagra.search(tc, Q[:2], 5, mode="fused")
    np.testing.assert_array_equal(tres.indices, fused)


# -- threaded pumps ----------------------------------------------------------------------


def test_threaded_pumps_serve_and_survive_a_kill(corpus, indexes):
    _, Q = corpus
    base = JEngine(max_batch=1)
    base.register("t", "brute_force", indexes["jax"])
    want = [base.submit("t", Q[i : i + 1], 5) for i in range(16)]
    base.run_until_idle()
    tfaults.enable()
    tfaults.install("replica.dispatch", error=RuntimeError("chaos kill"), match={"replica": 1})
    grp = TGroup(n_replicas=2, failure_threshold=2, reset_timeout_s=30.0,
                 engine_factory=lambda r: TEngine(max_batch=1, res=CPU))
    grp.register("t", "brute_force", indexes["torch"])
    grp.start()
    try:
        assert grp.health()["threaded"] is True
        futs = [grp.submit("t", Q[i : i + 1], 5) for i in range(16)]
        results = [f.result(timeout=30.0) for f in futs]
    finally:
        grp.stop()
    assert grp.health()["threaded"] is False
    assert_same_results([w.result(0) for w in want], results)


@pytest.fixture(scope="module")
def shared(corpus):
    X, _ = corpus
    graph = np.random.default_rng(5).integers(0, X.shape[0], (X.shape[0], 16)).astype(np.int32)
    return X, graph


@pytest.mark.parametrize("algo", ["cagra", "ivf_pq"])
def test_a_cold_threaded_start_on_one_shared_index(corpus, shared, algo):
    """Four pumps start together on one index whose fused caches are still
    empty (CAGRA's neighbour table and seeds, B2's group tables): every
    answer equals the bare engine's on a fresh copy of the index."""
    X, graph = shared
    _, Q = corpus

    def make():
        if algo == "cagra":
            return tcagra.from_graph(X, graph, device="cpu"), {"mode": "fused"}
        idx = tpq.build(X, tpq.IvfPqIndexParams(n_lists=8, pq_dim=8, kmeans_n_iters=4), res=CPU)
        return idx, {"mode": "fused", "params": tpq.IvfPqSearchParams(n_probes=4)}

    idx, kw = make()
    bare = TEngine(max_batch=8, res=CPU)
    bare.register("s", algo, idx, **kw)
    want = [bare.submit("s", Q[8 * i : 8 * i + 8], 5) for i in range(8)]
    bare.run_until_idle()
    for cache in ("_fused_table_cache", "_fused_seed_cache", "_fused_group_tables"):
        idx.__dict__.pop(cache, None)
    grp = TGroup(n_replicas=4, engine_factory=lambda r: TEngine(max_batch=8, res=CPU))
    grp.register("s", algo, idx, **kw)
    futs = [grp.submit("s", Q[8 * i : 8 * i + 8], 5) for i in range(8)]
    grp.start()
    try:
        results = [f.result(timeout=60.0) for f in futs]
    finally:
        grp.stop()
    for w, r in zip(want, results):
        np.testing.assert_array_equal(w.result(0).indices, r.indices)
        np.testing.assert_array_equal(w.result(0).distances, r.distances)


_WITNESS = r"""
import json
import numpy as np
from raft_tpu_torch import obs
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.replica import ReplicaGroup
from raft_tpu_torch.robust import faults
from raft_tpu_torch.serve import ServingEngine
from raft_tpu_torch.utils import lockcheck
assert lockcheck.is_enabled()
obs.enable()
faults.enable()
cpu = Resources(device="cpu")
rng = np.random.default_rng(0)
X = rng.standard_normal((128, 8)).astype(np.float32)
idx = brute_force.build(X, res=cpu)
faults.install("replica.dispatch", error=RuntimeError("kill"), match={"replica": 2},
               trigger="first_n", first_n=3)
grp = ReplicaGroup(n_replicas=3, failure_threshold=1, reset_timeout_s=0.01,
                   engine_factory=lambda r: ServingEngine(max_batch=4, res=cpu))
grp.register("t", "brute_force", idx)
grp.set_slo("t", latency_ms=100.0)
grp.start()
futs = [grp.submit("t", X[i : i + 2], 3) for i in range(40)]
done = [f.result(timeout=60.0) for f in futs]
grp.health()
grp.stop()
grp.shutdown()
print(json.dumps({
    "manifest": lockcheck.default_manifest_path(),
    "edges": sorted(lockcheck.edges()),
    "violations": lockcheck.violations(),
    "field_violations": lockcheck.field_violations(),
    "coverage": lockcheck.field_coverage(),
    "served": len(done),
}))
"""


def test_the_lock_witness_passes_a_threaded_group_run():
    env = dict(os.environ, RAFT_TPU_LOCKCHECK="1")
    env.pop("RAFT_TPU_LOCKCHECK_MANIFEST", None)
    out = subprocess.run([sys.executable, "-c", _WITNESS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep["manifest"].startswith(os.path.join(REPO, "raft_tpu_torch") + os.sep)
    assert rep["served"] == 40
    assert rep["violations"] == [] and rep["field_violations"] == []
    # every new lock is an edge-free leaf
    new = {"replica.group", "replica.router", "obs.slo"}
    assert not [e for e in rep["edges"] if set(e[:2]) & new]
    for cls in ("ReplicaGroup", "Router", "SloTracker"):
        assert rep["coverage"][cls] == {"armed": True, "exercised": True}
