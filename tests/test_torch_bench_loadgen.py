"""The port's load generator (``raft_tpu_torch.bench.loadgen``) against
raft_tpu's: the percentile and the Poisson arrivals bit for bit, JAX's
``TestLoadgen`` scenarios (``tests/test_serve.py``) on the port's engine,
a full queue's rejections counted as JAX counts them, the loop driving a
``ReplicaGroup``-like shim, and the obs gauges. Inputs from numpy seeds;
JAX on the CPU."""
import numpy as np
import pytest

from raft_tpu import obs as jobs
from raft_tpu.bench import loadgen as jlg
from raft_tpu.core.errors import RaftError as JRaftError
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.serve import ServingEngine as JEngine
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.bench import loadgen as tlg
from raft_tpu_torch.core.errors import RaftError as TRaftError
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.serve import ServingEngine as TEngine

CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((512, 16)).astype(np.float32),
            rng.standard_normal((96, 16)).astype(np.float32))


@pytest.fixture(scope="module")
def t_index(corpus):
    return tbf.build(corpus[0], res=CPU)


def t_engine(index, **kw):
    eng = TEngine(res=CPU, **kw)
    eng.register("bf", "brute_force", index, mode="exact")
    return eng


def test_percentile_is_jax_s():
    rng = np.random.default_rng(0)
    for samples in ([30.0, 10.0, 20.0], list(range(1, 101)), [], list(rng.random(37) * 100)):
        for q in (0, 1, 50, 95, 99, 100):
            assert tlg.percentile(samples, q) == jlg.percentile(samples, q)
    assert tlg.percentile([30.0, 10.0, 20.0], 50) == 20.0
    assert tlg.percentile([], 99) == 0.0


def test_poisson_arrivals_are_bit_equal_and_checked():
    for rate, n, seed in ((100.0, 2000, 5), (2000.0, 2000, 0), (3.5, 17, 11)):
        a = tlg.poisson_arrivals(rate, n, seed=seed)
        np.testing.assert_array_equal(a, jlg.poisson_arrivals(rate, n, seed=seed))
    a = tlg.poisson_arrivals(100.0, 2000, seed=5)
    assert np.all(np.diff(a) >= 0) and 0.008 < float(np.mean(np.diff(a))) < 0.012
    with pytest.raises(TRaftError):
        tlg.poisson_arrivals(0.0, 10)
    with pytest.raises(JRaftError):
        jlg.poisson_arrivals(0.0, 10)


def test_open_loop_accounts_every_request(corpus, t_index):
    _, Q = corpus
    eng = t_engine(t_index, max_batch=8, max_wait_ms=0.5, queue_capacity=64)
    rep, got = tlg.run_open_loop(eng, "bf", Q, k=10, rate_qps=2000.0, n_requests=24,
                                 request_rows=2, collect=True)
    assert rep.mode == "open"
    assert rep.completed + sum(rep.rejected.values()) == rep.n_requests
    assert rep.completed == len(got) > 0
    for ids, res_idx in got:
        assert res_idx.shape == (len(ids), 10)
        _, want = tbf.search(t_index, Q[ids], 10)
        np.testing.assert_array_equal(res_idx, want.numpy())
    assert rep.latency_ms_p50 <= rep.latency_ms_p95 <= rep.latency_ms_p99 <= rep.latency_ms_max


def test_closed_loop_accounts_every_request(corpus, t_index):
    _, Q = corpus
    eng = t_engine(t_index, max_batch=8, max_wait_ms=0.5, queue_capacity=64)
    rep, got = tlg.run_closed_loop(eng, "bf", Q, k=10, concurrency=4, n_requests=16,
                                   request_rows=2, collect=True)
    assert rep.mode == "closed"
    assert rep.completed + sum(rep.rejected.values()) == rep.n_requests
    assert rep.completed == len(got) > 0
    assert rep.throughput_qps > 0
    assert set(rep.row()) == {"qps", "completed", "rejected", "p50_ms", "p95_ms", "p99_ms"}
    assert [sorted(ids.tolist()) for ids, _ in got] == \
        [[(2 * r) % 96, (2 * r + 1) % 96] for r in range(16)]


def test_a_full_queue_rejects_as_jax(corpus, t_index):
    """Every arrival is due at once (10^9 requests/s), so the queue of 8
    rows admits four requests of two rows and refuses the rest, in both
    packages."""
    X, Q = corpus
    reports = []
    for eng in (t_engine(t_index, max_batch=8, max_wait_ms=0.5, queue_capacity=8),
                JEngine(max_batch=8, max_wait_ms=0.5, queue_capacity=8)):
        if isinstance(eng, JEngine):
            eng.register("bf", "brute_force", jbf.build(X), mode="exact")
        mod = tlg if isinstance(eng, TEngine) else jlg
        rep, _ = mod.run_open_loop(eng, "bf", Q, k=5, rate_qps=1e9, n_requests=24,
                                   request_rows=2)
        reports.append(rep)
    t, j = reports
    assert t.rejected == j.rejected == {"QueueFull": 20}
    assert t.completed == j.completed == 4
    assert t.row()["rejected"] == 20


def test_the_loops_drive_anything_with_submit_step_and_run_until_idle(corpus, t_index):
    """As JAX's replica test drives a ``ReplicaGroup`` shim: the loops call
    only ``submit``, ``step`` and ``run_until_idle``."""
    _, Q = corpus

    class Shim:
        def __init__(self, eng):
            self.eng, self.calls = eng, {"submit": 0, "step": 0, "run_until_idle": 0}

        def submit(self, *a, **kw):
            self.calls["submit"] += 1
            return self.eng.submit(*a, **kw)

        def step(self, *a, **kw):
            self.calls["step"] += 1
            return self.eng.step(*a, **kw)

        def run_until_idle(self, *a, **kw):
            self.calls["run_until_idle"] += 1
            return self.eng.run_until_idle(*a, **kw)

    shim = Shim(t_engine(t_index, max_batch=8, max_wait_ms=0.5))
    rep, _ = tlg.run_open_loop(shim, "bf", Q, 5, rate_qps=3000.0, n_requests=64, seed=11)
    assert rep.completed == 64 and rep.rejected == {}
    assert shim.calls["submit"] == 64 and shim.calls["step"] >= 1
    assert shim.calls["run_until_idle"] >= 1
    shim.calls = dict.fromkeys(shim.calls, 0)
    rep, _ = tlg.run_closed_loop(shim, "bf", Q, 5, concurrency=3, n_requests=10)
    assert rep.completed == 10 and shim.calls["submit"] == 10


def test_reports_and_gauges_carry_jax_s_names(corpus, t_index):
    _, Q = corpus
    tobs.enable()
    try:
        tobs.registry().reset()
        eng = t_engine(t_index, max_batch=8, max_wait_ms=0.5)
        rep, _ = tlg.run_closed_loop(eng, "bf", Q, 5, concurrency=2, n_requests=6)
        snap = tobs.registry().as_dict()
    finally:
        tobs.disable()
        tobs.registry().reset()
    names = {key.split("{")[0] for kind in ("gauges", "histograms") for key in snap[kind]}
    assert {"loadgen.throughput_qps", "loadgen.p50_ms", "loadgen.p99_ms",
            "loadgen.latency_ms"} <= names
    assert snap["histograms"]['loadgen.latency_ms{mode="closed"}']["count"] == 6
    assert rep.worst_trace() == rep.trace_ids[rep.latencies_ms.index(rep.latency_ms_max)]
    assert rep.worst_trace() != ""
    assert [f.name for f in tlg.LoadReport.__dataclass_fields__.values()] == \
        [f.name for f in jlg.LoadReport.__dataclass_fields__.values()]
    assert jobs.is_enabled() is False
