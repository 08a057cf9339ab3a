"""The port's base layer against raft_tpu: the three new error types,
fault injection (``FaultSpec`` firing under every trigger), retry schedules
and ``retry_call``, the circuit breaker's transitions, the obs registry's
dumps, spans and trace scopes, the lock witness in a subprocess, and the
``KernelFailure`` boundary of the kernel build and launch.

Equal means equal here: the schedules, firings, transitions and dumps are
deterministic in both packages, so every comparison is exact (no
tolerance) except the obs dumps' wall-clock fields, which are left out."""
import ctypes
import io
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.core import errors as jerrors
from raft_tpu.robust import faults as jfaults
from raft_tpu.robust import retry as jretry
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core import errors as terrors
from raft_tpu_torch.ops import cuda_build, guard
from raft_tpu_torch.robust import faults as tfaults
from raft_tpu_torch.robust import retry as tretry
from raft_tpu_torch.utils import lockcheck as tlockcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Boom(RuntimeError):
    """A typed error the fault specs raise."""


@pytest.fixture
def obs_pair():
    """Both registries empty and enabled for the test; restored after."""
    for o in (jobs, tobs):
        o.registry().reset()
        o.enable()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.registry().reset()


# -- errors --------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda e: e.ShardFailure("lost", shard=3),
    lambda e: e.ShardFailure(),
    lambda e: e.KernelFailure("build ivf_scan.cu: OSError: x"),
    lambda e: e.HostFetchError("fetch failed", rows=128, attempts=3),
    lambda e: e.HostFetchError("fetch failed"),
], ids=["shard", "shard_default", "kernel", "host_fetch", "host_fetch_bare"])
def test_new_error_types_match_jax(make):
    j, t = make(jerrors), make(terrors)
    assert str(t) == str(j)
    assert isinstance(t, terrors.RaftError)
    for field in ("shard", "rows", "attempts"):
        assert getattr(t, field, None) == getattr(j, field, None)


# -- faults --------------------------------------------------------------------


def test_fault_points_are_jax_s():
    assert tfaults.FAULT_POINTS == jfaults.FAULT_POINTS


def _firings(mod, n_calls: int, **spec):
    """Which of ``n_calls`` fire() calls at wal.append raised, in a fresh
    registry of ``mod``, with every other call's stage not matching when
    ``match`` is given."""
    reg = mod.FaultRegistry()
    s = reg.install(mod.FaultSpec(point="wal.append", error=Boom("x"), **spec))
    out = []
    for i in range(n_calls):
        try:
            reg.fire("wal.append", op="insert", stage="pre" if i % 2 == 0 else "post")
            out.append(0)
        except Boom:
            out.append(1)
    return out, s.calls, s.fired


@pytest.mark.parametrize("spec", [
    {},
    {"trigger": "nth", "nth": 3},
    {"trigger": "first_n", "first_n": 4},
    {"trigger": "probability", "probability": 0.3, "seed": 7},
    {"trigger": "probability", "probability": 0.5, "seed": 123},
    {"trigger": "first_n", "first_n": 2, "match": {"stage": "post"}},
], ids=["always", "nth", "first_n", "p0.3", "p0.5", "match"])
def test_fault_spec_firing_matches_jax(spec):
    assert _firings(tfaults, 40, **spec) == _firings(jfaults, 40, **spec)


def test_fault_gate_install_checks_and_injected():
    assert not tfaults.is_enabled()
    tfaults.fire("wal.append", op="insert", stage="pre")  # gate off: a no-op
    with pytest.raises(terrors.LogicError):
        tfaults.install("no.such.point")
    with pytest.raises(terrors.LogicError):
        tfaults.registry().install(tfaults.FaultSpec(point="wal.append", trigger="sometimes"))
    with tfaults.injected("compact.merge", Boom("x"), trigger="first_n", first_n=1) as spec:
        assert tfaults.is_enabled()
        with pytest.raises(Boom):
            tfaults.fire("compact.merge", generation=1)
        tfaults.fire("compact.merge", generation=1)
    assert not tfaults.is_enabled() and spec.fired == 1 and spec.calls == 2
    assert tfaults.registry().specs() == []


def test_fault_latency_and_obs_count(obs_pair):
    with tfaults.injected("manifest.swap", latency_s=0.02):
        t0 = time.perf_counter()
        tfaults.fire("manifest.swap", generation=1)
        assert time.perf_counter() - t0 >= 0.02
    with tfaults.injected("wal.append", Boom("x")):
        with pytest.raises(Boom):
            tfaults.fire("wal.append", op="delete", stage="pre")
    counters = tobs.registry().as_dict()["counters"]
    assert counters['faults.fired{kind="latency",point="manifest.swap"}'] == 1.0
    assert counters['faults.fired{kind="Boom",point="wal.append"}'] == 1.0


# -- retries -------------------------------------------------------------------

POLICIES = [
    {},
    {"max_attempts": 6, "base_delay_s": 0.01, "multiplier": 3.0, "max_delay_s": 0.5,
     "jitter_frac": 0.25},
    {"max_attempts": 1},
    {"max_attempts": 3, "base_delay_s": 0.01, "multiplier": 2.0, "max_delay_s": 0.25},
]


@pytest.mark.parametrize("kw", POLICIES, ids=["default", "wide", "single", "compact"])
@pytest.mark.parametrize("seed", [0, 1, 99])
def test_retry_schedule_matches_jax(kw, seed):
    assert tretry.RetryPolicy(**kw).schedule(seed) == jretry.RetryPolicy(**kw).schedule(seed)


@pytest.mark.parametrize("fail_first", [0, 2, 5])
def test_retry_call_matches_jax(fail_first, obs_pair):
    """The same flaky function under both packages' retry_call: the same
    virtual sleeps, the same outcome and the same counters."""
    def run(mod):
        calls, slept = [0], []

        def flaky():
            calls[0] += 1
            if calls[0] <= fail_first:
                raise Boom(f"try {calls[0]}")
            return "ok"

        policy = mod.RetryPolicy(max_attempts=4, base_delay_s=0.1)
        try:
            out = mod.retry_call(flaky, policy=policy, op="t", seed=5, sleep=slept.append)
        except mod.RetryError as e:
            out = ("gave_up", e.attempts, str(e.last), isinstance(e.__cause__, Boom))
        return out, calls[0], slept

    assert run(tretry) == run(jretry)
    t = {k: v for k, v in tobs.registry().as_dict()["counters"].items() if k.startswith("retry.")}
    j = {k: v for k, v in jobs.registry().as_dict()["counters"].items() if k.startswith("retry.")}
    assert t == j
    assert bool(t) == (fail_first > 0)


def test_retry_deadline_non_retryable_and_decorator():
    now = [0.0]
    slept = []

    def sleep(d):
        slept.append(d)
        now[0] += d

    def always():
        raise Boom("x")

    policy = tretry.RetryPolicy(max_attempts=10, base_delay_s=1.0, deadline_s=2.5, jitter_frac=0.0)
    with pytest.raises(tretry.RetryError):
        tretry.retry_call(always, policy=policy, sleep=sleep, clock=lambda: now[0])
    assert slept == [1.0]  # the second delay (2.0) would pass the deadline
    with pytest.raises(ValueError):
        tretry.retry_call(lambda: int("x"), policy=tretry.RetryPolicy(retryable=(Boom,)))
    n = [0]

    @tretry.retrying(tretry.RetryPolicy(max_attempts=2, base_delay_s=0.0))
    def once_flaky():
        n[0] += 1
        if n[0] == 1:
            raise Boom("x")
        return n[0]

    assert once_flaky() == 2


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


#: a script of breaker events: ("f") failure, ("s") success, ("a") allow,
#: ("t", dt) time passes
BREAKER_SCRIPT = ["a", "f", "s", "f", "f", "a", "f", "a", ("t", 0.5), "a", ("t", 0.6), "a", "a",
                  "f", "a", ("t", 1.0), "a", "s", "a", "f", "f", "f", "f", ("t", 2.0), "a", "s"]


def test_circuit_breaker_transitions_match_jax(obs_pair):
    def run(mod):
        clk = _Clock()
        br = mod.CircuitBreaker("r0", failure_threshold=3, reset_timeout_s=1.0, clock=clk)
        trace = []
        for ev in BREAKER_SCRIPT:
            if ev == "a":
                trace.append(("allow", br.allow()))
            elif ev == "f":
                br.record_failure()
            elif ev == "s":
                br.record_success()
            else:
                clk.t += ev[1]
            trace.append((br.state, br.failures))
        return trace

    t, j = run(tretry), run(jretry)
    assert t == j
    assert {s for s, _ in t if isinstance(s, str)} >= {"closed", "open", "half_open"}
    pick = ("robust.breaker.",)
    td, jd = tobs.registry().as_dict(), jobs.registry().as_dict()
    for kind in ("counters", "gauges"):
        assert ({k: v for k, v in td[kind].items() if k.startswith(pick)}
                == {k: v for k, v in jd[kind].items() if k.startswith(pick)})


# -- obs -----------------------------------------------------------------------


def _drive(o):
    o.inc("a.calls", mode="fused")
    o.inc("a.calls", 2.0, mode="fused")
    o.inc("a.calls", mode="probe")
    o.set_gauge("a.depth", 7, index_id="x")
    for v in (0.05, 0.3, 3.0, 40.0, 9000.0):
        o.observe("a.ms", v, trace_id="t1" if v > 1 else None)
    o.registry().histogram("b.custom", buckets=(1.0, 2.0)).observe(1.5)


def test_registry_dumps_match_jax(obs_pair):
    _drive(tobs)
    _drive(jobs)
    td, jd = tobs.registry().as_dict(), jobs.registry().as_dict()
    assert td == jd
    assert tobs.registry().prometheus_text() == jobs.registry().prometheus_text()
    tb, jb = io.StringIO(), io.StringIO()
    tobs.registry().dump_jsonl(tb)
    jobs.registry().dump_jsonl(jb)
    assert tb.getvalue() == jb.getvalue()
    assert tobs.registry().sample(["a."]) == jobs.registry().sample(["a."])


def test_disabled_obs_records_nothing():
    reg = tobs.registry()
    reg.reset()
    assert not tobs.is_enabled()
    tobs.inc("x")
    tobs.set_gauge("y", 1.0)
    tobs.observe("z", 1.0)
    with tobs.span("s", a=1) as sp:
        assert sp.sync(3) == 3
    assert tobs.new_trace_id() == ""
    assert reg.as_dict() == {"counters": {}, "gauges": {}, "histograms": {}, "n_spans": 0,
                             "spans_dropped": 0}


def test_spans_nest_sync_and_trace(obs_pair):
    t = torch.arange(4.0)

    @tobs.traced("dec")
    def f():
        return t * 2

    with tobs.trace_scope(["t9", ""]):
        with tobs.span("outer", k=1) as sp:
            with tobs.span("inner"):
                f()
            assert sp.sync((t, {"x": [t]})) [0] is t
            sp.set(rows=4)
    spans = {s["name"]: s for s in tobs.registry().spans()}
    assert spans["outer"]["depth"] == 0 and spans["inner"]["depth"] == 1
    assert spans["dec"]["depth"] == 2 and spans["outer"]["args"] == {"k": 1, "rows": 4}
    assert spans["outer"]["trace"] == ["t9"] and tobs.current_trace() == ()
    assert [s["name"] for s in tobs.iter_trace_spans(tobs.registry(), "t9")] == [
        "outer", "inner", "dec"]
    assert tobs.new_trace_id().startswith("t")
    with pytest.raises(ValueError):
        with tobs.span("raises"):
            raise ValueError("x")
    assert tobs.registry().spans("raises")


def test_span_cap_counts_drops(obs_pair):
    reg = tobs.Registry(max_spans=2)
    for i in range(4):
        reg.record_span("s", 0.0, 1.0, 0, 0)
    assert reg.spans_dropped == 2 and len(reg.spans()) == 2
    assert reg.as_dict()["counters"]["obs.spans_dropped"] == 2.0


# -- the lock witness ------------------------------------------------------------

_WITNESS = r"""
import json, os, sys, tempfile, threading
import numpy as np
from raft_tpu_torch import obs
from raft_tpu_torch.utils import lockcheck
from raft_tpu_torch.robust import faults
from raft_tpu_torch.mutable import CompactionPolicy, Compactor, MutableIndex
assert lockcheck.is_enabled()
obs.enable()
faults.enable()
rng = np.random.default_rng(0)
with tempfile.TemporaryDirectory() as d:
    mut = MutableIndex.open(d, "brute_force", 8, device="cpu")
    ids = mut.insert(rng.standard_normal((64, 8)).astype(np.float32))
    mut.compact()
    mut.delete(ids[:4])
    mut.upsert(ids[4:6], rng.standard_normal((2, 8)).astype(np.float32))
    comp = Compactor(mut, policy=CompactionPolicy(delta_rows=1), poll_interval_s=0.002)
    comp.start()
    assert comp.tick() == "delta_rows"
    def writer():
        for _ in range(5):
            mut.insert(rng.standard_normal((3, 8)).astype(np.float32))
    t = threading.Thread(target=writer)
    t.start()
    assert comp.wait_idle(timeout_s=60.0)
    t.join()
    comp.stop()
    mut.compact_background()
    mut.search(rng.standard_normal((4, 8)).astype(np.float32), 5)
    mut.close()
print(json.dumps({
    "manifest": lockcheck.default_manifest_path(),
    "edges": sorted(lockcheck.edges()),
    "violations": lockcheck.violations(),
    "field_violations": lockcheck.field_violations(),
    "coverage": lockcheck.field_coverage(),
}))
"""


def test_lock_witness_in_a_subprocess():
    env = dict(os.environ, RAFT_TPU_LOCKCHECK="1")
    env.pop("RAFT_TPU_LOCKCHECK_MANIFEST", None)
    out = subprocess.run([sys.executable, "-c", _WITNESS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    pkg = os.path.join(REPO, "raft_tpu_torch") + os.sep
    assert rep["manifest"].startswith(pkg)
    man = tlockcheck._Manifest(tlockcheck._load_toml(rep["manifest"]))
    edges = {tuple(e) for e in rep["edges"]}
    assert edges <= man.edges, edges - man.edges
    assert ("mutable.compact_mutex", "mutable.lock") in edges
    assert ("mutable.lock", "obs.registry") in edges
    assert rep["violations"] == [] and rep["field_violations"] == []
    for cls in ("MutableIndex", "Compactor", "Registry"):
        assert rep["coverage"][cls] == {"armed": True, "exercised": True}


def test_lock_manifest_is_the_jax_manifest_cut_to_the_port_s_locks():
    """Every lock, edge and guard of the port's manifest is the JAX
    package's entry for that name, with every edge between the port's
    locks kept."""
    port = tlockcheck._load_toml(tlockcheck.default_manifest_path())
    ref = tlockcheck._load_toml(os.path.join(REPO, "tools", "graft_lint", "lock_order.toml"))
    names = {e["name"] for e in port["lock"]}
    assert names == {"mutable.lock", "mutable.compact_mutex", "compactor.state", "obs.registry",
                     "robust.faults", "obs.slo", "obs.recorder", "replica.group",
                     "replica.router", "replica.lease", "replica.autoscaler",
                     "serve.batcher", "serve.program_cache", "core.resources",
                     "core.resources_default", "core.interruptible", "native.build"}
    ref_locks = {e["name"]: e for e in ref["lock"]}
    for e in port["lock"]:
        assert (e["attr"], e["classes"]) == (ref_locks[e["name"]]["attr"],
                                             ref_locks[e["name"]]["classes"])
    assert ({(e["from"], e["to"]) for e in port["edge"]}
            == {(e["from"], e["to"]) for e in ref["edge"] if e["from"] in names and e["to"] in names})
    ref_guards = {g["class"]: g for g in ref["guards"]}
    for g in port["guards"]:
        r = ref_guards[g["class"]]
        assert (g["lock"], g["fields"], g.get("write_guarded", [])) == (
            r["lock"], r["fields"], r.get("write_guarded", []))


def test_lockcheck_off_returns_the_raw_lock_and_class():
    assert not tlockcheck.is_enabled()
    lock = threading.Lock()
    assert tlockcheck.tracked(lock, "mutable.lock") is lock

    class C:
        pass

    assert tlockcheck.guarded_fields(C) is C


def test_lockcheck_records_edges_and_flags_an_inversion(monkeypatch, tmp_path):
    toml = tmp_path / "order.toml"
    toml.write_text('[[lock]]\nname = "a"\n[[lock]]\nname = "b"\n[[edge]]\nfrom = "a"\nto = "b"\n')
    monkeypatch.setattr(tlockcheck, "_manifest", None)
    monkeypatch.setattr(tlockcheck, "_manifest_loaded", False)
    monkeypatch.setenv("RAFT_TPU_LOCKCHECK_MANIFEST", str(toml))
    tlockcheck.enable()
    try:
        tlockcheck.reset()
        a = tlockcheck.tracked(threading.Lock(), "a")
        b = tlockcheck.tracked(threading.RLock(), "b")
        with a:
            with b:
                with b:
                    pass
        # the re-entry of b under a takes the edge again; b under b is none
        assert tlockcheck.edges() == {("a", "b"): 2} and tlockcheck.violations() == []
        with b:
            with a:
                pass
        assert len(tlockcheck.violations()) == 1 and "b -> a" in tlockcheck.violations()[0]
        assert tlockcheck.coverage() == ({("a", "b")}, {("a", "b")})
    finally:
        tlockcheck.disable()
        tlockcheck.reset()
        monkeypatch.setattr(tlockcheck, "_manifest", None)
        monkeypatch.setattr(tlockcheck, "_manifest_loaded", False)


# -- the KernelFailure boundary -----------------------------------------------------


def test_kernel_guard_translates_toolchain_errors_only():
    with pytest.raises(terrors.KernelFailure) as ei:
        with guard.kernel_guard("load libx.so"):
            raise OSError("cannot open shared object file")
    assert isinstance(ei.value, terrors.RaftError)
    assert isinstance(ei.value.__cause__, OSError) and "load libx.so: OSError" in str(ei.value)
    with pytest.raises(terrors.LogicError):
        with guard.kernel_guard("x"):
            raise terrors.LogicError("library error")
    with pytest.raises(KeyError):
        with guard.kernel_guard("x"):
            raise KeyError("caller bug")
    guard.check_cuda(0, "ivf_scan kernel launch")
    with pytest.raises(terrors.KernelFailure, match=r"ivf_scan kernel launch failed \(cudaError 700\)"):
        guard.check_cuda(700, "ivf_scan kernel launch")


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    """cuda_build pointed at a scratch source and build directory."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("extern \"C\" int f() { return 0; }\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    yield csrc, build
    cuda_build._loaded.pop("fake.cu", None)


def test_missing_nvcc_raises_kernel_failure_from_b1(monkeypatch, tmp_path):
    from raft_tpu_torch.ops import ivf_scan

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    real_exists = os.path.exists
    monkeypatch.setattr(cuda_build.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc") else real_exists(p))
    monkeypatch.delitem(cuda_build._loaded, "ivf_scan.cu", raising=False)
    with pytest.raises(terrors.KernelFailure, match="nvcc not found") as ei:
        ivf_scan.build_kernel()
    assert isinstance(ei.value, terrors.RaftError)


def test_failed_compile_and_failed_load_raise_kernel_failure(fake_build, monkeypatch, tmp_path):
    _, build = fake_build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'fake.cu(1): error: expected a declaration' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    with pytest.raises(terrors.KernelFailure, match="nvcc failed to build fake.cu"):
        cuda_build.build_library("fake.cu", {"f": []})
    # a library that exists but does not load
    so = os.path.join(str(build), f"libfake_{cuda_build._digest(os.path.join(cuda_build.CSRC_DIR, 'fake.cu'))}.so")
    os.makedirs(str(build), exist_ok=True)
    with open(so, "wb") as f:
        f.write(b"not an ELF file")
    with pytest.raises(terrors.KernelFailure, match="build fake.cu: OSError") as ei:
        cuda_build.build_library("fake.cu", {"f": []})
    assert isinstance(ei.value.__cause__, OSError)


def test_build_lock_holds_across_threads(fake_build, monkeypatch):
    """Threads that reach build_library at first use together run the
    compiler once and share one loaded library."""
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        time.sleep(0.2)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.f = lambda *a: 0

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", FakeLib)
    out = [None] * 6
    barrier = threading.Barrier(6)

    def worker(i):
        barrier.wait()
        out[i] = cuda_build.build_library("fake.cu", {"f": [ctypes.c_int]})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    assert len({id(o[0]) for o in out}) == 1
    assert sorted(o[1] > 0 for o in out) == [False] * 5 + [True]
